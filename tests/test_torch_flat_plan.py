"""The flat kernel's plan (``ops/wavefront.py`` ``flat_plan``), on the CPU:
each pair's orientation and strips of ``32 * R`` rows (R = 4), the claim
order, the grid, the hand-off slots and the groups a cap on them makes; and
a plain emulation of the kernel's order of work
(``csrc/wavefront.cu`` ``wavefront_flat``: a warp's lanes of R rows each,
one anti-diagonal a step, the shift register of b's chars or of profile
offsets, the tagged slots taken by strip parity, the masked ramps) against
the plain version ``wavefront_reference`` in all 16 configurations at the
strip edges. The plan is pure arithmetic and the scores integers: every
check is exact."""

import contextlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu_torch.ops import wavefront as wf  # noqa: E402
from stringzilla_tpu_torch.ops.wavefront import (  # noqa: E402
    FLAT_CHUNK, FLAT_ROWS, FLAT_SHARE, FLAT_WARPS, flat_plan, wavefront_reference)

H100 = (132, 28)  # SMs, warps of the kernel an SM holds (NW with affine gaps and classes)


def _slot_words(pair, strips, affine):
    """A pair's hand-off slots: two rows of its columns, the longer
    string's chars and one, twice when affine; none for a pair of one
    strip."""
    return 2 * (max(pair) + 1) * (2 if affine else 1) if strips > 1 else 0


@contextlib.contextmanager
def _capped(cap):
    """``SCRATCH_CAP_BYTES`` set to ``cap`` (left as it is when None)."""
    saved = wf.SCRATCH_CAP_BYTES
    if cap is not None:
        wf.SCRATCH_CAP_BYTES = cap
    try:
        yield
    finally:
        wf.SCRATCH_CAP_BYTES = saved


def _check_plan(pairs, affine, sms, warps, cap=None):
    """Every property the kernel relies on."""
    with _capped(cap):
        plan = flat_plan(pairs, affine, sms, warps)
    h = 32 * FLAT_ROWS
    cap = wf.SCRATCH_CAP_BYTES if cap is None else cap
    assert FLAT_ROWS == 4 and FLAT_CHUNK == 16
    assert plan.ctas_per_sm == warps // FLAT_WARPS
    # a pair's rows are its shorter string's: transposed when m > n
    assert plan.transposed == tuple(m > n for m, n in pairs)
    assert plan.strips == tuple(-(-min(m, n) // h) for m, n in pairs)
    for g in plan.groups:
        own = range(g.first_pair, g.first_pair + g.pairs)
        # the pair's slots: two rows of n + 1 (four when affine), side by side
        words = 0
        for p in own:
            assert plan.slot_offsets[p] == words
            words += _slot_words(pairs[p], plan.strips[p], affine)
        assert g.slot_words == words and 8 * words <= cap
        # every strip of the group once; strip s - 1 of a pair before strip s
        claims = [tuple(x) for x in plan.claims[g.first_claim: g.first_claim + g.claims]]
        assert sorted(claims) == [(p - g.first_pair, s) for p in own
                                  for s in range(plan.strips[p])]
        seen = {}
        for k, (p, s) in enumerate(claims):
            assert s == 0 or seen[(p, s - 1)] < k
            seen[(p, s)] = k
        # strip-major: strip s of every pair before strip s + 1 of any
        assert [s for _, s in claims] == sorted(s for _, s in claims)
        # as many CTAs as the strips fill, at most FLAT_SHARE an SM, fewer
        # when the strips are few, never more than the card holds
        share = FLAT_WARPS * FLAT_SHARE
        per_sm = min(plan.ctas_per_sm, FLAT_SHARE, -(-g.claims // (sms * share)))
        assert g.ctas == min(-(-g.claims // FLAT_WARPS), sms * per_sm) >= 1
        assert g.ctas <= sms * min(plan.ctas_per_sm, FLAT_SHARE)
    # the groups cover the pairs and the claims in order; a group stops only
    # where the next pair would pass the cap
    assert plan.groups[0].first_pair == 0 and plan.groups[0].first_claim == 0
    assert sum(g.pairs for g in plan.groups) == len(pairs)
    for g, nxt in zip(plan.groups, plan.groups[1:]):
        assert nxt.first_pair == g.first_pair + g.pairs
        assert nxt.first_claim == g.first_claim + g.claims
        extra = _slot_words(pairs[nxt.first_pair], plan.strips[nxt.first_pair], affine)
        assert 8 * (g.slot_words + extra) > cap
    assert plan.handoff_bytes == 8 * len(plan.groups) + 8 * max(g.slot_words for g in plan.groups)
    rec = plan.record()
    assert rec.shape == (len(plan.groups), 6) and rec.tolist() == [list(g) for g in plan.groups]
    return plan


_READS = [(m, n) for m in (5000, 9000, 15000) for n in (5000, 12000, 100)]
_SHAPES = {
    "strip edges": [(m, n) for m in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257)
                    for n in (1, 2, 100)],
    "thin": [(700, 3), (3, 700), (1, 4097), (4097, 1)],
    "long reads": _READS * 7,
    "long pair": [(100_000, 100_000)],
    "largest": [((1 << 19) - 1, (1 << 19) - 1), ((1 << 19) - 1, 1)],
}


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("name", list(_SHAPES))
@pytest.mark.parametrize("card", [H100, (1, 4), (2, 64)], ids=["h100", "1sm", "2sm"])
def test_flat_plan_invariants(card, name, affine):
    _check_plan(_SHAPES[name], affine, *card)


@pytest.mark.parametrize("m,n", [(5000, 100), (100, 5000), (4097, 4097), (129, 128)])
def test_flat_plan_runs_a_pair_along_its_shorter_string(m, n):
    """The rows are the shorter string's: a thin pair is one strip whichever
    way it comes, with slots for the longer one's columns."""
    plan = _check_plan([(m, n), (300, 300)], True, *H100)
    assert plan.transposed[0] == (m > n)
    assert plan.strips[0] == -(-min(m, n) // 128)
    assert plan.groups[0].slot_words == sum(
        _slot_words(p, s, True) for p, s in zip([(m, n), (300, 300)], plan.strips))


@pytest.mark.parametrize("cap_pairs", [1, 2, 3, 7])
def test_flat_plan_splits_groups_under_a_cap(cap_pairs):
    """A cap of k pairs' slots makes groups of k pairs, whichever string is
    the longer; pairs of one strip have no slots and never split a group."""
    pairs = [(200, 300)] * 5 + [(300, 200)] * 5 + [(100, 50)] * 3
    per_pair = 8 * 2 * 301  # 200 rows in 2 strips, 300 columns either way
    plan = _check_plan(pairs, False, *H100, cap=cap_pairs * per_pair)
    assert [g.pairs for g in plan.groups[:-1]] == [cap_pairs] * (len(plan.groups) - 1)
    assert sum(g.pairs for g in plan.groups) == len(pairs)
    assert len(plan.groups) == -(-10 // cap_pairs)  # the 1-strip pairs join the last group
    if cap_pairs > 1:  # an affine pair's slots are twice as many
        affine = _check_plan(pairs, True, *H100, cap=cap_pairs * per_pair)
        assert len(affine.groups) == -(-10 // (cap_pairs // 2))


def test_flat_plan_raises_when_one_pair_cannot_be_placed():
    with _capped(8 * 2 * 501):
        with pytest.raises(ValueError, match="exceeds the cap"):
            flat_plan([(300, 500), (300, 1000)], False, *H100)
        with pytest.raises(ValueError, match="exceeds the cap"):
            flat_plan([(500, 300)], True, *H100)
        plan = flat_plan([(500, 300)], False, *H100)
    assert plan.transposed == (True,) and plan.groups[0].slot_words == 1002
    with pytest.raises(ValueError, match="needs pairs"):
        flat_plan([], False, *H100)
    with pytest.raises(ValueError, match="CTA of 4 warps"):
        flat_plan([(10, 10)], False, 132, 3)


def test_flat_plan_at_the_long_reads_and_the_long_pair():
    """The main path's shapes: the long reads' 64 pairs of 5-15 kb in one
    launch of 3 CTAs an SM, their strips more than the card's warps; the
    long pair's 782 strips in one launch of a CTA an SM."""
    rng = np.random.default_rng(0)
    reads = [(int(m), int(n)) for m, n in rng.integers(5000, 15001, (64, 2))]
    plan = _check_plan(reads, True, *H100)
    assert len(plan.groups) == 1 and plan.groups[0].ctas == 132 * FLAT_SHARE == 396
    assert sum(plan.strips) > 132 * 28
    pair = _check_plan([(100_000, 100_000)], False, *H100)
    assert pair.strips == (782,) and pair.groups[0].ctas == 132  # a CTA an SM


# -- a plain emulation of the kernel's order of work --------------------------

_NO_CHAR = -1


def _emulate(chars, a_off, a_len, b_off, b_len, card, cap=None, match=0, mismatch=1, gap=1,
             objective="min", locality="global", table=None, extend=None):
    """``csrc/wavefront.cu``'s flat kernel on numpy, each group's strips in
    claim order, each strip a step at a time over its 32 lanes of R rows:
    what a lane holds, reads by shuffle and stores, as the source writes
    it. A slot read checks its tag."""
    chars = np.asarray(chars, np.int64)
    pairs = list(zip(a_len.tolist(), b_len.tolist()))
    affine, local, mx = extend is not None, locality == "local", objective == "max"
    with _capped(cap):
        plan = flat_plan(pairs, affine, *card)
    R, C = FLAT_ROWS, FLAT_CHUNK
    H = 32 * R
    ext = extend if affine else 0
    opt = np.maximum if mx else np.minimum

    def add_opt(x, y, z, clamp):
        v = opt(x + y, z)
        return opt(v, 0) if clamp else v

    def boundary(k):
        k = np.asarray(k, np.int64)
        if local:
            return np.zeros_like(k)
        if affine:
            return np.where(k > 0, gap + ext * (k - 1), 0)
        return gap * k

    def gap_boundary(k):
        return boundary(k) + gap + ext

    out = np.zeros(len(pairs), np.int64)
    lane = np.arange(32)[:, None]
    q = np.arange(R)[None, :]
    o = lane * R + q  # row offsets in the strip, (32, R)
    imm = (q // 4) * 128 + q % 4  # a row's byte in its lane's profile word
    tab = None if table is None else np.asarray(table, np.int64)
    for g in plan.groups:
        slots = np.zeros(max(g.slot_words, 1), np.int64)
        for p, s in plan.claims[g.first_claim: g.first_claim + g.claims].tolist():
            pair = g.first_pair + p
            m, n = pairs[pair]
            a = chars[a_off[pair]: a_off[pair] + m]
            b = chars[b_off[pair]: b_off[pair] + n]
            cost = tab
            if plan.transposed[pair]:  # the rows are b's: costs table[b][a]
                m, n, a, b = n, m, b, a
                cost = None if tab is None else tab.T
            r0 = s * H + 1
            rows = min(H, m - r0 + 1)
            last = r0 + H > m
            i = r0 + o
            stride = (n + 1) * (2 if affine else 1)
            up = plan.slot_offsets[pair] + ((s + 1) & 1) * stride
            down = plan.slot_offsets[pair] + (s & 1) * stride

            def b_value(j, l):
                j = np.asarray(j)
                ch = np.where((j >= 0) & (j < n), b[np.clip(j, 0, max(n - 1, 0))], _NO_CHAR)
                return np.clip(ch, 0, 31) * H + 4 * l if tab is not None else ch

            D1 = boundary(i)
            D2 = D1.copy()
            I = gap_boundary(i)
            J = I.copy()
            a_row = np.where(o < rows, a[np.clip(i - 1, 0, m - 1)], _NO_CHAR)
            bc = b_value(-o, lane)
            if tab is not None:  # lane l's profile words (k R / 4 + g) * 32 + l, bytes by row
                prof = np.zeros(32 * H, np.int64)
                cls = np.where(o < rows, np.clip(a_row, 0, 31), 0)
                for k in range(32):
                    prof[k * H + 4 * lane + imm] = cost[cls, k]
            x2 = boundary(r0 + lane[:, 0] * R - 1)
            best = 0
            steps = -(-(n + rows - 1) // C) * C
            for tau in range(0, steps, C):
                cols = tau + np.arange(C) + 1
                if s > 0:
                    need = cols <= n
                    words = slots[up + np.where(need, cols, 0)]
                    assert ((words[need] >> 32) == s).all(), "a slot read before its strip wrote it"
                    above_d = ((words & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
                    above_j = 0 * above_d
                    if affine:
                        jw = slots[up + n + 1 + np.where(need, cols, 0)]
                        assert ((jw[need] >> 32) == s).all()
                        above_j = ((jw & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
                else:
                    above_d, above_j = boundary(cols), gap_boundary(cols)
                b_in = b_value(cols, 0)
                inside = rows == H and tau >= H - 1 and tau + C <= n
                for u in range(C):
                    t = tau + u
                    x1 = np.concatenate([[above_d[u]], D1[:-1, R - 1]])
                    y1 = np.concatenate([[above_j[u]], J[:-1, R - 1]])
                    upper = np.concatenate([x1[:, None], D1[:, :-1]], axis=1)
                    diag = np.concatenate([x2[:, None], D2[:, :-1]], axis=1)
                    up_j = np.concatenate([y1[:, None], J[:, :-1]], axis=1)
                    left = D1
                    if tab is not None:
                        sub = prof[bc + imm]
                    else:
                        sub = np.where(a_row == bc, match, mismatch)
                    if affine:
                        i_new = add_opt(left, gap, I + ext, False)
                        j_new = add_opt(upper, gap, up_j + ext, False)
                        v = add_opt(diag, sub, opt(i_new, j_new), local)
                    else:
                        i_new, j_new = I, J
                        v = add_opt(opt(left, upper), gap, diag + sub, local)
                    if not inside:
                        live = (o < rows) & (t - o >= 0) & (t - o < n)
                        v = np.where(live, v, left)
                        i_new = np.where(live, i_new, I)
                        j_new = np.where(live, j_new, J)
                    if local:
                        best = opt(best, int(opt.reduce(v, axis=None)))
                    D2, D1, I, J = left, v, i_new, j_new
                    x2 = x1
                    shifted = np.empty_like(bc)
                    shifted[:, 1:] = bc[:, :-1]
                    shifted[1:, 0] = bc[:-1, R - 1] + (4 if tab is not None else 0)
                    shifted[0, 0] = b_in[u]
                    bc = shifted
                    col = t - H + 2  # the bottom row's column at this step
                    if not last and (inside or 1 <= col <= n):
                        tag = (s + 1) << 32
                        slots[down + col] = tag | (int(D1[31, R - 1]) & 0xFFFFFFFF)
                        if affine:
                            slots[down + n + 1 + col] = tag | (int(J[31, R - 1]) & 0xFFFFFFFF)
            if local:
                out[pair] = opt(out[pair], best)
            elif last:
                out[pair] = D1[(m - r0) // R, (m - r0) % R]
    return out, plan


CONFIGS = list(itertools.product(("min", "max"), ("global", "local"), (False, True),
                                 (False, True)))
_IDS = ["-".join([o, l, "affine" if a else "linear", "classes" if c else "uniform"])
        for o, l, a, c in CONFIGS]


def _batch(rng, shapes, classes):
    parts, cols = [], []
    pos = 0
    hi = 40 if classes else 4
    for m, n in shapes:
        a, b = rng.integers(0, hi, m), rng.integers(0, hi, n)
        k = min(m, n)
        b[:k] = np.where(rng.random(k) < 0.7, a[:k], b[:k])
        parts += [a, b]
        cols.append((pos, m, pos + m, n))
        pos += m + n
    return np.concatenate(parts).astype(np.int32), *np.array(cols, np.int64).T


def _costs(rng, objective, affine, classes, wrong_sign):
    sign = 1 if (objective == "min") != wrong_sign else -1
    kw = dict(objective=objective)
    if affine:
        kw.update(gap=sign * int(rng.integers(2, 6)), extend=sign * int(rng.integers(1, 3)))
    else:
        kw.update(gap=sign * int(rng.integers(1, 4)))
    if classes:
        kw["table"] = rng.integers(-9, 10, (32, 32)).astype(np.int32)
    else:
        kw.update(match=int(rng.integers(-3, 1)) * sign, mismatch=int(rng.integers(1, 4)) * sign)
    return kw


# strips of 128 rows: pairs at the strip edges 127-129 and 255-257, one and
# two strips deep, run as they are and transposed; the card's plan, and one
# SM of 4 warps, which holds fewer strips than the batch has
_EMU_CARDS = {"edges": H100, "one sm": (1, 4)}
_EMU_SHAPES = {"edges": [(1, 1), (127, 130), (128, 100), (129, 300), (257, 260), (20, 150),
                         (300, 129)],
               "one sm": [(255, 300), (256, 2), (257, 260), (513, 600), (40, 300), (300, 257)]}


@pytest.fixture
def one_thread():
    """The plain version's many small torch ops, on one thread: a pool of
    threads per op only contends with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("batch", list(_EMU_SHAPES))
@pytest.mark.parametrize("objective,locality,affine,classes", CONFIGS, ids=_IDS)
def test_emulated_kernel_matches_the_plain_version(objective, locality, affine, classes, batch):
    """The kernel's order of work equals ``wavefront_reference`` at the
    strip edges 127-129 and 255-257 and past two strips, on pairs
    that run as they are and transposed (the shorter string's chars are the
    rows), costs of both signs, every pair in one group and in groups split
    by a cap of the largest pair's slots."""
    rng = np.random.default_rng(CONFIGS.index((objective, locality, affine, classes))
                                + 100 * list(_EMU_SHAPES).index(batch))
    chars, *cols = _batch(rng, _EMU_SHAPES[batch], classes)
    largest = max(8 * _slot_words(p, -(-min(p) // 128), affine) for p in _EMU_SHAPES[batch])
    for wrong_sign, cap in ((False, None), (True, largest)):
        kw = _costs(rng, objective, affine, classes, wrong_sign)
        kw["locality"] = locality
        got, plan = _emulate(chars, *cols, _EMU_CARDS[batch], cap, **kw)
        assert (len(plan.groups) > 1) == (cap is not None)
        want = wavefront_reference(torch.from_numpy(chars), *cols, **kw)
        assert got.tolist() == want.tolist(), (kw, plan.strips)
