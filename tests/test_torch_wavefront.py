"""The port's long-pair tier (``ops/wavefront.py``: ``wavefront_score``,
``wavefront_batch``, ``levenshtein_long_pair`` and ``band_batch`` on CPU
tensors, which run the plain PyTorch versions, and those versions
themselves) against the JAX package's ``wavefront_score`` and
``levenshtein_long_pair`` (Pallas interpreter on the CPU) and the DP
oracles of ``tests/oracles.py``, on the same numpy-seeded inputs, in all 16
configurations of the flat tier; and the band kernel's plan
(``band_plan``), pure arithmetic. Tolerance: exact equality — every result
is an integer score."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu.ops.wavefront_pallas import levenshtein_long_pair as jax_band  # noqa: E402
from stringzilla_tpu.ops.wavefront_pallas import wavefront_score as jax_score  # noqa: E402
from stringzilla_tpu_torch.ops import wavefront as wf  # noqa: E402
from stringzilla_tpu_torch.ops.wavefront import (  # noqa: E402
    BAND_CHUNK, BAND_RING, BAND_ROWS, BAND_WARPS, band_batch, band_plan,
    band_reference, levenshtein_batch, levenshtein_long_pair, wavefront_batch,
    wavefront_reference, wavefront_score)

from . import oracles  # noqa: E402


def _rng(seed=7):
    """A generator of this file's own, so the session ``rng`` that other
    files share stays as it is."""
    return np.random.default_rng(seed)


def _score(a, b, **kw):
    return wavefront_score(a, b, device="cpu", **kw)


CONFIGS = list(itertools.product(("min", "max"), ("global", "local"),
                                 (False, True), (False, True)))
_IDS = ["-".join([o, l, "affine" if a else "linear", "classes" if c else "uniform"])
        for o, l, a, c in CONFIGS]


def _costs(rng, objective, affine, classes, wrong_sign):
    """Gaps of the usual sign for the objective or of the wrong one (they
    reach the JAX kernel's boundaries unclamped); a random int8 table."""
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


def _pair(rng, m, n, classes):
    """Class ids up to 39 (ids >= 32 clamp to 31) or raw chars over four
    letters; b is a mutated copy of a half the time, so scores span a wide
    range."""
    hi = 40 if classes else 4
    a = rng.integers(0, hi, m).astype(np.uint8)
    b = rng.integers(0, hi, n).astype(np.uint8)
    if rng.random() < 0.5:
        k = min(m, n)
        b[:k] = np.where(rng.random(k) < 0.85, a[:k], b[:k])
    return a, b


@pytest.mark.parametrize("objective,locality,affine,classes", CONFIGS, ids=_IDS)
def test_wavefront_matches_jax(objective, locality, affine, classes):
    """Pairs of 1-300 chars, m != n both ways, wrong-sign gaps on every
    other pair; one batch of all of them equals the pairs one by one."""
    rng = _rng(CONFIGS.index((objective, locality, affine, classes)))
    shapes = [(1, 1), (1, 37), (40, 1), (300, 129), (97, 300), (64, 65)]
    pairs, kws = [], []
    for k, (m, n) in enumerate(shapes):
        kw = _costs(rng, objective, affine, classes, wrong_sign=k % 2 == 1)
        kw["locality"] = locality
        a, b = _pair(rng, m, n, classes)
        got = _score(a, b, **kw)
        assert got == jax_score(a, b, **kw), (m, n, kw)
        pairs.append((a, b))
        kws.append((kw, got))
    # the last pair's costs for a batch of every pair
    kw, _ = kws[-1]
    chars = torch.from_numpy(np.concatenate([x for p in pairs for x in p]).astype(np.int32))
    lens = np.array([len(x) for p in pairs for x in p])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    batch = wavefront_batch(chars, offs[0::2], lens[0::2], offs[1::2], lens[1::2], **kw)
    assert batch.dtype == torch.int32 and batch.shape == (len(pairs),)
    assert batch.tolist() == [_score(a, b, **kw) for a, b in pairs]


_STRIP_EDGES = [(m, n) for m in (1, 31, 32, 33, 63, 64, 65) for n in (1, 2, 100)] + [(700, 3)]


@pytest.fixture
def one_thread():
    """The plain version's many small torch ops, on one thread: a pool of
    threads per op only contends with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("objective,locality,affine,classes", CONFIGS, ids=_IDS)
def test_wavefront_at_strip_edges_matches_jax(objective, locality, affine, classes):
    """Lengths at the flat kernel's strip and lane edges (m of 1, 31-33 and
    63-65 rows against n of 1, 2 and 100 columns) and a thin 700 x 3 pair,
    costs of both signs, each pair alone and the batch of all of them."""
    rng = _rng(1000 + CONFIGS.index((objective, locality, affine, classes)))
    for wrong_sign in (False, True):
        kw = _costs(rng, objective, affine, classes, wrong_sign)
        kw["locality"] = locality
        pairs = [_pair(rng, m, n, classes) for m, n in _STRIP_EDGES]
        want = [jax_score(a, b, **kw) for a, b in pairs]
        assert [_score(a, b, **kw) for a, b in pairs] == want, kw
        chars = torch.from_numpy(np.concatenate([x for p in pairs for x in p]).astype(np.int32))
        lens = np.array([len(x) for p in pairs for x in p])
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        batch = wavefront_batch(chars, offs[0::2], lens[0::2], offs[1::2], lens[1::2], **kw)
        assert batch.tolist() == want, kw


@pytest.mark.parametrize("locality,affine,classes", list(itertools.product(
    ("global", "local"), (False, True), (False, True))))
def test_wavefront_matches_oracles(locality, affine, classes):
    """Max objective (NW and SW) against the textbook linear and Gotoh DPs
    of ``tests/oracles.py``, gaps of the usual sign."""
    rng = _rng(11)
    table = rng.integers(-6, 9, (32, 32)).astype(np.int32)
    for m, n in [(1, 9), (33, 70), (90, 61)]:
        a, b = _pair(rng, m, n, classes)
        if classes:
            sub = lambda x, y: int(table[min(x, 31), min(y, 31)])
            kw = dict(table=table)
        else:
            sub = lambda x, y: 2 if x == y else -1
            kw = dict(match=2, mismatch=-1)
        local = locality == "local"
        if affine:
            want = oracles.score_affine(a.tobytes(), b.tobytes(), sub, -4, -1, "max", local)
            kw.update(gap=-4, extend=-1)
        else:
            want = oracles.score_linear(a.tobytes(), b.tobytes(), sub, -2, "max", local)
            kw.update(gap=-2)
        assert _score(a, b, objective="max", locality=locality, **kw) == want


@pytest.mark.parametrize("m,n", [(31, 31), (32, 64), (33, 65), (63, 1), (1, 63),
                                 (65, 128), (129, 31)])
def test_unit_costs_at_tile_edges_match_levenshtein(m, n):
    """Lengths at the kernel's 32 x 64 tile edges, T - 1, T and T + 1."""
    rng = _rng(m * 1000 + n)
    a, b = _pair(rng, m, n, classes=False)
    want = oracles.levenshtein(a.tobytes(), b.tobytes())
    assert _score(a, b) == want == jax_score(a, b)


@pytest.mark.parametrize("locality,affine", list(itertools.product(
    ("global", "local"), (False, True))))
def test_empty_strings_follow_the_jax_rules(locality, affine):
    kw = dict(gap=-3, extend=-2 if affine else None, objective="max", locality=locality)
    empty, x = np.zeros(0, np.uint8), np.arange(5, dtype=np.uint8)
    for a, b in [(empty, empty), (empty, x), (x, empty)]:
        assert _score(a, b, **kw) == jax_score(a, b, **kw)
    # a batch with empty pairs between live ones
    chars = torch.from_numpy(np.concatenate([x, x]).astype(np.int32))
    got = wavefront_batch(chars, [0, 0, 5, 0], [5, 0, 5, 3], [5, 0, 0, 5], [0, 0, 5, 5], **kw)
    assert got.tolist() == [_score(x, empty, **kw), 0, _score(x, x, **kw),
                            _score(x[:3], x, **kw)]


def test_class_ids_from_32_clamp_to_31():
    """The JAX kernel clips class ids to [0, 31]: ids 32-255 cost as class
    31 here (the column DP gives them 0; each port copies its own kernel)."""
    table = np.zeros((32, 32), np.int32)
    table[31, 31] = 7
    table[31, 5] = -4
    a = np.array([40, 200, 31, 255], np.uint8)
    b = np.array([32, 5, 99, 31], np.uint8)
    kw = dict(gap=-1, objective="max", table=table)
    want = oracles.score_linear(a.tobytes(), b.tobytes(),
                                lambda x, y: int(table[min(x, 31), min(y, 31)]), -1)
    assert _score(a, b, **kw) == jax_score(a, b, **kw) == want
    rng = _rng(3)
    a, b = rng.integers(0, 256, 150).astype(np.uint8), rng.integers(0, 256, 90).astype(np.uint8)
    table = rng.integers(-5, 6, (32, 32)).astype(np.int32)
    for extend in (None, -1):
        kw = dict(gap=-3, extend=extend, objective="max", locality="local", table=table)
        assert _score(a, b, **kw) == jax_score(a, b, **kw)


def test_limits_and_bad_inputs():
    """The JAX package's ValueErrors: above MAX_FLAT_CELLS diagonal cells
    and for class costs outside int8; malformed arguments raise too."""
    big = np.zeros(wf.MAX_FLAT_CELLS, np.uint8)
    with pytest.raises(ValueError, match="too long"):
        _score(big, np.zeros(3, np.uint8))  # m + 1 cells
    with pytest.raises(ValueError, match="too long"):
        _score(np.zeros(3, np.uint8), np.zeros(wf.MAX_FLAT_CELLS + 1, np.uint8))
    assert _score(big, np.zeros(0, np.uint8), gap=2) == 2 * wf.MAX_FLAT_CELLS
    table = np.zeros((32, 32), np.int32)
    table[3, 4] = 128
    with pytest.raises(ValueError, match="int8"):
        _score(np.zeros(3, np.uint8), np.zeros(3, np.uint8), table=table)
    with pytest.raises(ValueError, match="int8"):
        _score(np.zeros(3, np.uint8), np.zeros(3, np.uint8), table=-table - 2)
    with pytest.raises(ValueError, match=r"\(32, 32\)"):
        _score(np.zeros(3, np.uint8), np.zeros(3, np.uint8), table=np.zeros((16, 16)))
    chars = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        wavefront_batch(chars.long(), [0], [3], [3], [3])
    with pytest.raises(ValueError, match="outside"):
        wavefront_batch(chars, [0], [3], [8], [3])
    with pytest.raises(ValueError):
        wavefront_batch(chars, [0], [3], [3], [3], objective="best")


def test_cpu_tensors_launch_nothing():
    before = dict(wf.KERNEL_LAUNCHES)
    chars = torch.arange(40, dtype=torch.int32) % 3
    pairs = (chars, [0, 10], [10, 30], [10, 0], [30, 10])
    assert torch.equal(wavefront_batch(*pairs), wavefront_reference(*pairs))
    assert torch.equal(band_batch(*pairs), band_reference(*pairs))
    assert wf.KERNEL_LAUNCHES == before


def _near(rng, m, edits, alphabet=4):
    """A random string of ``m`` chars and a copy with ``edits`` flips,
    deletions and insertions."""
    a = rng.integers(0, alphabet, m).astype(np.uint8)
    b = list(a)
    for _ in range(edits):
        at, kind = int(rng.integers(0, len(b))), int(rng.integers(0, 3))
        if kind == 0:
            b[at] = (b[at] + 1) % alphabet
        elif kind == 1 and len(b) > 1:
            del b[at]
        else:
            b.insert(at, int(rng.integers(0, alphabet)))
    return a, np.array(b, np.uint8)


def _wagner_fischer(a, b) -> int:
    """Row-at-a-time Wagner-Fischer in numpy: the in-row dependency is a
    running minimum of ``x[j] - j``, plus ``j``."""
    j = np.arange(len(b) + 1, dtype=np.int64)
    prev = j.copy()
    for i in range(1, len(a) + 1):
        x = np.empty_like(prev)
        x[0] = i
        x[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(x - j) + j
    return int(prev[-1])


_BAND_CASES = [  # m, edits (None: an unrelated b of n chars), n, k0
    (1, None, 1, 64), (1, None, 50, 64), (60, None, 1, 2), (300, 5, None, 4),
    (250, None, 180, 2), (120, 40, None, 3), (400, 90, None, 64), (900, 12, None, 64),
    # 1,500-2,600 chars, where the JAX band kernel would run (held against
    # Wagner-Fischer only: the interpreter takes ~45 s a pair there)
    (1800, 20, None, 64), (2400, 400, None, 2), (2000, None, 1900, 64),
]


@pytest.mark.parametrize("m,edits,n,k0", _BAND_CASES,
                         ids=[f"{m}-{e}-{n}-k{k}" for m, e, n, k in _BAND_CASES])
def test_band_matches_jax_and_levenshtein(m, edits, n, k0):
    """Near-duplicates and unrelated pairs, tiny first rungs (several rungs,
    aborts and the priced jump), m != n both ways and m or n = 1. Up to
    1,024 diagonal cells the JAX function answers through its flat kernel;
    the engine tests reach its band kernel."""
    rng = _rng(m + 7 * (n or 0) + k0)
    if edits is None:
        a, b = rng.integers(0, 4, m).astype(np.uint8), rng.integers(0, 4, n).astype(np.uint8)
    else:
        a, b = _near(rng, m, edits)
    want = _wagner_fischer(a, b)
    assert levenshtein_long_pair(a, b, k0, device="cpu") == want
    if max(len(a) + 1, len(b)) <= 1024:
        assert jax_band(a, b, k0) == want == oracles.levenshtein(a.tobytes(), b.tobytes())


def _band_cells(m, n, k):
    """Cells (i, j) of the matrix with |i - j| <= k in rows 1..m."""
    i, j = np.meshgrid(np.arange(m + 1), np.arange(n + 1), indexing="ij")
    return int(((np.abs(i - j) <= k) & (i >= 1)).sum())


def test_band_reports_its_rungs():
    """Status, last rung and cells walked: a near-duplicate certifies on its
    first rung having walked the whole band; an unrelated pair stops its
    rungs early and reports status 2 at ``BAND_KMAX``; |m - n| over
    ``BAND_KMAX`` walks nothing; an empty string certifies m + n."""
    rng = _rng(5)
    a, b = _near(rng, 700, 6)
    # no char in common: the distance is max(m, n) = 2200 > BAND_KMAX
    far_a = rng.integers(0, 2, 2200).astype(np.uint8)
    far_b = rng.integers(2, 4, 2150).astype(np.uint8)
    wide = rng.integers(0, 4, 2100).astype(np.uint8)
    strings = [a, b, far_a, far_b, wide, wide[:3]]
    chars = torch.from_numpy(np.concatenate(strings).astype(np.int32))
    lens = np.array([len(x) for x in strings])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    got = band_batch(chars, offs[[0, 2, 4, 1]], lens[[0, 2, 4, 1]],
                     offs[[1, 3, 5, 1]], [lens[1], lens[3], lens[5], 0], k0=64)
    d = oracles.levenshtein(a.tobytes(), b.tobytes())
    assert got[0].tolist() == [d, 1, 64, _band_cells(len(a), len(b), 64)]
    res, status, k, cells = got[1].tolist()
    assert (res, status, k) == (0, 2, wf.BAND_KMAX)
    assert 0 < cells < _band_cells(2200, 2150, 64) + _band_cells(2200, 2150, wf.BAND_KMAX)
    assert got[2].tolist() == [0, 2, wf.BAND_KMAX, 0]
    assert got[3].tolist() == [len(b), 1, 0, 0]
    # the flat tier answers what the band does not certify
    dist = levenshtein_batch(chars, offs[[0, 2, 4]], lens[[0, 2, 4]], offs[[1, 3, 5]],
                             lens[[1, 3, 5]])
    assert dist.dtype == torch.int32
    assert dist.tolist() == [d, 2200, len(wide) - 3]


def test_band_batch_equals_pairs_one_by_one(monkeypatch):
    """A batch of pairs with their own ladders gives each pair's own
    result, and ``levenshtein_batch`` sends only the uncertified pairs to
    the flat tier."""
    rng = _rng(9)
    pairs = [_near(rng, 150, 3), _near(rng, 90, 30), _near(rng, 40, 0),
             (rng.integers(0, 4, 70).astype(np.uint8), rng.integers(0, 4, 20).astype(np.uint8)),
             (rng.integers(0, 4, 2060).astype(np.uint8), rng.integers(0, 4, 5).astype(np.uint8))]
    strings = [x for p in pairs for x in p]
    chars = torch.from_numpy(np.concatenate(strings).astype(np.int32))
    lens = np.array([len(x) for x in strings])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = (offs[0::2], lens[0::2], offs[1::2], lens[1::2])
    batch = band_batch(chars, *cols, k0=4)
    for p, (a, b) in enumerate(pairs):
        one = torch.from_numpy(np.concatenate([a, b]).astype(np.int32))
        assert batch[p].tolist() == band_batch(one, [0], [len(a)], [len(a)], [len(b)], 4)[0].tolist()
    flat_pairs = []
    real = wf.wavefront_batch
    monkeypatch.setattr(wf, "wavefront_batch",
                        lambda c, *cols, **kw: flat_pairs.append(len(cols[0])) or real(c, *cols, **kw))
    dist = levenshtein_batch(chars, *cols, k0=4)
    assert dist.tolist() == [oracles.levenshtein(a.tobytes(), b.tobytes()) for a, b in pairs]
    assert batch[:, 1].tolist() == [1, 1, 1, 1, 2]  # |m - n| > BAND_KMAX
    assert flat_pairs == [1]


# -- the band kernel's plan ----------------------------------------------------

def _strip_steps(m, n, k):
    """The most steps any strip of 32 * R rows runs on a rung of
    half-width ``k``: its last row's last band column, from its first."""
    h = 32 * BAND_ROWS
    r0 = np.arange(0, m, h) + 1
    i_last = np.minimum(m, r0 + h - 1)
    return int((np.minimum(n, i_last + k) - np.maximum(0, r0 - k) + (i_last - r0) + 1).max())


def _check_circle(plan, pairs, kmax):
    """The circle of ``plan.warps`` warps covers every pair's strips at the
    widest band: where warps take several strips each, none waits for a
    warp (strips trail by 2 h - 1 steps and a chunk once the band has left
    column 0), and the rings hold no cycle of waits (strip s finishes
    before strip s + W starts: each strip runs ahead of the one below by
    h - 2 steps and the ring's slack past a chunk each side)."""
    h = 32 * plan.rows_per_lane
    for m, n in pairs:
        if -(-m // h) > plan.warps:
            steps = _strip_steps(m, n, kmax)
            assert plan.warps * (2 * h - 1 + BAND_CHUNK) >= steps
            assert plan.warps * (h + BAND_RING - BAND_CHUNK) - BAND_CHUNK >= steps


_PLAN_PAIRS = {
    "long pair": [(100_000, 100_000)],
    "64 of 20,000": [(20_000, 20_000)] * 64,
    "mixed": [(1, 1), (5000, 4800), (100, 1100), (4097, 4100), (300, 250), (2, 1)],
    "n >> m": [(200, 1150), (33, 2000), (1056, 2000)],
    "strip edges": [(32 * BAND_ROWS * q + e, 32 * BAND_ROWS * q + e + 3)
                    for q in (1, 3) for e in (-1, 0, 1)],
}
_CARDS = [(132, 64), (132, 16), (132, 48), (2, 16), (1, 16), (1, 64)]


@pytest.mark.parametrize("kmax", [wf.BAND_KMAX, 300])
@pytest.mark.parametrize("shape", list(_PLAN_PAIRS))
@pytest.mark.parametrize("sms,warps_per_sm", _CARDS, ids=[f"{s}sm-{w}" for s, w in _CARDS])
def test_band_plan_invariants(sms, warps_per_sm, shape, kmax):
    """What the kernel relies on: each pair's CTAs are one contiguous group
    of ``group_ctas``; the card holds every CTA at once; the circle of W
    warps covers the strips in flight, so strip ``s`` is done before strip
    ``s + W``'s input can arrive, at the widest band the ladder reaches;
    the hand-off buffer holds the groups' states and two sets of rings; as
    many groups as the card holds, at most one a pair. A card that cannot
    hold one circle is refused."""
    pairs = _PLAN_PAIRS[shape]
    ctas = -(-max(wf.band_warps(m, n, kmax) for m, n in pairs) // BAND_WARPS)
    fits = sms * (warps_per_sm // BAND_WARPS) // ctas
    if not fits:
        with pytest.raises(ValueError):
            band_plan(pairs, sms, warps_per_sm, kmax)
        return
    plan = band_plan(pairs, sms, warps_per_sm, kmax)
    assert (plan.rows_per_lane, plan.chunk, plan.warps_per_cta, plan.ring) == (
        BAND_ROWS, BAND_CHUNK, BAND_WARPS, BAND_RING)
    assert plan.group_ctas == ctas and plan.warps == plan.group_ctas * BAND_WARPS
    assert plan.ctas == plan.groups * plan.group_ctas  # group g: CTAs g * C .. g * C + C - 1
    assert plan.groups == min(len(pairs), fits)
    assert plan.ctas <= sms * (warps_per_sm // BAND_WARPS)
    assert plan.ctas_per_sm == -(-plan.ctas // sms)
    _check_circle(plan, pairs, kmax)
    assert plan.handoff_bytes == plan.groups * 64 + 2 * plan.ctas * (BAND_RING + 1) * 8
    assert plan.record() == [BAND_ROWS, BAND_CHUNK, BAND_WARPS, plan.group_ctas, plan.groups,
                             BAND_RING, plan.handoff_bytes]


def test_band_plan_on_one_sm_and_refusals():
    """A card cut to one SM of 64 warps still holds the longest pair's
    circle (the pairs then in turns); a card that cannot hold one circle,
    no pairs or no SM are refused."""
    plan = band_plan([(100_000, 100_000)] * 3, 1, 64)
    assert (plan.rows_per_lane, plan.group_ctas, plan.groups, plan.ctas) == (BAND_ROWS, 10, 1, 10)
    small = band_plan([(97, 100)] * 5, 1, 4)
    assert (small.group_ctas, small.groups, small.warps) == (1, 1, 4)
    with pytest.raises(ValueError):
        band_plan([(100_000, 100_000)], 1, 16)
    with pytest.raises(ValueError):
        band_plan([], 132, 64)
    with pytest.raises(ValueError):
        band_plan([(1000, 1000)], 0, 64)


_EDGES = [(q, e) for q in (1, 3) for e in (-1, 0, 1)]


@pytest.mark.parametrize("strips,edge", _EDGES, ids=[f"q{q}{e:+d}" for q, e in _EDGES])
def test_band_reference_at_strip_edges(strips, edge):
    """The plain band version at m = 32 R q + e, the shapes phase 3c runs
    on the card, against the JAX ``levenshtein_long_pair`` and
    Wagner-Fischer: a first rung of 64 certifies having walked the whole
    band; one of 2 climbs a ladder to the same distance."""
    m = 32 * BAND_ROWS * strips + edge
    a, b = _near(_rng(m), m, max(1, m // 50))
    cols = (torch.from_numpy(np.concatenate([a, b]).astype(np.int32)), [0], [m], [m], [len(b)])
    want = oracles.levenshtein(a.tobytes(), b.tobytes())
    assert want == jax_band(a, b, 64) == _wagner_fischer(a, b)
    assert band_reference(*cols).tolist() == [[want, 1, 64, _band_cells(m, len(b), 64)]]
    res, status, k, _ = band_reference(*cols, k0=2)[0].tolist()
    assert (res, status) == (want, 1) and k >= want


def test_band_batch_on_cpu_launches_nothing(monkeypatch):
    """On CPU tensors ``band_batch`` runs the plain version: no plan, no
    launch, nothing counted, even for pairs that would take a circle of
    many CTAs and several rungs on the card."""
    def refuse(*args, **kw):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(wf, "_band_launch", refuse)
    monkeypatch.setattr(wf, "band_plan", refuse)
    monkeypatch.setattr(wf, "band_card", refuse)
    before = dict(wf.KERNEL_LAUNCHES)
    rng = _rng(11)
    pairs = [_near(rng, 1500, 40), _near(rng, 97, 2), _near(rng, 64, 30)]
    strings = [x for p in pairs for x in p]
    chars = torch.from_numpy(np.concatenate(strings).astype(np.int32))
    lens = np.array([len(x) for x in strings])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = (chars, offs[0::2], lens[0::2], offs[1::2], lens[1::2])
    got = band_batch(*cols, k0=2)
    assert torch.equal(got, band_reference(*cols, k0=2))
    assert got[:, 0].tolist() == [oracles.levenshtein(a.tobytes(), b.tobytes()) for a, b in pairs]
    assert wf.KERNEL_LAUNCHES == before
