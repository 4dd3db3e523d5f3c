"""Tier B of the Myers kernel (``csrc/myers.cu`` ``myers_tier_b``), on the
CPU: the segment width ``ops/myers.py`` ``tier_b_plan`` picks for a block
(8 lanes a candidate, or 32 where 8 would leave the card short of warps),
how a segment places a query (its own words, the run of words a lane) at
the word edges, and a plain emulation of the kernel's order of work (32 /
S candidates a warp in the order of their lengths, each a segment of S
lanes; a lane's run of consecutive words, the carry and the shifts
rippling through it; ballots cut to the segment for the runs' carries and
top bits; candidates frozen past their ends) against the plain version
``myers_reference`` on blocks that mix query lengths across those edges,
in each segment width. Every check is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu_torch.ops.myers import (  # noqa: E402
    TIER_B_SEGMENTS, TIER_B_WIDEN_BELOW, _peq, myers_reference, tier_b_plan, words_of)

_EDGES = [(4, 5), (8, 9), (16, 17), (32, 33), (63, 64)]
_SMS = 132  # an H100's


def _segment(qlen: int, rows: int, seg: int) -> tuple[int, int]:
    """``(words, words a lane)`` that tier B gives a query of ``qlen``
    chars in a block of ``rows`` in segments of ``seg`` lanes, as
    ``myers_tier_b`` computes them: the query's own ``ceil(qlen / 64)``
    words (at least one; ``qlen`` clamped to the block), each lane a run of
    ``ceil(words / seg)`` consecutive words."""
    m = min(max(qlen, 0), 64 * words_of(rows))
    words = max(1, -(-m // 64))
    return words, -(-words // seg)


@pytest.mark.parametrize("below,above", _EDGES, ids=[f"{a}-{b}" for a, b in _EDGES])
def test_segment_at_the_word_edges(below, above):
    """A query of 64 w chars takes w words, one more char w + 1; a lane of
    an S-lane segment runs ceil(w / S) of them."""
    for seg in TIER_B_SEGMENTS:
        for w in (below, above):
            for qlen in (64 * (w - 1) + 1, 64 * w):
                assert _segment(qlen, 4096, seg) == (w, -(-w // seg))
        assert _segment(64 * below + 1, 4096, seg)[0] == above


def test_segment_of_short_and_clamped_queries():
    """An empty query still takes a word; a length past the block's rows
    counts as the block's (the kernel clamps it)."""
    assert _segment(0, 512, 8) == (1, 1)
    assert _segment(1, 512, 8) == (1, 1)
    assert _segment(10_000, 512, 8) == (8, 1)
    assert _segment(10_000, 4096, 8) == (64, 8)
    assert _segment(10_000, 4096, 32) == (64, 2)
    assert _segment(-3, 4096, 32) == (1, 1)
    assert _segment(4032, 4096, 8) == (63, 8)


@pytest.mark.parametrize("below,above", _EDGES, ids=[f"{a}-{b}" for a, b in _EDGES])
def test_plan_at_the_word_edges(below, above):
    """A launch of few warps takes 32 lanes and one of many 8, on either
    side of a word edge; the threshold is the short one up to 8 words."""
    assert TIER_B_SEGMENTS == (8, 32)
    for words in (below, above):
        below_sm = TIER_B_WIDEN_BELOW[words > 8]
        warps = below_sm * _SMS  # an 8-lane launch of 4 candidates a warp
        assert tier_b_plan(words, 1, 4 * warps - 4, _SMS) == 32
        assert tier_b_plan(words, 1, 4 * warps - 3, _SMS) == 8
        assert tier_b_plan(words, warps, 4, _SMS) == 8
        assert tier_b_plan(words, warps - 1, 4, _SMS) == 32


# (block words, queries, candidates, the pick on 132 SMs): phase 4's long
# block, phase 4d's CJK-wide rune block and the engine's own tier-B blocks
# of the long set, each at the width that was fastest or within 3% of it
# in tools/tier_b_probe.py's run (PERF.md)
_PICKS = [(62, 16, 2048, 8), (7, 64, 2048, 8), (64, 9, 1123, 8), (64, 9, 566, 32),
          (64, 9, 253, 32), (64, 9, 106, 32), (32, 5, 1123, 32), (32, 5, 566, 32),
          (32, 5, 253, 32), (32, 5, 106, 32), (8, 2, 1123, 8), (8, 2, 566, 8),
          (8, 2, 253, 32), (8, 2, 106, 32)]


@pytest.mark.parametrize("words,nq,nc,want", _PICKS,
                         ids=[f"{w}w-{q}x{c}" for w, q, c, _ in _PICKS])
def test_plan_at_the_main_path_blocks(words, nq, nc, want):
    assert tier_b_plan(words, nq, nc, _SMS) == want


_MASK = (1 << 64) - 1


def _emulate(q_t, qlens, cands_t, clens, S):
    """``myers_tier_b`` on Python ints: each query's candidates in the
    order of their lengths, 32 / S a warp, each a segment of S lanes, lane l
    holding the run of words lL .. lL + L - 1; a step ripples the carry and
    the shifts through a run and takes the runs' carries and top bits from
    the segment's ballots, as the source writes it."""
    rows, nq = q_t.shape
    cand_len, nc = cands_t.shape
    words = words_of(rows)
    peq = _peq(torch.from_numpy(q_t), torch.from_numpy(qlens), words).numpy()
    order = np.argsort(clens.reshape(-1), kind="stable")
    out = np.zeros((nq, nc), np.int64)
    for q in range(nq):
        m = min(max(int(qlens[q, 0]), 0), 64 * words)
        W, L = _segment(int(qlens[q, 0]), rows, S)
        for slot0 in range(0, nc, 32 // S):
            segs = [order[s] for s in range(slot0, min(slot0 + 32 // S, nc))]
            n = [min(max(int(clens[0, c]), 0), cand_len) for c in segs]
            # a lane's run: vp, vn of words lL + k
            state = [[[[(1 << min(max(m - 64 * (l * L + k), 0), 64)) - 1 for k in range(L)],
                       [0] * L] for l in range(S)] for _ in segs]
            for j in range(max(n)):
                for x, (c, run) in enumerate(zip(segs, state)):
                    ch = int(cands_t[j, c]) if j < n[x] else 0
                    eq = [[int(peq[q, ch, l * L + k]) & _MASK
                           if 0 <= ch < 256 and l * L + k < W else 0 for k in range(L)]
                          for l in range(S)]
                    gen, prop, sums = 0, 0, []
                    for l in range(S):
                        vp, _ = run[l]
                        xs = [((eq[l][k] & vp[k]) + vp[k]) & _MASK for k in range(L)]
                        g = [xs[k] < (eq[l][k] & vp[k]) for k in range(L)]
                        p = [xs[k] == _MASK for k in range(L)]
                        G, P = False, True
                        for k in range(L):
                            G, P = g[k] or (p[k] and G), P and p[k]
                        gen |= G << l
                        prop |= P << l
                        sums.append((xs, g, p))
                    a = gen | prop
                    cin = (a + gen) ^ a ^ gen
                    ph, mh = [], []
                    for l in range(S):
                        vp, vn = run[l]
                        xs, g, p = sums[l]
                        carry = (cin >> l) & 1
                        phl, mhl = [], []
                        for k in range(L):
                            total = (xs[k] + carry) & _MASK
                            carry = g[k] or (p[k] and carry)
                            xh = (total ^ vp[k]) | eq[l][k]
                            phl.append((vn[k] | ~(xh | vp[k])) & _MASK)
                            mhl.append(vp[k] & xh)
                        ph.append(phl)
                        mh.append(mhl)
                    if j >= n[x]:  # past this candidate's end: frozen
                        continue
                    for l in range(S):
                        vp, vn = run[l]
                        ph_in = 1 if l == 0 else ph[l - 1][L - 1] >> 63
                        mh_in = 0 if l == 0 else mh[l - 1][L - 1] >> 63
                        for k in range(L):
                            xv = eq[l][k] | vn[k]
                            phs = ((ph[l][k] << 1) | ph_in) & _MASK
                            mhs = ((mh[l][k] << 1) | mh_in) & _MASK
                            ph_in, mh_in = ph[l][k] >> 63, mh[l][k] >> 63
                            vp[k] = (mhs | ~(xv | phs)) & _MASK
                            vn[k] = phs & xv
            for x, (c, run) in enumerate(zip(segs, state)):
                delta = 0
                for l in range(S):
                    for k in range(L):
                        mask = (1 << min(max(m - 64 * (l * L + k), 0), 64)) - 1
                        delta += bin(run[l][0][k] & mask).count("1")
                        delta -= bin(run[l][1][k] & mask).count("1")
                out[q, c] = n[x] + delta
    return out


def _block(rng, q_lens, c_lens, rows, cand_len):
    q_t = np.full((rows, len(q_lens)), -1, np.int32)
    for i, m in enumerate(q_lens):
        q_t[:m, i] = rng.integers(97, 100, m)
    c_t = np.zeros((cand_len, len(c_lens)), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = rng.integers(97, 100, n)
        if j % 2 == 0:  # a prefix of a query, so distances span small to large
            src = q_t[:, j % len(q_lens)]
            k = min(n, q_lens[j % len(q_lens)])
            c_t[:k, j] = np.where(rng.random(k) < 0.9, src[:k], c_t[:k, j])
    c_t[0, -1] = 300  # a char outside the bytes matches nothing
    return (q_t, np.asarray(q_lens, np.int32).reshape(-1, 1), c_t,
            np.asarray(c_lens, np.int32).reshape(1, -1))


# query lengths at the word edges 4/5, 8/9, 16/17, 32/33, 63/64 (and an
# empty one); candidates of different lengths share each warp
_MIXED = [64 * w + d for w in (4, 8, 16, 32, 63) for d in (0, 1)] + [0, 4096]


@pytest.mark.parametrize("seg", TIER_B_SEGMENTS)
@pytest.mark.parametrize("part", [0, 1, 2])
def test_emulated_tier_b_matches_the_plain_version(part, seg):
    """A 4,096-row block mixing runs of 1 to 8 words a lane, one part of the
    query lengths a test, in segments of ``seg`` lanes, against
    ``myers_reference``."""
    rng = np.random.default_rng(40 + part)
    q_lens = _MIXED[part::3]
    c_lens = [0, 1, 17, 40, 64, 65, 3, 33, 50, 12, 63]
    args = _block(rng, q_lens, c_lens, 4096, 65)
    want = myers_reference(*(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_array_equal(_emulate(*args, seg), want)
