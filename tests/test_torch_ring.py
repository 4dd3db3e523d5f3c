"""The port's ring tier (``stringzilla_tpu_torch/parallel/ring.py``) on CPU
scopes that list the CPU D times, where every tile runs the plain version
``ring_tile_reference``.

Held against the JAX ``ring_wavefront_score`` on the conftest's virtual
CPU mesh (its first D devices) and ``tests/oracles.py``, on the same
numpy-seeded inputs: the cases of ``tests/test_ring.py`` on 8 entries, and
a fixed set over all 16 configurations with D in {1, 2, 3, 8}, m < D, n
under the column block and n not a multiple of it, class ids >= 32, and the
JAX ring's two departures from Gotoh, which the port copies (marked as
differing from the oracle on purpose). Each at column blocks of 64 and the
port's default. Then, with no JAX, hypothesis over shapes, configurations,
entries and blocks: the ring against the port's whole-pair plain DP
(``ops.wavefront.wavefront_reference``) and the oracles, and
``ring_tile_reference`` on random tiles of a pair against a whole-matrix
numpy DP. Tolerance: exact equality."""

import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from stringzilla_tpu.parallel.ring import ring_wavefront_score as jax_ring  # noqa: E402

import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.ops.wavefront import wavefront_reference  # noqa: E402
from stringzilla_tpu_torch.parallel import ring  # noqa: E402
from stringzilla_tpu_torch.parallel.ring import (TileCosts, ring_block_cols,  # noqa: E402
                                                 ring_tile, ring_tile_reference,
                                                 ring_wavefront_score, tile_plan)

from .oracles import levenshtein, score_affine, score_linear  # noqa: E402

BIG = 1 << 28
BLOCKS = [64, None]  # None: the port's default, ring_block_cols


def _scope(d: int):
    return tsz.DeviceScope(devices=["cpu"] * d)


def _mesh(d: int):
    return Mesh(np.asarray(jax.devices()[:d]), axis_names=("data",))


def _oracle(a, b, kw) -> int:
    """``tests/oracles.py`` on the configuration ``kw`` (uniform costs on
    the raw values, or the class table with ids clamped to [0, 31])."""
    table = kw.get("table")
    if table is not None:
        sub = lambda x, y: int(table[min(max(x, 0), 31), min(max(y, 0), 31)])
    else:
        sub = lambda x, y: kw.get("match", 0) if x == y else kw.get("mismatch", 1)
    objective, local = kw.get("objective", "min"), kw.get("locality") == "local"
    a, b = list(np.asarray(bytearray(a) if isinstance(a, bytes) else a)), \
        list(np.asarray(bytearray(b) if isinstance(b, bytes) else b))
    if kw.get("extend") is None:
        return score_linear(a, b, sub, kw.get("gap", 1), objective=objective, local=local)
    return score_affine(a, b, sub, kw.get("gap", 1), kw["extend"], objective=objective,
                        local=local)


def _dna(rng, n, hi=101):
    return bytes(rng.integers(97, hi, int(n)).astype(np.uint8))


def _ring_cases():
    """``{name: (a, b, entries, kwargs, differs_from_oracle)}``: the cases of
    ``tests/test_ring.py`` on 8 entries, then the fixed set."""
    rng = np.random.default_rng(22)
    cases = {}
    for k in range(4):
        cases[f"test_ring levenshtein {k}"] = (
            _dna(rng, rng.integers(1, 500)), _dna(rng, rng.integers(1, 500)), 8, {}, False)
    a, b = _dna(rng, 200), _dna(rng, 333)
    cases["test_ring scores"] = (a, b, 8, dict(match=1, mismatch=-1, gap=-2, objective="max"),
                                 False)
    cases["test_ring edges a a"] = (b"a", b"a", 8, {}, False)
    cases["test_ring edges empty a"] = (b"", b"xyz", 8, {}, False)
    cases["test_ring edges empty b"] = (b"xyz", b"", 8, {}, False)
    a, b = _dna(rng, 180), _dna(rng, 290)
    cases["test_ring affine max"] = (a, b, 8, dict(match=2, mismatch=-1, gap=-4, extend=-1,
                                                   objective="max"), False)
    cases["test_ring affine min"] = (a, b, 8, dict(match=0, mismatch=1, gap=3, extend=1,
                                                   objective="min"), False)
    a, b = _dna(rng, 150), _dna(rng, 260)
    cases["test_ring local linear"] = (a, b, 8, dict(match=2, mismatch=-1, gap=-2,
                                                     objective="max", locality="local"), False)
    cases["test_ring local affine"] = (a, b, 8, dict(match=2, mismatch=-1, gap=-3, extend=-1,
                                                     objective="max", locality="local"), False)
    table = rng.integers(-3, 4, (32, 32)).astype(np.int32)
    np.fill_diagonal(table, 3)
    a, b = rng.integers(0, 32, 170).astype(np.uint8), rng.integers(0, 32, 240).astype(np.uint8)
    cases["test_ring classes linear"] = (a, b, 8, dict(gap=-2, objective="max", table=table),
                                         False)
    cases["test_ring classes affine"] = (a, b, 8, dict(gap=-4, extend=-1, objective="max",
                                                       table=table), False)

    # the fixed set: each of the 16 configurations once, over D in {1, 2, 3, 8}
    dist = rng.integers(0, 5, (32, 32)).astype(np.int32)
    np.fill_diagonal(dist, 0)
    score = rng.integers(-3, 4, (32, 32)).astype(np.int32)
    np.fill_diagonal(score, 3)
    shapes = [(40, 90), (5, 100), (2, 40), (130, 65), (64, 128), (7, 1), (1, 77), (97, 200)]
    for k in range(16):
        is_max, local, affine, classes = k & 8, k & 4, k & 2, k & 1
        entries = (1, 2, 3, 8)[k % 4]
        m, n = shapes[k % len(shapes)]
        kw = dict(objective="max" if is_max else "min", locality="local" if local else "global")
        if is_max:
            kw.update(gap=-4, extend=-1) if affine else kw.update(gap=-2)
        else:
            kw.update(gap=3, extend=1) if affine else kw.update(gap=2)
        if classes:  # ids up to 39: those >= 32 cost as class 31
            kw["table"] = score if is_max else dist
            a = rng.integers(0, 40, m).astype(np.uint8)
            b = rng.integers(0, 40, n).astype(np.uint8)
        else:
            kw.update(match=2, mismatch=-1) if is_max else kw.update(match=0, mismatch=1)
            a, b = _dna(rng, m, 103), _dna(rng, n, 103)
        name = (f"fixed {kw['objective']} {kw['locality']} {'affine' if affine else 'linear'} "
                f"{'classes' if classes else 'uniform'} D={entries} {m}x{n}")
        cases[name] = (a, b, entries, kw, False)
    # the JAX ring's departures from Gotoh, copied: the vertical chain runs
    # on the cell before it (here reopening pays: open < extend under min),
    # and a min-objective local score is 0
    a, b = _dna(rng, 60), _dna(rng, 90)
    cases["quirk affine min open 1 extend 3"] = (
        a, b, 4, dict(match=0, mismatch=4, gap=1, extend=3, objective="min"), True)
    cases["quirk local min match -2"] = (
        a, b, 3, dict(match=-2, mismatch=1, gap=1, objective="min", locality="local"), True)
    return cases


CASES = _ring_cases()


@pytest.fixture(scope="module")
def jax_scores():
    """Each case's JAX ring score and oracle score, made once. Each JAX
    call compiles its own shard_map (2-7 s on the CPU), so four threads
    compile them side by side (XLA compiles outside the GIL)."""
    def one(case):
        a, b, d, kw, _ = case
        return jax_ring(a, b, _mesh(d), **kw), _oracle(a, b, kw)

    with ThreadPoolExecutor(4) as pool:
        return dict(zip(CASES, pool.map(one, CASES.values())))


@pytest.mark.parametrize("block_cols", BLOCKS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax_and_oracles(jax_scores, name, block_cols):
    a, b, d, kw, differs = CASES[name]
    want_jax, want_oracle = jax_scores[name]
    got = ring_wavefront_score(a, b, _scope(d), block_cols=block_cols, **kw)
    assert isinstance(got, int)
    assert got == want_jax
    if differs:  # on purpose: the JAX ring's answer, not Gotoh's
        assert want_jax != want_oracle
    else:
        assert got == want_oracle


def test_ring_quirks_are_the_jax_rings():
    """The two departures: affine min with open < extend depends on where
    the rows are cut (the chain restarts from D at each entry's first
    row), as in the JAX ring; local min is 0 whatever the costs."""
    a, b, _, kw, _ = CASES["quirk affine min open 1 extend 3"]
    exact = _oracle(a, b, kw)
    assert ring_wavefront_score(a, b, _scope(1), **kw) != exact
    a, b, _, kw, _ = CASES["quirk local min match -2"]
    assert _oracle(a, b, kw) < 0
    assert ring_wavefront_score(a, b, _scope(5), **kw) == 0


def test_ring_inputs():
    """Bytes, numpy arrays and integer tensors give one score; a tensor
    stays on its device; the empty rules are the JAX ones."""
    rng = np.random.default_rng(3)
    a, b = _dna(rng, 70), _dna(rng, 45)
    want = levenshtein(a, b)
    sc = _scope(3)
    arr = lambda s: np.frombuffer(s, np.uint8)
    assert ring_wavefront_score(arr(a), arr(b), sc) == want
    assert ring_wavefront_score(torch.from_numpy(arr(a).astype(np.int64)),
                                torch.from_numpy(arr(b).astype(np.int32)), sc) == want
    assert ring_wavefront_score(b"", b"", sc) == 0
    assert ring_wavefront_score(b"ab", b"", sc, gap=3, extend=1) == 3 + 1
    assert ring_wavefront_score(b"", b"abc", sc, locality="local", objective="max") == 0
    with pytest.raises(ValueError):
        ring_wavefront_score(a, b, sc, objective="best")
    with pytest.raises(ValueError):
        ring_wavefront_score(a, b, sc, block_cols=0)
    with pytest.raises(TypeError):
        ring_wavefront_score(torch.ones(3), b, sc)


def test_block_cols_and_tile_plan():
    """The default block: a multiple of 128, the whole pair on one entry,
    a 600,000-char pair in 4 blocks on 4 entries; the plan's grid: the
    claims in flight, capped, and past one CTA an SM a whole number of
    them an SM."""
    assert ring_block_cols(600_000, 600_000, 4) == 150_016
    assert -(-600_000 // ring_block_cols(600_000, 600_000, 4)) == 4
    assert ring_block_cols(1000, 900, 1) == 1024
    for m, n, d in [(1, 1, 8), (5, 100, 8), (300, 7, 2), (10**6, 3, 3)]:
        c = ring_block_cols(m, n, d)
        assert c % 128 == 0 and c >= 128
    R, W, C = ring.GEOMETRY
    h = 32 * R
    claim = W * h  # the rows a CTA claims at once
    assert tile_plan(claim, 50, 132) == 1
    assert tile_plan(claim + 1, 50, 132) == 2
    assert tile_plan(600_000, 600_000, 132) == 132 * ring.RING_SHARE  # capped
    # claims in flight: one starts every W (h + C) steps and is busy for
    # (W - 1)(h + C) + w + h; past 132 rounded to a whole number of CTAs an SM
    busy = (W - 1) * (h + C) + 150_016 + h
    in_flight = -(-busy // (W * (h + C))) + 1
    assert in_flight > 132
    assert tile_plan(150_000, 150_016, 132) == 2 * 132
    assert ring._claims_plan(150_000, 150_016, 132, R, W, C, 1) == 132
    assert tile_plan(300_000, 300_032, 132) == 3 * 132
    assert tile_plan(150_000, 1_000, 132) == -(-((W - 1) * (h + C) + 1000 + h) // (W * (h + C))) + 1
    for rows, w in [(1, 1), (5_000, 3), (10 ** 6, 10 ** 6), (150_000, 40_000)]:
        ctas = tile_plan(rows, w, 132)
        assert 1 <= ctas <= 132 * ring.RING_SHARE
        assert ctas <= min(-(-rows // claim), 132) or ctas % 132 == 0
    # another geometry: strips of 256 rows, one CTA an SM in flight
    assert ring._claims_plan(150_000, 150_016, 132, 8, 4, 16, ring.RING_SHARE) == 132


def test_ring_tile_checks_its_tensors():
    z = lambda k: torch.zeros(k, dtype=torch.int32)
    costs = TileCosts("min", "global", 1, None, 0, 1, None)
    args = [z(4), z(3), z(4), z(4), z(4), z(4), z(4), z(4), z(1)]
    ring_tile(*args, costs)
    bad = list(args)
    bad[2] = z(3)  # top_d must hold w + 1
    with pytest.raises(ValueError):
        ring_tile(*bad, costs)
    bad = list(args)
    bad[6] = z(3)  # left_d a value a row
    with pytest.raises(ValueError):
        ring_tile(*bad, costs)
    bad = list(args)
    bad[0] = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        ring_tile(*bad, costs)
    with pytest.raises(ValueError):
        ring_tile(*args, costs._replace(table=torch.zeros((32, 32), dtype=torch.int64)))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 4096, 5000])
def test_running_scan_in_two_levels(n):
    """``_running`` equals ``torch.cummin``/``cummax`` at the row width's
    edges, one row and several, padded or not."""
    x = torch.from_numpy(np.random.default_rng(n).integers(-10**6, 10**6, n).astype(np.int32))
    assert ring.SCAN_WIDTH == 1024
    assert torch.equal(ring._running(x, True), torch.cummin(x, 0).values)
    assert torch.equal(ring._running(x, False), torch.cummax(x, 0).values)


class _LargestStorage(TorchDispatchMode):
    """Records the largest storage, in bytes, that any op returns."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.bytes = max(self.bytes, t.untyped_storage().nbytes())
        return out


@pytest.mark.parametrize("config", [0, 11])
def test_tile_reference_memory_is_linear(config):
    """The plain tile makes each column's costs in its step: on a tile of
    3,000 x 2,000 cells (as one tile and as a ring over 2 entries) no op
    returns more than 128 bytes a row or column (the class table's 32
    costs of each row), where a matrix of the tile's costs would take 24
    MB. The tile is the whole pair, so its corner is the pair's score."""
    rng = np.random.default_rng(config)
    m, n = 3000, 2000
    classes, affine = config & 1, config & 2
    kw = dict(objective="max" if config & 8 else "min", locality="global",
              gap=-5 if config & 8 else 1)
    if affine:
        kw["extend"] = -1
    if classes:
        kw["table"] = rng.integers(-3, 4, (32, 32)).astype(np.int32)
    else:
        kw.update(match=0, mismatch=1)
    a, b = rng.integers(0, 40 if classes else 4, m), rng.integers(0, 40 if classes else 4, n)
    flat = dict(kw)
    if classes:
        flat["table"] = torch.from_numpy(kw["table"])
    chars = torch.from_numpy(np.concatenate([a, b]).astype(np.int32))
    want = int(wavefront_reference(chars, [0], [m], [m], [n], **flat)[0])
    _, r = ring._ring_plan(a, b, _scope(1), kw.get("match", 0), kw.get("mismatch", 1),
                           kw["gap"], kw["objective"], kw["locality"], kw.get("table"),
                           kw.get("extend"), None)
    e = r.entries[0]
    assert r.blocks == [(0, n)]
    args = [e.a, r.b[e.device], e.top[0].clone(), e.top[1].clone(),
            torch.zeros(n + 1, dtype=torch.int32), torch.zeros(n + 1, dtype=torch.int32),
            e.left0[0].clone(), e.left0[1].clone(), torch.zeros(1, dtype=torch.int32)]
    cap = 128 * (m + n + 1)
    with _LargestStorage() as seen:
        ring_tile_reference(*args, e.costs)
    assert seen.bytes <= cap < 4 * m * n
    assert int(args[4][n]) == int(args[6][m - 1]) == want
    with _LargestStorage() as seen:
        got = ring_wavefront_score(a, b, _scope(2), block_cols=700, **kw)
    assert seen.bytes <= cap
    assert got == want


# -- no JAX: the ring against the port's whole-pair DP, and tiles against a
# -- whole-matrix numpy DP, in the configurations where the ring is Gotoh's

def _exact_config(draw):
    """A configuration where the ring is exact (Gotoh's): reopening never
    pays, and local alignment is max-objective."""
    is_max = draw(st.booleans())
    local = is_max and draw(st.booleans())
    affine = draw(st.booleans())
    classes = draw(st.booleans())
    sign = 1 if is_max else -1  # max scores penalise gaps, min distances charge them
    kw = dict(objective="max" if is_max else "min", locality="local" if local else "global")
    if affine:
        ext = draw(st.integers(0, 3))
        open_ = ext + draw(st.integers(0, 4))  # |open| >= |extend|
        kw.update(gap=-sign * open_, extend=-sign * ext)
    else:
        kw["gap"] = -sign * draw(st.integers(0, 4))
    if classes:
        seed = draw(st.integers(0, 2**16))
        t = np.random.default_rng(seed).integers(-3, 4, (32, 32)).astype(np.int32)
        kw["table"] = t if is_max else np.abs(t)
    else:
        kw.update(match=sign * draw(st.integers(0, 2)), mismatch=-sign * draw(st.integers(0, 3)))
    return kw


def _chars_for(draw, length, classes):
    hi = 40 if classes else 4
    return np.asarray(draw(st.lists(st.integers(0, hi), min_size=length, max_size=length)),
                      np.int32)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_ring_against_whole_pair_dp(data):
    draw = data.draw
    kw = _exact_config(draw)
    m, n = draw(st.integers(1, 36)), draw(st.integers(1, 36))
    a, b = _chars_for(draw, m, "table" in kw), _chars_for(draw, n, "table" in kw)
    entries = draw(st.integers(1, 6))
    block = draw(st.one_of(st.none(), st.integers(1, 40)))
    got = ring_wavefront_score(a, b, _scope(entries), block_cols=block, **kw)
    chars = torch.from_numpy(np.concatenate([a, b]))
    flat = dict(kw)
    if flat.get("table") is not None:
        flat["table"] = torch.from_numpy(flat["table"])
    want = int(wavefront_reference(chars, [0], [m], [m], [n], **flat)[0])
    assert got == want == _oracle(a, b, kw)


def _matrices(a, b, kw):
    """The whole DP of ``(a, b)`` as the ring's tiles see it: D, E (the
    horizontal gap) and F (the vertical one), ``(m + 1, n + 1)`` int64,
    with the ring's borders in row 0 and column 0."""
    is_max = kw["objective"] == "max"
    opt = max if is_max else min
    local = kw["locality"] == "local"
    affine = kw.get("extend") is not None
    gap = kw["gap"]
    ext = kw["extend"] if affine else gap
    m, n = len(a), len(b)

    def border(k):
        if local or k == 0:
            return 0
        return gap + ext * (k - 1) if affine else gap * k

    def gap_border(k):
        return (-BIG if is_max else BIG) // 2 if local else border(k) + gap + ext

    table = kw.get("table")
    D, E, F = (np.zeros((m + 1, n + 1), np.int64) for _ in range(3))
    for k in range(n + 1):
        D[0, k], F[0, k], E[0, k] = border(k), gap_border(k), gap_border(k)
    for i in range(1, m + 1):
        D[i, 0], E[i, 0], F[i, 0] = border(i), gap_border(i), gap_border(i)
        for j in range(1, n + 1):
            if table is not None:
                sub = int(table[min(max(a[i - 1], 0), 31), min(max(b[j - 1], 0), 31)])
            else:
                sub = kw["match"] if a[i - 1] == b[j - 1] else kw["mismatch"]
            if affine:
                E[i, j] = opt(E[i, j - 1] + ext, D[i, j - 1] + gap)
                F[i, j] = opt(F[i - 1, j] + ext, D[i - 1, j] + gap)
            else:
                E[i, j], F[i, j] = D[i, j - 1] + gap, D[i - 1, j] + gap
            cell = opt(D[i - 1, j - 1] + sub, opt(E[i, j], F[i, j]))
            D[i, j] = opt(cell, 0) if local else cell
    return D, E, F


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_tile_reference_on_random_tiles(data):
    """A tile of rows ``i0 + 1 .. i0 + rows`` and columns ``c0 + 1 .. c0 +
    w`` fed the whole DP's row ``i0`` and column ``c0`` gives its last row,
    its last column and, for local max, its best cell."""
    draw = data.draw
    kw = _exact_config(draw)
    m, n = draw(st.integers(1, 24)), draw(st.integers(1, 24))
    a, b = _chars_for(draw, m, "table" in kw), _chars_for(draw, n, "table" in kw)
    D, E, F = _matrices(a, b, kw)
    i0 = draw(st.integers(0, m - 1))
    rows = draw(st.integers(1, m - i0))
    c0 = draw(st.integers(0, n - 1))
    w = draw(st.integers(1, n - c0))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    top_d, top_f = t(D[i0, c0: c0 + w + 1]), t(F[i0, c0: c0 + w + 1])
    left_d, left_e = t(D[i0 + 1: i0 + rows + 1, c0]), t(E[i0 + 1: i0 + rows + 1, c0])
    bottom_d, bottom_f = torch.zeros(w + 1, dtype=torch.int32), torch.zeros(w + 1, dtype=torch.int32)
    best = torch.zeros(1, dtype=torch.int32)
    table = kw.get("table")
    costs = TileCosts(kw["objective"], kw["locality"], kw["gap"], kw.get("extend"),
                      kw.get("match", 0), kw.get("mismatch", 1),
                      None if table is None else torch.from_numpy(table))
    ring_tile_reference(t(a[i0: i0 + rows]), t(b[c0: c0 + w]), top_d, top_f, bottom_d, bottom_f,
                        left_d, left_e, best, costs)
    rr, cc = slice(i0 + 1, i0 + rows + 1), slice(c0 + 1, c0 + w + 1)
    np.testing.assert_array_equal(bottom_d[1:].numpy(), D[i0 + rows, cc])
    np.testing.assert_array_equal(left_d.numpy(), D[rr, c0 + w])
    if kw.get("extend") is not None:
        np.testing.assert_array_equal(bottom_f[1:].numpy(), F[i0 + rows, cc])
        np.testing.assert_array_equal(left_e.numpy(), E[rr, c0 + w])
    want_best = max(0, int(D[rr, cc].max())) if kw["locality"] == "local" else 0
    assert int(best[0]) == want_best


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_ring_does_not_depend_on_entries_or_blocks(data):
    """In every configuration, quirks included, the score is the same for
    any column block; outside the affine quirk, for any count of entries
    too."""
    draw = data.draw
    k = draw(st.integers(0, 15))
    kw = dict(objective="max" if k & 8 else "min", locality="local" if k & 4 else "global",
              gap=draw(st.integers(-4, 4)))
    if k & 2:
        kw["extend"] = draw(st.integers(-4, 4))
    if k & 1:
        kw["table"] = np.random.default_rng(k).integers(-4, 5, (32, 32)).astype(np.int32)
    else:
        kw.update(match=draw(st.integers(-2, 2)), mismatch=draw(st.integers(-3, 3)))
    m, n = draw(st.integers(1, 30)), draw(st.integers(1, 30))
    a, b = _chars_for(draw, m, k & 1), _chars_for(draw, n, k & 1)
    entries = draw(st.integers(1, 5))
    scores = {ring_wavefront_score(a, b, _scope(entries), block_cols=blk, **kw)
              for blk in (None, 1, draw(st.integers(2, 31)))}
    assert len(scores) == 1
    reopen = "extend" in kw and (kw["gap"] < kw["extend"] if kw["objective"] == "min"
                                 else kw["gap"] > kw["extend"])
    if not reopen:
        assert ring_wavefront_score(a, b, _scope(draw(st.integers(1, 5))), **kw) in scores


# -- a numpy model of csrc/ring.cu's order of work ----------------------------------

RING_CU = Path(ring.__file__).resolve().parent.parent / "csrc" / "ring.cu"


def _ring_constant(name: str) -> int:
    """A ``constexpr int`` of ``csrc/ring.cu``, read from its source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", RING_CU.read_text()).group(1))


def test_geometry_mirrors_the_kernel_source():
    """``GEOMETRY`` is ``csrc/ring.cu``'s rows a lane, warps a CTA and
    chunk (the card checks it at first launch; this checks it here)."""
    assert ring.GEOMETRY == tuple(_ring_constant(k) for k in
                                  ("kRingRows", "kRingWarps", "kRingChunk"))


def _strip_model(s, warp, claim, rows, w, a, b, left_d, left_e, top_d, top_f, costs, flags,
                 rings, slots, out, S):
    """Strip ``s`` of ``csrc/ring.cu`` run by warp ``warp`` of a CTA, in
    numpy: a generator that yields, before each chunk that waits on another
    warp of its CTA, the test of that wait on the shared ``flags``, so that
    the CTA's warps run as the flags let them. The 32 lanes of the warp are
    rows of arrays, each holding R rows of the strip; the row above through
    the lane before (D0, D and F when affine) or, for lane 0, a slot a step
    of the ring above: warp 0 stages the top row (strip 0) or the slots of
    the claim before, tagged with its first strip's number and checked on
    every read, a chunk at a time; warp i > 0 reads warp i - 1's ring,
    column c in slot (c - 1) mod S (S columns a ring), once warp i - 1 has
    published it (and publishes what it has taken, which bounds how far
    warp i - 1 may write ahead). Warp 0 of a claim after the first waits
    until the slots of its chunk carry its tag. Rows past the tile copy the row above. Lane 31's last row goes
    to the warp's ring each step; the claim's last strip writes the ring
    out a chunk at a time: slots tagged with its number + 1 by the claim's
    parity, or the tile's bottom row. b's chars, or with classes the byte
    offsets of the lane's class profile, move as a shift register down the
    lanes."""
    R, W, C = ring.GEOMETRY
    H = 32 * R
    is_max, local = costs.objective == "max", costs.locality == "local"
    affine, classes = costs.extend is not None, costs.table is not None
    opt = np.maximum if is_max else np.minimum
    gap, ext = costs.gap, costs.extend
    strips = -(-rows // H)
    r0 = s * H
    n_rows = min(H, rows - r0)
    last = s == strips - 1
    hands_on = not last and warp < W - 1
    lanes = np.arange(32)
    o = lanes[:, None] * R + np.arange(R)[None, :]  # row offsets, (32, R)
    real = o < n_rows
    i = np.minimum(r0 + o, rows - 1)
    D1 = np.where(real, left_d[i], 0)
    D2 = D1.copy()
    I = np.where(real, left_e[i], 0) if affine else None
    F, U = np.zeros_like(D1), np.zeros_like(D1)
    ach = np.where(real, np.asarray(a)[i], -1)
    prof = None
    if classes:  # fill_profile: byte x of word (k R/4 + g) 32 + l
        t = costs.table.numpy()
        cls = np.where(real, np.clip(np.asarray(a)[i], 0, 31), 0)
        prof = np.zeros(32 * 32 * R, np.int64)
        for k in range(32):
            for q in range(R):
                word = (k * (R // 4) + q // 4) * 32 + lanes
                prof[4 * word + q % 4] = t[cls[:, q], k]

    def b_value(j, lane):
        ch = int(b[j]) if 0 <= j < w else -1
        return int(np.clip(ch, 0, 31)) * H + 4 * lane if classes else ch

    bc = np.array([[b_value(-(l * R + q), l) for q in range(R)] for l in range(32)])
    above, below = rings[warp], rings[warp + 1]  # [S, 3]: D0, D, F of a column
    arrays = 3 if affine else 1
    steps = -(-(w + H - 1) // C) * C
    best = 0
    for tau in range(0, steps, C):
        hi = tau + C - H + 1  # the last column of the bottom row this chunk writes
        if warp > 0:
            if tau > 0:
                flags["used"][warp - 1] = tau
            need = min(tau + C, w)
            yield lambda need=need: flags["done"][warp - 1] >= need
        else:  # stage columns tau + 1 .. tau + C (and column 0 first)
            cols = ([0] if tau == 0 else []) + list(range(tau + 1, min(tau + C, w) + 1))
            parity = (claim + 1) & 1
            if s > 0:  # column 0: D alone
                yield lambda cols=cols: all(
                    (parity, k) in slots and slots[(parity, k)][0][col] == s
                    for col in cols for k in range(arrays) if col > 0 or k == arrays // 2)
            for col in cols:
                if s == 0:
                    above[(col - 1) % S] = (top_d[col], top_d[col], top_f[col])
                    continue
                got = [slots[(parity, k)][1][col] for k in range(arrays)]
                above[(col - 1) % S] = got * 3 if not affine else got
        if hands_on:
            yield lambda hi=hi: flags["used"][warp] >= hi - S
        if tau == 0:
            x2 = np.concatenate([[above[S - 1][1]], D1[:-1, R - 1]])
        for u in range(C):
            t = tau + u
            ab = above[t % S]
            x1 = np.concatenate([[ab[0] if affine else ab[1]], (U if affine else D1)[:-1, R - 1]])
            xd, y1 = x1, None
            if affine:
                xd = np.concatenate([[ab[1]], D1[:-1, R - 1]])
                y1 = np.concatenate([[ab[2]], F[:-1, R - 1]])
            for q in range(R - 1, -1, -1):
                left = D1[:, q].copy()
                diag = D2[:, q - 1] if q > 0 else x2
                if classes:
                    sub = prof[bc[:, q] + (q // 4) * 128 + q % 4]
                else:
                    sub = np.where(ach[:, q] == bc[:, q], costs.match, costs.mismatch)
                live = real[:, q] & (t - o[:, q] >= 0) & (t - o[:, q] < w)
                if affine:
                    upper = U[:, q - 1] if q > 0 else x1
                    up_f = F[:, q - 1] if q > 0 else y1
                    up_d = D1[:, q - 1] if q > 0 else xd
                    i_new = opt(left + gap, I[:, q] + ext)
                    f_new = opt(upper + gap, up_f + ext)
                    d0 = opt(diag + sub, i_new)
                    d0 = opt(d0, 0) if local else d0
                    v = opt(d0, f_new)
                    v = np.where(live, v, np.where(real[:, q], left, up_d))
                    I[:, q] = np.where(live, i_new, I[:, q])
                    F[:, q] = np.where(live, f_new, np.where(real[:, q], F[:, q], up_f))
                    U[:, q] = np.where(live, d0, np.where(real[:, q], U[:, q], upper))
                else:
                    upper = D1[:, q - 1] if q > 0 else x1
                    v = opt(opt(left, upper) + gap, diag + sub)
                    v = opt(v, 0) if local else v
                    v = np.where(live, v, np.where(real[:, q], left, upper))
                if local and is_max and live.any():
                    best = max(best, int(v[live].max()))
                D2[:, q] = left
                D1[:, q] = v
            x2 = xd
            b_in = b_value(t + 1, 0)
            shifted = bc[:-1, R - 1] + (4 if classes else 0)
            bc[:, 1:] = bc[:, :-1].copy()
            bc[:, 0] = np.concatenate([[b_in], shifted])
            below[(t - H + 1) % S] = (U[31, R - 1], D1[31, R - 1], F[31, R - 1])
        if hands_on:
            flags["done"][warp] = hi
        else:  # the chunk's columns out
            for col in range(max(hi - C + 1, 0), min(hi, w) + 1):
                value = below[(col - 1) % S]
                if not last:
                    for k in range(arrays):
                        slot = slots.setdefault((claim & 1, k), (np.zeros(w + 1, np.int64),
                                                                 np.zeros(w + 1, np.int64)))
                        slot[0][col], slot[1][col] = s + 1, value[k if affine else 1]
                elif col > 0:
                    out["bottom_d"][col], out["bottom_f"][col] = value[1], value[2]
    for q in range(R):
        for lane in range(32):
            if real[lane, q]:
                left_d[r0 + o[lane, q]] = D1[lane, q]
                if affine:
                    left_e[r0 + o[lane, q]] = I[lane, q]
    out["best"] = max(out["best"], best)  # atomicMax


def _kernel_model(a, b, top_d, top_f, left_d, left_e, best, costs: TileCosts, span=None,
                  ctas=2, greedy=False):
    """``ring_tile`` as ``csrc/ring.cu`` computes it, in numpy, on a grid of
    ``ctas`` CTAs that take the claims of W strips in order, each the next
    one once its claim is done (a claim waits only on the slots of the one
    before). The warps of the running claims run as their waits let them
    (``_strip_model``): each a chunk a turn, or with ``greedy`` each until
    it waits. A CTA keeps its rings of ``span`` columns (``kRingSpan`` of
    ``csrc/ring.cu`` unless given) from one claim to the next. Returns
    ``(bottom_d, bottom_f, left_d, left_e, best)``."""
    R, W, C = ring.GEOMETRY
    H, S = 32 * R, span or _ring_constant("kRingSpan")
    rows, w = len(a), len(b)
    left_d, left_e = left_d.astype(np.int64), left_e.astype(np.int64)
    out = {"bottom_d": np.zeros(w + 1, np.int64), "bottom_f": np.zeros(w + 1, np.int64),
           "best": int(best[0])}
    slots = {}  # (parity, row of slots) -> (tags, values) over columns 0..w
    strips = -(-rows // H)
    claims = -(-strips // W)
    rings = [[np.zeros((S, 3), np.int64) for _ in range(W + 1)] for _ in range(ctas)]
    running = {}  # CTA -> {warp: [strip generator, its wait]}
    taken = 0
    while True:
        for cta in range(ctas):
            if cta not in running and taken < claims:
                flags = {"done": [-(2 ** 31)] * W, "used": [-1] * W}
                running[cta] = {k: [_strip_model(taken * W + k, k, taken, rows, w, a, b, left_d,
                                                 left_e, top_d, top_f, costs, flags, rings[cta],
                                                 slots, out, S), None]
                                for k in range(W) if taken * W + k < strips}
                taken += 1
        if not running:
            break
        moved = False
        for cta, warps in list(running.items()):
            for k in list(warps):
                gen, wait = warps[k]
                while wait is None or wait():
                    moved = True
                    try:
                        wait = warps[k][1] = next(gen)
                    except StopIteration:
                        del warps[k]
                        break
                    if not greedy:
                        break
            if not warps:
                del running[cta]
        assert moved, f"claims {taken - len(running)}..{taken - 1}: every warp waits"
    return out["bottom_d"], out["bottom_f"], left_d, left_e, out["best"]


def _model_shapes():
    """(rows, w): one row; a strip (H rows) less one, whole and plus one at
    w under, at and over a chunk; a CTA's claim of W strips and one more; a
    ragged last lane."""
    R, W, C = ring.GEOMETRY
    H = 32 * R
    return [(1, 1), (H - 1, C - 1), (H, C), (H + 1, C + 1), (W * H + 1, C), (H + 44, 47)]


def _model_against_reference(config, rows, w, **model):
    """The kernel model (``_kernel_model`` with ``model``) against
    ``ring_tile_reference`` on a random ``rows`` x ``w`` tile of
    ``config``, all four outputs and the best cell exact."""
    rng = np.random.default_rng(1000 + 7 * config + rows)
    is_max, local, affine, classes = config & 8, config & 4, config & 2, config & 1
    table = None
    if classes:
        table = torch.from_numpy(rng.integers(-4, 5, (32, 32)).astype(np.int32))
    costs = TileCosts("max" if is_max else "min", "local" if local else "global",
                      int(rng.integers(-3, 4)), int(rng.integers(-3, 4)) if affine else None,
                      int(rng.integers(-2, 3)), int(rng.integers(-2, 3)), table)
    hi = 40 if classes else 4
    t = lambda x: torch.from_numpy(np.asarray(x, np.int32))
    args = [t(rng.integers(0, hi, rows)), t(rng.integers(0, hi, w)),
            t(rng.integers(-99, 99, w + 1)), t(rng.integers(-99, 99, w + 1)),
            t(np.zeros(w + 1)), t(np.zeros(w + 1)), t(rng.integers(-99, 99, rows)),
            t(rng.integers(-99, 99, rows)), t([7])]
    got = _kernel_model(*(x.numpy() for x in args[:4]), args[6].numpy(), args[7].numpy(),
                        args[8].numpy(), costs, **model)
    ring_tile_reference(*args, costs)
    np.testing.assert_array_equal(got[0][1:], args[4][1:].numpy())
    np.testing.assert_array_equal(got[2], args[6].numpy())
    if affine:
        np.testing.assert_array_equal(got[1][1:], args[5][1:].numpy())
        np.testing.assert_array_equal(got[3], args[7].numpy())
    assert got[4] == int(args[8][0])


@pytest.mark.parametrize("shape", _model_shapes())
@pytest.mark.parametrize("config", range(16))
def test_kernel_model_matches_tile_reference(config, shape):
    """The model of ``csrc/ring.cu`` (strips of 32 R rows, lanes of R, a
    CTA's warps handing on through rings in shared memory under their
    flags, tagged slots written a chunk at a time between claims, slot 0,
    rows past the tile copying the row above, the profile) against
    ``ring_tile_reference`` on random frontiers, on two CTAs whose claims
    overlap: a change to the kernel's order of work changes the model with
    it."""
    _model_against_reference(config, *shape)


@pytest.mark.parametrize("span,greedy", [(None, True), (2 * ring.RING_CHUNK, False)])
@pytest.mark.parametrize("config", [0, 3, 9, 14])
def test_kernel_model_reuses_rings_and_slots(config, span, greedy):
    """A tile of four claims (each parity of slots written twice, while the
    next claim still reads the other) and more columns than a ring and a
    chunk, so that every ring wraps and its writer waits on its reader:
    under the kernel's ring of ``kRingSpan`` columns with each warp run
    until it waits, and under the smallest ring (two chunks) with the
    warps a chunk a turn. Three CTAs take the claims, so that a CTA takes
    a claim beside the two before it, its rings holding the old claim's
    columns."""
    R, W, C = ring.GEOMETRY
    S = span or _ring_constant("kRingSpan")
    _model_against_reference(config, 3 * W * 32 * R + 1, S + C + 1, span=span, ctas=3,
                             greedy=greedy)
