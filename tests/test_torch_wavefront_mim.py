"""The port's meet-in-the-middle tier (``ops/wavefront.py``:
``wavefront_score_mim``, ``sweep_frontier`` and the stage function
``stage_batch``/``stage_reference`` on CPU tensors, which run the plain
PyTorch version) against the JAX package's ``wavefront_score_mim`` and
``_sweep_frontier`` (Pallas interpreter on the CPU), the port's flat tier and
``tests/oracles.py``, on the same numpy-seeded inputs. Tolerance: exact
equality — frontiers are int32 cells, scores integers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu.ops.wavefront_pallas import _sweep_frontier as jax_sweep  # noqa: E402
from stringzilla_tpu.ops.wavefront_pallas import wavefront_score_mim as jax_mim  # noqa: E402
from stringzilla_tpu_torch.ops import wavefront as wf  # noqa: E402
from stringzilla_tpu_torch.ops.wavefront import (  # noqa: E402
    BIG, initial_state, ladder, stage_batch, stage_reference, sweep_frontier,
    wavefront_score, wavefront_score_mim)

from . import oracles  # noqa: E402

COSTS = [(0, 1, 1), (0, 3, 2), (-1, 1, 1)]


def _rng(seed):
    """A generator of this file's own, so the session ``rng`` that other
    files share stays as it is."""
    return np.random.default_rng(seed)


def _pair(rng, m, n, alphabet=4):
    """``b`` copies ``a`` at about 70% of its positions, so scores run from
    small to large."""
    a = rng.integers(0, alphabet, m).astype(np.int32)
    b = rng.integers(0, alphabet, n).astype(np.int32)
    k = min(m, n)
    b[:k] = np.where(rng.random(k) < 0.7, a[:k], b[:k])
    return a, b


# m, n, n_stages, costs, d_end (None: the middle diagonal, as the MIM asks)
_SWEEPS = [
    (4, 9, 4, (0, 1, 1), None), (9, 4, 7, (-1, 1, 1), None),
    (300, 280, 4, (0, 1, 1), None), (280, 300, 7, (0, 3, 2), None),
    (50, 50, 1, (-1, 1, 1), None), (700, 700, 2, (0, 3, 2), None),
    (1100, 900, 4, (0, 1, 1), None),  # m > d_end: the JAX frontier is short
    (1025, 900, 2, (0, 3, 2), None),
    (30, 20, 4, (0, 1, 1), 2),  # a first stage of zero steps
    (20, 30, 4, (0, 3, 2), 3), (5, 5, 1, (-1, 1, 1), 2),
]


@pytest.mark.parametrize("m,n,n_stages,costs,d_end", _SWEEPS,
                         ids=[f"{m}x{n}-s{s}-{'_'.join(map(str, c))}-d{d}"
                              for m, n, s, c, d in _SWEEPS])
def test_sweep_frontier_matches_jax(m, n, n_stages, costs, d_end):
    """Both frontiers, cell for cell; past a short JAX frontier every cell
    is BIG (those cells have i > d_end, outside the matrix's diagonal)."""
    a, b = _pair(_rng(m * 1000 + n), m, n)
    d_end = (m + n) // 2 if d_end is None else d_end
    want = jax_sweep(a, b, m, n, d_end, *costs, n_stages)
    got = sweep_frontier(a, b, m, n, d_end, *costs, n_stages, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == np.int32 and g.shape == (m + 1,)
        np.testing.assert_array_equal(g[: len(w)], w)
        assert (g[len(w):] == BIG).all()


def test_score_matches_jax_and_levenshtein():
    """``tests/test_wavefront.py``'s MIM draws and degenerate shapes."""
    rng = _rng(11)
    for _ in range(6):
        m, n = int(rng.integers(4, 300)), int(rng.integers(4, 300))
        a = rng.integers(97, 101, m).astype(np.uint8)
        b = rng.integers(97, 101, n).astype(np.uint8)
        got = wavefront_score_mim(a, b, device="cpu")
        assert got == jax_mim(a, b) == oracles.levenshtein(bytes(a), bytes(b))
        got = wavefront_score_mim(a, b, match=0, mismatch=3, gap=2, device="cpu")
        assert got == jax_mim(a, b, match=0, mismatch=3, gap=2)
        assert got == oracles.levenshtein(bytes(a), bytes(b), 0, 3, 2)
    empty = np.zeros(0, np.uint8)
    for x, y in [(empty, b), (a, empty), (empty, empty), (a[:1], b[:1]), (a[:1], b[:2]),
                 (a[:2], b[:1]), (a[:2], b[:2])]:
        for costs in COSTS:
            assert wavefront_score_mim(x, y, *costs, device="cpu") == jax_mim(x, y, *costs)


@pytest.mark.parametrize("costs", COSTS, ids=["_".join(map(str, c)) for c in COSTS])
def test_score_equals_the_flat_tier(costs):
    rng = _rng(12)
    for m, n in [(3, 40), (40, 3), (130, 129), (257, 500)]:
        a, b = _pair(rng, m, n)
        for n_stages in (1, 3, 8):
            assert (wavefront_score_mim(a, b, *costs, n_stages, device="cpu")
                    == wavefront_score(a, b, *costs, device="cpu"))


@pytest.mark.parametrize("m,n", [(1100, 900), (1024, 1000), (1025, 900)])
def test_exact_where_the_jax_function_raises(m, n):
    """The JAX ``_sweep_frontier`` returns a frontier shorter than m + 1
    when m > d_end, and its combine fails to broadcast; the port keeps
    m + 1 cells and gives the exact distance (ROADMAP queue 3)."""
    a, b = _pair(_rng(m + n), m, n)
    got = wavefront_score_mim(a, b, device="cpu")
    assert got == oracles.levenshtein(bytes(a.astype(np.uint8)), bytes(b.astype(np.uint8)))
    assert got == wavefront_score(a, b, device="cpu")
    with pytest.raises(ValueError, match="broadcast"):
        jax_mim(a, b)


@pytest.mark.parametrize("costs", COSTS, ids=["_".join(map(str, c)) for c in COSTS])
def test_stages_one_at_a_time_equal_one_piece(costs):
    """A ladder run a stage at a time, each from the state the last one
    carried, ends where the plain stage run in one piece does; a stage of
    zero steps returns its input."""
    match, mismatch, gap = costs
    a, b = (torch.from_numpy(x) for x in _pair(_rng(13), 90, 140))
    d_end = 115
    whole = stage_reference([(a, b, *initial_state(90, gap, "cpu"), 2, d_end + 1)], *costs)[0]
    for n_stages in (1, 2, 5, 8):
        state = initial_state(90, gap, "cpu")
        for d0, d1 in ladder(d_end, n_stages):
            state = stage_batch([(a, b, *state, d0, d1)], *costs)[0]
        assert all(torch.equal(x, y) for x, y in zip(state, whole))
    same = stage_batch([(a, b, *whole, d_end + 1, d_end + 1)], *costs)[0]
    assert all(torch.equal(x, y) for x, y in zip(same, whole))
    # two sweeps in one call, as the kernel takes them, each on its own
    back = (a.flip(0).contiguous(), b.flip(0).contiguous(), *initial_state(90, gap, "cpu"), 2, 7)
    two = stage_batch([(a, b, *initial_state(90, gap, "cpu"), 2, 9), back], *costs)
    assert all(torch.equal(x, y) for x, y in zip(two[1], stage_reference([back], *costs)[0]))


def test_ladder_cuts_the_jax_stages():
    assert ladder(2, 4) == [(2, 2), (2, 3)]  # a first stage of zero steps
    assert ladder(1000, 4) == [(2, 251), (251, 501), (501, 751), (751, 1001)]
    assert ladder(3, 8) == [(2, 2), (2, 3), (3, 4)]
    assert ladder(7, 1) == [(2, 8)]


def test_no_hidden_cpu_route(monkeypatch):
    """Without a card, no ``device`` raises before any work; the plain
    stage is never reached."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*args):
        raise AssertionError("the plain stage ran")

    monkeypatch.setattr(wf, "_stage_plain", refuse)
    a, b = _pair(_rng(14), 40, 50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wavefront_score_mim(a, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_frontier(a, b, 40, 50, 45, 0, 1, 1)


def test_cpu_tensors_launch_nothing():
    before = dict(wf.KERNEL_LAUNCHES)
    a, b = _pair(_rng(15), 60, 70)
    assert wavefront_score_mim(a, b, device="cpu") == wavefront_score(a, b, device="cpu")
    assert wf.KERNEL_LAUNCHES == before


def test_bad_inputs_raise():
    a = torch.zeros(5, dtype=torch.int32)
    b = torch.zeros(6, dtype=torch.int32)
    d1, d2 = initial_state(5, 1, "cpu")
    with pytest.raises(TypeError):
        stage_batch([(a.long(), b, d1, d2, 2, 3)])
    with pytest.raises(ValueError, match="len"):
        stage_batch([(a, b, d1[:5], d2, 2, 3)])
    with pytest.raises(ValueError, match="d0"):
        stage_batch([(a, b, d1, d2, 1, 3)])
    with pytest.raises(ValueError, match="d0"):
        stage_batch([(a, b, d1, d2, 4, 3)])
    with pytest.raises(ValueError, match="d0"):
        stage_batch([(a, b, d1, d2, 2, 13)])
    with pytest.raises(ValueError, match="one or two"):
        stage_batch([(a, b, d1, d2, 2, 3)] * 3)
    with pytest.raises(ValueError, match="contiguous"):
        stage_batch([(torch.zeros(10, dtype=torch.int32)[::2], b, d1, d2, 2, 3)])
    with pytest.raises(ValueError, match="m, n"):
        sweep_frontier(a.numpy(), b.numpy(), 6, 6, 4, 0, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="past"):
        sweep_frontier(a.numpy(), b.numpy(), 5, 6, 12, 0, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="d_end"):
        ladder(0)
