"""The port's column DP (``similarity`` on CPU tensors, which runs its plain
PyTorch version, and ``similarity_reference`` itself) against the JAX
package's ``score_block`` and ``similarity_pallas`` (Pallas interpreter on
the CPU), on the same numpy-seeded inputs, in all 16 configurations.
Tolerance: exact equality — every result is an integer score."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops import similarity as jsim  # noqa: E402
from stringzilla_tpu.ops.similarity_pallas import similarity_pallas  # noqa: E402
from stringzilla_tpu_torch.ops import similarity as tsim  # noqa: E402
from stringzilla_tpu_torch.ops import similarity_dp as dp_mod  # noqa: E402
from stringzilla_tpu_torch.ops.similarity import (  # noqa: E402
    config_from, score_block, similarity_reference)
from stringzilla_tpu_torch.ops.similarity_dp import similarity  # noqa: E402

from . import oracles  # noqa: E402


def _rng():
    """A generator of this file's own: the tests draw the same data in any
    order and leave the session ``rng``, which other files share, as it is."""
    return np.random.default_rng(42)

# Costs of the usual sign for the objective, and of the wrong one: the
# engines take any costs in [-128, 127], and row 0's boundary then differs
# from textbook Gotoh.
_GAPS = {("min", False): 2, ("max", False): -3, ("min", True): (-3, -1),
         ("max", True): (5, 2)}
_WRONG_GAPS = {("min", False): -1, ("max", False): 2, ("min", True): (3, 1),
               ("max", True): (-6, -1)}


def _jax_config(objective, locality, affine, classes, table, wrong_sign=False):
    g = (_WRONG_GAPS if wrong_sign else _GAPS)[objective, affine]
    gaps = jsim.AffineGaps(*g) if affine else jsim.LinearGaps(g)
    costs = (jsim.ClassCosts.from_arrays(np.arange(256) % 64, table) if classes
             else jsim.UniformCosts(-1, 2) if objective == "min"
             else jsim.UniformCosts(3, -2))
    return jsim.SimilarityConfig(objective, locality, gaps, costs)


def _inputs(rng, classes, rows=24, cand_len=16, nc=128):
    """``similarity_pallas`` layouts: query lengths 0 and rows - 1 among
    them, candidate lengths 0, 1 and cand_len; class ids up to 39 (ids >= 32
    cost 0), raw chars with negative values."""
    lo, hi = (0, 40) if classes else (-1, 4)
    q_lens = [0, rows - 1, int(rng.integers(1, rows - 1))]
    q_t = np.zeros((rows, len(q_lens)), np.int32)
    for i, m in enumerate(q_lens):
        q_t[1: m + 1, i] = rng.integers(lo, hi, m)
    c_lens = np.concatenate([[0, 1, cand_len], rng.integers(0, cand_len + 1, nc - 3)])
    c_t = np.zeros((cand_len, nc), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = rng.integers(lo, hi, n)
        if j % 4 == 0:  # a near-copy of a query, so scores span a wide range
            src = q_t[1: q_lens[1] + 1, 1][:n]
            c_t[: len(src), j] = np.where(rng.random(len(src)) > 0.2, src, c_t[: len(src), j])
    return (q_t, np.asarray(q_lens, np.int32).reshape(-1, 1), c_t,
            np.asarray(c_lens, np.int32).reshape(1, -1))


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CONFIGS = list(itertools.product(("min", "max"), ("global", "local"),
                                 (False, True), (False, True)))


@pytest.mark.parametrize(
    "objective,locality,affine,classes", CONFIGS,
    ids=["-".join([o, l, "affine" if a else "linear", "classes" if c else "uniform"])
         for o, l, a, c in CONFIGS])
def test_similarity_matches_jax(objective, locality, affine, classes):
    rng = _rng()
    table = rng.integers(-6, 7, (32, 32)).astype(np.int32)
    jcfg = _jax_config(objective, locality, affine, classes, table,
                       wrong_sign=bool(rng.integers(0, 2)))
    cfg = config_from(jcfg)
    arrays = _inputs(rng, classes)
    t_table = torch.from_numpy(table) if classes else None

    got = similarity(*_torch(arrays), cfg, t_table).numpy()
    plain = similarity_reference(*_torch(arrays), cfg, t_table).numpy()
    want = np.asarray(similarity_pallas(
        *(jnp.asarray(a) for a in arrays), jcfg,
        table=jnp.asarray(table) if classes else None))
    q_t, qlens, c_t, clens = arrays
    block = np.stack([np.asarray(jsim.score_block(
        jnp.asarray(q_t[:, i: i + 1]), jnp.int32(qlens[i, 0]), jnp.asarray(c_t),
        jnp.asarray(clens), jcfg, table=jnp.asarray(table) if classes else None))[0]
        for i in range(q_t.shape[1])])
    assert got.dtype == np.int32 and got.shape == want.shape == (3, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(block, want)


def test_score_block_matches_jax_and_oracle_on_wrong_sign_gaps():
    """Gaps of the wrong sign for the objective (negative gaps under min,
    positive under max) reach row 0 through opt(boundary, gap boundary):
    the port gives the JAX package's numbers there, not textbook Gotoh's."""
    rng = _rng()
    cands = [rng.integers(97, 99, int(n)).astype(np.uint8).tobytes()
             for n in rng.integers(0, 13, 20)]
    lens = np.array([[len(c) for c in cands]], np.int32)
    block = np.zeros((12, len(cands)), np.int32)
    for j, c in enumerate(cands):
        block[: len(c), j] = np.frombuffer(c, np.uint8)
    q = b"abbab"
    q_ext = np.zeros((8, 1), np.int32)
    q_ext[1:6, 0] = np.frombuffer(q, np.uint8)
    for objective, gaps in (("min", jsim.AffineGaps(-3, -1)),
                            ("max", jsim.AffineGaps(4, 1)),
                            ("min", jsim.LinearGaps(-2))):
        jcfg = jsim.SimilarityConfig(objective, "global", gaps, jsim.UniformCosts(0, 1))
        got = score_block(torch.from_numpy(q_ext), len(q), torch.from_numpy(block),
                          torch.from_numpy(lens), config_from(jcfg)).numpy()
        want = np.asarray(jsim.score_block(jnp.asarray(q_ext), jnp.int32(len(q)),
                                           jnp.asarray(block), jnp.asarray(lens), jcfg))
        np.testing.assert_array_equal(got, want)
    # With the usual signs the same cells equal the independent Gotoh oracle.
    jcfg = jsim.SimilarityConfig("min", "global", jsim.AffineGaps(3, 1), jsim.UniformCosts(0, 1))
    got = score_block(torch.from_numpy(q_ext), len(q), torch.from_numpy(block),
                      torch.from_numpy(lens), config_from(jcfg)).numpy()[0]
    want = [oracles.score_affine(q, c, lambda x, y: int(x != y), 3, 1, "min", False)
            for c in cands]
    np.testing.assert_array_equal(got, want)


def test_class_ids_from_32_cost_zero():
    """A query or candidate class outside [0, 32) has substitution cost 0,
    as the JAX package's one-hot products give it: two chars of class 40
    score 0 under NW with linear gap -1."""
    table = np.full((32, 32), 7, np.int32)
    jcfg = jsim.SimilarityConfig("max", "global", jsim.LinearGaps(-1),
                                 jsim.ClassCosts.from_arrays(np.arange(256) % 64, table))
    q_t = np.array([[0], [40], [40]], np.int32)
    c_t = np.array([[40, 5, 40], [40, 40, 200]], np.int32)
    arrays = (q_t, np.array([[2]], np.int32), c_t, np.array([[2, 2, 2]], np.int32))
    got = similarity(*_torch(arrays), config_from(jcfg), torch.from_numpy(table)).numpy()
    want = np.asarray(similarity_pallas(*(jnp.asarray(a) for a in arrays), jcfg,
                                        table=jnp.asarray(table)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0


def test_empty_blocks_and_bad_inputs():
    cfg = tsim.SimilarityConfig("min", "global", tsim.AffineGaps(3, 1), tsim.UniformCosts(0, 2))
    q_t = torch.zeros((8, 2), dtype=torch.int32)
    qlens = torch.tensor([[0], [3]], dtype=torch.int32)
    c_t = torch.zeros((5, 0), dtype=torch.int32)
    assert similarity(q_t, qlens, c_t, torch.zeros((1, 0), dtype=torch.int32), cfg).shape == (2, 0)
    # no candidate chars at all: global scores are the query's gap run
    c_t = torch.zeros((0, 2), dtype=torch.int32)
    clens = torch.zeros((1, 2), dtype=torch.int32)
    assert similarity(q_t, qlens, c_t, clens, cfg).tolist() == [[0, 0], [5, 5]]
    before = dict(dp_mod.KERNEL_LAUNCHES)
    similarity(q_t, qlens, c_t, clens, cfg)
    assert dp_mod.KERNEL_LAUNCHES == before  # CPU tensors launch nothing
    with pytest.raises(TypeError):
        similarity(q_t.long(), qlens, c_t, clens, cfg)
    with pytest.raises(ValueError):
        similarity(torch.zeros((4105, 2), dtype=torch.int32), qlens, c_t, clens, cfg)
    with pytest.raises(ValueError):
        similarity(q_t, qlens.view(1, -1), c_t, clens, cfg)
    classes = tsim.SimilarityConfig(
        "max", "local", tsim.LinearGaps(-1),
        tsim.ClassCosts.from_arrays(np.zeros(256), np.zeros((32, 32))))
    with pytest.raises(TypeError):
        similarity(q_t, qlens, c_t, clens, classes)  # class costs need the table


def test_config_from_a_jax_config():
    b2c = np.arange(256) % 20
    table = np.arange(1024).reshape(32, 32) % 11 - 5
    jcfg = jsim.SimilarityConfig("max", "local", jsim.AffineGaps(-10, -1),
                                 jsim.ClassCosts.from_arrays(b2c, table))
    cfg = config_from(jcfg)
    assert cfg == tsim.SimilarityConfig("max", "local", tsim.AffineGaps(-10, -1),
                                        tsim.ClassCosts.from_arrays(b2c, table))
    assert hash(cfg) == hash(config_from(jcfg))
    np.testing.assert_array_equal(cfg.costs.table_np(), table)
    assert config_from(jsim.SimilarityConfig()) == tsim.SimilarityConfig()
    assert config_from(cfg) == cfg
