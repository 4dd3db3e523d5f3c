"""The similarity engines' split route over a ``DeviceScope``'s devices
(``models/similarities.py`` through ``parallel/cross.py``'s
``sharded_myers`` and ``sharded_similarity``) on CPU scopes that list the
CPU 1, 3 or 8 times, held against the port's one-device results, the JAX
package's one-device engines (the Pallas interpreter) and
``tests/oracles.py``, on the same numpy-seeded inputs: unit and other
costs, NW and SW with class tables, UTF-8 (valid and malformed), int-array
items, the symmetric call, long pairs beside the split blocks, and pairs
over ``MAX_FLAT_CELLS`` scored on the ring tier (``parallel/ring.py``)
over 2 and 3 entries, against the JAX engines on a mesh of as many
devices. Tolerance: exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402

import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.models import similarities as tsim  # noqa: E402
from stringzilla_tpu_torch.ops import wavefront as twf  # noqa: E402

from .oracles import levenshtein, score_affine, score_linear  # noqa: E402

CPU = tsz.DeviceScope(device="cpu")
SPLITS = [1, 3, 8]


def _scope(k: int):
    return tsz.DeviceScope(devices=["cpu"] * k)


def _strings(rng, lengths, alphabet=b"acgt"):
    return [bytes(rng.choice(list(alphabet), int(n)).astype(np.uint8)) for n in lengths]


def _engine_cases():
    """``(name, port engine, JAX engine, queries, candidates)``, strings in
    two dyadic buckets (16 and 32 chars)."""
    rng = np.random.default_rng(11)
    qs = _strings(rng, rng.integers(9, 33, 5))
    cs = _strings(rng, rng.integers(9, 33, 21))
    b2c = (np.arange(256) % 20).astype(np.uint8)
    table = rng.integers(-4, 6, (32, 32)).astype(np.int32)
    runes = "aé数😀"
    uq = ["".join(rng.choice(list(runes), int(n))) for n in rng.integers(9, 33, 4)]
    uc = ["".join(rng.choice(list(runes), int(n))) for n in rng.integers(9, 33, 13)]
    bad = [s.encode() for s in uc]
    bad[3] = bad[3][:5] + b"\xff\xfe" + bad[3][5:]  # malformed: the host's decode
    arrays = [np.asarray(rng.integers(0, 300, int(n)), np.int32) for n in rng.integers(9, 33, 11)]
    return [
        ("unit", tsz.LevenshteinDistances(), jsz.LevenshteinDistances(), qs, cs),
        ("weighted", tsz.LevenshteinDistances(mismatch=2, open=3, extend=1),
         jsz.LevenshteinDistances(mismatch=2, open=3, extend=1), qs, cs),
        ("nw-classes", tsz.NeedlemanWunschScores(b2c, table, open=-5, extend=-5),
         jsz.NeedlemanWunschScores(b2c, table, open=-5, extend=-5), qs, cs),
        ("sw-affine-classes", tsz.SmithWatermanScores(b2c, table, open=-4, extend=-1),
         jsz.SmithWatermanScores(b2c, table, open=-4, extend=-1), qs, cs),
        ("utf8", tsz.LevenshteinDistancesUTF8(), jsz.LevenshteinDistancesUTF8(), uq, uc),
        ("utf8-weighted", tsz.LevenshteinDistancesUTF8(mismatch=3, open=2, extend=1),
         jsz.LevenshteinDistancesUTF8(mismatch=3, open=2, extend=1), uq, uc),
        ("utf8-malformed", tsz.LevenshteinDistancesUTF8(), jsz.LevenshteinDistancesUTF8(),
         [s.encode() for s in uq], bad),
        ("int-arrays", tsz.LevenshteinDistances(), jsz.LevenshteinDistances(),
         arrays[:4], arrays[4:]),
        ("symmetric", tsz.LevenshteinDistances(), jsz.LevenshteinDistances(), cs, None),
    ]


ENGINE_CASES = {case[0]: case[1:] for case in _engine_cases()}


@pytest.fixture(scope="module")
def engine_answers():
    """Each case's JAX answer (one device, the Pallas interpreter) and the
    port's on one CPU device, made once."""
    out = {}
    for name, (port, jax_engine, qs, cs) in ENGINE_CASES.items():
        out[name] = (np.asarray(jax_engine(qs, cs)), port(qs, cs, device=CPU))
    return out


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_split_engine_matches_one_device_and_jax(engine_answers, name, k):
    port, _, qs, cs = ENGINE_CASES[name]
    want_jax, want_port = engine_answers[name]
    got = port(qs, cs, device=_scope(k))
    assert got.dtype == want_port.dtype == want_jax.dtype
    np.testing.assert_array_equal(got, want_port)
    np.testing.assert_array_equal(got, want_jax)


def test_split_engine_against_oracles():
    """A few pairs of the split results against Wagner-Fischer and Gotoh;
    a bucket with fewer candidates than devices; an empty side."""
    port, _, qs, cs = ENGINE_CASES["unit"]
    got = port(qs, cs[:2], device=_scope(8))
    for i in range(len(qs)):
        for j in range(2):
            assert got[i, j] == levenshtein(qs[i], cs[j])
    nw, _, qs, cs = ENGINE_CASES["sw-affine-classes"]
    costs = nw.config.costs
    sub = costs.table_np()
    b2c = costs.byte_to_class_np()
    got = nw(qs, cs, device=_scope(3))
    for i, j in [(0, 0), (2, 7), (4, 20)]:
        assert got[i, j] == score_affine(qs[i], cs[j], lambda a, b: sub[b2c[a], b2c[b]],
                                         -4, -1, local=True)
    assert port([], cs, device=_scope(3)).shape == (0, len(cs))
    assert port(qs, [], device=_scope(3)).shape == (len(qs), 0)
    dev_out = port._device_scores(qs, cs, device=_scope(3))
    assert dev_out.device == torch.device("cpu") and dev_out.shape == (len(qs), len(cs))


@pytest.mark.parametrize("name", ["unit", "nw-classes", "utf8"])
def test_split_engine_long_pairs_on_the_first_device(monkeypatch, name):
    """Pairs with a string over the long threshold (cut to 32 chars here,
    a power of two as the engines' buckets need) run on the first device,
    beside the split blocks; a multi-device scope gives the one-device
    answers."""
    monkeypatch.setattr(tsim, "_LONG_THRESHOLD", 32)
    rng = np.random.default_rng(5)
    port, _, _, _ = ENGINE_CASES[name]
    if name == "utf8":
        qs = ["".join(rng.choice(list("aé数"), int(n))) for n in (10, 45, 30)]
        cs = ["".join(rng.choice(list("aé数"), int(n))) for n in (50, 12, 33, 7, 41)]
    else:
        qs = _strings(rng, [10, 45, 30])
        cs = _strings(rng, [50, 12, 33, 7, 41])
    want = port(qs, cs, device=CPU)
    for k in SPLITS:
        np.testing.assert_array_equal(port(qs, cs, device=_scope(k)), want)
    if name == "unit":
        assert want[1, 0] == levenshtein(qs[1], cs[0])


@pytest.mark.parametrize("engine", [tsz.LevenshteinDistances(),
                                    tsz.NeedlemanWunschScores(np.arange(256) % 4,
                                                              np.eye(32, dtype=np.int32))])
def test_oversize_pair_in_a_split_scope_waits_for_the_ring(monkeypatch, engine):
    """A pair over ``MAX_FLAT_CELLS`` in a scope over several devices is
    the ring's: scored alone by ``ring_wavefront_score`` with its rows over
    the scope's 2 or 3 entries, equal to the JAX engine on a mesh of as
    many devices and to the oracle, in the symmetric call too. In a call
    with another long pair, that one stays in the batch on the first
    device. On one device the
    column-DP engine keeps raising the JAX package's ``ValueError``. Both
    packages' thresholds are cut as ``tests/test_ring.py`` cuts them: 64
    chars for a long pair, 128 diagonal cells for the flat tier."""
    import jax
    import stringzilla_tpu.models.similarities as jsim
    from jax.sharding import Mesh
    from stringzilla_tpu.ops import wavefront_pallas

    for mod, name, value in ((tsim, "_LONG_THRESHOLD", 64), (jsim, "_LONG_THRESHOLD", 64),
                             (twf, "MAX_FLAT_CELLS", 128),
                             (wavefront_pallas, "MAX_FLAT_CELLS", 128)):
        monkeypatch.setattr(mod, name, value)
    rings = []
    ring = tsim.ring_wavefront_score
    monkeypatch.setattr(tsim, "ring_wavefront_score",
                        lambda a, b, scope, **kw: rings.append((len(a), len(b)))
                        or ring(a, b, scope, **kw))
    nw = isinstance(engine, tsz.NeedlemanWunschScores)
    if nw:
        jax_engine = jsz.NeedlemanWunschScores(np.arange(256) % 4, np.eye(32, dtype=np.int32))
        cfg = engine.config
        sub = lambda x, y: int(cfg.costs.table_np()[x % 4, y % 4])
        if cfg.is_affine:
            oracle = lambda a, b: score_affine(a, b, sub, cfg.gaps.open, cfg.gaps.extend,
                                               objective=cfg.objective)
        else:
            oracle = lambda a, b: score_linear(a, b, sub, cfg.gaps.open_or_extend,
                                               objective=cfg.objective)
    else:
        jax_engine, oracle = jsz.LevenshteinDistances(), levenshtein
    rng = np.random.default_rng(1)
    a, b, mid = _strings(rng, [200, 251, 90])
    for k in (2, 3):
        scope = jsz.DeviceScope(mesh=Mesh(np.asarray(jax.devices()[:k]), axis_names=("data",)))
        got = engine([a], [b], device=_scope(k))
        np.testing.assert_array_equal(got, np.asarray(jax_engine([a], [b], device=scope)))
        assert got[0, 0] == oracle(a, b)
    assert rings == [(200, 251)] * 2
    rings.clear()
    short = _strings(rng, [100])[0]
    got = engine([a, mid], [short], device=_scope(2))
    scope = jsz.DeviceScope(mesh=Mesh(np.asarray(jax.devices()[:2]), axis_names=("data",)))
    np.testing.assert_array_equal(got, np.asarray(jax_engine([a, mid], [short], device=scope)))
    assert rings == [(200, 100)]  # max(201, 100) > 128; (90, 100) stays in the batch
    assert got[1, 0] == oracle(mid, short)
    # the symmetric call: its ring pairs cut from the one collection
    rings.clear()
    got = engine([b"ab", a], device=_scope(3))
    scope = jsz.DeviceScope(mesh=Mesh(np.asarray(jax.devices()[:3]), axis_names=("data",)))
    np.testing.assert_array_equal(got, np.asarray(jax_engine([b"ab", a], device=scope)))
    assert rings and all(max(m + 1, n) > 128 for m, n in rings)
    assert got[1, 1] == oracle(a, a) and got[0, 1] == oracle(b"ab", a)
    if nw:
        with pytest.raises(ValueError, match="too long"):
            engine([a], [b], device=CPU)
    # pairs within the cut still score on a split scope
    pairs = _strings(rng, [70, 90])
    np.testing.assert_array_equal(engine(pairs, device=_scope(2)), engine(pairs, device=CPU))
