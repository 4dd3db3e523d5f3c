"""The port's engines on a CPU scope against the JAX package's engines
(Pallas interpreter on the CPU), Wagner-Fischer and the Gotoh oracle, on the
same numpy-seeded inputs: ``LevenshteinDistances`` with unit and other
costs, ``NeedlemanWunschScores`` and ``SmithWatermanScores``. Tolerance:
exact equality of the uint64 / int64 results."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.models import device_scope  # noqa: E402

from .oracles import levenshtein, score_affine, score_linear  # noqa: E402

CPU = tsz.DeviceScope(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng():
    """A generator of this file's own: the column-DP tests draw the same
    data in any order and leave the session ``rng``, which other files
    share, as it is."""
    return np.random.default_rng(42)


def _strings(rng, lengths, alphabet=b"abc"):
    return [bytes(rng.choice(list(alphabet), int(n)).astype(np.uint8)) for n in lengths]


def test_engine_matches_jax_across_buckets(rng):
    """Lengths 0-300 span the dyadic buckets 8 to 512, so queries reach
    both kernel tiers (<= 4 words per thread, more per warp on the card)."""
    qs = _strings(rng, [0, 5, 40, 100, 200, 300])
    cs = _strings(rng, [0, 3, 9, 17, 33, 70, 140, 290])
    cs[-1] = qs[-1][:250] + b"x" * 40
    got = tsz.LevenshteinDistances()(qs, cs, device=CPU)
    want = jsz.LevenshteinDistances()(qs, cs)
    assert got.dtype == np.uint64 and got.shape == (6, 8)
    np.testing.assert_array_equal(got, want)
    for i, j in [(0, 7), (3, 4), (5, 7), (4, 0)]:
        assert got[i, j] == levenshtein(qs[i], cs[j])


def test_dyadic_buckets_match_jax(rng):
    from stringzilla_tpu.models import similarities as jsim
    from stringzilla_tpu_torch.models import similarities as tsim

    lengths = np.concatenate([np.arange(0, 300), rng.integers(0, 5000, 200),
                              [4095, 4096, 4097, 2**20 + 1]])
    got, want = tsim._group_dyadic(lengths), jsim._group_dyadic(lengths)
    assert got.keys() == want.keys()
    for b in want:
        np.testing.assert_array_equal(got[b], want[b])


def test_engine_symmetric_call_matches_jax(rng):
    seqs = _strings(rng, rng.integers(0, 70, 7))
    got = tsz.LevenshteinDistances()(seqs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistances()(seqs))
    assert (got == got.T).all() and (np.diag(got) == 0).all()


def test_engine_tape_input_and_out(rng):
    qs = _strings(rng, rng.integers(0, 40, 4))
    cs = _strings(rng, rng.integers(0, 40, 5))
    out = np.full((4, 5), 99, dtype=np.uint64)
    res = tsz.LevenshteinDistances()(tsz.Tape.from_strings(qs),
                                     tsz.Tape.from_strings(cs), device=CPU, out=out)
    assert res is out
    np.testing.assert_array_equal(out, jsz.LevenshteinDistances()(
        jsz.Tape.from_strings(qs), jsz.Tape.from_strings(cs)))
    with pytest.raises(ValueError):
        tsz.LevenshteinDistances()(qs, cs, device=CPU, out=np.zeros((5, 4)))


def test_engine_int_array_input_takes_the_host_collection(rng):
    """Non-uint8 ndarrays are char values, packed on the host and scored on
    the scope's device."""
    qs = [rng.integers(97, 100, int(n)).astype(np.int64) for n in (0, 12, 33)]
    cs = [rng.integers(97, 100, int(n)).astype(np.int32) for n in (4, 20, 0, 70)]
    got = tsz.LevenshteinDistances()(qs, cs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistances()(qs, cs))
    mixed = tsz.LevenshteinDistances()([b"abc", qs[1]], [b"abd"], device=CPU)
    assert mixed[0, 0] == 1


def test_engine_str_input_dtype_and_errors():
    eng = tsz.LevenshteinDistances()
    out = eng(["kitten", "héllo", ""], ["sitting", "hello"], device=CPU)
    assert out.dtype == np.uint64
    assert out.tolist() == [[3, 6], [7, 2], [7, 5]]  # é is two bytes
    assert eng([], ["a"], device=CPU).shape == (0, 1)
    with pytest.raises(TypeError):
        eng([b"ab", 3], device=CPU)
    assert tsz.LevenshteinDistancesUTF8()(["héllo"], ["hello"], device=CPU).tolist() == [[1]]
    # pairs over 4096 bytes run on the wavefront tier up to MAX_FLAT_CELLS
    assert eng([b"a" * 5000], [b"ab"], device=CPU).tolist() == [[4999]]
    assert tsz.LevenshteinDistances(mismatch=2)([b"ab"], [b"a" * 4097],
                                                device=CPU).tolist() == [[4097]]
    eye = np.eye(32, dtype=np.int32)
    nw = tsz.NeedlemanWunsch(substitution_matrix=eye)([b"a" * 4097], [b"ab"], device=CPU)
    assert nw.tolist() == [[score_linear(b"a" * 4097, b"ab",
                                         lambda x, y: int(eye[x % 32, y % 32]), -1)]]
    cap = b"a" * (1 << 19)  # max(m + 1, n) is one cell over MAX_FLAT_CELLS
    with pytest.raises(ValueError, match="too long"):  # |m - n| is over the widest band
        eng([cap], [b"ab"], device=CPU)
    with pytest.raises(ValueError, match="too long"):
        tsz.LevenshteinDistances(mismatch=2)([b"ab"], [cap + b"a"], device=CPU)
    with pytest.raises(ValueError):
        tsz.NeedlemanWunsch()  # no costs given, as the JAX engine raises
    with pytest.raises(ValueError):
        tsz.LevenshteinDistances(open=300)


def test_default_scope_needs_a_card(monkeypatch):
    """The default scope is cuda:0 and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsz.LevenshteinDistances()([b"a"], [b"b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsz.DeviceScope(device_index=0)
    assert CPU.device == torch.device("cpu")
    assert "devices:0" in tsz.__capabilities__()


def test_multi_device_scope_is_not_ported(monkeypatch):
    """A scope spans every card, or the first ``cpu_cores``; over several
    devices the pairs over ``MAX_FLAT_CELLS`` (cut to 128 here) go to the
    ring (``parallel/ring.py``), which scores them."""
    from stringzilla_tpu_torch.models import similarities as tsim
    from stringzilla_tpu_torch.ops import wavefront as twf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert device_scope.DeviceScope().device_count == 4
    assert device_scope.DeviceScope(cpu_cores=2).devices == (torch.device("cuda", 0),
                                                             torch.device("cuda", 1))
    assert device_scope.DeviceScope(gpu_device=3).device == torch.device("cuda", 3)
    monkeypatch.setattr(tsim, "_LONG_THRESHOLD", 64)
    monkeypatch.setattr(twf, "MAX_FLAT_CELLS", 128)
    got = tsz.LevenshteinDistances()([b"a" * 200], [b"b" * 150],
                                     device=device_scope.DeviceScope(devices=["cpu"] * 2))
    assert got.tolist() == [[levenshtein(b"a" * 200, b"b" * 150)]] == [[200]]


def test_one_card_scope_counts_one_device():
    """The port's one-card scope beside the JAX scope over one device."""
    want = jsz.DeviceScope(device_index=0)
    for scope in (CPU, device_scope.DeviceScope(device="cpu")):
        assert scope.device_count == want.device_count == 1
        assert scope.is_single_device is want.is_single_device is True


def test_port_imports_no_jax():
    code = ("import sys, stringzilla_tpu_torch, stringzilla_tpu_torch.ops.wavefront, "
            "stringzilla_tpu_torch.models.fingerprints, "
            "stringzilla_tpu_torch.ops.fingerprints_kernel, "
            "stringzilla_tpu_torch.ops.utf8_pack_device, "
            "stringzilla_tpu_torch.models.str_api, stringzilla_tpu_torch.ops.find, "
            "stringzilla_tpu_torch.ops.find_kernel, stringzilla_tpu_torch.ops.utf8_device, "
            "stringzilla_tpu_torch.ops.utf8, stringzilla_tpu_torch.ops.hash, "
            "stringzilla_tpu_torch.parallel.ring; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'stringzilla_tpu' for m in sys.modules), "
            "'stringzilla_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _proteins(rng, lengths):
    return _strings(rng, lengths, b"ACDEFGHIKLMNPQRSTVWY")


def _class_costs(rng):
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    b2c = np.zeros(256, np.uint8)
    b2c[aa] = np.arange(20)
    table = rng.integers(-4, 6, (32, 32)).astype(np.int32)
    table = (table + table.T) // 2
    np.fill_diagonal(table, rng.integers(4, 10, 32))
    return b2c, table


@pytest.mark.parametrize("engine,open,extend", [
    ("NeedlemanWunschScores", -5, -5), ("NeedlemanWunschScores", -10, -1),
    ("SmithWatermanScores", -5, -5), ("SmithWatermanScores", -10, -1)])
def test_nw_sw_match_jax(engine, open, extend):
    """Two dyadic buckets a side (rows 16 and 24); one candidate holds most
    of a query, so alignments score high."""
    rng = _rng()
    b2c, table = _class_costs(rng)
    qs = _proteins(rng, [0, 7, 16])
    cs = _proteins(rng, [0, 1, 9, 16])
    cs[-1] = qs[-1][:12] + cs[-1][:4]
    got = getattr(tsz, engine)(b2c, table, open=open, extend=extend)(qs, cs, device=CPU)
    want = getattr(jsz, engine)(b2c, table, open=open, extend=extend)(qs, cs)
    assert got.dtype == np.int64 and got.shape == (3, 4)
    np.testing.assert_array_equal(got, want)
    sub = lambda x, y: int(table[b2c[x], b2c[y]])
    local = engine.startswith("Smith")
    for i, j in [(2, 3), (1, 2), (0, 2)]:
        oracle = (score_linear(qs[i], cs[j], sub, open, "max", local) if open == extend
                  else score_affine(qs[i], cs[j], sub, open, extend, "max", local))
        assert got[i, j] == oracle


def test_substitution_matrix_forms_match_jax():
    """A dense 256x256 matrix compresses to classes; a 32x32 one maps byte
    b to class b % 32. Both as the JAX engines do."""
    rng = _rng()
    b2c, table = _class_costs(rng)
    dense = table[b2c][:, b2c]
    qs = _proteins(rng, [9, 16])
    cs = _proteins(rng, [0, 5, 14])
    for matrix in (dense, table):
        got = tsz.NeedlemanWunsch(substitution_matrix=matrix, open=-3, extend=-1)(
            qs, cs, device=CPU)
        want = jsz.NeedlemanWunsch(substitution_matrix=matrix, open=-3, extend=-1)(qs, cs)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tsz.SmithWaterman(substitution_matrix=np.zeros((16, 16)))


@pytest.mark.parametrize("costs", [
    dict(match=0, mismatch=2, open=3, extend=1), dict(mismatch=3, open=2, extend=2),
    dict(match=-1), dict(match=-2, mismatch=1, open=-3, extend=-1),
    dict(open=-3, extend=-1)])
def test_weighted_levenshtein_matches_jax(costs):
    """Weighted, affine, negative and wrong-sign costs; negative distances
    wrap in uint64 as in the JAX package."""
    rng = _rng()
    qs = _strings(rng, [0, 4, 8])
    cs = _strings(rng, [0, 2, 5, 8])
    got = tsz.LevenshteinDistances(**costs)(qs, cs, device=CPU)
    want = jsz.LevenshteinDistances(**costs)(qs, cs)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_negative_distance_wraps_in_uint64():
    got = tsz.LevenshteinDistances(match=-1)([b"aaa"], [b"aaa"], device=CPU)
    assert got.dtype == np.uint64 and int(got[0, 0]) == 2**64 - 3
    np.testing.assert_array_equal(got, jsz.LevenshteinDistances(match=-1)([b"aaa"], [b"aaa"]))


def test_int_array_host_collection_with_classes():
    """Int-array inputs keep the host collection and map through b2c by
    numpy indexing, class ids >= 32 included (they cost 0)."""
    rng = _rng()
    b2c = (np.arange(256) % 64).astype(np.uint8)
    table = rng.integers(-5, 6, (32, 32)).astype(np.int32)
    qs = [rng.integers(0, 256, int(n)).astype(np.int64) for n in (0, 5, 8)]
    cs = [rng.integers(0, 256, int(n)).astype(np.int32) for n in (3, 7, 0, 8)]
    for engine in ("NeedlemanWunschScores", "SmithWatermanScores"):
        got = getattr(tsz, engine)(b2c, table, open=-2, extend=-1)(qs, cs, device=CPU)
        want = getattr(jsz, engine)(b2c, table, open=-2, extend=-1)(qs, cs)
        np.testing.assert_array_equal(got, want)
    two = tsz.NeedlemanWunsch(b2c, np.full((32, 32), 7), open=-1, extend=-1)(
        [bytes([40, 40])], [bytes([40, 40])], device=CPU)
    assert two[0, 0] == 0  # class 40: no table entry, cost 0


def test_score_engine_symmetric_call_matches_jax():
    rng = _rng()
    b2c, table = _class_costs(rng)
    seqs = _proteins(rng, rng.integers(0, 9, 6))
    got = tsz.SmithWatermanScores(b2c, table, open=-4, extend=-1)(seqs, device=CPU)
    want = jsz.SmithWatermanScores(b2c, table, open=-4, extend=-1)(seqs)
    np.testing.assert_array_equal(got, want)
    assert (got == got.T).all()


def test_class_mapped_tape_is_memoised(monkeypatch):
    """One LUT pass per collection and table, however many calls."""
    rng = _rng()
    from stringzilla_tpu_torch.models import similarities as tsim

    calls = []
    real = tsim.lookup_transform
    monkeypatch.setattr(tsim, "lookup_transform",
                        lambda data, lut: calls.append(len(data)) or real(data, lut))
    b2c, table = _class_costs(rng)
    tape = tsz.Tape.from_strings(_proteins(rng, [3, 10, 25]))
    nw = tsz.NeedlemanWunsch(b2c, table)
    first = nw(tape, tape, device=CPU)
    np.testing.assert_array_equal(nw(tape, device=CPU), first)
    tsz.SmithWaterman(b2c, table)(tape, device=CPU)
    assert calls == [tape.total_bytes + 1]
    tsz.NeedlemanWunsch(b2c, 2 * table)(tape, device=CPU)  # same classes: memo hit
    other = b2c.copy()
    other[65] = 31
    tsz.NeedlemanWunsch(other, table)(tape, device=CPU)
    assert len(calls) == 2
    mapped = tsim._class_mapped_tape(tsim.device_tape(tape, CPU.device), b2c)
    assert mapped is tsim._class_mapped_tape(tsim.device_tape(tape, CPU.device), b2c)
    assert mapped.data[:-1].tolist() == b2c[tape.data].tolist()


def _long_call(rng, alphabet, side="both"):
    """Short strings and strings of 4097-4200 bytes in one call: a long
    query against short, empty and long candidates, the long candidate a
    mutated copy of the query (substitutions, a deletion, a tail), and a
    short query against all of them. ``side`` keeps the long strings on
    the query or the candidate side only."""
    long_q = bytearray(_strings(rng, [4150], alphabet)[0])
    long_c = bytearray(long_q[:4100])
    for k in rng.integers(0, 4100, 30):
        long_c[k] = alphabet[int(rng.integers(0, len(alphabet)))]
    del long_c[2000]
    long_c = bytes(long_c) + _strings(rng, [60], alphabet)[0]
    qs = _strings(rng, [30], alphabet) + [bytes(long_q), b""]
    cs = _strings(rng, [12], alphabet) + [long_c] + _strings(rng, [0, 50], alphabet)
    if side == "query":
        del cs[1]
    elif side == "candidate":
        del qs[1]
    return qs, cs


_LONG_CASES = [  # engine, costs, class costs, where the long strings are
    ("LevenshteinDistances", {}, False, "both"),
    ("LevenshteinDistances", dict(mismatch=3, open=2, extend=2), False, "candidate"),
    ("LevenshteinDistances", dict(match=0, mismatch=2, open=3, extend=1), False, "query"),
    ("NeedlemanWunschScores", dict(open=-5, extend=-5), True, "candidate"),
    ("NeedlemanWunschScores", dict(open=-7, extend=-2), True, "query"),
    ("SmithWatermanScores", dict(open=-5, extend=-5), True, "query"),
    ("SmithWatermanScores", dict(open=-7, extend=-2), True, "candidate"),
]


@pytest.mark.parametrize("engine,costs,classes,side", _LONG_CASES,
                         ids=[f"{e}-{c}-{s}" for e, c, _, s in _LONG_CASES])
def test_long_pairs_match_jax(engine, costs, classes, side):
    """Every pair touching a string over 4096 bytes runs on the wavefront
    tier (unit costs on its band kernel, as in the JAX engine), the rest on
    the Myers kernel or the column DP, in one call."""
    rng = _rng()
    if classes:
        b2c, table = _class_costs(rng)
        args, alphabet = (b2c, table), b"ACDEFGHIKLMNPQRSTVWY"
    else:
        args, alphabet = (), b"acgt"
    qs, cs = _long_call(rng, alphabet, side)
    got = getattr(tsz, engine)(*args, **costs)(qs, cs, device=CPU)
    want = getattr(jsz, engine)(*args, **costs)(qs, cs)
    assert got.dtype == want.dtype and got.shape == (len(qs), len(cs))
    np.testing.assert_array_equal(got, want)
    if engine == "LevenshteinDistances" and not costs:
        assert got[0, 0] == levenshtein(qs[0], cs[0])
        assert got[2, 1] == len(cs[1]) and got[1, 2] == len(qs[1])


def test_long_pairs_symmetric_call_out_and_int_arrays():
    """The symmetric call and ``out=`` over long strings, and int-array
    inputs (the host collection) with a long string, as the JAX engines."""
    rng = _rng()
    b2c, table = _class_costs(rng)
    qs, cs = _long_call(rng, b"ACDEFGHIKLMNPQRSTVWY")
    seqs = qs[:2] + cs[1:3]
    eng = (b2c, table)
    out = np.full((4, 4), 7, np.int64)
    got = tsz.SmithWatermanScores(*eng, open=-7, extend=-2)(seqs, device=CPU, out=out)
    assert got is out
    np.testing.assert_array_equal(out, jsz.SmithWatermanScores(*eng, open=-7, extend=-2)(seqs))
    ints = [np.frombuffer(s, np.uint8).astype(np.int64) for s in qs]
    shorts = cs[:1] + cs[2:]
    got = tsz.LevenshteinDistances(mismatch=3, open=2, extend=2)(ints, shorts, device=CPU)
    np.testing.assert_array_equal(
        got, jsz.LevenshteinDistances(mismatch=3, open=2, extend=2)(ints, shorts))


def test_unit_cost_long_pairs_take_the_band(monkeypatch):
    """A near-duplicate unit-cost long pair is certified by the band tier
    and never reaches the flat one; a pair too far apart for the widest band
    does, as in the JAX engine; non-unit costs stay on the flat tier."""
    from stringzilla_tpu_torch.models import similarities as tsim
    from stringzilla_tpu_torch.ops import wavefront as wf

    calls = {"band": 0, "flat": 0}
    real_band, real_flat = wf.band_batch, wf.wavefront_batch

    def spy(name, real):
        def call(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return call

    monkeypatch.setattr(wf, "band_batch", spy("band", real_band))
    monkeypatch.setattr(wf, "wavefront_batch", spy("flat", real_flat))
    monkeypatch.setattr(tsim, "wavefront_batch", wf.wavefront_batch)
    rng = _rng()
    long1 = bytes(rng.integers(97, 100, 4096 + 300).astype(np.uint8))
    long2 = long1[:-6] + b"XYZXYZ"
    got = tsz.LevenshteinDistances()([long1], [long2], device=CPU)
    assert got.tolist() == [[6]] and calls == {"band": 1, "flat": 0}
    short = b"ab"
    got = tsz.LevenshteinDistances()([long1], [short], device=CPU)
    assert got.tolist() == [[levenshtein(long1, short)]] and calls == {"band": 2, "flat": 1}
    got = tsz.LevenshteinDistances(mismatch=2)([long1], [long2], device=CPU)
    assert got.tolist() == [[12]] and calls == {"band": 2, "flat": 2}
