"""The port's Arrow C data interface (``models/arrow.py``): the cases of
tests/test_arrow.py on ``stringzilla_tpu_torch``'s ``Tape`` and ``Strs``,
validated against pyarrow, beside the JAX package's results on the same
inputs, and one round trip with no pyarrow at all (``Strs`` → capsules →
``Tape.from_arrow``). Also the tape helpers ported with it, ``pack_dense``
and ``group_by_dyadic_length``, against the JAX package's. Exact
equality."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu.ops import tape as jtape  # noqa: E402
from stringzilla_tpu_torch.models import arrow as A  # noqa: E402
from stringzilla_tpu_torch.ops.tape import Tape, group_by_dyadic_length, pack_dense  # noqa: E402

ITEMS = [b"hello", b"", b"world", bytes(range(256)), b"x" * 1000]


def _tape_items(tape):
    return [bytes(np.asarray(tape.data[int(tape.offsets[i]): int(tape.offsets[i + 1])]))
            for i in range(len(tape))]


def test_roundtrip_without_pyarrow():
    """Export and import through the capsules alone."""
    strs = tsz.Strs(ITEMS)
    tape = Tape.from_arrow(strs)
    assert _tape_items(tape) == ITEMS
    assert _tape_items(Tape.from_arrow(strs[::2])) == ITEMS[::2]  # re-taped views
    assert _tape_items(Tape.from_arrow(Tape.from_strings(ITEMS))) == ITEMS
    assert _tape_items(Tape.from_arrow(tsz.Strs())) == []
    assert tsz.Strs(Tape.from_strings(ITEMS)).to_list() == ITEMS
    assert tsz.Strs(strs).to_list() == ITEMS  # a Strs is a producer too
    with pytest.raises(TypeError):
        A.tape_arrays_from_arrow(object())


def test_pack_dense_and_buckets_match_jax():
    items = [b"a", b"", b"hello world", b"xy" * 40, b"tail"]
    tape, jt = Tape.from_strings(items), jtape.Tape.from_strings(items)
    for kw in ({}, {"indices": [4, 0, 2]}, {"pad_length": 90, "pad_count_multiple": 4},
               {"transpose": True, "fill": 7}):
        got, want = pack_dense(tape, **kw), jtape.pack_dense(jt, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pack_dense(tape, pad_length=3)
    lengths = np.array([0, 1, 8, 9, 16, 17, 100, 1000])
    got, want = group_by_dyadic_length(lengths), jtape.group_by_dyadic_length(lengths)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


pa = pytest.importorskip("pyarrow")


def test_tape_export_roundtrip():
    tape = Tape.from_strings(ITEMS)
    arr = pa.array(tape)  # consumes __arrow_c_array__
    assert arr.type == pa.large_binary()
    assert arr.to_pylist() == ITEMS == pa.array(jtape.Tape.from_strings(ITEMS)).to_pylist()


def test_strs_export_zero_copy_views():
    strs = tsz.Strs(ITEMS)
    arr = pa.array(strs)
    assert arr.to_pylist() == ITEMS
    # non-contiguous selection falls back to a re-taped copy
    assert pa.array(strs[::2]).to_pylist() == ITEMS[::2] == pa.array(jsz.Strs(ITEMS)[::2]).to_pylist()


def test_import_from_pyarrow_binary_and_utf8():
    for a in (pa.array(ITEMS, type=pa.binary()),
              pa.array(ITEMS, type=pa.large_binary()),
              pa.array(["héllo", "", "wörld"], type=pa.string()),
              pa.array(["héllo", "", "wörld"], type=pa.large_string())):
        want = [v if isinstance(v, bytes) else v.encode() for v in a.to_pylist()]
        assert _tape_items(Tape.from_arrow(a)) == want == _tape_items(jtape.Tape.from_arrow(a))


def test_import_sliced_array():
    a = pa.array(ITEMS, type=pa.binary()).slice(1, 3)
    tape = Tape.from_arrow(a)
    assert len(tape) == 3
    assert _tape_items(tape) == ITEMS[1:4]


def test_import_rejects_nulls():
    a = pa.array([b"a", None, b"b"], type=pa.binary())
    with pytest.raises(ValueError):
        Tape.from_arrow(a)
    with pytest.raises(TypeError):
        Tape.from_arrow(pa.array([1, 2, 3]))


def test_strs_constructor_accepts_arrow():
    a = pa.array(ITEMS, type=pa.binary())
    strs = tsz.Strs(a)
    assert strs.to_list() == ITEMS == jsz.Strs(a).to_list()
    # and the engines consume the result directly
    d = tsz.LevenshteinDistances()(strs[:2].to_list(), strs[2:3].to_list(),
                                   device=tsz.DeviceScope(device="cpu"))
    assert d.shape == (2, 1)
    np.testing.assert_array_equal(d, jsz.LevenshteinDistances()(ITEMS[:2], ITEMS[2:3]))


def test_export_release_unpins():
    before = len(A._EXPORTS)
    arr = pa.array(Tape.from_strings([b"abc", b"def"]))
    del arr
    gc.collect()
    assert len(A._EXPORTS) == before  # consumer released both structs
