"""The port's search and UTF-8 validation on CPU tensors (their plain PyTorch
versions) against the JAX package: ``search_positions`` / ``find_long``
against ``find_pallas`` in the Pallas interpreter, ``validate_count_raw``
against ``_validate_count_raw``, and the port's ``ops.find`` against the JAX
``ops.find``, on the same numpy-seeded bytes. Tolerance: exact equality of
every integer result."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops import find as jax_find  # noqa: E402
from stringzilla_tpu.ops import find_pallas as jax_fp  # noqa: E402
from stringzilla_tpu.ops.utf8_device import _validate_count_raw  # noqa: E402
from stringzilla_tpu_torch.ops import find as port_find  # noqa: E402
from stringzilla_tpu_torch.ops import find_kernel, utf8_device  # noqa: E402
from stringzilla_tpu_torch.ops.find_kernel import (  # noqa: E402
    find_long,
    search_positions,
    search_positions_reference,
)
from stringzilla_tpu_torch.ops.utf8_device import (  # noqa: E402
    validate_count_device,
    validate_count_raw,
)


def _rng(salt=0):
    """A generator of this file's own: the tests draw the same data in any
    order and leave the session ``rng``, which other files share, as it is."""
    return np.random.default_rng(42 + salt)


@pytest.fixture(scope="module")
def corpus():
    """``tests/test_find.py``'s shape: two 128 KiB blocks of 'a'-'d', 777
    bytes short of full; the JAX kernel's (rows, 128) view and the port's
    flat tensor of the same bytes."""
    rows = jax_fp.BLOCK_ROWS * 2
    n = rows * jax_fp.LANES - 777
    buf = _rng().integers(97, 101, rows * jax_fp.LANES).astype(np.uint8)
    buf[n:] = 0
    return buf, n, jnp.asarray(buf.reshape(rows, jax_fp.LANES)), torch.from_numpy(buf.copy())


def _both(corpus, mode, **kw):
    buf, n, hay2d, flat = corpus
    got = search_positions(flat, n, mode, **kw)
    assert got.dtype == torch.int64 and got.dim() == 0
    return int(got), int(jax_fp.search_positions(hay2d, n, mode, **kw))


@pytest.mark.parametrize("mode", ["first", "last", "count"])
@pytest.mark.parametrize("k", [1, 2, 5, 13, 16])
def test_needle_matches_jax(corpus, k, mode):
    buf, n = corpus[0], corpus[1]
    at = int(_rng(k).integers(0, n - k))
    needle = buf[at: at + k].copy()
    got, want = _both(corpus, mode, needle=needle)
    assert got == want
    hay = buf[:n].tobytes()
    if mode == "first":
        assert got == hay.find(needle.tobytes())
    elif mode == "last":
        assert got == hay.rfind(needle.tobytes())


@pytest.mark.parametrize("mode", ["first", "last", "count"])
def test_byteset_matches_jax(corpus, mode):
    for charset in (b"b", b"\x00d", bytes([0xFF, 97])):
        words = jax_find.byteset_mask(charset)
        np.testing.assert_array_equal(port_find.byteset_mask(charset), words)
        for w in (words, ~words):
            got, want = _both(corpus, mode, byteset_words=w)
            assert got == want, (charset, w)


@pytest.mark.parametrize("lo,hi", [(1000, 200000), (0, 5), (131071, 131073),
                                   (70000, 60000), (261000, 10**9)])
def test_bounds_match_jax(corpus, lo, hi):
    needle = np.frombuffer(b"ab", np.uint8)
    for mode in ("first", "last", "count"):
        got, want = _both(corpus, mode, needle=needle, lo=lo, hi=hi)
        assert got == want, (mode, lo, hi)


@pytest.mark.parametrize("k", [17, 130])
def test_long_needles_match_jax(corpus, k):
    """``find_long`` both ways, a hit and a miss; the port's
    ``search_positions`` is exact on its own for these lengths."""
    buf, n, hay2d, flat = corpus
    hay = buf[:n].tobytes()
    at = int(_rng(k).integers(0, n - k))
    hit = buf[at: at + k].copy()
    miss = hit.copy()
    miss[k // 2] = ord("z")
    for needle in (hit, miss):
        for reverse in (False, True):
            got = find_long(flat, n, needle, reverse=reverse)
            assert got == jax_fp.find_long(hay2d, n, needle, reverse=reverse)
            want = (hay.rfind if reverse else hay.find)(needle.tobytes())
            assert got == want
            mode = "last" if reverse else "first"
            assert int(search_positions(flat, n, mode, needle=needle)) == want
        assert int(search_positions(flat, n, "count", needle=needle)) == (
            hay.count(hit.tobytes()) if needle is hit else 0)


def test_search_edges_and_checks():
    hay = torch.from_numpy(np.frombuffer(b"aaaaab" + bytes(10), np.uint8).copy())
    a = np.frombuffer(b"aa", np.uint8)
    assert int(search_positions(hay, 6, "count", needle=a)) == 4
    assert int(search_positions(hay, 6, "last", needle=np.frombuffer(b"b", np.uint8))) == 5
    # the zero tail past n is not part of the haystack
    zero = np.zeros(2, np.uint8)
    assert int(search_positions(hay, 6, "first", needle=zero)) == -1
    assert int(search_positions(hay, 0, "count", needle=a)) == 0
    assert int(search_positions(hay, 6, "first", needle=b"ab", lo=4)) == 4
    assert int(search_positions(hay, 6, "first", needle=b"ab", lo=5)) == -1
    before = dict(find_kernel.KERNEL_LAUNCHES)
    assert int(search_positions_reference(hay, 6, "first", needle=a, lo=-3)) == 0
    assert find_kernel.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError):
        search_positions(hay, 6, "first", needle=b"")
    with pytest.raises(ValueError):
        search_positions(hay, 6, "middle", needle=a)
    with pytest.raises(ValueError):
        search_positions(hay, 17, "first", needle=a)
    with pytest.raises(ValueError):
        search_positions(hay, 6, "first")
    with pytest.raises(TypeError):
        search_positions(hay.int(), 6, "first", needle=a)


UTF8_CASES = [
    b"", b"plain ascii", "héllo wörld".encode(), "日本語テキスト".encode(),
    "emoji 🎉🎊".encode(), b"\x80", b"\xC0\xAF", b"\xC1\xBF",
    b"\xE0\x80\x80", b"\xE0\xA0\x80", b"\xED\x9F\xBF", b"\xED\xA0\x80",
    b"\xF0\x8F\xBF\xBF", b"\xF0\x90\x80\x80", b"\xF4\x8F\xBF\xBF", b"\xF4\x90\x80\x80",
    b"\xF5\x80\x80\x80", b"\xFF", b"ok\xC3", b"ok\xE2\x82", "ab€cd".encode()[:-1],
    b"\xC3\xA9" * 50,
]
UTF8_POOL = ("xyz".encode(), "é".encode(), "€".encode(), "🎉".encode(),
             b"\xC3", b"\x80", b"\xED\xA0\x80", b"\xF4\x90\x80\x80")


def _jax_pair(buf: bytes) -> list:
    """The JAX pass over a zero-padded (rows, 128) mirror, as ``Str`` makes."""
    arr = np.zeros(max(-(-(len(buf) + 1) // 128), 1) * 128, np.uint8)
    arr[: len(buf)] = np.frombuffer(buf, np.uint8)
    return np.asarray(_validate_count_raw(jnp.asarray(arr.reshape(-1, 128)), len(buf)))[0].tolist()


def _port_pair(buf: bytes, tail: int = 16) -> list:
    mirror = torch.full((len(buf) + tail,), 0xBF, dtype=torch.uint8)  # junk past n
    mirror[: len(buf)] = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    out = validate_count_raw(mirror, len(buf))
    assert out.dtype == torch.int64 and out.shape == (2,)
    return out.tolist()


def _decodes(buf: bytes) -> bool:
    try:
        buf.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def test_validate_count_matches_jax_on_cases_and_fuzz():
    rng = _rng(7)
    fuzz = [b"".join(UTF8_POOL[int(i)] for i in rng.integers(0, len(UTF8_POOL), int(m)))
            for m in rng.integers(0, 12, 60)]
    for buf in UTF8_CASES + fuzz:
        got = _port_pair(buf)
        assert got == _jax_pair(buf), buf
        assert (got[0] == 0) == _decodes(buf), buf
        if got[0] == 0:
            assert got[1] == len(buf.decode("utf-8"))
        valid, count = validate_count_device(torch.from_numpy(
            np.frombuffer(buf + bytes(4), np.uint8).copy()), len(buf))
        assert (valid, count) == (got[0] == 0, got[1])


def test_validate_count_matches_jax_over_several_blocks():
    """More than one 128 KiB JAX block, with violations at its block and
    halo edges and a lead cut off at the very end."""
    rng = _rng(8)
    text = "".join(rng.choice(list("aé€🎉ж"), 60000)).encode()
    assert len(text) > 128 * 1024
    buf = bytearray(text)
    for at in (0, 131071, 131072, 131073, 4095, 4096, len(buf) - 1):
        buf[at] = 0x80
    for buf_ in (text, bytes(buf), text + b"\xF0\x9F"):
        assert _port_pair(buf_) == _jax_pair(buf_)


def test_validate_count_cpu_counts_no_launch_and_checks_inputs():
    before = dict(utf8_device.KERNEL_LAUNCHES)
    assert _port_pair(b"abc") == [0, 3]
    assert utf8_device.KERNEL_LAUNCHES == before
    with pytest.raises(TypeError):
        validate_count_raw(torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        validate_count_raw(torch.zeros(4, dtype=torch.uint8), 5)


@pytest.mark.parametrize("fn", ["find", "rfind", "count", "count_overlap", "find_byte",
                                "rfind_byte", "count_byte", "find_byteset", "rfind_byteset"])
def test_ops_find_matches_jax(fn):
    rng = _rng(sum(map(ord, fn)))
    for _ in range(12):
        n = int(rng.integers(0, 300))
        hay = rng.integers(97, 100, n).astype(np.uint8).tobytes()
        k = int(rng.integers(0, 6))
        start = int(rng.integers(0, max(n - k, 0) + 1))
        needle = hay[start: start + k] if rng.random() < 0.6 else bytes(rng.integers(97, 100, k).astype(np.uint8))
        byte = int(rng.integers(96, 100))
        charset = bytes(rng.integers(96, 100, int(rng.integers(0, 3))).astype(np.uint8))
        args = {"find": (hay, needle), "rfind": (hay, needle), "count": (hay, needle),
                "count_overlap": (hay, needle), "find_byte": (hay, byte),
                "rfind_byte": (hay, byte), "count_byte": (hay, byte),
                "find_byteset": (hay, charset), "rfind_byteset": (hay, charset)}[fn]
        if fn == "count":
            got = port_find.count(*args, allowoverlap=False, device="cpu")
            want = jax_find.count(*args, allowoverlap=False)
        elif fn == "count_overlap":
            got = port_find.count(*args, device="cpu")
            want = jax_find.count(*args)
        else:
            got = getattr(port_find, fn)(*args, device="cpu")
            want = getattr(jax_find, fn)(*args)
        assert got == want, (fn, hay, args[1])
    # a long needle and a tensor haystack
    hay = rng.integers(97, 99, 3000).astype(np.uint8)
    needle = hay[2000:2100].tobytes()
    t = torch.from_numpy(hay)
    assert port_find.find(t, needle) == jax_find.find(hay.tobytes(), needle)
    assert port_find.rfind(t, needle) == jax_find.rfind(hay.tobytes(), needle)
    assert port_find.count(t, needle) == jax_find.count(hay.tobytes(), needle)
