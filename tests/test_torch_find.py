"""The port's search and UTF-8 validation on CPU tensors (their plain PyTorch
versions) against the JAX package: ``search_positions`` / ``find_long``
against ``find_pallas`` in the Pallas interpreter, ``validate_count_raw``
against ``_validate_count_raw``, and the port's ``ops.find`` against the JAX
``ops.find``, on the same numpy-seeded bytes. The search kernel's own
algorithm (tiles with a halo, a filter on ``filter_offsets``' offsets,
verification of every needle byte) is held through ``kernel_model``, a
numpy model of ``csrc/find.cu``, against the plain version and the JAX
package. Tolerance: exact equality of every integer result."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops import find as jax_find  # noqa: E402
from stringzilla_tpu.ops import find_pallas as jax_fp  # noqa: E402
from stringzilla_tpu.ops.utf8_device import _validate_count_raw  # noqa: E402
from stringzilla_tpu_torch.ops import find as port_find  # noqa: E402
from stringzilla_tpu_torch.ops import find_kernel, utf8_device  # noqa: E402
from stringzilla_tpu_torch.ops.find_kernel import (  # noqa: E402
    find_long,
    filter_offsets,
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


# -- the search kernel's algorithm: filter_offsets and a model of csrc/find.cu --

def _funnel_r(lo, hi, r):
    """``__funnelshift_r(lo, hi, r)`` on uint32 arrays, r a multiple of 8 below 32."""
    if r == 0:
        return lo
    return ((lo >> np.uint32(r)) | (hi << np.uint32(32 - r))).astype(np.uint32)


def kernel_model(hay, n, mode, needle=None, words=None, lo=0, hi=None, offsets=None,
                 tile=find_kernel.TILE_POSITIONS, halo=find_kernel.HALO_BYTES, seed=0):
    """``csrc/find.cu``'s search in numpy: tile t holds bytes [at, at + avail)
    of the haystack, at = base + t * tile, in a stage of tile + halo bytes
    whose other bytes are whatever a stage held before (random here); its
    positions start at at - lead. Each 4-byte word of a tile ANDs one
    inexact zero-byte test a filter offset (the word at that offset
    funnel-shifted into place); flagged positions in [lo, hi] are verified
    byte by byte, from the stage while it holds them and from the haystack
    past it. Returns the kernel's answer as an int."""
    hay = np.asarray(hay, np.uint8)
    k = 1 if needle is None else len(needle)
    lo = max(int(lo), 0)
    hi = n - k if hi is None else min(int(hi), n - k)
    if hi < lo:
        return 0 if mode == "count" else -1
    rng = np.random.default_rng(seed)
    if needle is not None:
        needle = np.frombuffer(bytes(needle), np.uint8)
        offsets = filter_offsets(needle) if offsets is None else offsets
        lead = offsets[0]
        deltas = [o - lead for o in offsets]
        pats = [np.uint32(0x01010101 * int(needle[o])) for o in offsets]
    else:
        lead = 0
        table = find_kernel._byteset_table(np.asarray(words, np.uint32))
    base = (lo + lead) & ~15
    tiles = (hi + lead - base) // tile + 1
    hits = []
    for t in range(tiles):
        at = base + t * tile
        avail = min(tile + halo, n - at)
        stage = rng.integers(0, 256, tile + halo, dtype=np.uint8)
        stage[:avail] = hay[at: at + avail]
        S = stage.view("<u4")
        u = np.arange(tile // 4)
        if needle is None:
            flagged = table[stage[:tile].reshape(-1, 4)]
        else:
            ones = np.uint32(0x01010101)
            y = S[u] ^ pats[0]
            acc = (y - ones) & ~y
            for d, pat in zip(deltas[1:], pats[1:]):
                w, r = d // 4, 8 * (d % 4)
                y = _funnel_r(S[u + w], S[u + w + 1], r) ^ pat
                acc &= (y - ones) & ~y
            flagged = ((acc[:, None] >> (8 * np.arange(4, dtype=np.uint32) + 7)) & 1).astype(bool)
        for uq, s in zip(*np.nonzero(flagged)):
            p = at - lead + 4 * int(uq) + int(s)
            if p < lo or p > hi:
                continue
            if needle is not None:
                rel = p - at + np.arange(k)
                inside = (rel >= 0) & (rel < avail)
                got = np.where(inside, stage[np.clip(rel, 0, tile + halo - 1)],
                               hay[np.minimum(p + np.arange(k), n - 1)])
                if not np.array_equal(got, needle):
                    continue
            hits.append(p)
    if mode == "count":
        return len(hits)
    if not hits:
        return -1
    return min(hits) if mode == "first" else max(hits)


# the filter's plans the tests hold the kernel model under: the kernel's
# own, and the first and last reachable byte
PLANS = {"rarest": filter_offsets,
         "first and last": lambda nd: tuple(sorted({0, min(len(nd) - 1, find_kernel.REACH)}))}


@pytest.mark.parametrize("count", [2, 3, 4])
@settings(max_examples=150, deadline=None)
@given(needle=st.binary(min_size=1, max_size=300))
def test_filter_offsets_properties(count, needle):
    """Deterministic, ascending and distinct, within [0, k) and the halo's
    reach, the last reachable byte always among them, FILTER_OFFSETS of
    them (fewer only for a shorter needle), distinct values while the
    reachable bytes have them."""
    saved, find_kernel.FILTER_OFFSETS = find_kernel.FILTER_OFFSETS, count
    try:
        got = filter_offsets(needle)
        assert got == filter_offsets(bytes(needle)) == filter_offsets(
            np.frombuffer(needle, np.uint8))
    finally:
        find_kernel.FILTER_OFFSETS = saved
    k = len(needle)
    last = min(k - 1, find_kernel.REACH)
    assert list(got) == sorted(set(got))
    assert got[0] >= 0 and got[-1] == last and got[-1] - got[0] <= find_kernel.REACH
    assert len(got) == min(count, last + 1)
    values = [needle[j] for j in got]
    assert len(set(values)) == min(len(got), len(set(needle[: last + 1])))


def test_filter_offsets_pick_rare_bytes():
    """The plan on the probe needles: a dense ASCII prefix gives way to
    punctuation and digits, a control byte is taken first."""
    assert filter_offsets(b"worker-99 request") == (6, 7, 16)
    assert filter_offsets(b"\x01orker-99 request") == (0, 6, 16)
    assert filter_offsets(b"XqZwV") == (0, 2, 4)
    assert filter_offsets(b"a") == (0,)
    assert filter_offsets(b"aaaa") == (0, 1, 3)
    assert filter_offsets(b"ab") == (0, 1)
    assert filter_offsets(bytes(300))[-1] == find_kernel.REACH
    with pytest.raises(ValueError):
        filter_offsets(b"")


def test_geometry_and_host_args():
    """The geometry the kernel assumes, and the host arguments of a needle
    and of a byteset as the C call reads them."""
    g = find_kernel.GEOMETRY
    assert g[0] == find_kernel.TILE_POSITIONS and g[1] == find_kernel.HALO_BYTES
    assert find_kernel.TILE_POSITIONS % (4 * 256) == 0 and find_kernel.HALO_BYTES % 16 == 0
    assert find_kernel.REACH == find_kernel.HALO_BYTES - 1 < find_kernel.HEAD_BYTES
    assert find_kernel.FILTER_OFFSETS <= find_kernel.MAX_OFFSETS
    needle = bytes(range(40, 240))
    kind, n_off, *_, (head, offsets, words) = find_kernel._host_args(needle, None)
    assert kind == 0 and tuple(offsets[:n_off]) == filter_offsets(needle)
    assert head[:200].tobytes() == needle and not head[200:].any() and not words.any()
    ws = port_find.byteset_mask(b"\x00\xff")
    kind, n_off, *_, (head, offsets, words) = find_kernel._host_args(None, ws.tobytes())
    assert kind == 1 and n_off == 0 and np.array_equal(words, ws) and not head.any()


@pytest.mark.parametrize("tile", [64, find_kernel.TILE_POSITIONS])
@pytest.mark.parametrize("plan", PLANS)
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_kernel_model_matches_plain(plan, tile, data):
    """The kernel's algorithm on drawn haystacks and needles of a small
    alphabet (so that hits and near misses abound), drawn windows and every
    mode: equal to ``search_positions_reference``. Bytes past n are junk."""
    letters = data.draw(st.integers(1, 4))
    n = data.draw(st.integers(0, 700))
    seed = data.draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    hay = np.concatenate([rng.integers(97, 97 + letters, n, dtype=np.uint8),
                          rng.integers(0, 256, 64, dtype=np.uint8)])
    k = data.draw(st.integers(1, 140))
    if n >= k and data.draw(st.booleans()):
        at = data.draw(st.integers(0, n - k))
        needle = hay[at: at + k].copy()
    else:
        needle = rng.integers(97, 97 + letters, k, dtype=np.uint8)
    lo = data.draw(st.integers(-3, n + 2))
    hi = data.draw(st.one_of(st.none(), st.integers(-1, n + 2)))
    mode = data.draw(st.sampled_from(["first", "last", "count"]))
    flat = torch.from_numpy(hay.copy())
    want = int(search_positions_reference(flat, n, mode, needle=needle, lo=lo, hi=hi))
    got = kernel_model(hay, n, mode, needle=needle, lo=lo, hi=hi,
                       offsets=PLANS[plan](needle), tile=tile, seed=seed)
    assert got == want
    if data.draw(st.booleans()):
        words = port_find.byteset_mask(bytes(rng.integers(96, 100, 2, dtype=np.uint8)))
        want = int(search_positions_reference(flat, n, mode, byteset_words=words, lo=lo, hi=hi))
        assert kernel_model(hay, n, mode, words=words, lo=lo, hi=hi, tile=tile,
                            seed=seed) == want


DENSE_KS = list(range(1, 18)) + [130, 5000]


def _dense_hay(needle, planted, salt):
    """Two JAX blocks (less 777 bytes) of lowercase and digits with the
    needle's first min(7, k - 1) bytes about every 90 bytes, each followed
    by a byte the needle does not have there; with ``planted``, the needle
    one byte either side of each tile edge, across each edge and near the
    end. Bytes past n are junk."""
    rng = _rng(salt)
    size = jax_fp.BLOCK_ROWS * 2 * jax_fp.LANES
    n = size - 777
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
    buf = alphabet[rng.integers(0, len(alphabet), size)]
    k = len(needle)
    j = min(7, k - 1)
    if j:
        starts = np.arange(0, n - k - 8, 90) + rng.integers(0, 40, len(range(0, n - k - 8, 90)))
        for i in range(j):
            buf[starts + i] = needle[i]
        buf[starts + j] = needle[j] ^ 0x40
    if planted:
        tile = find_kernel.TILE_POSITIONS
        spots = [n - k - 3] + [p for e in range(tile, n - k, tile)
                               for p in (e - 1, e + 1, e - k // 2 - 1)]
        for p in spots:
            if 0 <= p <= n - k:
                buf[p: p + k] = needle
    buf[n:] = rng.integers(0, 256, size - n)
    return buf, n


def _jax_answer(buf, n, hay2d, mode, needle, lo, hi):
    """The JAX package's exact answer: its Pallas kernel for needles of at
    most 16 bytes, ``find_long`` for longer ones unbounded, its dense XLA
    tier (``ops.find``) on the window for the rest."""
    k = len(needle)
    if k <= jax_fp.MAX_OFFSETS:
        return int(jax_fp.search_positions(hay2d, n, mode, needle=needle, lo=lo,
                                           hi=hi if hi is not None else None))
    if hi is None and lo == 0 and mode != "count":
        return int(jax_fp.find_long(hay2d, n, needle, reverse=mode == "last"))
    hi_ = n - k if hi is None else min(hi, n - k)
    window = buf[lo: hi_ + k].tobytes() if hi_ >= lo else b""
    if mode == "count":
        return jax_find.count(window, needle.tobytes())
    p = (jax_find.find if mode == "first" else jax_find.rfind)(window, needle.tobytes())
    return p + lo if p >= 0 and hi_ >= lo else -1


# the plain version's k shifted compares over m start positions: held only
# where k * m stays under this (a 5,000-byte needle over the whole
# haystack takes minutes on a loaded CPU), on narrow windows past that
PLAIN_COMPARES = 50_000_000


@pytest.mark.parametrize("planted", [False, True], ids=["absent", "planted"])
@pytest.mark.parametrize("k", DENSE_KS)
def test_dense_prefix_matches_jax(k, planted):
    """A needle whose prefix is in every ~90-byte line, absent or planted at
    tile edges, across them and near the end: the kernel model under both
    plans and the JAX package agree in every mode, unbounded and on a
    window that cuts tiles, and so does the plain version, on those windows
    where it is affordable and on narrow ones around the first tile edge
    and the end."""
    rng = _rng(100 + k)
    needle = np.frombuffer(b"worker-" + bytes(rng.integers(97, 123, max(k - 7, 0),
                                                           dtype=np.uint8)), np.uint8)[:k].copy()
    buf, n = _dense_hay(needle, planted, k)
    hay2d = jnp.asarray(buf.reshape(-1, jax_fp.LANES))
    flat = torch.from_numpy(buf.copy())
    tile = find_kernel.TILE_POSITIONS
    windows = [(0, None), (tile - 3, n - tile + 5), (tile - k - 3, tile + 2000),
               (n - k - 2100, None)]
    for lo, hi in windows:
        m = (n - k if hi is None else hi) - lo + 1
        for mode in ("first", "last", "count"):
            want = _jax_answer(buf, n, hay2d, mode, needle, lo, hi)
            if k * m <= PLAIN_COMPARES:
                got = int(search_positions(flat, n, mode, needle=needle, lo=lo, hi=hi))
                assert got == want, (mode, lo, hi)
            for plan, offsets in PLANS.items():
                assert kernel_model(buf, n, mode, needle=needle, lo=lo, hi=hi,
                                    offsets=offsets(needle)) == want, (mode, lo, hi, plan)
    if planted and k <= 130:
        assert int(search_positions(flat, n, "count", needle=needle)) > 0
