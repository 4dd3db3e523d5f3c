"""A numpy model of ``csrc/utf8.cu``'s UTF-8 pass, op for op, with the
masks and geometry of ``stringzilla_tpu_torch.ops.utf8_device``, held
against the plain version ``validate_count_reference`` position by position
and against the JAX ``_validate_count_raw`` (Pallas interpreter) on a
seeded sample. The model cuts a buffer as the kernel does (``launch_plan``:
a head before the first 16-byte aligned byte, groups of rows of 32
vectors, the last rows), takes each main row's branches as the warp does
(an all-ASCII row skipped, the >= F0 classes only in a row that holds such
a byte) and steps each vector word by word as ``vector_step`` does. The
masks are ``MASKS``, the ones the wrapper passes to the kernel.
Tolerance: exact equality of every flag and count."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops.utf8_device import _validate_count_raw  # noqa: E402
from stringzilla_tpu_torch.ops import utf8_device as U  # noqa: E402
from stringzilla_tpu_torch.ops.utf8_device import (  # noqa: E402
    launch_plan,
    validate_count_raw,
    validate_count_reference,
)

M32 = np.uint32(0xFFFFFFFF)


def _u(x):
    return np.uint32(x)


def _shl(x, k):
    return (x << np.uint32(k)) & M32


def _shr(x, k):
    return x >> np.uint32(k)


def _funnel(lo, hi, k):
    """``__funnelshift_l(lo, hi, k)``: the high word of (hi:lo) << k."""
    return _shl(hi, k) | _shr(lo, 32 - k)


def _ranks(w):
    a = w & _shl(w, 1)
    b = a & _shl(a, 1)
    return a, b, b & _shl(a, 2)


def _classify(w, four):
    """``classify<kFour>`` on arrays of words; ``four`` a bool array (one
    value a vector, broadcast over its words)."""
    a, b, c = _ranks(w)
    cont = w & ~_shl(w, 1) & _u(U.HIGH)
    x7 = w & _u(U.LOW7)
    keep = np.where(four, ~(c & (x7 + _u(U.GE_F5))), M32)
    l1 = a & (x7 + _u(U.GE_C2)) & keep
    l2 = b & keep
    l3 = np.where(four, c, _u(0)) & keep
    return cont, l1, l2, l3, a & ~l1 & _u(U.HIGH)


def _after_three(a1, w):
    forbid = (_shr(w, 5) & _u(U.ONES)) * _u(U.E_STEP) + _u(U.LEAD_E)
    return (a1 ^ forbid) & _u(U.LOW7)


def _after_four(a1, w):
    above = (_shr(w, 4) & _u(U.BITS_54)) + _u(U.BITS_54)
    return (a1 ^ (above & _u(U.F_STEP)) ^ _u(U.LEAD_F)) & _u(U.LOW7)


def _vector_step(prev, w, four):
    """``vector_step<kFour>`` on V vectors: prev (V,), w (V, 4), four (V,).
    Returns the error and continuation masks (V, 4), bit 7 of each byte a
    flag."""
    _, p1, p2, p3, _ = _classify(prev, four)
    errs, conts = [], []
    for t in range(4):
        cont, l1, l2, l3, bad = _classify(w[:, t], four)
        must = _funnel(p1, l1, 8) | _funnel(p2, l2, 16) | _funnel(p3, l3, 24)
        a1 = _funnel(prev, w[:, t], 8)
        ok = _after_three(a1, w[:, t]) + _u(U.LOW7)
        ok = np.where(four, ok & (_after_four(a1, w[:, t]) + _u(U.LOW7)), ok)
        errs.append(((cont ^ must) & _u(U.HIGH)) | bad | (~ok & a1 & cont))
        conts.append(cont)
        prev, p1, p2, p3 = w[:, t], l1, l2, l3
    return np.stack(errs, 1), np.stack(conts, 1)


def _words(ext, lo, starts):
    """Little-endian words at byte positions ``starts`` (an array, relative
    to the buffer) of ``ext``, which holds the buffer at offset ``lo``."""
    idx = starts[:, None] + lo + np.arange(4)
    b = ext[idx].astype(np.uint32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def model(buf: bytes, address: int = 0):
    """The kernel's pass over ``buf`` at ``address`` (only ``address % 16``
    matters). Returns (flags, conts, violations, runes): per-position
    violation and continuation flags over [-16, n + 19), index 0 = position
    -16, and the two counts as the kernel sums them."""
    n = len(buf)
    plan = launch_plan(n, address)
    head, groups, tail = plan["head"], plan["groups"], plan["tail"]
    lo = 32
    ext = np.zeros(n + 2 * lo + U.ROW_BYTES * 8, np.uint8)
    ext[lo: lo + n] = np.frombuffer(buf, np.uint8)
    flags = np.zeros(n + 35, bool)
    cflags = np.zeros(n + 35, bool)
    viol = conts = 0

    def run(starts, four):
        nonlocal viol, conts
        w = np.stack([_words(ext, lo, starts + 4 * t) for t in range(4)], 1)
        prev = _words(ext, lo, starts - 4)
        e, c = _vector_step(prev, w, four)
        viol += sum(int(np.bitwise_count(x).sum()) for x in (
            e[:, 0] | _shr(e[:, 1], 1) | _shr(e[:, 2], 2) | _shr(e[:, 3], 3),))
        conts += int(np.bitwise_count(c[:, 0] | _shr(c[:, 1], 1) | _shr(c[:, 2], 2)
                                      | _shr(c[:, 3], 3)).sum())
        for t in range(4):
            for k in range(4):
                at = starts + 4 * t + k + 16
                flags[at] |= ((e[:, t] >> np.uint32(8 * k + 7)) & 1).astype(bool)
                cflags[at] |= ((c[:, t] >> np.uint32(8 * k + 7)) & 1).astype(bool)

    # main rows: every lane a full aligned vector; a row's branches are the warp's
    vec = head + U.VECTOR_BYTES * np.arange(groups * U.GROUP_BYTES // U.VECTOR_BYTES)
    if len(vec):
        w = np.stack([_words(ext, lo, vec + 4 * t) for t in range(4)], 1)
        prev = _words(ext, lo, vec - 4)
        high = ((w[:, 0] | w[:, 1] | w[:, 2] | w[:, 3] | (prev & _u(U.NOT_FIRST)))
                & _u(U.HIGH)) != 0
        four = (np.bitwise_or.reduce(np.stack([_ranks(x)[2] for x in (*w.T, prev)]), 0)
                & _u(U.HIGH)) != 0
        rows = len(vec) // 32
        row_high = high.reshape(rows, 32).any(1).repeat(32)
        row_four = four.reshape(rows, 32).any(1).repeat(32)
        run(vec[row_high], row_four[row_high])
    # the last warp's edge rows: the head, then [tail, n + 3), every vector
    # with the >= F0 classes
    edges = []
    if head > 0:
        edges.append(np.array([head - U.VECTOR_BYTES]))
    edges.append(np.arange(tail, n + 3, U.VECTOR_BYTES))
    for starts in edges:
        run(starts, np.ones(len(starts), bool))
    return flags, cflags, viol, n - conts


def reference_flags(buf: bytes):
    """The plain version's classification, position by position over [-16,
    n + 19): (violation flags, continuation flags)."""
    n = len(buf)
    ext = np.zeros(n + 22, np.int64)
    ext[3: 3 + n] = np.frombuffer(buf, np.uint8)
    b, p1, p2, p3 = ext[3:], ext[2:-1], ext[1:-2], ext[:-3]
    inside = np.arange(len(b)) < n

    def lead2(x):
        return (x >= 0xC2) & (x <= 0xDF)

    def lead3(x):
        return (x & 0xF0) == 0xE0

    def lead4(x):
        return (x >= 0xF0) & (x <= 0xF4)

    cont = (b & 0xC0) == 0x80
    bad_lead = (b >= 0x80) & ~cont & ~lead2(b) & ~lead3(b) & ~lead4(b)
    must = lead2(p1) | lead3(p1) | lead4(p1) | lead3(p2) | lead4(p2) | lead4(p3)
    bad_range = cont & (((p1 == 0xE0) & (b < 0xA0)) | ((p1 == 0xED) & (b >= 0xA0))
                        | ((p1 == 0xF0) & (b < 0x90)) | ((p1 == 0xF4) & (b >= 0x90)))
    viol = ((bad_lead | bad_range) & inside) | (cont != must)
    out_v, out_c = np.zeros(n + 35, bool), np.zeros(n + 35, bool)
    out_v[16: 16 + len(b)] = viol
    out_c[16: 16 + len(b)] = cont & inside
    return out_v, out_c


def _held(buf: bytes, address: int = 0):
    """The model against the plain version: every position's flags and both
    counts; returns the counts."""
    flags, cflags, viol, runes = model(buf, address)
    want_v, want_c = reference_flags(buf)
    bad = np.flatnonzero(flags != want_v)
    assert not len(bad), f"flags differ at positions {(bad[:8] - 16).tolist()} (address {address})"
    assert np.array_equal(cflags, want_c)
    mirror = torch.from_numpy(np.frombuffer(buf + bytes(16), np.uint8).copy())
    want = validate_count_reference(mirror, len(buf)).tolist()
    assert [viol, runes] == want, (viol, runes, want)
    return viol, runes


CLASS_BYTES = [0x00, 0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0, 0xC1, 0xC2, 0xDF, 0xE0,
               0xE1, 0xEC, 0xED, 0xEE, 0xEF, 0xF0, 0xF1, 0xF3, 0xF4, 0xF5, 0xFF]
BELOW_F0 = [b for b in CLASS_BYTES if b < 0xF0]


@pytest.mark.parametrize("high", range(16))
def test_every_byte_pair_after_ascii_before_continuations(high):
    """Every 2-byte sequence (x, y) with x's high nibble ``high``, each as
    'a' x y 80 80 80 'b': 7 bytes a case, so pairs fall at every offset of a
    vector, row and group; the buffer at address ``high``."""
    x = np.repeat(np.arange(16 * high, 16 * high + 16), 256)
    y = np.tile(np.arange(256), 16)
    cases = np.zeros((len(x), 7), np.uint8)
    cases[:, 0], cases[:, 1], cases[:, 2] = ord("a"), x, y
    cases[:, 3:6], cases[:, 6] = 0x80, ord("b")
    _held(cases.tobytes(), address=high)


def _windows(first, alphabet):
    rest = np.array(np.meshgrid(alphabet, alphabet, alphabet, indexing="ij")).reshape(3, -1).T
    cases = np.zeros((len(rest), 5), np.uint8)
    cases[:, 0], cases[:, 1:4], cases[:, 4] = first, rest, ord("a")
    return cases.tobytes()


@pytest.mark.parametrize("first", CLASS_BYTES)
def test_class_windows(first):
    """Every 4-byte window over the class-representative bytes that starts
    with ``first``, each followed by 'a' (5 bytes a case)."""
    _held(_windows(first, CLASS_BYTES), address=first % 16)


@pytest.mark.parametrize("first", BELOW_F0)
def test_class_windows_below_f0(first):
    """The same over the classes below F0 only, so the main rows take the
    branch without the >= F0 classes."""
    buf = _windows(first, BELOW_F0)
    assert max(buf) < 0xF0
    _held(buf)


CUT_LEADS = ["é", "€", "\U0001f389", "퟿", "ࠀ", "\U00010000", "\U0010ffff"]


@pytest.mark.parametrize("rune", CUT_LEADS)
@pytest.mark.parametrize("cut", [1, 2, 3])
@pytest.mark.parametrize("ascii_len", [0, 13, 2045, 2047, 2 * 2048 + 511])
def test_lead_cut_off_before_n(rune, cut, ascii_len):
    """A buffer of ASCII that ends in a rune with its last 1-3 bytes cut off
    (the whole rune when it has fewer), at aligned and unaligned addresses:
    the structure check must count the missing continuations past n."""
    enc = rune.encode("utf-8", "surrogatepass")
    buf = b"x" * ascii_len + enc[: max(len(enc) - cut, 0)]
    for address in (0, 1, 7, 15):
        viol, _ = _held(buf, address)
        assert viol == (0 if cut >= len(enc) else cut)


EDGES = {"vector": U.VECTOR_BYTES, "row": U.ROW_BYTES, "group": U.GROUP_BYTES, "cta": U.CTA_BYTES}
TAILS = {"lead2": b"\xC3", "lead3": b"\xE2\x82", "lead4": b"\xF0\x9F\x8E", "bad": b"\xFF",
         "overlong": b"\xE0\x80", "cont": b"\x80", "lone3": b"\xE2", "lone4": b"\xF0",
         "bad4": b"\xF8\x88\x80\x80", "c0": b"\xC0\x80"}


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("tail", list(TAILS))
def test_ascii_runs_with_a_lead_at_span_ends(edge, tail):
    """ASCII with a multi-byte lead or a violation in the last 1-3 bytes of
    every vector, row, group or CTA span (relative to the aligned start),
    then the rune's continuations: the look-back of the next span's first
    vector, which the ASCII branch must not skip."""
    span, piece = EDGES[edge], TAILS[tail]
    for address in (0, 5):
        head = (16 - address) % 16
        buf = bytearray(b"y" * (head + 3 * max(span, 4096) + 100))
        for i, end in enumerate(range(head + span, len(buf) - 8, span)):
            at = end - 1 - i % 3  # the last 1, 2 or 3 bytes of the span
            buf[at: at + len(piece)] = piece
        _held(bytes(buf), address)


def _jax_pair(buf: bytes) -> list:
    """The JAX pass over a zero-padded (rows, 128) mirror, as ``Str`` makes."""
    arr = np.zeros(max(-(-(len(buf) + 1) // 128), 1) * 128, np.uint8)
    arr[: len(buf)] = np.frombuffer(buf, np.uint8)
    return np.asarray(_validate_count_raw(jnp.asarray(arr.reshape(-1, 128)), len(buf)))[0].tolist()


POOL = ("xyz".encode(), "é".encode(), "€".encode(), "中文".encode(), "🎉".encode(), b"\xC3",
        b"\x80", b"\xED\xA0\x80", b"\xF4\x90\x80\x80", b"\xE0\x9F\xBF", b"\xC1\xBF", b"\xF5")


@pytest.mark.parametrize("seed", range(4))
def test_model_matches_jax_on_a_sample(seed):
    """Seeded buffers of valid and broken pieces, 2-9 KiB: the model, the
    plain version and the JAX pass agree on both counts."""
    rng = np.random.default_rng(900 + seed)
    buf = b"".join(POOL[int(i)] for i in rng.integers(0, len(POOL), int(rng.integers(600, 3000))))
    got = _held(buf, address=int(rng.integers(0, 16)))
    assert list(got) == _jax_pair(buf)
    assert validate_count_raw(torch.from_numpy(np.frombuffer(buf, np.uint8).copy()),
                              len(buf)).tolist() == list(got)


def test_launch_plan_covers_every_position():
    """The head, the groups and the tail cover [0, n + 3) once, at every
    address; the grid stride is a full grid's groups."""
    for n in (0, 1, 15, 16, 17, U.GROUP_BYTES - 1, U.GROUP_BYTES, U.GROUP_BYTES + 15,
              5 * U.CTA_BYTES + 3, 1 << 28):
        for address in range(16):
            plan = launch_plan(n, address)
            assert 0 <= plan["head"] <= min(15, n)
            assert (address + plan["head"]) % 16 == 0 or plan["head"] == n
            assert plan["tail"] == plan["head"] + plan["groups"] * U.GROUP_BYTES <= n
            assert n - plan["tail"] < U.GROUP_BYTES + 16
    assert U.grid_stride(132) == 132 * U.BLOCKS_PER_SM * U.WARPS * U.UNROLL * 512


def test_masks_follow_the_kernels_struct():
    """``MASKS`` holds the module's named masks in the order of the fields of
    ``csrc/utf8.cu``'s ``struct Masks``, which the kernel reads them into."""
    path = os.path.join(os.path.dirname(U.__file__), os.pardir, "csrc", "utf8.cu")
    with open(path) as f:
        body = re.search(r"struct Masks \{(.*?)\};", f.read(), re.S).group(1)
    fields = re.findall(r"uint32_t (\w+);", body)
    assert len(fields) == len(U.MASKS) == U.GEOMETRY[-1]
    assert [getattr(U, name.upper()) for name in fields] == list(U.MASKS)
