"""The port's hash and AES kernels' wrappers (``ops.hash_kernel``,
``ops.aes_kernel``) on the CPU, where they run their plain PyTorch versions,
against the JAX package's Pallas kernels in interpret mode
(``hash_pallas.hash_batch_device``, ``hash_bounds_device``,
``aes_pallas.fill_random_device``) on the same numpy-seeded bytes, and
against the host ``sz_hash`` and the golden vectors generated from the
reference's serial build. Interpret mode is slow, so each JAX kernel runs
once a set, in a module fixture. Tolerance: exact equality of every 64-bit
digest and byte."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu.ops import aes_pallas as jax_aes  # noqa: E402
from stringzilla_tpu.ops import hash as jax_host_hash  # noqa: E402
from stringzilla_tpu.ops import hash_pallas as jax_hash_pallas  # noqa: E402
from stringzilla_tpu_torch.ops import aes_kernel, hash_kernel  # noqa: E402
from stringzilla_tpu_torch.ops import hash as port_hash  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hash_vectors.json")
CPU = torch.device("cpu")


def _rng(salt=0):
    return np.random.default_rng(42 + salt)


def _items(salt, lengths):
    rng = _rng(salt)
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in lengths]


# The item sets of tests/test_hash_batch_segment.py's device-kernel tests:
# 100 tokens of 0-64 bytes at seed 42, and long strings at seed 9 (here the
# lengths of its first two chunk-count buckets, 65-192 bytes, since each
# bucket costs the interpreter ~12 s).
SETS = {
    "short": (42, _items(1, _rng(2).integers(0, 65, 100))),
    "long": (9, _items(3, [65, 100, 127, 128, 129, 191, 192])),
}
# ``hash_long_wide``'s ring of P = 32 chunks (csrc/hash.cu kPrefetch): the
# strings it takes (from WIDE_BYTES on) of mP - 1, mP and mP + 1 full
# chunks, and 1 or 64 bytes more, end a ring group short of, at and one past
# its loop's bound.
P = 32
_M0 = hash_kernel.WIDE_BYTES // (64 * P)
PREFETCH_EDGES = [64 * f + d for m in range(_M0, _M0 + 4)
                  for f in (m * P - 1, m * P, m * P + 1)
                  for d in (1, 64) if 64 * f + d >= hash_kernel.WIDE_BYTES][:12]


@pytest.fixture(scope="module")
def jax_digests():
    return {name: jax_hash_pallas.hash_batch_device(items, seed)
            for name, (seed, items) in SETS.items()}


@pytest.mark.parametrize("name", sorted(SETS))
def test_hash_batch_device_matches_jax(jax_digests, name):
    seed, items = SETS[name]
    got = hash_kernel.hash_batch_device(items, seed, device="cpu")
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jax_digests[name])
    assert hash_kernel.KERNEL_LAUNCHES == {"hash_short": 0, "hash_long": 0,
                                           "hash_long_wide": 0}


# Every length of both paths and the deferred-block edges, 64k - 1, 64k and
# 64k + 1; seeds where seed + length carries into the high word.
EDGE_LENGTHS = list(range(0, 301)) + [64 * k + d for k in range(5, 9) for d in (-1, 0, 1)]


@pytest.mark.parametrize("seed", [0, 2**63 + 9, 2**64 - 1])
def test_hash_batch_device_matches_host(seed):
    items = _items(4, EDGE_LENGTHS)
    got = hash_kernel.hash_batch_device(items, seed, device="cpu")
    want = np.array([port_hash.sz_hash(s, seed) for s in items], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def spans():
    """Spans of one buffer, overlapping and at odd offsets: 70% of 0-16
    bytes, the rest of 65-128 (one bucket a path for the interpreter)."""
    rng = _rng(5)
    buf = rng.integers(0, 256, 3000, dtype=np.uint8)
    starts = rng.integers(0, 2000, 200)
    ends = starts + np.where(rng.random(200) < 0.7, rng.integers(0, 17, 200),
                             rng.integers(65, 129, 200))
    return buf, starts, ends, jax_hash_pallas.hash_bounds_device(buf, starts, ends, 5)


def test_hash_bounds_device_matches_jax(spans):
    buf, starts, ends, want = spans
    np.testing.assert_array_equal(hash_kernel.hash_bounds_device(buf, starts, ends, 5,
                                                                 device="cpu"), want)
    # a buffer already on the device is read where it lies, at its offsets
    mirror = torch.from_numpy(np.concatenate([buf, np.zeros(16, np.uint8)]))
    np.testing.assert_array_equal(hash_kernel.hash_bounds_device(mirror, starts, ends, 5), want)


@pytest.mark.parametrize("length,nonce", [(1, 0), (16, 5), (100, 7), (5000, 123456789),
                                          (40000, 2**63 + 9), (4000, 2**64 - 3)])
def test_fill_random_device_matches_jax(length, nonce):
    got = aes_kernel.fill_random_device(length, nonce, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (length,)
    want = np.asarray(jax_aes.fill_random_device(length, nonce))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bytes(got.numpy()) == port_hash.fill_random(length, nonce)
    assert aes_kernel.KERNEL_LAUNCHES == {"fill_random": 0}


def test_golden_vectors_through_the_plain_versions():
    with open(GOLDEN) as f:
        vectors = json.load(f)
    data = torch.from_numpy(np.frombuffer(bytes(vectors["input"]), np.uint8).copy())
    for length, seed, expected in vectors["hash"]:
        starts = torch.zeros(1, dtype=torch.int64)
        lengths = torch.full((1,), length, dtype=torch.int64)
        plain = (hash_kernel.hash_short_reference if length <= hash_kernel.SHORT_MAX
                 else hash_kernel.hash_long_reference)
        got = plain(data, starts, lengths, int(seed))
        assert int(got[0]) & (2**64 - 1) == int(expected), (length, seed)
    for length, nonce, expected in vectors["fill_random"]:
        got = aes_kernel.fill_random_reference(length, int(nonce), device="cpu")
        assert got.tolist() == expected, (length, nonce)


def test_aes_round_matches_host_aesenc():
    rng = _rng(6)
    state = rng.integers(0, 256, (3, 5, 16), dtype=np.uint8)
    key = rng.integers(0, 256, (3, 5, 16), dtype=np.uint8)
    got = aes_kernel.aes_round(torch.from_numpy(state), torch.from_numpy(key))
    np.testing.assert_array_equal(got.numpy(), port_hash.aesenc(state, key))


def test_each_path_writes_only_its_own_strings():
    """``hash_short`` and ``hash_long`` leave the other path's entries as
    they find them; ``hash_tokens_raw`` runs the kernels asked for."""
    items = _items(7, [0, 5, 64, 65, 200, 17])
    blob = torch.from_numpy(np.frombuffer(b"".join(items) + b"\0", np.uint8).copy())
    lengths = torch.tensor([len(s) for s in items], dtype=torch.int64)
    starts = torch.cumsum(lengths, 0) - lengths
    want = np.array([port_hash.sz_hash(s, 3) for s in items], np.uint64).view(np.int64)
    is_short = lengths <= 64
    out = torch.full((6,), -7, dtype=torch.int64)
    hash_kernel.hash_short(blob, starts, lengths, 3, out)
    np.testing.assert_array_equal(out.numpy(), np.where(is_short.numpy(), want, -7))
    hash_kernel.hash_long(blob, starts, lengths, 3, out)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(hash_kernel.hash_tokens_raw(blob, starts, lengths, 3).numpy(),
                                  want)
    only_long = hash_kernel.hash_tokens_raw(blob, starts, lengths, 3, short=False)
    np.testing.assert_array_equal(only_long.numpy(), np.where(is_short.numpy(), 0, want))
    assert hash_kernel.KERNEL_LAUNCHES == {"hash_short": 0, "hash_long": 0,
                                           "hash_long_wide": 0}


def test_hash_long_device():
    items = _items(8, [65, 128, 129, 1000])
    want = np.array([port_hash.sz_hash(s, 11) for s in items], np.uint64)
    np.testing.assert_array_equal(hash_kernel.hash_long_device(items, 11, device="cpu"), want)
    with pytest.raises(ValueError, match="over 64 bytes"):
        hash_kernel.hash_long_device([b"short"], 0, device="cpu")


@pytest.mark.parametrize("seed", [11, 2**64 - 1])
def test_hash_long_at_the_prefetch_edges_matches_jax(seed):
    """Strings of P - 1, P and P + 1 full chunks at odd offsets in one blob,
    against the JAX package's hash (its host ``hash_batch``: the Pallas
    kernel in interpret mode takes minutes a bucket at these lengths) and
    this package's host hash."""
    items = _items(9, PREFETCH_EDGES + PREFETCH_EDGES[::-1])
    got = hash_kernel.hash_batch_device(items, seed, device="cpu")
    np.testing.assert_array_equal(got, jax_host_hash.hash_batch(items, seed))
    np.testing.assert_array_equal(got, port_hash.hash_batch(items, seed))


@pytest.mark.parametrize("length", PREFETCH_EDGES + [65, 128, 129])
@pytest.mark.parametrize("skew", [0, 1, 3])
def test_hash_long_on_a_string_that_ends_at_the_blobs_last_byte(length, skew):
    """A string whose last byte is the blob's last, in a blob that starts
    ``skew`` bytes past a 4-byte boundary: the bytes past it are never part
    of the digest."""
    data = _items(10 + skew, [length])[0]
    whole = torch.full((length + skew + 8,), 0xA5, dtype=torch.uint8)
    blob = whole[skew: skew + length]
    blob.copy_(torch.from_numpy(np.frombuffer(data, np.uint8).copy()))
    starts = torch.zeros(1, dtype=torch.int64)
    lengths = torch.full((1,), length, dtype=torch.int64)
    got = hash_kernel.hash_long(blob, starts, lengths, 13)
    assert int(got[0]) & (2**64 - 1) == port_hash.sz_hash(data, 13)
    assert hash_kernel.KERNEL_LAUNCHES == {"hash_short": 0, "hash_long": 0,
                                           "hash_long_wide": 0}


SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("count,kernel,want", [
    (1001, "hash_long_wide", (256, 126)),   # the documents: a warp each
    (2_890_000, "hash_long", (256, 1056)),  # a log's lines: a quad each, 8 CTAs an SM
    (1, "hash_long_wide", (32, 1)),         # one long string: one warp
    (1, "hash_long", (32, 1)),
    (5000, "hash_long", (160, 125)),        # 20,000 quad threads over 125 SMs
    (33, "hash_long_wide", (32, 33)),       # 33 long strings, a warp on each of 33 SMs
])
def test_hash_long_plan(count, kernel, want):
    assert hash_kernel.hash_long_plan(count, SMS, kernel) == want


@pytest.mark.parametrize("count", [1, 7, 8, 33, 132, 1000, 1001, 4224, 4225, 8449, 10**5, 10**7])
@pytest.mark.parametrize("sms", [1, 2, 132])
@pytest.mark.parametrize("kernel", ["hash_long", "hash_long_wide"])
def test_hash_long_plan_bounds(count, sms, kernel):
    """CTAs of whole warps, 32-256 threads, at most 8 an SM; with few strings
    the fewest threads a CTA that still leave at most one CTA an SM, so the
    strings (a quad or a warp each) spread over as many SMs as there are
    warps of them."""
    threads, blocks = hash_kernel.hash_long_plan(count, sms, kernel)
    need = (4 if kernel == "hash_long" else 32) * count
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert 1 <= blocks <= 8 * sms
    assert blocks == min(-(-need // threads), 8 * sms)
    if threads < 256:  # every string resident, one CTA an SM
        assert blocks * threads >= need and blocks <= sms
        assert threads == 32 or -(-need // (threads - 32)) > sms


def test_hash_long_plan_raises_on_what_it_cannot_place():
    for args in [(0, SMS, "hash_long"), (1, 0, "hash_long_wide"), (5, SMS, "hash_short")]:
        with pytest.raises(ValueError):
            hash_kernel.hash_long_plan(*args)


W = hash_kernel.WIDE_BYTES


@pytest.mark.parametrize("lengths,want", [
    ([], (False, False, False)),
    ([0, 64], (True, False, False)),
    ([65, W - 1], (False, True, False)),       # a log's lines: the quad alone
    ([W, 100_000, 3 << 20], (False, False, True)),  # the documents: the warp kernel alone
    ([5, 90, W], (True, True, True)),          # one long string among short ones
    ([64, W - 1, W], (True, True, True)),
])
def test_each_string_goes_to_one_kernel_by_its_length(lengths, want):
    """Strings of at most 64 bytes reach hash_short, those of 65 to
    WIDE_BYTES - 1 hash_long (a quad each), the rest hash_long_wide,
    whatever the others' lengths."""
    got = hash_kernel.kernel_routes(np.array(lengths, dtype=np.int64))
    assert (got["short"], got["quad"], got["wide"]) == want


def test_hash_long_kernel_flags_leave_the_plain_version_whole():
    """On CPU tensors ``quad`` and ``wide`` choose no kernel: the plain
    version hashes every long string."""
    items = _items(12, [65, W - 1, W, W + 1])
    tape = [np.frombuffer(x, np.uint8) for x in items]
    blob = torch.from_numpy(np.concatenate(tape))
    lengths = torch.tensor([len(x) for x in items], dtype=torch.int64)
    starts = torch.cumsum(lengths, 0) - lengths
    for quad, wide in [(None, None), (False, True), (True, False)]:
        got = hash_kernel.hash_long(blob, starts, lengths, 4, quad=quad, wide=wide)
        assert [int(g) & (2**64 - 1) for g in got] == [port_hash.sz_hash(x, 4) for x in items]
    assert hash_kernel.KERNEL_LAUNCHES == {"hash_short": 0, "hash_long": 0,
                                           "hash_long_wide": 0}


def test_wrappers_check_their_arguments():
    blob = torch.zeros(8, dtype=torch.uint8)
    ok = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError, match="blob"):
        hash_kernel.hash_short(blob.to(torch.int32), ok, ok)
    with pytest.raises(TypeError, match="lengths"):
        hash_kernel.hash_long(blob, ok, ok.to(torch.int32))
    with pytest.raises(ValueError, match="differ"):
        hash_kernel.hash_tokens_raw(blob, ok, ok[:1])
    with pytest.raises(ValueError, match="out"):
        hash_kernel.hash_short(blob, ok, ok, 0, torch.zeros(3, dtype=torch.int64))


def test_no_card_raises_instead_of_falling_back(monkeypatch):
    """``device=None`` is ``cuda:0``: without a card the entry points raise
    rather than run the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aes_kernel.fill_random_device(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hash_kernel.hash_batch_device([b"a"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hash_kernel.hash_bounds_device(np.zeros(4, np.uint8), [0], [2])
