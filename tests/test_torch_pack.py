"""The port's device tape and ``pack_chars`` against the JAX package's
``pack_chars`` on the same numpy-seeded tape (CPU on both sides). Tolerance:
exact equality of the int32 blocks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops import pack_device as jax_pack  # noqa: E402
from stringzilla_tpu.ops.tape import Tape as JaxTape  # noqa: E402
from stringzilla_tpu_torch.ops.pack_device import DeviceTape, device_tape, pack_chars  # noqa: E402
from stringzilla_tpu_torch.ops.tape import Tape, dyadic_bucket, ladder, round_up  # noqa: E402

CPU = torch.device("cpu")


def _rng():
    """A generator of this file's own: the tests draw the same data in any
    order and leave the session ``rng``, which other files share, as it is."""
    return np.random.default_rng(42)


def _tape_arrays(rng, count, row_len):
    """One collection's numpy arrays, lengths 0..row_len, both ends hit."""
    lens = rng.integers(0, row_len + 1, count)
    lens[:2] = [0, row_len]
    offsets = np.zeros(count + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = rng.integers(0, 256, int(offsets[-1])).astype(np.uint8)
    return data, offsets


@pytest.mark.parametrize("fill", [-1, 0])
@pytest.mark.parametrize("row_len", [32, 37, 128])
@pytest.mark.parametrize("transpose", [True, False])
def test_pack_chars_matches_jax(rng, fill, row_len, transpose):
    data, offsets = _tape_arrays(rng, 40, row_len)
    idx = rng.permutation(40)[:29]

    dt = device_tape(Tape(data, offsets), CPU)
    offs, lens = dt.bucket_arrays(idx)
    got = pack_chars(dt.data, offs, lens, row_len=row_len,
                     transpose=transpose, fill=fill).numpy()

    jdt = jax_pack.DeviceTape(JaxTape(data, offsets))
    joffs, jlens = jdt.bucket_arrays(idx, len(idx))
    want = np.asarray(jax_pack.pack_chars(
        jdt.data, joffs, jlens, jnp.zeros(256, jnp.int32), row_len=row_len,
        transpose=transpose, fill=fill))
    assert got.dtype == np.int32
    assert got.shape == ((row_len, len(idx)) if transpose else (len(idx), row_len))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lens.numpy(), offsets[idx + 1] - offsets[idx])


def test_device_tape_is_cached_per_tape_and_device():
    tape = Tape.from_strings([b"ab", "c", b"", np.frombuffer(b"xyz", np.uint8)])
    dt = device_tape(tape, CPU)
    assert device_tape(tape, "cpu") is dt
    assert device_tape(Tape(tape.data, tape.offsets), CPU) is not dt
    assert tape.to_list() == [b"ab", b"c", b"", b"xyz"]
    assert dt.data.dtype == torch.uint8 and dt.data.device == CPU
    assert dt.data[:-1].numpy().tobytes() == b"abcxyz"


def test_empty_collection_packs_to_fill():
    dt = device_tape(Tape.from_strings([b"", b""]), CPU)
    offs, lens = dt.bucket_arrays(np.arange(2))
    block = pack_chars(dt.data, offs, lens, row_len=32, transpose=True, fill=-1)
    assert block.shape == (32, 2) and (block == -1).all()


def test_tape_helpers_match_jax():
    from stringzilla_tpu.ops import tape as jax_tape

    for n in [0, 1, 7, 8, 9, 100, 129, 4095, 4096, 4097, 10**6 + 3]:
        assert dyadic_bucket(n) == jax_tape.dyadic_bucket(n)
        assert ladder(n) == jax_tape.ladder(n)
        assert round_up(n, 32) == jax_tape.round_up(n, 32)


@pytest.mark.parametrize("row_len", [15, 32, 135])
def test_pack_chars_shift_matches_jax(row_len):
    """``shift`` prepends the zero row of the column DP's query layout."""
    rng = _rng()
    data, offsets = _tape_arrays(rng, 30, row_len)
    idx = rng.permutation(30)[:21]
    dt = device_tape(Tape(data, offsets), CPU)
    offs, lens = dt.bucket_arrays(idx)
    got = pack_chars(dt.data, offs, lens, row_len=row_len, transpose=True,
                     fill=0, shift=True).numpy()
    jdt = jax_pack.DeviceTape(JaxTape(data, offsets))
    joffs, jlens = jdt.bucket_arrays(idx, len(idx))
    want = np.asarray(jax_pack.pack_chars(
        jdt.data, joffs, jlens, jnp.zeros(256, jnp.int32), row_len=row_len,
        transpose=True, fill=0, shift=True))
    assert got.shape == (row_len + 1, len(idx)) and (got[0] == 0).all()
    np.testing.assert_array_equal(got, want)


def test_device_tape_from_a_device_blob():
    """A tape over an already-mapped blob keeps the source's bounds."""
    tape = Tape.from_strings([b"abc", b"", b"de"])
    dt = device_tape(tape, CPU)
    mapped = DeviceTape(data=dt.data + 1, starts=dt.starts, lengths=dt.lengths)
    assert mapped.device == CPU and len(mapped) == 3
    offs, lens = mapped.bucket_arrays(np.array([2, 0]))
    block = pack_chars(mapped.data, offs, lens, row_len=4, transpose=False, fill=-1)
    assert block.tolist() == [[ord("d") + 1, ord("e") + 1, -1, -1],
                              [ord("a") + 1, ord("b") + 1, ord("c") + 1, -1]]
