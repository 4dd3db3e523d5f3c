"""The port's byte lookup (``lookup_transform`` on CPU tensors, which runs
its plain PyTorch version) against the JAX package's ``lookup_transform``
(Pallas interpreter on the CPU), on the same numpy-seeded bytes. Tolerance:
exact equality of the uint8 results."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops.memory_pallas import lookup_transform as jax_lookup  # noqa: E402
from stringzilla_tpu_torch.ops import memory as memory_mod  # noqa: E402
from stringzilla_tpu_torch.ops.memory import lookup_reference, lookup_transform  # noqa: E402


def _rng():
    """A generator of this file's own: the tests draw the same data in any
    order and leave the session ``rng``, which other files share, as it is."""
    return np.random.default_rng(42)


def _jax(data: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """The JAX function takes a (rows, 128) buffer; pad, map, cut."""
    padded = np.zeros(-(-max(len(data), 1) // 128) * 128, np.uint8)
    padded[: len(data)] = data
    out = jax_lookup(jnp.asarray(padded.reshape(-1, 128)), len(padded) // 128, lut)
    return np.asarray(out).reshape(-1)[: len(data)]


@pytest.mark.parametrize("n", [1, 15, 16, 17, 128, 1000, 70001])
def test_lookup_matches_jax(n):
    rng = _rng()
    data = rng.integers(0, 256, n).astype(np.uint8)
    lut = rng.permutation(256).astype(np.uint8)
    got = lookup_transform(torch.from_numpy(data), lut)
    assert got.dtype == torch.uint8 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), _jax(data, lut))
    np.testing.assert_array_equal(got.numpy(), lut[data])


def test_lookup_takes_a_tensor_table_and_empty_input():
    rng = _rng()
    lut = torch.from_numpy((np.arange(256) % 64).astype(np.uint8))
    data = torch.from_numpy(rng.integers(0, 256, 300).astype(np.uint8))
    np.testing.assert_array_equal(lookup_transform(data, lut).numpy(),
                                  data.numpy() % 64)
    assert lookup_transform(data[:0], lut).shape == (0,)
    # a contiguous view that starts off 16-byte alignment
    np.testing.assert_array_equal(lookup_transform(data[3:], lut).numpy(),
                                  data[3:].numpy() % 64)


def test_lookup_cpu_counts_no_launch_and_checks_inputs():
    before = dict(memory_mod.KERNEL_LAUNCHES)
    data = torch.arange(10, dtype=torch.uint8)
    lookup_transform(data, np.arange(256)[::-1])
    assert memory_mod.KERNEL_LAUNCHES == before
    with pytest.raises(TypeError):
        lookup_transform(data.int(), np.arange(256))
    with pytest.raises(TypeError):
        lookup_transform(data.view(2, 5), np.arange(256))
    with pytest.raises(ValueError):
        lookup_transform(data, np.arange(255))
    with pytest.raises(ValueError):
        lookup_reference(torch.zeros(6, dtype=torch.uint8)[::2], np.arange(256))
