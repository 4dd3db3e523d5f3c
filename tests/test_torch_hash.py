"""The port's host hash layer (``stringzilla_tpu_torch.ops.hash``, numpy)
against the golden vectors generated from the reference's serial build
(``tests/golden/hash_vectors.json``) and against the JAX package's
``ops.hash`` on the same numpy-seeded bytes. Tolerance: exact equality of
every 64-bit value and byte."""

import json
import os

import numpy as np
import pytest

from stringzilla_tpu.ops import hash as jax_hash
from stringzilla_tpu_torch.ops import hash as port_hash

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hash_vectors.json")


@pytest.fixture(scope="module")
def vectors():
    with open(GOLDEN) as f:
        return json.load(f)


def _rng(salt=0):
    return np.random.default_rng(42 + salt)


def test_hash_golden(vectors):
    data = bytes(vectors["input"])
    for length, seed, expected in vectors["hash"]:
        assert port_hash.sz_hash(data[:length], int(seed)) == int(expected), (length, seed)


def test_bytesum_golden(vectors):
    data = bytes(vectors["input"])
    for length, expected in vectors["bytesum"]:
        assert port_hash.bytesum(data[:length]) == int(expected)


def test_fill_random_golden(vectors):
    for length, nonce, expected in vectors["fill_random"]:
        assert list(port_hash.fill_random(length, int(nonce))) == expected, (length, nonce)


def test_streaming_hash_golden(vectors):
    data = bytes(vectors["input"])
    for splits, expected in vectors["hash_streaming"]:
        h = port_hash.Hasher(42)
        off = 0
        for s in splits:
            h.update(data[off: off + s])
            off += s
        assert h.digest() == int(expected), splits
        assert h.copy().digest() == h.digest() and h.hexdigest() == f"{int(expected):016x}"


@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000])
def test_sz_hash_matches_jax(length):
    data = _rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    for seed in (0, 1, 2**63 + 5):
        assert port_hash.sz_hash(data, seed) == jax_hash.sz_hash(data, seed)
    np.testing.assert_array_equal(port_hash.hash_multiseed(data, [0, 7, 2**64 - 1]),
                                  jax_hash.hash_multiseed(data, [0, 7, 2**64 - 1]))


def test_hash_batch_random_and_hasher_match_jax():
    rng = _rng(1)
    items = [rng.integers(0, 256, int(m), dtype=np.uint8).tobytes()
             for m in rng.integers(0, 150, 60)]
    np.testing.assert_array_equal(port_hash.hash_batch(items, 3), jax_hash.hash_batch(items, 3))
    from stringzilla_tpu_torch.ops.tape import Tape

    np.testing.assert_array_equal(port_hash.hash_batch(Tape.from_strings(items), 3),
                                  jax_hash.hash_batch(items, 3))
    assert port_hash.random(50, 9, alphabet="ACGT") == jax_hash.random(50, 9, alphabet="ACGT")
    assert port_hash.fill_random(100, 4) == jax_hash.fill_random(100, 4)
    h = port_hash.Hasher(5).update(items[7]).update(items[8])
    assert h.digest() == port_hash.sz_hash(items[7] + items[8], 5)
    assert h.reset().digest() == port_hash.sz_hash(b"", 5)
