"""Arrow-style string tapes — the string collection format.

Counterpart of ``stringzilla_tpu/ops/tape.py``, copied rather than imported
(importing any ``stringzilla_tpu`` module imports jax). A tape is one
contiguous ``uint8`` data blob plus ``count+1`` int64 offsets, the layout of
the reference's ``sz_sequence_u64tape_t`` (reference
``include/stringzillas/stringzillas.h:61-76``); the same numpy arrays build a
tape of either package.

Ragged→dense conversion groups strings into dyadic length buckets (the
reference's ``candidate_length_bucket_``, ``similarities/serial.hpp:3437-3444``)
so padding waste stays below 2×.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["Tape", "dyadic_bucket", "ladder", "round_up"]


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def ladder(n: int, mantissa_bits: int = 3) -> int:
    """Smallest value >= n of the form m * 2^e with m < 2^(mantissa_bits+1)
    — a coarse dyadic ladder (waste <= 2^-mantissa_bits)."""
    n = max(int(n), 1)
    if n < (1 << (mantissa_bits + 1)):
        return n
    e = n.bit_length() - 1 - mantissa_bits
    return -(-n >> e) << e


def _as_bytes(item) -> bytes:
    if isinstance(item, bytes):
        return item
    if isinstance(item, (bytearray, memoryview)):
        return bytes(item)
    if isinstance(item, str):
        return item.encode("utf-8")
    if isinstance(item, np.ndarray) and item.dtype == np.uint8:
        return item.tobytes()
    raise TypeError(f"can't interpret {type(item)!r} as a byte string")


@dataclasses.dataclass(frozen=True)
class Tape:
    """A collection of byte strings as ``(data, offsets)`` host arrays.

    ``data`` is ``uint8[total_bytes]``; ``offsets`` is ``int64[count+1]``
    with ``offsets[0] == 0``. String ``i`` occupies
    ``data[offsets[i]:offsets[i+1]]``.
    """

    data: np.ndarray
    offsets: np.ndarray

    @classmethod
    def from_strings(cls, items: Iterable) -> "Tape":
        blobs = [_as_bytes(s) for s in items]
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        if blobs:
            np.cumsum([len(b) for b in blobs], out=offsets[1:])
        data = np.frombuffer(b"".join(blobs), dtype=np.uint8).copy()
        return cls(data=data, offsets=offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> bytes:
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return np.asarray(self.data[lo:hi]).tobytes()

    def to_list(self) -> list[bytes]:
        return [self[i] for i in range(len(self))]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def total_bytes(self) -> int:
        return int(self.offsets[-1])


def dyadic_bucket(length: int, minimum: int = 8) -> int:
    """Smallest power-of-two padded length ≥ ``length`` (and ≥ ``minimum``)
    — the reference's ``candidate_length_bucket_`` rule."""
    n = max(int(length), minimum)
    return 1 << (n - 1).bit_length()
