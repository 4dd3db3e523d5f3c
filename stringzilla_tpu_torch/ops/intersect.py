"""Set intersection of string collections: ``sz_sequence_intersect``.

Counterpart of ``stringzilla_tpu/ops/intersect.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax). The
reference builds a seeded open-addressing hash table (reference
``include/stringzilla/intersect.h:33-96``); the JAX package, and this port,
run a sort-merge join on hash keys instead:

1. every *distinct* string of both collections gets its 64-bit seeded
   ``sz_hash``: the host numpy ``hash_batch`` below 2^15 distinct strings
   in all, ``ops.hash_kernel.hash_batch_device`` on ``device`` from there
   on (``cuda:0`` unless the caller names another; the JAX package takes
   its device only on a TPU);
2. the two key arrays are sorted, on ``device`` once both hold 2^15 keys:
   one stable ``torch.sort`` of the u64 keys as int64 with the sign bit
   flipped, so that signed order is unsigned order;
3. every pair of equal keys is checked byte for byte on the host, so a
   64-bit collision never yields a false match.

Returns the C ABI's shape of answer: parallel index arrays into the first
and second collection (the first occurrence of each distinct common string).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import platform
from .hash import hash_batch
from .hash_kernel import hash_batch_device

__all__ = ["intersect"]

_DEVICE_MIN_ITEMS = 1 << 15


def _distinct(items: list[bytes]):
    """(strings, first_index i64[k]) over distinct strings, order-preserving."""
    seen: dict[bytes, int] = {}
    for i, s in enumerate(items):
        if s not in seen:
            seen[s] = i
    strings = list(seen.keys())
    idx = np.fromiter(seen.values(), dtype=np.int64, count=len(seen))
    return strings, idx


def _device_argsort_u64(keys: np.ndarray, device: torch.device) -> np.ndarray:
    """Stable argsort of u64 keys on ``device``: the keys with the sign bit
    flipped, as int64, order exactly as the u64 values do."""
    flipped = (keys ^ np.uint64(1 << 63)).view(np.int64)
    k = torch.from_numpy(flipped).to(device)
    return torch.sort(k, stable=True).indices.cpu().numpy()


def _sorted_match(a_keys: np.ndarray, b_keys: np.ndarray, device=None):
    """All position pairs (ia, ib) with a_keys[ia] == b_keys[ib]; every
    element of an equal-key run in b is paired (the exact check downstream
    picks the true matches among 64-bit collisions)."""
    if min(len(a_keys), len(b_keys)) >= _DEVICE_MIN_ITEMS:
        dev = platform.resolve_device(device)
        order_a = _device_argsort_u64(a_keys, dev)
        order_b = _device_argsort_u64(b_keys, dev)
    else:
        order_a = np.argsort(a_keys, kind="stable")
        order_b = np.argsort(b_keys, kind="stable")
    sa, sb = a_keys[order_a], b_keys[order_b]
    lo = np.searchsorted(sb, sa, side="left")
    hi = np.searchsorted(sb, sa, side="right")
    runs = hi - lo  # 0 for misses; >1 only under 64-bit collisions
    ia = np.repeat(np.arange(len(sa), dtype=np.int64), runs)
    if len(ia) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.repeat(np.cumsum(runs) - runs, runs)
    ib_sorted = np.repeat(lo, runs) + (np.arange(len(ia)) - starts)
    return order_a[ia], order_b[ib_sorted]


def intersect(first, second, seed: int = 0, device=None):
    """Indices of distinct common strings: ``(first_idx i64[k], second_idx
    i64[k])`` (C ABI ``sz_sequence_intersect``, reference ``intersect.h:86``).
    Accepts lists of bytes/str, ``Tape``, or ``Strs``."""

    def as_list(x):
        if hasattr(x, "to_list"):
            return [bytes(b) for b in x.to_list()]
        return [s.encode() if isinstance(s, str) else bytes(s) for s in x]

    a_items, b_items = as_list(first), as_list(second)
    a_strs, a_idx = _distinct(a_items)
    b_strs, b_idx = _distinct(b_items)
    if not a_strs or not b_strs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if len(a_strs) + len(b_strs) >= _DEVICE_MIN_ITEMS:
        dev = platform.resolve_device(device)
        a_hash = hash_batch_device(a_strs, seed, device=dev)
        b_hash = hash_batch_device(b_strs, seed, device=dev)
    else:
        a_hash = hash_batch(a_strs, seed)
        b_hash = hash_batch(b_strs, seed)
    ia, ib = _sorted_match(a_hash, b_hash, device)
    # Exact verification kills 64-bit collisions (and keeps adversarial
    # inputs correct, like the reference's bounded-budget rehash).
    keep = [k for k in range(len(ia)) if a_strs[ia[k]] == b_strs[ib[k]]]
    out_a = a_idx[ia[keep]] if keep else np.zeros(0, np.int64)
    out_b = b_idx[ib[keep]] if keep else np.zeros(0, np.int64)
    order = np.argsort(out_a, kind="stable")
    return out_a[order], out_b[order]
