"""Argsort of string collections: the ``sz_sequence_argsort`` analog.

Counterpart of ``stringzilla_tpu/ops/sort.py``, copied rather than imported
(importing any ``stringzilla_tpu`` module imports jax). The reference sorts
pointer-sized "pgrams" and recurses into equal runs (reference
``include/stringzilla/sort.h:87,141``); here every string becomes one row of
a key matrix and the rows are sorted once, lexicographically:

* each string's bytes become big-endian ``uint32`` key words (zero-padded,
  so shorter strings order before their extensions) plus a length tiebreak
  word, exported from the buffer in numpy (the JAX module's native
  ``tc_pgram_keys`` tier is not ported; it gives the same order);
* the host tier, the default, is ``np.lexsort`` (the port has no native
  ``argsort_keys``); ``prefer_device=True`` at 2^14 rows or more sorts on
  ``device`` (``cuda:0`` unless the caller names another): the key matrix,
  padded to a dyadic row count with ``0xFFFFFFFF`` rows, goes up as int64,
  and successive stable ``torch.sort`` passes run from the last pair of key
  columns to the first, two u32 columns packed into one int64 a pass. The
  JAX module runs one multi-key ``lax.sort``; ``torch.sort`` has no
  ``num_keys``.

``reverse=True`` inverts the key bytes (``0xFF - b``), giving descending
order with ties kept stable (``sort.h:24-26``); ``top_count`` returns the
first K indices; ``uncased`` folds ASCII case, and applies full Unicode case
folding when the buffer holds a byte >= 0x80 (``sz_sequence_argsort_uncased``,
reference ``sort.h:18-22,114``): keys exported by the native host runtime's
``tc_pgram_keys_unicode`` from the folded strings, or, without that
runtime, packed from ``ops.utf8.utf8_fold`` of each string.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import platform

__all__ = ["argsort_strings", "argsort_tape", "argsort_bounds", "argsort_rows",
           "pack_pgram_keys", "pgram_keys_bounds"]

_DEVICE_MIN_ITEMS = 1 << 14  # below this, the host lexsort wins on latency
_ROWS_PER_PASS = 1 << 20  # rows exported at once, to bound the dense block


def pgram_keys_bounds(data: np.ndarray, starts, ends, words: int, uncased: bool = False,
                      reverse: bool = False) -> np.ndarray:
    """Key matrix ``uint32[n, words + 1]`` of the spans ``data[starts[i]:
    ends[i]]``: ``words`` big-endian words of zero-padded bytes (longer
    strings are cut), then the length (bit-inverted with ``reverse``)."""
    data = np.asarray(data, dtype=np.uint8).reshape(-1)
    if data.size == 0:  # only empty strings: give the masked gather a byte to read
        data = np.zeros(1, dtype=np.uint8)
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    n = len(starts)
    keys = np.empty((n, words + 1), dtype=np.uint32)
    j = np.arange(4 * words, dtype=np.int64)
    for lo in range(0, n, _ROWS_PER_PASS):
        hi = min(lo + _ROWS_PER_PASS, n)
        valid = j[None, :] < lens[lo:hi, None]
        dense = np.where(valid, data[np.where(valid, starts[lo:hi, None] + j, 0)], 0)
        dense = dense.astype(np.uint8)
        if uncased:
            dense = np.where((dense >= 65) & (dense <= 90), dense + 32, dense).astype(np.uint8)
        if reverse:
            dense = 255 - dense
        keys[lo:hi, :words] = dense.view(">u4").astype(np.uint32)
    tiebreak = lens.astype(np.uint32)
    keys[:, words] = ~tiebreak if reverse else tiebreak
    return keys


def pack_pgram_keys(items: list[bytes], reverse: bool = False,
                    uncased: bool = False) -> np.ndarray:
    """Dense key matrix ``uint32[n, 2 * ceil(maxlen / 8) + 1]`` (at least two
    key words) of a list of byte strings."""
    lens = np.fromiter(map(len, items), dtype=np.int64, count=len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    maxlen = int(lens.max()) if len(items) else 0
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    return pgram_keys_bounds(data, offsets[:-1], offsets[1:], max(-(-maxlen // 8) * 2, 2),
                             uncased=uncased, reverse=reverse)


def argsort_rows(k: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort of the rows of ``k``, an int64 ``(n, w)``
    tensor of u32 values, on its device: int64 positions, no pull."""
    order = torch.arange(k.shape[0], device=k.device)
    width = k.shape[1]
    for c in reversed(range(0, width, 2)):  # least significant pass first
        col = k[order, c]
        # two u32 columns as one int64 in unsigned order: (hi - 2^31) * 2^32 + lo
        key = (col - (1 << 31)) * (1 << 32) + k[order, c + 1] if c + 1 < width else col
        order = order[torch.sort(key, stable=True).indices]
    return order


def _device_argsort(keys: np.ndarray, device: torch.device) -> np.ndarray:
    """Stable lexicographic argsort of the rows of ``keys`` on ``device``."""
    return argsort_rows(torch.from_numpy(keys.astype(np.int64)).to(device)).cpu().numpy()


def _argsort_keys(keys: np.ndarray, top_count: int | None, prefer_device: bool = False,
                  device=None) -> np.ndarray:
    """Sort the key matrix. ``np.lexsort`` on the host is the default; with
    ``prefer_device`` a collection of 2^14 rows or more sorts on ``device``
    (padded to a dyadic row count, as the JAX module pads its compiled
    shapes)."""
    n = keys.shape[0]
    if top_count is not None and 0 < top_count < n // 4:
        # Partial-sort pruning (reference ``sz_sequence_argsort_top_k``,
        # sort.h:24-26): every row whose first word ties the k-th smallest
        # stays in, so the full sort of the candidates is exact.
        c0 = keys[:, 0]
        thresh = c0[np.argpartition(c0, top_count - 1)[top_count - 1]]
        cand = np.flatnonzero(c0 <= thresh)
        if cand.size < n:
            sub = _argsort_keys(keys[cand], None, prefer_device=prefer_device, device=device)
            return cand[sub][:top_count].astype(np.int64)
    if not prefer_device or n < _DEVICE_MIN_ITEMS:
        order = np.lexsort(tuple(keys[:, c] for c in reversed(range(keys.shape[1]))))
    else:
        m = 1 << (n - 1).bit_length()
        if m != n:
            pad = np.full((m - n, keys.shape[1]), 0xFFFFFFFF, dtype=keys.dtype)
            keys = np.concatenate([keys, pad], axis=0)
        order = _device_argsort(keys, platform.resolve_device(device))
        order = order[order < n]
    order = order.astype(np.int64)
    return order[:top_count] if top_count is not None else order


def _unicode_uncased_keys(data, starts, ends, maxlen: int, reverse: bool) -> np.ndarray:
    """Key matrix of the fully case-folded spans, as the JAX module makes it."""
    from ..utils import native
    from .utf8 import _fold_tables, utf8_fold

    words = max(-(-(3 * maxlen) // 4), 2)  # folded bytes can expand up to 3x the raw length
    tabs = _fold_tables()
    keys = (native.pgram_keys_unicode(data, starts, ends, words, reverse, *tabs)
            if tabs is not None else None)
    if keys is None:
        items = [utf8_fold(bytes(data[int(s):int(e)])) for s, e in zip(starts, ends)]
        keys = pack_pgram_keys(items, reverse=reverse, uncased=False)
    return keys


def argsort_bounds(data: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                   reverse: bool = False, top_count: int | None = None,
                   uncased: bool = False, prefer_device: bool = False,
                   device=None) -> np.ndarray:
    """Argsort of string views ``data[starts[i]:ends[i]]``: the zero-copy
    entry that ``Strs.order`` uses."""
    if len(starts) == 0:
        return np.zeros(0, dtype=np.int64)
    data = np.asarray(data)
    maxlen = int((np.asarray(ends) - np.asarray(starts)).max())
    if uncased and bool((data >= 0x80).any()):
        keys = _unicode_uncased_keys(data, starts, ends, maxlen, reverse)
        return _argsort_keys(keys, top_count, prefer_device=prefer_device, device=device)
    keys = pgram_keys_bounds(data, starts, ends, max(-(-maxlen // 4), 2),
                             uncased=uncased, reverse=reverse)
    return _argsort_keys(keys, top_count, prefer_device=prefer_device, device=device)


def argsort_strings(items: list[bytes], reverse: bool = False,
                    top_count: int | None = None, uncased: bool = False,
                    prefer_device: bool = False, device=None) -> np.ndarray:
    """Stable argsort permutation of a list of byte strings."""
    if len(items) == 0:
        return np.zeros(0, dtype=np.int64)
    lens = np.fromiter(map(len, items), dtype=np.int64, count=len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    return argsort_bounds(data, offsets[:-1], offsets[1:], reverse=reverse,
                          top_count=top_count, uncased=uncased,
                          prefer_device=prefer_device, device=device)


def argsort_tape(tape, **kwargs) -> np.ndarray:
    """Argsort of a ``Tape``."""
    return argsort_bounds(np.asarray(tape.data), tape.offsets[:-1], tape.offsets[1:], **kwargs)
