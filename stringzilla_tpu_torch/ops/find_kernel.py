"""Streaming search over a flat byte buffer: first, last or count.

Counterpart of ``stringzilla_tpu/ops/find_pallas.py``:

    search_positions(hay, n, mode, needle=None, byteset_words=None, lo=0, hi=None)
    find_long(hay, n, needle, reverse=False) -> int

* ``hay``  1-D ``uint8`` tensor holding the haystack in ``hay[:n]`` (a
  ``Str``'s device mirror; bytes past ``n`` are never read);
* ``mode`` ``"first"``, ``"last"`` or ``"count"``;
* ``needle`` the bytes to find (``np.ndarray`` of ``uint8``, ``bytes`` or a
  ``uint8`` tensor), or ``byteset_words`` 8 ``uint32`` words of a 256-bit
  set (``ops.find.byteset_mask``);
* start positions run over ``[lo, hi]`` with ``hi`` clipped to ``n - k``;
* returns a 0-d int64 tensor on ``hay``'s device: the position, -1 when
  there is none, or the count.

The JAX function takes a ``(rows, 128)`` buffer and compares at most 16
needle offsets, so for longer needles it returns candidates that
``find_long`` then verifies one launch each. Here every needle byte is
compared, so ``search_positions`` is exact for any needle length and
``find_long`` is one call of it. ``search_positions`` runs the hand-written
Hopper kernel (``csrc/find.cu``) on CUDA tensors and the plain PyTorch
version ``search_positions_reference`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build

__all__ = ["search_positions", "search_positions_reference", "find_long",
           "KERNEL_LAUNCHES", "CHUNK_POSITIONS", "MODES"]

# Launches of the CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"find_search": 0}

MODES = {"first": 0, "last": 1, "count": 2}
CHUNK_POSITIONS = 65536  # start positions a CTA claims at once (csrc/find.cu kChunk)


def _prepare(hay, n, mode, needle, byteset_words, lo, hi):
    """Checks the arguments; returns (needle or None, words or None, k, lo, hi)
    with ``lo >= 0`` and ``hi <= n - k``."""
    if not isinstance(hay, torch.Tensor) or hay.dtype != torch.uint8 or hay.dim() != 1:
        raise TypeError("hay must be a 1-D uint8 tensor")
    if not hay.is_contiguous():
        raise ValueError("hay must be contiguous")
    n = int(n)
    if not 0 <= n <= hay.numel():
        raise ValueError(f"n={n} is outside the buffer of {hay.numel()} bytes")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if (needle is None) == (byteset_words is None):
        raise ValueError("give exactly one of needle and byteset_words")
    words = None
    if needle is not None:
        if isinstance(needle, torch.Tensor):
            needle = needle.cpu().numpy()
        elif isinstance(needle, (bytes, bytearray, memoryview)):
            needle = np.frombuffer(bytes(needle), np.uint8)
        needle = np.ascontiguousarray(needle, dtype=np.uint8).reshape(-1)
        k = needle.shape[0]
        if k == 0:
            raise ValueError("the needle must not be empty")
    else:
        words = np.ascontiguousarray(byteset_words, dtype=np.uint32).reshape(-1)
        if words.shape != (8,):
            raise ValueError("byteset_words must be 8 uint32 words")
        k = 1
    lo = max(int(lo), 0)
    hi = n - k if hi is None else min(int(hi), n - k)
    return needle, words, k, lo, hi


def _byteset_table(words: np.ndarray) -> np.ndarray:
    """The 256-bit byteset of 8 uint32 words as 256 booleans, one a byte."""
    return np.unpackbits(words.view(np.uint8), bitorder="little").astype(bool)


def _empty_result(mode, device) -> torch.Tensor:
    return torch.tensor(0 if mode == "count" else -1, dtype=torch.int64, device=device)


def search_positions_reference(hay: torch.Tensor, n: int, mode: str, needle=None,
                               byteset_words=None, lo: int = 0, hi: int | None = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the AND of k shifted compares
    (or a 256-entry set lookup) over the start positions in ``[lo, hi]``."""
    needle, words, k, lo, hi = _prepare(hay, n, mode, needle, byteset_words, lo, hi)
    if lo > hi:
        return _empty_result(mode, hay.device)
    m = hi - lo + 1
    window = hay[lo: hi + k]
    if needle is not None:
        mask = window[:m] == int(needle[0])
        for a in range(1, k):
            mask &= window[a: a + m] == int(needle[a])
    else:
        mask = torch.from_numpy(_byteset_table(words)).to(hay.device)[window[:m].long()]
    if mode == "count":
        return mask.sum(dtype=torch.int64)
    hit = mask.any()
    if mode == "first":
        pos = mask.to(torch.uint8).argmax().to(torch.int64) + lo
    else:
        pos = hi - mask.flip(0).to(torch.uint8).argmax().to(torch.int64)
    return torch.where(hit, pos, torch.full_like(pos, -1))


def search_positions(hay: torch.Tensor, n: int, mode: str, needle=None,
                     byteset_words=None, lo: int = 0, hi: int | None = None
                     ) -> torch.Tensor:
    """First or last start position in ``[lo, hi]``, or their count, of
    ``needle`` or of any byte of the set: the Hopper kernel for CUDA
    tensors, the plain version for CPU ones. Exact for any needle length."""
    if isinstance(hay, torch.Tensor) and hay.device.type == "cpu":
        return search_positions_reference(hay, n, mode, needle, byteset_words, lo, hi)
    needle, words, k, lo, hi = _prepare(hay, n, mode, needle, byteset_words, lo, hi)
    if hay.device.type != "cuda":
        raise ValueError(f"search_positions runs on CUDA or CPU tensors, not {hay.device}")
    if lo > hi:
        return _empty_result(mode, hay.device)
    kind = 0 if needle is not None else 1
    head = np.zeros(16, np.uint8)
    if needle is not None:
        head[: min(k, 16)] = needle[:16]
    words = np.zeros(8, np.uint32) if words is None else words
    # head and words are read by value in the C call; needle_dev is read by
    # the kernel, and the caching allocator reuses its block only for work
    # queued after this launch on the same stream
    needle_dev = (torch.from_numpy(needle.copy()).to(hay.device) if needle is not None and k > 16
                  else None)
    scratch = torch.empty(2, dtype=torch.int64, device=hay.device)
    lib = cuda_build.load()
    with torch.cuda.device(hay.device):
        stream = torch.cuda.current_stream(hay.device).cuda_stream
        sms = torch.cuda.get_device_properties(hay.device).multi_processor_count
        err = lib.sz_find_search(
            hay.data_ptr(), int(n), MODES[mode], kind, head.ctypes.data,
            needle_dev.data_ptr() if needle_dev is not None else None, k,
            words.ctypes.data, lo, hi, scratch.data_ptr(), sms, stream)
    if err != 0:
        raise RuntimeError(f"sz_find_search launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES["find_search"] += 1
    return scratch[1]


def find_long(hay: torch.Tensor, n: int, needle, reverse: bool = False) -> int:
    """Exact first (or, with ``reverse``, last) match of ``needle`` in
    ``hay[:n]``, -1 if none. The JAX function filters and then verifies
    candidates one by one; ``search_positions`` is exact for any length, so
    this is one search and one pull."""
    return int(search_positions(hay, n, "last" if reverse else "first", needle=needle))
