"""Exact substring and byteset search on a 1-D ``uint8`` tensor.

Counterpart of ``stringzilla_tpu/ops/find.py``, the reference's ``find``
domain (reference ``include/stringzilla/find.h:43-431``): ``sz_find`` /
``sz_rfind`` / ``sz_find_byte`` / ``sz_find_byteset`` and counting.

The JAX module computes these in XLA, outside any Pallas kernel. Here each
is one ``ops.find_kernel.search_positions`` call over the whole haystack:
the streaming-search kernel on a CUDA tensor, its plain PyTorch version on
a CPU one (both exact for any needle length). Positions are Python ints;
"not found" is -1.

A haystack is a tensor (searched where it lies) or anything byte-like
(``bytes``, ``str`` as UTF-8, a numpy array), which is copied to
``device``: ``cuda:0`` unless the caller names another, such as ``"cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import platform
from .find_kernel import search_positions

__all__ = [
    "find",
    "rfind",
    "find_byte",
    "rfind_byte",
    "count",
    "count_byte",
    "find_byteset",
    "rfind_byteset",
    "byteset_mask",
]


def _host_bytes(x) -> np.ndarray:
    if isinstance(x, str):
        x = x.encode("utf-8")
    if isinstance(x, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(x), dtype=np.uint8)
    return np.asarray(x, dtype=np.uint8).reshape(-1)


def _as_tensor(haystack, device) -> torch.Tensor:
    if isinstance(haystack, torch.Tensor):
        if haystack.dtype != torch.uint8 or haystack.dim() != 1:
            raise TypeError("a tensor haystack must be 1-D uint8")
        return haystack.contiguous()
    return torch.from_numpy(_host_bytes(haystack).copy()).to(platform.resolve_device(device))


def byteset_mask(charset) -> np.ndarray:
    """256-bit byteset as 8 uint32 words (``sz_byteset_t``; consumed by
    ``sz_find_byteset``, reference ``find.h:272``)."""
    words = np.zeros(8, dtype=np.uint32)
    data = charset if isinstance(charset, (bytes, bytearray)) else bytes(charset)
    for b in data:
        words[b >> 5] |= np.uint32(1 << (b & 31))
    return words


def _search(haystack, device, mode: str, needle=None, byteset_words=None) -> int:
    hay = _as_tensor(haystack, device)
    return int(search_positions(hay, hay.numel(), mode, needle=needle,
                                byteset_words=byteset_words))


def find(haystack, needle, device=None) -> int:
    """Offset of the first occurrence, -1 if absent (``sz_find``, reference
    ``find.h:144``). Empty needle → 0, matching the reference wrappers."""
    nd = _host_bytes(needle)
    if nd.shape[0] == 0:
        return 0
    return _search(haystack, device, "first", needle=nd)


def rfind(haystack, needle, device=None) -> int:
    """Offset of the last occurrence (``sz_rfind``, reference ``find.h:156``)."""
    nd = _host_bytes(needle)
    if nd.shape[0] == 0:
        return _as_tensor(haystack, device).numel()
    return _search(haystack, device, "last", needle=nd)


def find_byte(haystack, byte: int, device=None) -> int:
    """First occurrence of one byte (``sz_find_byte``, reference ``find.h:43``)."""
    return _search(haystack, device, "first", needle=np.array([byte], np.uint8))


def rfind_byte(haystack, byte: int, device=None) -> int:
    return _search(haystack, device, "last", needle=np.array([byte], np.uint8))


def count(haystack, needle, allowoverlap: bool = True, device=None) -> int:
    """Occurrence count. Overlapping by default; greedy left-to-right
    otherwise (Python ``str.count`` semantics, the binding's ``Str.count``
    contract — delegated to ``bytes.count`` on the host)."""
    nd = _host_bytes(needle)
    if not allowoverlap:
        if isinstance(haystack, torch.Tensor):
            return haystack.cpu().numpy().tobytes().count(nd.tobytes())
        return _host_bytes(haystack).tobytes().count(nd.tobytes())
    if nd.shape[0] == 0:
        return _as_tensor(haystack, device).numel() + 1
    return _search(haystack, device, "count", needle=nd)


def count_byte(haystack, byte: int, device=None) -> int:
    return _search(haystack, device, "count", needle=np.array([byte], np.uint8))


def find_byteset(haystack, charset, device=None) -> int:
    """First byte ∈ set (``sz_find_byteset``, reference ``find.h:272``)."""
    return _search(haystack, device, "first", byteset_words=byteset_mask(charset))


def rfind_byteset(haystack, charset, device=None) -> int:
    """Last byte ∈ set (``sz_rfind_byteset``, reference ``find.h:290``)."""
    return _search(haystack, device, "last", byteset_words=byteset_mask(charset))
