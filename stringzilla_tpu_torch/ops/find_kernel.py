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
``find_long`` then verifies one launch each. Here the kernel filters on
the few offsets ``filter_offsets`` picks and verifies every needle byte of
the survivors, so ``search_positions`` is exact for any needle length and
``find_long`` is one call of it. ``search_positions`` runs the
hand-written Hopper kernel (``csrc/find.cu``) on CUDA tensors and the plain
PyTorch version ``search_positions_reference`` on CPU tensors.

The kernel's geometry is named here (``csrc/find.cu`` holds the same
values; ``sz_find_geometry`` reports them): CTAs claim tiles of
``TILE_POSITIONS`` start positions; each tile's stage holds ``HALO_BYTES``
more, so the filter's offsets lie within ``REACH`` of the first; the
needle's first ``HEAD_BYTES`` live in shared memory, the rest is uploaded.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import cuda_build

__all__ = ["search_positions", "search_positions_reference", "find_long", "filter_offsets",
           "KERNEL_LAUNCHES", "TILE_POSITIONS", "REACH", "MODES"]

# Launches of the CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"find_search": 0}

MODES = {"first": 0, "last": 1, "count": 2}
TILE_POSITIONS = 16384  # start positions a CTA claims at once: a tile
HALO_BYTES = 128  # bytes past its tile that a stage holds
REACH = HALO_BYTES - 1  # the filter's offsets lie within REACH of the first
MAX_OFFSETS = 3  # offsets a plan may have in the kernel (csrc/find.cu kMaxOffsets)
HEAD_BYTES = 256  # needle bytes the kernel takes by value; longer needles are uploaded
RING_STAGES = 4
CTAS_PER_SM = 2
THREADS = 288  # 8 consumer warps and a producer warp
# as sz_find_geometry reports it
GEOMETRY = (TILE_POSITIONS, HALO_BYTES, RING_STAGES, CTAS_PER_SM, MAX_OFFSETS, HEAD_BYTES,
            THREADS)

# Offsets filter_offsets picks for needles with that many bytes within
# reach. 3 ran the dense-prefix probe 4.2x faster than 2 (the first and last
# byte, or the last and the rarest) and the 1 GiB random scan as fast; 4 was
# 15% slower on both (tools/find_ab.py --plans; PERF.md §6 row 9).
FILTER_OFFSETS = 3


def _byte_rank() -> np.ndarray:
    """Rank of each byte value, rarest first: an assumed order for ASCII
    text and machine logs, not fitted to a corpus. Bytes >= 0x80 and control
    bytes; uppercase letters; punctuation and symbols; digits; lowercase
    letters; then tab, newline, carriage return and space. Letters run from
    the rarest to the commonest in English text (Lewand, Cryptological
    Mathematics, 2000: etaoinshrdlcumwfgypbvkjxqz)."""
    by_use = b"etaoinshrdlcumwfgypbvkjxqz"[::-1]
    order = [b for b in range(256) if b >= 0x80 or (b < 0x20 and b not in b"\t\n\r") or b == 0x7F]
    order += list(by_use.upper())
    order += [b for b in range(0x21, 0x7F) if not chr(b).isalnum()]
    order += list(b"0123456789") + list(by_use) + list(b"\t\n\r ")
    rank = np.empty(256, np.int32)
    rank[order] = np.arange(256)
    return rank


BYTE_RANK = _byte_rank()


def filter_offsets(needle) -> tuple:
    """The ascending needle offsets the kernel's filter compares, a pure
    function of the needle's bytes: distinct, within ``[0, min(k, REACH +
    1))``. The last reachable byte ``min(k - 1, REACH)``, then the rarest
    others by ``BYTE_RANK`` (earlier first among equals), values not yet
    taken first, after the reference's anomaly offsets (find/serial.h:35),
    until there are ``FILTER_OFFSETS`` (the kernel takes up to
    ``MAX_OFFSETS``)."""
    nd = bytes(needle)
    k = len(nd)
    if k == 0:
        raise ValueError("the needle must not be empty")
    last = min(k - 1, REACH)
    want = min(FILTER_OFFSETS, last + 1)
    ranked = sorted(range(last), key=lambda j: (BYTE_RANK[nd[j]], j))
    chosen, values = [last], {nd[last]}
    for j in ranked:  # distinct values first
        if len(chosen) == want:
            break
        if nd[j] not in values:
            chosen.append(j)
            values.add(nd[j])
    for j in ranked:  # then repeats, if the needle has too few values
        if len(chosen) == want:
            break
        if j not in chosen:
            chosen.append(j)
    return tuple(sorted(chosen))


@functools.lru_cache(maxsize=256)
def _host_args(needle: bytes | None, words: bytes | None) -> tuple:
    """The kernel's host arguments for a needle or a byteset's 8 words (as
    bytes): (kind, the needle's head of HEAD_BYTES, the MAX_OFFSETS int32
    offsets of its filter, their count, the 8 byteset words), numpy arrays
    the C call reads, and their addresses. Cached: a search loop repeats
    its needle."""
    head = np.zeros(HEAD_BYTES, np.uint8)
    offsets = np.zeros(MAX_OFFSETS, np.int32)
    set_words = np.zeros(8, np.uint32)
    if needle is not None:
        kind = 0
        head[: min(len(needle), HEAD_BYTES)] = np.frombuffer(needle[:HEAD_BYTES], np.uint8)
        chosen = filter_offsets(needle)
        offsets[: len(chosen)] = chosen
        n_off = len(chosen)
    else:
        kind, n_off = 1, 0
        set_words[:] = np.frombuffer(words, np.uint32)
    arrays = (head, offsets, set_words)
    return (kind, n_off, *(a.ctypes.data for a in arrays), arrays)


_CARDS: dict = {}  # device index -> (kernel library, SM count)


def _card(device: torch.device) -> tuple:
    """The kernel library and ``device``'s SM count, looked up once."""
    got = _CARDS.get(device.index)
    if got is None:
        got = _CARDS[device.index] = (
            cuda_build.load(), torch.cuda.get_device_properties(device).multi_processor_count)
    return got


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


def _launch(hay: torch.Tensor, n: int, mode: str, args: tuple, needle_dev, k: int, lo: int,
            hi: int, scratch: torch.Tensor) -> None:
    """One ``sz_find_search`` call (a memset of ``scratch`` and one launch
    on the current stream) with ``_host_args``' ``args``; raises if it
    fails. The answer lands in ``scratch[2]``."""
    kind, n_off, head, offsets, set_words, _ = args
    lib, sms = _card(hay.device)
    # the raw handle of the current stream, without the Stream object that
    # torch.cuda.current_stream builds (a few microseconds a call)
    stream = torch._C._cuda_getCurrentRawStream(hay.device.index)
    call = (hay.data_ptr(), n, MODES[mode], kind, head,
            needle_dev.data_ptr() if needle_dev is not None else None, k, offsets, n_off,
            set_words, lo, hi, scratch.data_ptr(), sms, stream)
    if hay.device.index == torch.cuda.current_device():
        err = lib.sz_find_search(*call)
    else:
        with torch.cuda.device(hay.device):
            err = lib.sz_find_search(*call)
    if err != 0:
        raise RuntimeError(f"sz_find_search launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")


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
    args = _host_args(None if needle is None else needle.tobytes(),
                      None if words is None else words.tobytes())
    # the caching allocator reuses needle_dev's block only for work queued
    # after this launch on the same stream
    needle_dev = (torch.from_numpy(needle.copy()).to(hay.device)
                  if needle is not None and k > HEAD_BYTES else None)
    scratch = torch.empty(3, dtype=torch.int64, device=hay.device)
    _launch(hay, int(n), mode, args, needle_dev, k, lo, hi, scratch)
    KERNEL_LAUNCHES["find_search"] += 1
    return scratch[2]


def find_long(hay: torch.Tensor, n: int, needle, reverse: bool = False) -> int:
    """Exact first (or, with ``reverse``, last) match of ``needle`` in
    ``hay[:n]``, -1 if none. The JAX function filters and then verifies
    candidates one by one; ``search_positions`` is exact for any length, so
    this is one call and one pull."""
    return int(search_positions(hay, n, "last" if reverse else "first", needle=needle))
