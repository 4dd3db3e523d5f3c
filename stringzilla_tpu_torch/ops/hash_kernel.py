"""Batched ``sz_hash`` of string collections on the card.

Counterpart of ``stringzilla_tpu/ops/hash_pallas.py``:

    hash_tokens_raw(blob, starts, lengths, seed=0) -> int64 tensor
    hash_batch_device(items, seed=0, device=None)  -> uint64[n]
    hash_bounds_device(buf, starts, ends, seed=0, device=None) -> uint64[n]
    hash_long_device(items, seed=0, device=None)   -> uint64[n]

* ``blob``     1-D ``uint8`` tensor; string i is
  ``blob[starts[i] : starts[i] + lengths[i]]``;
* ``starts``, ``lengths``  1-D int64 tensors on ``blob``'s device;
* the digests are bit-identical to ``ops.hash.sz_hash`` (reference
  ``hash/serial.h:506-599``): int64 tensors holding the u64 bits on the
  device (torch on CUDA lacks most ``uint64`` operations), ``uint64``
  numpy arrays on the host.

Strings of at most 64 bytes run ``hash_short``, longer ones ``hash_long``
(a quad a string, or a warp a string from ``WIDE_BYTES`` on, each string
by its own length): the hand-written Hopper kernels of ``csrc/hash.cu`` on
CUDA tensors, the plain PyTorch versions ``hash_short_reference`` and
``hash_long_reference`` on CPU tensors. Each kernel writes the digests of
its own strings and leaves the others' entries as they are.

The JAX module buckets strings by block count (short) or dyadic chunk
count (long) and packs each bucket into byte planes, because each bucket
is a compiled shape; here a thread (short), four or a warp (long) read each
string straight from the blob at its own offset, so nothing is padded. Only
``hash_short`` groups by block count, inside the kernel: a warp takes
32 G consecutive strings and hashes them in rounds of 32 in order of their
block count (``short_order`` is that order), so the lanes of a round run
about their own strings' blocks. The JAX module hashes strings over 2 MiB on the host (a VMEM
limit); the card has no such limit, and every length runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build, platform
from .aes_kernel import aes_round, bytes_to_words, words_to_bytes
from .hash import PI, SHUFFLE
from .pack_device import DeviceTape, device_tape
from .tape import Tape

__all__ = ["hash_tokens_raw", "hash_batch_device", "hash_bounds_device", "hash_long_device",
           "hash_short", "hash_long", "hash_short_reference", "hash_long_reference",
           "hash_long_plan", "kernel_routes", "short_blocks", "short_order", "short_steps",
           "KERNEL_LAUNCHES", "SHORT_MAX", "SHORT_GEOMETRY", "WIDE_BYTES"]

# Launches of the CUDA kernels, counted where the wrappers launch them
# (hash_long launches hash_long, hash_long_wide or both).
KERNEL_LAUNCHES = {"hash_short": 0, "hash_long": 0, "hash_long_wide": 0}

SHORT_MAX = 64  # the longest string of the short path (hash/serial.h:506)
_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


def _check(blob, starts, lengths, out):
    if not isinstance(blob, torch.Tensor) or blob.dtype != torch.uint8 or blob.dim() != 1:
        raise TypeError("blob must be a 1-D uint8 tensor")
    if not blob.is_contiguous():
        raise ValueError("blob must be contiguous")
    for name, t in (("starts", starts), ("lengths", lengths)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor")
        if t.device != blob.device:
            raise ValueError(f"{name} is on {t.device}, blob on {blob.device}")
    if starts.shape != lengths.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and lengths "
                         f"{tuple(lengths.shape)} differ")
    if out is None:
        return torch.zeros(starts.numel(), dtype=torch.int64, device=blob.device)
    if out.dtype != torch.int64 or out.shape != starts.shape or out.device != blob.device \
            or not out.is_contiguous():
        raise ValueError("out must be a contiguous int64 tensor shaped like starts, on "
                         "blob's device")
    return out


# -- plain versions ----------------------------------------------------------

def _u64_pairs(seed: int, first: int, count: int) -> np.ndarray:
    """``seed ^ PI[first : first + count]`` as little-endian bytes."""
    return (np.uint64(seed) ^ PI[first: first + count]).astype("<u8").view(np.uint8)


def _sum_update(summ: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """shuffle(sum) + data as two wrapping u64 lanes, on ``(..., 16)`` bytes."""
    a = bytes_to_words(summ[..., torch.as_tensor(SHUFFLE, device=summ.device)])
    b = bytes_to_words(data)
    lo = a[..., 0::2] + b[..., 0::2]  # u32 halves in int64: no overflow
    hi = a[..., 1::2] + b[..., 1::2] + (lo >> 32)
    return words_to_bytes(torch.stack([lo & _U32, hi & _U32], dim=-1).flatten(-2))


def _key_with_length(seed: int, lengths: torch.Tensor) -> torch.Tensor:
    """(seed + length, seed) as u64 lanes, wrapping, as ``(n, 16)`` bytes."""
    low = (seed & _U32) + lengths
    lo, hi = low & _U32, ((seed >> 32) + (low >> 32)) & _U32
    return words_to_bytes(torch.stack(
        [lo, hi, torch.full_like(lo, seed & _U32), torch.full_like(lo, seed >> 32)], dim=1))


def _gather(blob, starts, counts, width: int) -> torch.Tensor:
    """``(n, width)`` bytes of each string from its start, zero past ``counts``."""
    j = torch.arange(width, device=blob.device)
    valid = j[None, :] < counts[:, None]
    return torch.where(valid, blob[torch.where(valid, starts[:, None] + j, 0)], 0)


def _digest(result: torch.Tensor) -> torch.Tensor:
    """The first 8 bytes of each block as the int64 of the same bits."""
    return result[:, :8].contiguous().view(torch.int64)[:, 0]


def hash_short_reference(blob, starts, lengths, seed: int = 0, out=None) -> torch.Tensor:
    """Plain PyTorch version of ``hash_short``: strings of the same 16-byte
    block count (1-4) advance through the AES pipeline together, as the
    numpy ``hash_batch`` groups them."""
    out = _check(blob, starts, lengths, out)
    seed = int(seed) & _U64
    dev = blob.device
    blocks = torch.clamp((lengths + 15) // 16, min=1)
    short = (lengths >= 0) & (lengths <= SHORT_MAX)
    aes0 = torch.from_numpy(_u64_pairs(seed, 0, 2)).to(dev)
    sum0 = torch.from_numpy(_u64_pairs(seed, 8, 2)).to(dev)
    for nb in range(1, 5):
        idx = torch.nonzero(short & (blocks == nb)).flatten()
        if idx.numel() == 0:
            continue
        lens = lengths[idx]
        data = _gather(blob, starts[idx], lens, 16 * nb)
        aes = aes0.expand(idx.numel(), 16)
        summ = sum0.expand(idx.numel(), 16)
        for b in range(nb):
            block = data[:, 16 * b: 16 * b + 16]
            aes = aes_round(aes, block)
            summ = _sum_update(summ, block)
        mixed = aes_round(summ, aes)
        out[idx] = _digest(aes_round(aes_round(mixed, _key_with_length(seed, lens)), mixed))
    return out


def hash_long_reference(blob, starts, lengths, seed: int = 0, out=None) -> torch.Tensor:
    """Plain PyTorch version of ``hash_long``: the strings of a dyadic group
    of full-chunk counts step together, one 64-byte chunk at a time, over a
    ``(n, 4, 16)`` state of four AES and four sum lanes."""
    out = _check(blob, starts, lengths, out)
    seed = int(seed) & _U64
    dev = blob.device
    idx_long = torch.nonzero(lengths > SHORT_MAX).flatten()
    if idx_long.numel() == 0:
        return out
    full = (lengths[idx_long] - 1) // 64
    group = torch.ceil(torch.log2(full.double())).long()  # dyadic group of the chunk count
    aes0 = torch.from_numpy(_u64_pairs(seed, 0, 8).reshape(4, 16)).to(dev)
    sum0 = torch.from_numpy(_u64_pairs(seed, 8, 8).reshape(4, 16)).to(dev)
    for g in torch.unique(group).tolist():
        sel = torch.nonzero(group == g).flatten()
        idx, chunks = idx_long[sel], full[sel]
        st, lens = starts[idx], lengths[idx]
        aes = aes0.expand(idx.numel(), 4, 16)
        summ = sum0.expand(idx.numel(), 4, 16)
        for k in range(int(chunks.max())):
            live = (k < chunks)[:, None, None]
            block = _gather(blob, st + 64 * k, torch.where(chunks > k, 64, 0), 64).view(-1, 4, 16)
            aes = torch.where(live, aes_round(aes, block), aes)
            summ = torch.where(live, _sum_update(summ, block), summ)
        tail = _gather(blob, st + 64 * chunks, lens - 64 * chunks, 64).view(-1, 4, 16)
        mixed = aes_round(_sum_update(summ, tail), aes_round(aes, tail))
        mixed_all = aes_round(aes_round(mixed[:, 0], mixed[:, 1]),
                              aes_round(mixed[:, 2], mixed[:, 3]))
        result = aes_round(aes_round(mixed_all, _key_with_length(seed, lens)), mixed_all)
        out[idx] = _digest(result)
    return out


# -- kernels -----------------------------------------------------------------

# CTAs of the long path: a multiple of 32 threads up to 256, at most 8 an SM.
_MAX_THREADS = 256
_BLOCKS_PER_SM = 8
_LONG_THREADS = {"hash_long": 4, "hash_long_wide": 32}  # threads a string
# Bytes from which a string goes to hash_long_wide (a warp a string, 32
# chunks of loads in flight) rather than hash_long (a quad a string, one
# chunk ahead); each string by its own length. tools/dp_hash_sweep.py timed
# both on strings of one length (NVIDIA H100 80GB HBM3, 700 W): on 64 MiB
# batches, which fill the card, the quad was faster up to 8 KiB (1.9-7x)
# and the two within 10% at 16 KiB; at 64 KiB the warp kernel was 3.5x
# faster. On batches of 1,056 strings the warp kernel won from 2 KiB, by
# tens of microseconds.
WIDE_BYTES = 16384


def hash_long_plan(count: int, sms: int, kernel: str) -> tuple[int, int]:
    """``(threads, blocks)`` of a launch of ``kernel`` (``"hash_long"``, a
    quad a string, or ``"hash_long_wide"``, a warp a string) over ``count``
    strings on ``sms`` SMs: CTAs of the fewest threads (a warp's multiple,
    32-256) that still put every string on the card in at most one CTA an
    SM when strings are few, so a few long strings spread over every SM; at
    most 8 CTAs an SM, striding over the rest. Pure arithmetic on the
    shapes; raises on what it cannot place."""
    if kernel not in _LONG_THREADS or count < 1 or sms < 1:
        raise ValueError(f"no {kernel} plan for {count} strings on {sms} SMs")
    threads_needed = _LONG_THREADS[kernel] * count
    per_sm = -(-threads_needed // sms)  # threads an SM when every SM takes one CTA
    threads = min(_MAX_THREADS, max(32, -(-per_sm // 32) * 32))
    blocks = min(-(-threads_needed // threads), sms * _BLOCKS_PER_SM)
    return threads, blocks


# hash_short's launch, as csrc/hash.cu's sz_hash_short_geometry reports it:
# (G, threads a CTA, CTAs an SM). A warp takes 32 G consecutive strings at a
# time and hashes them in G rounds of 32 in order of their block count.
SHORT_GEOMETRY = (4, 1024, 1)


def short_blocks(lengths) -> np.ndarray:
    """Each string's 16-byte block count on the short path (1-4, a string
    of 0 bytes one), 0 for a length outside 0-64, which it does not hash."""
    lengths = np.asarray(lengths, np.int64)
    blocks = np.maximum((lengths + 15) // 16, 1)
    return np.where((lengths >= 0) & (lengths <= SHORT_MAX), blocks, 0)


def short_order(lengths, group: int = SHORT_GEOMETRY[0]) -> tuple[np.ndarray, np.ndarray]:
    """The order in which ``hash_short`` takes the strings of these host
    lengths, which the kernel's ranking computes: ``(order, bounds)``, where
    ``order[bounds[g]:bounds[g + 1]]`` are the indices of group g's hashed
    strings (group g is strings ``32 group g`` to ``32 group (g + 1) - 1``,
    the last one shorter) in the order of its rounds (round r, lane l takes
    its entry 32 r + l): block counts ascending, a count's strings in index
    order. Strings of lengths outside 0-64 are in no group's order."""
    blocks = short_blocks(lengths)
    size = 32 * group
    n_groups = -(-len(blocks) // size)
    idx = np.nonzero(blocks)[0]
    order = idx[np.lexsort((idx, blocks[idx], idx // size))]
    bounds = np.searchsorted(order // size, np.arange(n_groups + 1))
    return order, bounds


def short_steps(lengths, group: int | None = SHORT_GEOMETRY[0]) -> int:
    """Lane-steps of block absorption the warps of ``hash_short`` run on
    these lengths: each round of 32 lanes runs as many steps as its longest
    string has blocks. ``group=None`` is a thread a string in index order
    (rounds of 32 consecutive strings), as before the grouping."""
    blocks = short_blocks(lengths)
    if group is None:
        firsts = np.arange(0, len(blocks), 32)
    else:
        order, bounds = short_order(lengths, group)
        blocks = blocks[order]
        rounds = -(-np.diff(bounds) // 32)  # each group's rounds
        nth = np.arange(rounds.sum()) - np.repeat(np.cumsum(rounds) - rounds, rounds)
        firsts = np.repeat(bounds[:-1], rounds) + 32 * nth
    if len(firsts) == 0:
        return 0
    return int(32 * np.maximum.reduceat(blocks, firsts).sum())


def _launch(kernel: str, blob, starts, lengths, seed, out):
    dev = blob.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, not {dev}")
    n = starts.numel()
    if n == 0:
        return out
    starts, lengths = starts.contiguous(), lengths.contiguous()
    lib = cuda_build.load()
    symbol = "sz_" + kernel
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        args = (blob.data_ptr(), blob.numel(), starts.data_ptr(), lengths.data_ptr(), n,
                int(seed) & _U64)
        if kernel == "hash_short":
            err = lib.sz_hash_short(*args, out.data_ptr(), sms, stream)
        else:
            err = getattr(lib, symbol)(*args, WIDE_BYTES, out.data_ptr(),
                                       *hash_long_plan(n, sms, kernel), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES[kernel] += 1
    return out


def hash_short(blob, starts, lengths, seed: int = 0, out=None) -> torch.Tensor:
    """Digests of the strings of at most 64 bytes into ``out`` (zeros when
    None), the others' entries left as they are: the Hopper kernel for CUDA
    tensors, the plain version for CPU ones."""
    out = _check(blob, starts, lengths, out)
    if blob.device.type == "cpu":
        return hash_short_reference(blob, starts, lengths, seed, out)
    return _launch("hash_short", blob, starts, lengths, seed, out)


def hash_long(blob, starts, lengths, seed: int = 0, out=None, *, quad: bool | None = None,
              wide: bool | None = None) -> torch.Tensor:
    """Digests of the strings of more than 64 bytes into ``out``, as
    ``hash_short`` does for the short ones: on CUDA tensors ``hash_long``
    hashes those under ``WIDE_BYTES`` and ``hash_long_wide`` the others. A
    caller that knows whether any string falls in each range (from lengths
    it holds on the host) passes ``quad`` and ``wide``, and a kernel with no
    string is not launched; when None, that is read from ``lengths`` on the
    device (one small transfer)."""
    out = _check(blob, starts, lengths, out)
    if blob.device.type == "cpu":
        return hash_long_reference(blob, starts, lengths, seed, out)
    if quad is None or wide is None:
        found = torch.stack([((lengths > SHORT_MAX) & (lengths < WIDE_BYTES)).any(),
                             (lengths >= WIDE_BYTES).any()]).tolist()
        quad = found[0] if quad is None else quad
        wide = found[1] if wide is None else wide
    if quad:
        _launch("hash_long", blob, starts, lengths, seed, out)
    if wide:
        _launch("hash_long_wide", blob, starts, lengths, seed, out)
    return out


def kernel_routes(lengths: np.ndarray) -> dict:
    """Which kernels the strings of these host lengths reach: ``short``
    (``hash_short``), and ``quad`` and ``wide``, ``hash_long``'s arguments."""
    n_short = np.count_nonzero(lengths <= SHORT_MAX)
    n_wide = np.count_nonzero(lengths >= WIDE_BYTES)
    return {"short": n_short > 0, "quad": len(lengths) > n_short + n_wide, "wide": n_wide > 0}


def hash_tokens_raw(blob, starts, lengths, seed: int = 0, *, short: bool = True,
                    long: bool = True) -> torch.Tensor:
    """Digest bits of every string, an int64 tensor on ``blob``'s device. A
    caller that knows no string is short (or long) passes ``short=False``
    (``long=False``) to skip that path; ``hash_long`` reads which of its
    kernels to launch from ``lengths`` on the device."""
    out = _check(blob, starts, lengths, None)
    if short:
        hash_short(blob, starts, lengths, seed, out)
    if long:
        hash_long(blob, starts, lengths, seed, out)
    return out


def _hash_tape(dt: DeviceTape, seed: int) -> np.ndarray:
    """``uint64`` digests of every string of a device tape, pulled once; the
    kernels to launch are read from the tape's host lengths."""
    if len(dt) == 0:
        return np.zeros(0, dtype=np.uint64)
    starts = torch.from_numpy(dt.starts).to(dt.device)
    lengths = torch.from_numpy(dt.lengths).to(dt.device)
    out = _check(dt.data, starts, lengths, None)
    routes = kernel_routes(dt.lengths)
    if routes["short"]:
        hash_short(dt.data, starts, lengths, seed, out)
    if routes["quad"] or routes["wide"]:
        hash_long(dt.data, starts, lengths, seed, out, quad=routes["quad"], wide=routes["wide"])
    return out.cpu().numpy().view(np.uint64)


def hash_batch_device(items, seed: int = 0, device=None) -> np.ndarray:
    """``sz_hash`` of every string of a list of byte strings or a ``Tape``,
    as ``uint64``: the blob goes to ``device`` (``cuda:0`` when None) once,
    and each string is read there at its offset."""
    tape = items if isinstance(items, Tape) else Tape.from_strings([bytes(s) for s in items])
    return _hash_tape(device_tape(tape, platform.resolve_device(device)), seed)


def hash_bounds_device(buf, starts, ends, seed: int = 0, device=None) -> np.ndarray:
    """``sz_hash`` over ``(start, end)`` spans of one buffer: the zero-copy
    ``Strs.hashes`` path. A tensor ``buf`` (a ``Str``'s device mirror) is
    read where it lies; anything else is copied to ``device`` first."""
    if not isinstance(buf, torch.Tensor):
        host = np.asarray(buf, dtype=np.uint8).reshape(-1)
        blob = np.zeros(host.shape[0] + 1, dtype=np.uint8)  # the trailing byte of a DeviceTape
        blob[:-1] = host
        buf = torch.from_numpy(blob).to(platform.resolve_device(device))
    return _hash_tape(DeviceTape.from_bounds(buf, starts, ends), seed)


def hash_long_device(items, seed: int = 0, device=None) -> np.ndarray:
    """``sz_hash`` of strings over 64 bytes through ``hash_long`` alone. The
    JAX function's ``ncm`` (a compiled bucket) has no counterpart here."""
    tape = Tape.from_strings([bytes(s) for s in items])
    if (tape.lengths <= SHORT_MAX).any():
        raise ValueError(f"hash_long_device hashes strings over {SHORT_MAX} bytes")
    return _hash_tape(device_tape(tape, platform.resolve_device(device)), seed)
