"""The AES round in plain PyTorch, and ``fill_random`` on the card.

Counterpart of ``stringzilla_tpu/ops/aes_pallas.py``:

    aes_round(state, key) -> (..., 16) uint8
    fill_random_device(length, nonce=0, device=None) -> uint8 tensor [length]
    fill_random_reference(length, nonce=0, device=None)

* ``aes_round`` is one AESENC (SubBytes, ShiftRows, MixColumns, xor key)
  on ``uint8`` blocks of 16 bytes, batched over the leading axes, as the
  host ``ops.hash.aesenc`` computes it in numpy. The plain hash versions of
  ``ops.hash_kernel`` share it;
* ``fill_random_device`` is ``sz_fill_random`` (reference
  ``hash/serial.h:953-968``), bit-identical to the host ``ops.hash.
  fill_random``: block ``l`` is ``AESENC(ctr || ctr, nonce ^ PI[2(l % 4)]
  || nonce ^ PI[2(l % 4) + 1])`` with ``ctr = nonce + l`` mod 2^64. On a
  card it runs the hand-written Hopper kernel (``csrc/hash.cu``
  ``fill_random``), on the CPU ``fill_random_reference``. ``device=None``
  is ``cuda:0``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build, platform
from .hash import PI, SBOX, SHIFTROWS_SRC

__all__ = ["aes_round", "fill_random_device", "fill_random_reference",
           "words_to_bytes", "bytes_to_words", "KERNEL_LAUNCHES"]

# Launches of the CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"fill_random": 0}

_U32 = 0xFFFFFFFF
_tables: dict = {}


def _on(device: torch.device, name: str, array: np.ndarray) -> torch.Tensor:
    """A constant table as a tensor on ``device``, made once per device."""
    key = (name, device)
    if key not in _tables:
        _tables[key] = torch.from_numpy(np.ascontiguousarray(array)).to(device)
    return _tables[key]


def aes_round(state: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """One AESENC round on ``(..., 16) uint8`` blocks; ``key`` broadcasts."""
    dev = state.device
    sub = _on(dev, "sbox", SBOX)[state.long()]
    shifted = sub[..., _on(dev, "shiftrows", SHIFTROWS_SRC)]
    cols = shifted.reshape(*shifted.shape[:-1], 4, 4)
    rot = cols.roll(-1, dims=-1)
    xor_all = cols[..., :1] ^ cols[..., 1:2] ^ cols[..., 2:3] ^ cols[..., 3:4]
    g = cols ^ rot
    dbl = (g << 1) ^ ((g >> 7) * 0x1B)  # GF(2^8) doubling; uint8 drops the carry
    return (cols ^ xor_all ^ dbl).reshape(state.shape) ^ key


def bytes_to_words(blocks: torch.Tensor) -> torch.Tensor:
    """``(..., 4k) uint8`` as ``(..., k)`` int64 holding little-endian u32 words."""
    return blocks.contiguous().view(torch.int32).to(torch.int64) & _U32


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """Inverse of ``bytes_to_words``: int64 u32 words to ``uint8`` bytes."""
    bits = (words - ((words >> 31) << 32)).to(torch.int32)  # the same 32 bits, signed
    return bits.contiguous().view(torch.uint8)


def _u64_block(lo: int, hi: int) -> np.ndarray:
    """Two u64 lanes as 16 little-endian bytes."""
    return np.array([lo, hi], dtype="<u8").view(np.uint8)


def _fill_keys() -> np.ndarray:
    """The four keys' PI halves, ``(4, 16)`` bytes: PI[2v] || PI[2v + 1]."""
    return PI[:8].astype("<u8").view(np.uint8).reshape(4, 16)


def fill_random_reference(length: int, nonce: int = 0, device=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one vectorised AESENC over all
    counter blocks, as ``ops.hash.fill_random`` does in numpy."""
    dev = platform.resolve_device(device)
    if length <= 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    nonce = int(nonce) & ((1 << 64) - 1)
    blocks = -(-length // 16)
    lanes = torch.arange(blocks, dtype=torch.int64, device=dev)
    low = (nonce & _U32) + lanes
    ctr_lo, ctr_hi = low & _U32, ((nonce >> 32) + (low >> 32)) & _U32
    inp = words_to_bytes(torch.stack([ctr_lo, ctr_hi, ctr_lo, ctr_hi], dim=1))
    nonce_bytes = np.tile(_u64_block(nonce, nonce), 4).reshape(4, 16)
    keys = torch.from_numpy(_fill_keys() ^ nonce_bytes).to(dev)
    out = aes_round(inp, keys[lanes & 3]).reshape(-1)
    return out[:length]


def fill_random_device(length: int, nonce: int = 0, device=None) -> torch.Tensor:
    """``sz_fill_random`` bytes as a ``uint8`` tensor on ``device`` (``cuda:0``
    when None): the Hopper kernel on a card, the plain version on the CPU."""
    dev = platform.resolve_device(device)
    if dev.type == "cpu":
        return fill_random_reference(length, nonce, dev)
    if dev.type != "cuda":
        raise ValueError(f"fill_random_device runs on CUDA or CPU devices, not {dev}")
    if length <= 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    blocks = -(-length // 16)
    out = torch.empty(16 * blocks, dtype=torch.uint8, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = lib.sz_fill_random(int(nonce) & ((1 << 64) - 1), blocks, out.data_ptr(), sms,
                                 stream)
    if err != 0:
        raise RuntimeError(f"sz_fill_random launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES["fill_random"] += 1
    return out[:length]
