"""Byte lookup transform — the ``memory`` domain's one kernel.

Counterpart of ``stringzilla_tpu/ops/memory_pallas.py``: ``sz_lookup``
(reference ``include/stringzilla/memory.h:153``), a 256-entry table applied
to every byte of a buffer. The class-cost engines map each collection's
byte blob to cost classes with it, once per collection.

    lookup_transform(data, lut) -> uint8 tensor of data's shape

``data`` is a 1-D ``uint8`` tensor of any length; ``lut`` is 256 bytes (a
``uint8`` tensor or anything numpy reads as one). The JAX function takes a
``(rows, 128)`` buffer padded to its block; here the kernel handles any
length, so there is nothing to pad. ``lookup_transform`` runs the
hand-written Hopper kernel (``csrc/lut.cu``) on CUDA tensors and the plain
PyTorch version ``lookup_reference`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build

__all__ = ["lookup_transform", "lookup_reference", "KERNEL_LAUNCHES"]

# Launches of the CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"byte_lut": 0}


def _lut_on(lut, device: torch.device) -> torch.Tensor:
    if not isinstance(lut, torch.Tensor):
        lut = torch.from_numpy(np.array(lut, dtype=np.uint8))  # a copy: lut may be read-only
    if lut.dtype != torch.uint8 or lut.shape != (256,):
        raise ValueError(f"lut must be 256 uint8 values, got {lut.dtype} {tuple(lut.shape)}")
    return lut.to(device).contiguous()


def _check(data) -> None:
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError("data must be a 1-D uint8 tensor")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")


def lookup_reference(data: torch.Tensor, lut) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one gather from the table."""
    _check(data)
    return _lut_on(lut, data.device)[data.long()]


def lookup_transform(data: torch.Tensor, lut) -> torch.Tensor:
    """``lut[data]`` byte by byte: the Hopper kernel for CUDA tensors, the
    plain version for CPU ones."""
    _check(data)
    if data.device.type == "cpu":
        return lookup_reference(data, lut)
    if data.device.type != "cuda":
        raise ValueError(f"lookup_transform runs on CUDA or CPU tensors, not {data.device}")
    lut_t = _lut_on(lut, data.device)
    out = torch.empty_like(data)
    if data.numel() == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        sms = torch.cuda.get_device_properties(data.device).multi_processor_count
        err = lib.sz_lookup(data.data_ptr(), data.numel(), lut_t.data_ptr(),
                            out.data_ptr(), sms, stream)
    if err != 0:
        raise RuntimeError(f"sz_lookup launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES["byte_lut"] += 1
    return out
