"""Rolling MinHash + count-min of every document for every dimension.

Counterpart of ``stringzilla_tpu/ops/fingerprints_pallas.py``:

    fingerprint_all(blob, starts, lengths, params) -> (hashes, counts)

* ``blob``     1-D ``uint8`` document bytes; document k is
  ``blob[starts[k] : starts[k] + lengths[k]]``;
* ``starts``, ``lengths``  1-D int64, one entry a document;
* ``params``   the per-dimension int64 tensors of ``ops.fingerprints``
  (``width``, ``mult``, ``modulo``, ``fused_disc``; ``params_from`` or
  ``derive_params``; widths >= 1), on any device;
* returns two ``(n_docs, ndim)`` int32 tensors holding the u32 bits of each
  minimum hash (``0xFFFFFFFF`` for a document shorter than the window) and
  the count of windows that reached it.

The JAX function takes documents packed into a ``(doc_len, n_docs)`` block
per dyadic length bucket, dimensions padded per width group, and limb
parameters; here the kernel streams each document straight from the blob,
so there is nothing to pad. ``fingerprint_all`` runs the hand-written
Hopper kernel (``csrc/fingerprints.cu``) on CUDA tensors and the plain
PyTorch version ``fingerprint_reference`` on CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

__all__ = ["fingerprint_all", "fingerprint_reference", "KERNEL_LAUNCHES"]

# Launches of the CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"fingerprint_minhash": 0}

_NONE = torch.iinfo(torch.int64).max  # a minimum no window has reached yet


def _check(blob, starts, lengths, params):
    if not isinstance(blob, torch.Tensor) or blob.dtype != torch.uint8 or blob.dim() != 1:
        raise TypeError("blob must be a 1-D uint8 tensor")
    for name, t in (("starts", starts), ("lengths", lengths)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor")
        if t.device != blob.device:
            raise ValueError(f"{name} is on {t.device}, blob on {blob.device}")
    if starts.shape != lengths.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and lengths "
                         f"{tuple(lengths.shape)} differ")
    ndim = params["width"].numel()
    for key in ("width", "mult", "modulo", "fused_disc"):
        if tuple(params[key].shape) != (ndim,):
            raise ValueError(f"params[{key!r}] must have shape ({ndim},)")


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` as the int32 of the same bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def fingerprint_reference(blob, starts, lengths, params):
    """Plain PyTorch version of the kernel: one step per byte over a
    ``(n_docs, ndim)`` int64 state, exact (``x < 2^53``, ``%`` on int64)."""
    _check(blob, starts, lengths, params)
    dev = blob.device
    n, ndim = starts.numel(), params["width"].numel()
    w, mult, m, fd = (params[k].to(dev, torch.int64)
                      for k in ("width", "mult", "modulo", "fused_disc"))
    steps = int(lengths.max()) if n else 0
    t = torch.arange(steps, device=dev)
    # Each document's bytes + 1 and, per step and dimension, the column of
    # the byte leaving the window: gathers made once, not once a step.
    live = t[None, :] < lengths[:, None]
    terms = torch.where(live, blob[torch.where(live, starts[:, None] + t[None, :], 0)].long() + 1, 0)
    back = t[:, None] - w[None, :]
    cols, has_old, full = back.clamp(min=0), back >= 0, back >= -1
    state = torch.zeros((n, ndim), dtype=torch.int64, device=dev)
    minimum = torch.full((n, ndim), _NONE, dtype=torch.int64, device=dev)
    count = torch.zeros((n, ndim), dtype=torch.int32, device=dev)
    for i in range(steps):
        old = terms[:, cols[i]] * has_old[i]
        state = (state * mult + fd * old + terms[:, i, None]) % m
        upd = live[:, i, None] & full[i]
        lower = upd & (state < minimum)
        count = torch.where(lower, 1, count + (upd & (state == minimum)))
        minimum = torch.where(lower, state, minimum)
    filled = minimum != _NONE
    hashes = torch.where(filled, _wrap_i32(minimum & 0xFFFFFFFF), -1).to(torch.int32)
    return hashes, torch.where(filled, count, 0)


def fingerprint_all(blob, starts, lengths, params):
    """``(hashes, counts)``, two ``(n_docs, ndim)`` int32 tensors: the Hopper
    kernel for CUDA tensors, the plain version for CPU ones."""
    _check(blob, starts, lengths, params)
    dev = blob.device
    if dev.type == "cpu":
        return fingerprint_reference(blob, starts, lengths, params)
    if dev.type != "cuda":
        raise ValueError(f"fingerprint_all runs on CUDA or CPU tensors, not {dev}")
    n, ndim = starts.numel(), params["width"].numel()
    hashes = torch.empty((n, ndim), dtype=torch.int32, device=dev)
    counts = torch.empty((n, ndim), dtype=torch.int32, device=dev)
    if n == 0 or ndim == 0:
        return hashes, counts
    width = params["width"].to(dev, torch.int32).contiguous()
    mult, modulo, fused = (params[k].to(dev, torch.float64).contiguous()
                           for k in ("mult", "modulo", "fused_disc"))
    starts, lengths = starts.contiguous(), lengths.contiguous()
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sz_fingerprints(blob.data_ptr(), starts.data_ptr(), lengths.data_ptr(), n,
                                  width.data_ptr(), mult.data_ptr(), modulo.data_ptr(),
                                  fused.data_ptr(), ndim, hashes.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sz_fingerprints launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES["fingerprint_minhash"] += 1
    return hashes, counts
