"""Fingerprints engine — the public API mirroring ``szs.Fingerprints``.

Counterpart of ``stringzilla_tpu/models/fingerprints.py``. Reference Python
type: ``stringzillas.Fingerprints(ndim, window_widths=None,
alphabet_size=256, seed=0, capabilities=None)``
(``python/stringzillas.c:2085-2150``), called as ``engine(texts,
device=None)`` and returning ``(min_hashes, min_counts)``, two ``(docs,
ndim) uint32`` arrays (``python/stringzillas.c:2162-2300``, C ABI
``stringzillas.h:516-580``).

One call plans the collection's device tape on the host and launches the
MinHash kernel over it (``ops/fingerprints_kernel.py``; a second, small
launch merges the documents the plan cut into byte ranges), writing the
``(docs, ndim)`` layout directly: no length buckets, no lane or dimension
padding. The outputs are
bit-identical to the reference's f64 engines and to the JAX package's.

A scope over several devices splits the documents into one contiguous part
a device (``parallel/cross.py`` ``sharded_fingerprints``): each device plans
and fingerprints its own part, with the kernel parameters made there once,
and the results are gathered on the scope's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fingerprints import DEFAULT_WINDOW_WIDTHS, derive_params
from ..ops.fingerprints_kernel import fingerprint_all, kernel_params
from ..ops.pack_device import device_tape
from ..ops.tape import Tape
from ..parallel.cross import sharded_fingerprints
from .device_scope import DeviceScope, default_device_scope

__all__ = ["Fingerprints"]


class Fingerprints:
    def __init__(self, ndim: int, window_widths=None, alphabet_size: int = 256,
                 seed: int = 0, capabilities=None):
        del capabilities  # accepted for API parity
        if ndim <= 0:
            raise ValueError("ndim must be positive")
        self.ndim = int(ndim)
        self.alphabet_size = int(alphabet_size)
        self.seed = int(seed)
        self.window_widths = (tuple(int(w) for w in window_widths)
                              if window_widths is not None else DEFAULT_WINDOW_WIDTHS)
        if any(w < 1 for w in self.window_widths):
            raise ValueError("window widths must be >= 1")
        self._params = derive_params(self.ndim, self.window_widths, self.seed)
        self._on_device: dict[torch.device, dict] = {}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Fingerprints(ndim={self.ndim},window_widths={len(self.window_widths)},"
                f"alphabet_size={self.alphabet_size},seed={self.seed})")

    def _params_on(self, device: torch.device) -> dict:
        """The per-dimension parameters as int64 tensors on ``device``, with
        the kernel's arrays (``kernel_params``), made there once."""
        params = self._on_device.get(device)
        if params is None:
            params = self._on_device[device] = kernel_params(self._params, device)
        return params

    def __call__(self, texts, device: DeviceScope | None = None,
                 out=None, device_out: bool = False):
        """Min-hashes and count-mins of a collection (a list of ``str``,
        ``bytes`` or 1-D ndarrays, or a ``Tape``): two ``(n, ndim) uint32``
        numpy arrays, or the given ``out=(hashes, counts)`` filled in place.

        ``device_out=True`` returns the same bits as two ``(n, ndim)`` int32
        tensors on the scope's first device and pulls nothing: int32 because
        torch 2.11 cannot index a ``torch.uint32`` tensor on CUDA. Their
        ``.numpy().view(np.uint32)`` on the host is the host result; they
        are the input of ``ops.fingerprints.band_keys``."""
        scope = device or default_device_scope()
        # a 1-D ndarray item of any dtype is its raw bytes, as the JAX
        # engine's bytes(item) takes it
        tape = texts if isinstance(texts, Tape) else Tape.from_strings(
            [s.tobytes() if isinstance(s, np.ndarray) and s.ndim == 1 else s
             for s in texts])
        if scope.device_count > 1:
            hashes, counts = sharded_fingerprints(tape.data, tape.offsets[:-1], tape.lengths,
                                                  self._params_on, scope)
        else:
            dt = device_tape(tape, scope.device)
            # starts and lengths stay on the host, where the plan is made
            hashes, counts = fingerprint_all(
                dt.data, torch.from_numpy(dt.starts), torch.from_numpy(dt.lengths),
                self._params_on(scope.device))
        if device_out:
            return hashes, counts
        min_hashes = hashes.cpu().numpy().view(np.uint32)
        min_counts = counts.cpu().numpy().view(np.uint32)
        if out is not None:
            out_h, out_c = out
            out_h[...] = min_hashes
            out_c[...] = min_counts
            return out_h, out_c
        return min_hashes, min_counts
