"""Batch similarity engines — the public API mirroring ``szs.*``.

Counterpart of ``stringzilla_tpu/models/similarities.py``. Call convention
matches ``LevenshteinDistances_vectorcall`` (reference
``python/stringzillas.c:581-700``):

    engine(queries, candidates=None, device=None, out=None) -> np.ndarray

``candidates=None`` computes symmetric self-similarity; distances return
``uint64`` (C ABI ``sz_size_t*``, reference ``stringzillas.h:199``).

Host-side scheduling groups strings into dyadic length buckets (the
reference's ``candidate_length_bucket_``, ``serial.hpp:3442-3444``) so every
dense block wastes < 2x on padding; each (query bucket, candidate bucket)
block is scored on the scope's device by the Myers kernel and scattered into
one device result, pulled to the host once.

This slice of the port covers unit-cost byte Levenshtein with strings of at
most 4096 bytes. Other configurations raise ``NotImplementedError`` naming
the ROADMAP item that brings them; none computes an approximate answer.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from ..ops.myers import myers
from ..ops.pack_device import device_tape, pack_chars
from ..ops.similarity import LinearGaps, AffineGaps, SimilarityConfig, UniformCosts
from ..ops.tape import Tape, round_up
from .device_scope import DeviceScope, default_device_scope

__all__ = [
    "LevenshteinDistances",
    "LevenshteinDistancesUTF8",
    "NeedlemanWunsch",
    "SmithWaterman",
]

_LONG_THRESHOLD = 4096  # longer pairs wait for the wavefront tier


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to stringzilla_tpu_torch yet (ROADMAP.md, "
        f"queue 1: {item}); stringzilla_tpu computes it on a TPU")


def _reject_integer_like(s) -> None:
    """Integer-like items must raise TypeError like the reference binding —
    ``bytes(n)`` would silently yield an n-byte ZERO-FILLED string."""
    try:
        operator.index(s)
    except TypeError:
        return
    raise TypeError(f"expected a string-like item, got {type(s).__name__}")


def _as_int_arrays(items) -> list[np.ndarray]:
    out = []
    for s in items:
        if isinstance(s, str):
            s = s.encode("utf-8")
        elif not isinstance(s, (bytes, np.ndarray)):
            _reject_integer_like(s)
            s = bytes(s)  # bytearray/memoryview views
        if isinstance(s, np.ndarray):
            out.append(s.astype(np.int32))
        else:
            out.append(np.frombuffer(s, dtype=np.uint8).astype(np.int32))
    return out


def _dyadic(lengths: np.ndarray, minimum: int = 8) -> np.ndarray:
    """Smallest power of two >= max(n, minimum), elementwise: frexp's
    exponent is the exact bit length of integers below 2**53."""
    exponent = np.frexp(np.maximum(lengths, minimum) - 1)[1]
    return np.left_shift(1, exponent.astype(np.int64))


def _group_dyadic(lengths: np.ndarray) -> dict[int, np.ndarray]:
    sizes = _dyadic(np.asarray(lengths, dtype=np.int64))
    return {int(b): np.nonzero(sizes == b)[0] for b in np.unique(sizes)}


class _HostFallback(Exception):
    """Raised when a collection can't take the device-tape path
    (pre-decoded ndarray inputs, whose values are chars, not raw bytes)."""


class _HostCollection:
    """Host-packed collection for int-array inputs: each block is packed on
    the host and copied to the scope's device, where it is scored."""

    def __init__(self, items, device: torch.device):
        self._arrs = _as_int_arrays(items)
        self.lens = np.array([len(a) for a in self._arrs], dtype=np.int64)
        self._device = device

    def __len__(self) -> int:
        return len(self._arrs)

    def pack(self, idx, rows: int, fill: int):
        """``(rows, len(idx))`` int32 char block and ``len(idx)`` int32
        lengths, on the device."""
        block = np.full((rows, len(idx)), fill, dtype=np.int32)
        for col, i in enumerate(idx):
            block[: self.lens[i], col] = self._arrs[i]
        lens = self.lens[idx].astype(np.int32)
        return (torch.from_numpy(block).to(self._device),
                torch.from_numpy(lens).to(self._device))


class _DeviceCollection:
    """Device-resident collection: the byte blob rides to the device once
    and every dense block is gathered there."""

    def __init__(self, items, device: torch.device):
        if isinstance(items, Tape):
            tape = items
        else:
            conv = []
            for s in items:
                if isinstance(s, str):
                    s = s.encode("utf-8")
                elif isinstance(s, np.ndarray):
                    if s.dtype == np.uint8 and s.ndim == 1:
                        s = s.tobytes()  # values == raw bytes
                    else:
                        raise _HostFallback
                elif not isinstance(s, bytes):
                    _reject_integer_like(s)
                    s = bytes(s)  # bytearray/memoryview views
                conv.append(s)
            tape = Tape.from_strings(conv)
        self._dt = device_tape(tape, device)
        self.lens = tape.lengths

    def __len__(self) -> int:
        return len(self.lens)

    def pack(self, idx, rows: int, fill: int):
        offs, lens = self._dt.bucket_arrays(idx)
        return (pack_chars(self._dt.data, offs, lens, row_len=rows,
                           transpose=True, fill=fill), lens)


class _CrossProductEngine:
    """Shared host loop for all-pairs scoring."""

    result_dtype = np.int64

    def __init__(self, cfg: SimilarityConfig):
        self._cfg = cfg
        if not self._is_unit_cost:
            raise _not_ported(f"{cfg}", "NeedlemanWunsch / SmithWaterman and "
                              "non-unit LevenshteinDistances")

    @property
    def _is_unit_cost(self) -> bool:
        """Unit-cost Levenshtein routes to the Myers bit-parallel kernel —
        the same dispatch rule as the reference (``serial.hpp:2620-2720``)."""
        return (
            self._cfg.objective == "min"
            and self._cfg.locality == "global"
            and isinstance(self._cfg.gaps, LinearGaps)
            and self._cfg.gaps.open_or_extend == 1
            and isinstance(self._cfg.costs, UniformCosts)
            and self._cfg.costs.match == 0
            and self._cfg.costs.mismatch == 1
        )

    @staticmethod
    def _collection(items, device: torch.device):
        try:
            return _DeviceCollection(items, device)
        except _HostFallback:
            return _HostCollection(items, device)

    @property
    def config(self) -> SimilarityConfig:
        return self._cfg

    def __call__(self, queries, candidates=None, device: DeviceScope | None = None,
                 out: np.ndarray | None = None) -> np.ndarray:
        dev = (device or default_device_scope()).device
        qc = self._collection(queries, dev)
        cc = qc if candidates is None else self._collection(candidates, dev)

        nq, nc = len(qc), len(cc)
        if out is None:
            out = np.zeros((nq, nc), dtype=self.result_dtype)
        elif out.shape != (nq, nc):
            raise ValueError(f"out must have shape {(nq, nc)}, got {out.shape}")
        if nq == 0 or nc == 0:
            return out
        if max(int(qc.lens.max()), int(cc.lens.max())) > _LONG_THRESHOLD:
            raise _not_ported(f"a pair longer than {_LONG_THRESHOLD} bytes",
                              "long-pair tier")

        result = torch.empty((nq, nc), dtype=torch.int32, device=dev)
        q_blocks = [(torch.from_numpy(q_idx).to(dev)[:, None],
                     qc.pack(q_idx, round_up(q_bucket, 32), fill=-1))
                    for q_bucket, q_idx in _group_dyadic(qc.lens).items()]
        for c_bucket, c_idx in _group_dyadic(cc.lens).items():
            block_j, lens_j = cc.pack(c_idx, c_bucket, fill=0)
            c_rows = torch.from_numpy(c_idx).to(dev)[None, :]
            for q_rows, (q_t, qlens) in q_blocks:
                result[q_rows, c_rows] = myers(q_t, qlens.view(-1, 1), block_j,
                                               lens_j.view(1, -1))
        out[...] = result.cpu().numpy()
        return out


def _gaps_from(open: int, extend: int):
    # The reference linearizes affine gaps when open == extend
    # (``levenshtein_distance`` dispatch, serial.hpp:2620-2720).
    return LinearGaps(open) if open == extend else AffineGaps(open, extend)


class LevenshteinDistances(_CrossProductEngine):
    """Batched byte-level edit distances (reference engine
    ``szs::levenshtein_distances``, ``serial.hpp:3709-3760``; Python type
    ``python/stringzillas.c:388-470``). Only unit costs are ported."""

    result_dtype = np.uint64

    def __init__(self, match: int = 0, mismatch: int = 1, open: int = 1,
                 extend: int = 1, capabilities=None):
        for name, v in (("match", match), ("mismatch", mismatch), ("open", open), ("extend", extend)):
            if not (-128 <= v <= 127):
                raise ValueError(f"{name} cost must fit in 8-bit signed integer")
        del capabilities  # accepted for API parity; dispatch is automatic
        super().__init__(
            SimilarityConfig("min", "global", _gaps_from(open, extend),
                             UniformCosts(match, mismatch))
        )


class LevenshteinDistancesUTF8(LevenshteinDistances):
    """Edit distances over Unicode codepoints (reference
    ``levenshtein_distance_utf8``, ``serial.hpp:2800``): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("LevenshteinDistancesUTF8", "LevenshteinDistancesUTF8")


class NeedlemanWunsch:
    """Global alignment scores (reference ``needleman_wunsch_scores``):
    not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("NeedlemanWunsch", "NeedlemanWunsch / SmithWaterman")


class SmithWaterman:
    """Local alignment scores (reference ``smith_waterman_scores``): not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("SmithWaterman", "NeedlemanWunsch / SmithWaterman")
