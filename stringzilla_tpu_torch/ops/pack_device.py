"""Device-resident ragged→dense packing — the on-device half of the tape.

Counterpart of ``stringzilla_tpu/ops/pack_device.py``. The blob travels to
the scope's device once, as raw bytes; every bucketed dense block the DP
kernels read is then one gather and one mask on the device. The host's jobs
are bucketing (integer work on lengths) and pulling results. A class-cost
engine maps the blob to cost classes once on the device and builds a second
``DeviceTape`` over the mapped blob, with the same starts and lengths.

Layout produced: ``transpose=True`` → ``(row_len, count)`` int32, characters
down the rows and one string per column (what the kernels read, so a step's
loads of neighbouring strings are neighbouring addresses);
``transpose=False`` → ``(count, row_len)``. ``shift=True`` prepends the
zero row of the column DP's +1-shifted query layout, so the block has
``row_len + 1`` rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .tape import Tape

__all__ = ["DeviceTape", "device_tape", "pack_chars"]


class DeviceTape:
    """A string collection mirrored to one device.

    ``data`` is the raw ``uint8`` blob on the device plus one zero byte, so a
    masked gather of an empty collection still has an index 0 to read;
    ``starts``/``lengths`` stay host numpy arrays — bucketing is host work,
    and only per-bucket ``(offs, lens)`` vectors ride to the device.
    """

    def __init__(self, tape: Tape | None = None, device: torch.device | None = None,
                 *, data: torch.Tensor | None = None, starts=None, lengths=None):
        """From a host ``tape`` copied to ``device``, or from a ``data`` blob
        already on a device (with its trailing zero byte) plus host
        ``starts``/``lengths``."""
        if tape is not None:
            blob = np.zeros(tape.total_bytes + 1, dtype=np.uint8)
            blob[:-1] = np.asarray(tape.data, dtype=np.uint8)[: tape.total_bytes]
            data = torch.from_numpy(blob).to(torch.device(device))
            offsets = np.asarray(tape.offsets, dtype=np.int64)
            starts, lengths = offsets[:-1], np.diff(offsets)
        self.data = data
        self.device = data.device
        self.starts = np.asarray(starts, dtype=np.int64)
        self.lengths = np.asarray(lengths, dtype=np.int64)

    @classmethod
    def from_bounds(cls, data: torch.Tensor, starts, ends) -> "DeviceTape":
        """Spans ``data[starts[i] : ends[i]]`` of a blob already on a device
        (a ``Str``'s mirror): no byte is copied."""
        starts = np.asarray(starts, dtype=np.int64)
        return cls(data=data, starts=starts,
                   lengths=np.asarray(ends, dtype=np.int64) - starts)

    def __len__(self) -> int:
        return len(self.starts)

    def bucket_arrays(self, idx: np.ndarray):
        """``(offs int64, lens int32)`` device vectors of strings ``idx``."""
        idx = np.asarray(idx, dtype=np.int64)
        offs = torch.from_numpy(self.starts[idx]).to(self.device)
        lens = torch.from_numpy(self.lengths[idx].astype(np.int32)).to(self.device)
        return offs, lens


def pack_chars(blob: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor, *,
               row_len: int, transpose: bool, fill: int,
               shift: bool = False) -> torch.Tensor:
    """Dense int32 char block of the strings at ``offs``/``lens`` in
    ``blob``, padded with ``fill`` past each string's end; strings longer
    than ``row_len`` are cut (callers bucket so they never are). ``shift``
    prepends a zero row (a zero column before the transpose)."""
    j = torch.arange(row_len, device=blob.device)
    valid = j[None, :] < lens[:, None]
    pos = torch.where(valid, offs[:, None] + j[None, :], 0)
    vals = torch.where(valid, blob[pos].to(torch.int32), fill)
    if shift:
        vals = torch.cat([torch.zeros_like(vals[:, :1]), vals], dim=1)
    return vals.T.contiguous() if transpose else vals


def device_tape(tape: Tape, device: torch.device) -> DeviceTape:
    """Device mirror of a host tape, cached on the Tape object itself per
    device, so the blob stays resident exactly as long as the collection."""
    device = torch.device(device)
    mirrors = tape.__dict__.get("_torch_mirrors")
    if mirrors is None:
        mirrors = {}
        object.__setattr__(tape, "_torch_mirrors", mirrors)
    mirror = mirrors.get(device)
    if mirror is None:
        mirror = mirrors[device] = DeviceTape(tape, device)
    return mirror
