"""Device-resident ragged→dense packing — the on-device half of the tape.

Counterpart of ``stringzilla_tpu/ops/pack_device.py``. The blob travels to
the scope's device once, as raw bytes; every bucketed dense block the Myers
kernel reads is then one gather and one mask on the device. The host's jobs
are bucketing (integer work on lengths) and pulling results.

Layout produced: ``transpose=True`` → ``(row_len, count)`` int32, characters
down the rows and one string per column (what the kernels read, so a step's
loads of neighbouring strings are neighbouring addresses);
``transpose=False`` → ``(count, row_len)``.
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

    def __init__(self, tape: Tape, device: torch.device):
        blob = np.zeros(tape.total_bytes + 1, dtype=np.uint8)
        blob[:-1] = np.asarray(tape.data, dtype=np.uint8)[: tape.total_bytes]
        self.device = torch.device(device)
        self.data = torch.from_numpy(blob).to(self.device)
        offsets = np.asarray(tape.offsets, dtype=np.int64)
        self.starts = offsets[:-1]
        self.lengths = np.diff(offsets)

    def __len__(self) -> int:
        return len(self.starts)

    def bucket_arrays(self, idx: np.ndarray):
        """``(offs int64, lens int32)`` device vectors of strings ``idx``."""
        idx = np.asarray(idx, dtype=np.int64)
        offs = torch.from_numpy(self.starts[idx]).to(self.device)
        lens = torch.from_numpy(self.lengths[idx].astype(np.int32)).to(self.device)
        return offs, lens


def pack_chars(blob: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor, *,
               row_len: int, transpose: bool, fill: int) -> torch.Tensor:
    """Dense int32 char block of the strings at ``offs``/``lens`` in
    ``blob``, padded with ``fill`` past each string's end; strings longer
    than ``row_len`` are cut (callers bucket so they never are)."""
    j = torch.arange(row_len, device=blob.device)
    valid = j[None, :] < lens[:, None]
    pos = torch.where(valid, offs[:, None] + j[None, :], 0)
    vals = torch.where(valid, blob[pos].to(torch.int32), fill)
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
