"""Device-side UTF-8 decode to runes, feeding the ``_utf8`` engines.

Counterpart of ``stringzilla_tpu/ops/utf8_pack_device.py``, in plain torch
ops over the device tape (the JAX functions are XLA, not Pallas, so there
is no kernel to port). The reference decodes with lead-byte classification
(``sz_utf8_decode``, reference ``utf8_runes.h:96``).

* **Count pass** (``rune_count_validity``): one gather of the strings'
  bytes; a rune starts at every byte that is not a continuation, so the
  rune count is a masked row sum. The same pass checks RFC 3629 per string
  (structure, overlong, surrogate, above U+10FFFF, a lead cut off by the
  end), so a malformed collection can take the host's maximal-subpart
  U+FFFD decode instead.
* **Decode pass** (``decode_pack_device``): rune slot j of a string starts
  at the lower bound of ``j + 1`` in the row's inclusive prefix sum of the
  lead mask (a vectorised binary search, ``log2(byte_len)`` gathers); the
  rune is assembled from up to four bytes by its lead's class.
"""

from __future__ import annotations

import numpy as np
import torch

from .pack_device import DeviceTape

__all__ = ["rune_count_validity", "decode_pack_device"]


def _gather_rows(dt: DeviceTape, idx, row_len: int):
    """``(len(idx), row_len)`` int32 bytes of strings ``idx``, zero past each
    end, and the mask of real bytes."""
    offs, lens = dt.bucket_arrays(np.asarray(idx, dtype=np.int64))
    j = torch.arange(row_len, device=dt.device)
    valid = j[None, :] < lens[:, None]
    b = dt.data[torch.where(valid, offs[:, None] + j[None, :], 0)].to(torch.int32)
    return torch.where(valid, b, 0), valid, lens


def _back(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` shifted right by ``d`` within each row, zero-filled."""
    return torch.nn.functional.pad(x, (d, 0))[:, :-d]


def rune_count_validity(dt: DeviceTape, idx, row_len: int):
    """Per-string ``(rune_count, violations)`` int32 numpy arrays for tape
    rows ``idx``, whose byte lengths are all <= ``row_len``. One device
    pass, one pull.

    The pass reads three columns past ``row_len``, so a lead cut off by the
    end of a string that fills the row is flagged too; the JAX function
    reads ``row_len`` columns and misses it there (its engines then decode
    that lead as a rune, where the host gives U+FFFD)."""
    b, valid, lens = _gather_rows(dt, idx, row_len + 3)
    cont = (b & 0xC0) == 0x80
    l2 = (b >= 0xC2) & (b <= 0xDF)
    l3 = (b & 0xF0) == 0xE0
    l4 = (b >= 0xF0) & (b <= 0xF4)
    must_cont = (_back(l2, 1) | _back(l3, 1) | _back(l4, 1)
                 | _back(l3, 2) | _back(l4, 2) | _back(l4, 3))
    bad_lead = (b >= 0x80) & ~(cont | l2 | l3 | l4)
    p1 = _back(b, 1)
    bad_rng = cont & (((p1 == 0xE0) & (b < 0xA0)) | ((p1 == 0xED) & (b >= 0xA0))
                      | ((p1 == 0xF0) & (b < 0x90)) | ((p1 == 0xF4) & (b >= 0x90)))
    # Structure is checked up to three places past the end too, where the
    # zero padding is no continuation: a lead cut off by the end shows there.
    j = torch.arange(row_len + 3, device=dt.device)[None, :]
    struct_bad = (cont != must_cont) & (j < lens[:, None] + 3)
    viol = ((bad_lead | bad_rng) & valid) | struct_bad
    lead = ~cont & valid
    counts = torch.stack([lead.sum(dim=1), viol.sum(dim=1)]).to(torch.int32).cpu().numpy()
    return counts[0], counts[1]


def decode_pack_device(dt: DeviceTape, idx, byte_len: int, rune_len: int,
                       fill: int = 0, transpose: bool = True,
                       shift: bool = False) -> torch.Tensor:
    """Dense int32 rune block of tape rows ``idx`` (valid UTF-8, byte length
    <= ``byte_len``, which is >= 1): ``rune_len`` runes a string, ``fill`` past each end.
    ``transpose`` puts runes down the rows and one string per column;
    ``shift`` prepends the zero row (column before the transpose) of the
    column DP's +1-shifted query layout. On the tape's device."""
    b, valid, _ = _gather_rows(dt, idx, byte_len)
    lead = ((b & 0xC0) != 0x80) & valid
    cum = torch.cumsum(lead.to(torch.int32), dim=1)  # inclusive
    total = cum[:, -1:]

    # lower_bound(cum, j + 1) per row: a branchless binary search.
    dev = dt.device
    target = torch.arange(1, rune_len + 1, dtype=torch.int32, device=dev)[None, :]
    lo = torch.zeros((b.shape[0], rune_len), dtype=torch.int64, device=dev)
    span = 1 << max(byte_len - 1, 0).bit_length()
    while span:
        mid = lo + span
        v = torch.gather(cum, 1, (mid.clamp(max=byte_len) - 1).clamp(min=0))
        # cum[mid - 1] < target: the lower bound is at mid or beyond
        lo = torch.where((mid <= byte_len) & (v < target), mid, lo)
        span >>= 1

    def at(off):
        return torch.gather(b, 1, (lo + off).clamp(max=byte_len - 1))

    b0, b1, b2, b3 = at(0), at(1), at(2), at(3)
    r2 = ((b0 & 0x1F) << 6) | (b1 & 0x3F)
    r3 = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    r4 = (((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12)
          | ((b2 & 0x3F) << 6) | (b3 & 0x3F))
    rune = torch.where(b0 < 0x80, b0,
                       torch.where(b0 < 0xE0, r2, torch.where(b0 < 0xF0, r3, r4)))
    out = torch.where(target <= total, rune, fill).to(torch.int32)
    if shift:
        out = torch.cat([torch.zeros_like(out[:, :1]), out], dim=1)
    return out.T.contiguous() if transpose else out
