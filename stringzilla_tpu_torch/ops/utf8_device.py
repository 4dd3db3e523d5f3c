"""UTF-8 validation (RFC 3629) and rune count in one pass over a buffer.

Counterpart of ``stringzilla_tpu/ops/utf8_device.py``:

    validate_count_raw(mirror, n)    -> int64 tensor [violations, rune_count]
    validate_count_device(mirror, n) -> (valid: bool, rune_count: int)
    utf8_valid(data)                 -> bool

``mirror`` is a 1-D ``uint8`` tensor holding the bytes in ``mirror[:n]``
(a ``Str``'s device mirror); every byte before 0 or from ``n`` on counts
as zero, whatever the tensor holds there. The checks, as the JAX pass
defines them (``_val_kernel``): a bad lead byte (C0, C1, F5-FF) or a
continuation out of range after E0, ED, F0 or F4 (overlong, surrogate,
above U+10FFFF) at a position below ``n``; a continuation byte where no
lead needs one, or none where one does, at a position below ``n + 3`` (so
a lead cut off at the end counts); the rune count is the number of
non-continuation bytes below ``n``. A valid buffer has ``violations == 0``
and one rune per non-continuation byte; an invalid one falls back to the
host's exact U+FFFD count (``ops.utf8.utf8_count``).

The JAX pass returns int32; here both numbers are int64, equal below 2^31.
``validate_count_raw`` runs the hand-written Hopper kernel
(``csrc/utf8.cu``) on CUDA tensors and the plain PyTorch version
``validate_count_reference`` on CPU tensors.

The masks of the kernel's word step are made here and passed to it at
launch (``MASKS``; the kernel holds no copy): the step keeps each byte's
class in bit 7 (``HIGH``), and ``x & LOW7`` plus ``GE_C2`` or ``GE_F5``
carries into bit 7 where a lead byte is at least C2 or F5. The kernel's
geometry is named here too (``csrc/utf8.cu`` holds the same values;
``sz_utf8_geometry`` reports them). ``launch_plan`` cuts a buffer as the
kernel does: a head of at most 15 bytes before its first 16-byte aligned
byte, groups of ``GROUP_BYTES`` (``UNROLL`` rows of 32 vectors) that warps
take in turns, and the rest, which the grid's last warp takes with the
head.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

__all__ = ["validate_count_raw", "validate_count_reference", "validate_count_device",
           "utf8_valid", "launch_plan", "grid_stride", "MASKS", "KERNEL_LAUNCHES"]

# Launches of the CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"utf8_validate_count": 0}

# The kernel's geometry: 16-byte vectors a lane, rows of 32 vectors a warp,
# UNROLL rows a group (a warp's turn), CTAs of THREADS, at most
# BLOCKS_PER_SM CTAs an SM.
VECTOR_BYTES = 16
THREADS = 256
WARPS = THREADS // 32
UNROLL = 4
BLOCKS_PER_SM = 4
ROW_BYTES = 32 * VECTOR_BYTES
GROUP_BYTES = UNROLL * ROW_BYTES
CTA_BYTES = WARPS * GROUP_BYTES

# The word step's masks (bit 7 of each byte a class), passed to the kernel
# in MASKS' order (csrc/utf8.cu's struct Masks).
HIGH = 0x80808080
LOW7 = 0x7F7F7F7F
GE_C2 = 0x3E3E3E3E  # low 7 bits + GE_C2 reach bit 7 iff >= 0x42: with bits 7-6 set, >= C2
GE_F5 = 0x0B0B0B0B  # ... iff >= 0x75: with bits 7-4 set, >= F5
ONES = 0x01010101
LEAD_E = 0x60606060  # E0 & 0x7F; ED is E0 + E_STEP
E_STEP = 0x0D
LEAD_F = 0x70707070  # F0 & 0x7F; F4 is F0 ^ F_STEP
F_STEP = 0x04040404
BITS_54 = 0x03030303  # a continuation's bits 5-4 (shifted down 4), + BITS_54 sets bit 2 unless 00
NOT_FIRST = 0xFFFFFF00  # the bytes of a word that reach the next word
MASKS = (HIGH, LOW7, GE_C2, GE_F5, ONES, LEAD_E, E_STEP, LEAD_F, F_STEP, BITS_54, NOT_FIRST)
_MASKS_ARG = (ctypes.c_uint32 * len(MASKS))(*MASKS)
# as sz_utf8_geometry reports it
GEOMETRY = (VECTOR_BYTES, THREADS, UNROLL, BLOCKS_PER_SM, len(MASKS))


def launch_plan(n: int, address: int) -> dict:
    """How the kernel cuts ``n`` bytes at ``address``: ``head`` bytes before
    the first 16-byte aligned one (at most 15, at most n), ``groups`` whole
    groups from there, and the span ``[tail, n + 3)`` that the grid's last
    warp takes with the head."""
    head = min(n, (16 - address % 16) % 16)
    groups = (n - head) // GROUP_BYTES
    return dict(head=head, groups=groups, tail=head + groups * GROUP_BYTES)


def grid_stride(sms: int) -> int:
    """Bytes between the groups one warp takes in turn, on a full grid
    (``BLOCKS_PER_SM`` CTAs an SM, as the kernel's entry caps it)."""
    return sms * BLOCKS_PER_SM * CTA_BYTES


def _check(mirror, n) -> int:
    if not isinstance(mirror, torch.Tensor) or mirror.dtype != torch.uint8 or mirror.dim() != 1:
        raise TypeError("mirror must be a 1-D uint8 tensor")
    if not mirror.is_contiguous():
        raise ValueError("mirror must be contiguous")
    n = int(n)
    if not 0 <= n <= mirror.numel():
        raise ValueError(f"n={n} is outside the buffer of {mirror.numel()} bytes")
    return n


def validate_count_reference(mirror: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same classification of every
    position in ``[0, n + 3)`` with its three predecessors."""
    n = _check(mirror, n)
    ext = torch.zeros(n + 6, dtype=torch.uint8, device=mirror.device)
    ext[3: 3 + n] = mirror[:n]
    b, p1, p2, p3 = ext[3:], ext[2: n + 5], ext[1: n + 4], ext[: n + 3]
    inside = torch.arange(n + 3, device=mirror.device) < n

    def lead2(x):
        return (x >= 0xC2) & (x <= 0xDF)

    def lead3(x):
        return (x & 0xF0) == 0xE0

    def lead4(x):
        return (x >= 0xF0) & (x <= 0xF4)

    cont = (b & 0xC0) == 0x80
    bad_lead = (b >= 0x80) & ~cont & ~lead2(b) & ~lead3(b) & ~lead4(b)
    must_cont = lead2(p1) | lead3(p1) | lead4(p1) | lead3(p2) | lead4(p2) | lead4(p3)
    bad_range = cont & (((p1 == 0xE0) & (b < 0xA0)) | ((p1 == 0xED) & (b >= 0xA0))
                        | ((p1 == 0xF0) & (b < 0x90)) | ((p1 == 0xF4) & (b >= 0x90)))
    violations = ((bad_lead | bad_range) & inside) | (cont != must_cont)
    return torch.stack([violations.sum(dtype=torch.int64),
                        (~cont & inside).sum(dtype=torch.int64)])


def validate_count_raw(mirror: torch.Tensor, n: int) -> torch.Tensor:
    """``[violations, rune_count]`` as a 2-element int64 tensor on the
    mirror's device, no host sync: the Hopper kernel for CUDA tensors, the
    plain version for CPU ones."""
    if isinstance(mirror, torch.Tensor) and mirror.device.type == "cpu":
        return validate_count_reference(mirror, n)
    n = _check(mirror, n)
    if mirror.device.type != "cuda":
        raise ValueError(f"validate_count_raw runs on CUDA or CPU tensors, not {mirror.device}")
    out = torch.empty(2, dtype=torch.int64, device=mirror.device)
    if n == 0:
        return out.zero_()
    lib = cuda_build.load()
    with torch.cuda.device(mirror.device):
        stream = torch.cuda.current_stream(mirror.device).cuda_stream
        sms = torch.cuda.get_device_properties(mirror.device).multi_processor_count
        err = lib.sz_utf8_validate_count(mirror.data_ptr(), n, out.data_ptr(), _MASKS_ARG, sms,
                                         stream)
    if err != 0:
        raise RuntimeError(f"sz_utf8_validate_count launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES["utf8_validate_count"] += 1
    return out


def validate_count_device(mirror: torch.Tensor, n: int) -> tuple[bool, int]:
    """Run the validation and count pass; ``(valid, rune_count)`` after one
    host pull."""
    violations, runes = validate_count_raw(mirror, n).tolist()
    return violations == 0, runes


def utf8_valid(data) -> bool:
    """Whether ``data`` is well-formed UTF-8 (RFC 3629). A ``Str`` of at
    least 1 MiB takes the device pass over its mirror; anything else
    CPython's decoder."""
    from ..models.str_api import Str
    from .utf8 import _as_bytes

    if isinstance(data, Str) and data._use_device():
        valid, _ = validate_count_device(data._device(), len(data))
        return valid
    buf = _as_bytes(data)
    try:
        buf.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False
