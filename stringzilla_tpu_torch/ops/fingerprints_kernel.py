"""Rolling MinHash + count-min of every document for every dimension.

Counterpart of ``stringzilla_tpu/ops/fingerprints_pallas.py``:

    fingerprint_all(blob, starts, lengths, params) -> (hashes, counts)

* ``blob``     1-D ``uint8`` document bytes; document k is
  ``blob[starts[k] : starts[k] + lengths[k]]``;
* ``starts``, ``lengths``  1-D int64, one entry a document, on the host or
  on the blob's device (the CUDA path plans on the host, so host ones save
  it a pull);
* ``params``   the per-dimension int64 tensors of ``ops.fingerprints``
  (``width``, ``mult``, ``modulo``, ``fused_disc``; ``params_from`` or
  ``derive_params``; widths >= 1), on any device; on CUDA tensors they
  must come as ``kernel_params``' dict of them, made once per parameter
  set and device, which also holds the kernel's own arrays;
* returns two ``(n_docs, ndim)`` int32 tensors holding the u32 bits of each
  minimum hash (``0xFFFFFFFF`` for a document shorter than the window) and
  the count of windows that reached it.

The JAX function takes documents packed into a ``(doc_len, n_docs)`` block
per dyadic length bucket, dimensions padded per width group, and limb
parameters; here the kernel streams the documents straight from the blob,
so there is nothing to pad. On CUDA tensors ``fingerprint_all`` plans the
work on the host (``minhash_unit``, ``minhash_plan``: whole documents packed
several to a CTA, longer ones cut into byte ranges), rolls the pieces with
the hand-written Hopper kernel ``fingerprint_minhash`` (``minhash_ranges``,
``csrc/fingerprints.cu``) and merges the ranges of each cut document with
``fingerprint_merge`` (``minhash_merge``); on CPU tensors it runs the plain
PyTorch version ``fingerprint_reference``. ``minhash_ranges`` and
``minhash_merge`` run their plain versions (``ranges_reference``,
``merge_reference``) on CPU tensors.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_build

__all__ = ["fingerprint_all", "fingerprint_reference", "kernel_params", "KernelParams",
           "merge_reference",
           "minhash_merge", "minhash_plan", "minhash_ranges", "minhash_unit", "MinhashPlan",
           "plan_arrays", "PlanArrays", "ranges_reference", "KERNEL_LAUNCHES", "CTAS_PER_SM",
           "UNIT_SHARE", "UNIT_MIN", "WARMUP_SHARE", "MAX_HALO"]

# Launches of the CUDA kernels, counted where the wrappers launch them.
KERNEL_LAUNCHES = {"fingerprint_minhash": 0, "fingerprint_merge": 0}

# The plan's constants. A launch gets about CTAS_PER_SM CTAs an SM (about
# a dozen waves of the 5 CTAs of 256 threads an SM that the kernel's 48
# registers allow, so the card's block scheduler evens out what the plan
# leaves uneven); a CTA's share of the bytes is UNIT_SHARE units, and no
# piece is longer than a unit, so every CTA but the last rolls
# UNIT_SHARE - 1 to UNIT_SHARE + 1 units. UNIT_MIN keeps small inputs from
# being cut finer than the kernel's warm-up (up to w - 1 bytes a cut range)
# is worth; it sets the unit of the phase 4d lines. The three are the
# settings with the least summed time, each over its workload's fastest,
# of CTAS_PER_SM 4-64, UNIT_SHARE 2-8 and UNIT_MIN 128-1024 on both of
# chip_smoke.py's phase 4d workloads (tools/minhash_ab.py --probe: lines
# 0.7065 ms, documents 2.7694 ms; 32, 2, 512 gave 0.7231 and 2.7890; NVIDIA
# H100 80GB HBM3, 700 W; PERF.md §6).
CTAS_PER_SM = 64
UNIT_SHARE = 2
UNIT_MIN = 256
# A unit is also at least WARMUP_SHARE times the widest window's w - 1, so
# a cut range's warm-up adds at most 1 / WARMUP_SHARE to its steps: a bound
# chosen, not fitted (the default widths' 8 * 30 = 240 stays under
# UNIT_MIN; it sets the unit only for widths over 33).
WARMUP_SHARE = 8

_NONE = torch.iinfo(torch.int64).max  # a minimum no window has reached yet
# (m - 1) * (mult + 256) + 256 must stay below this for the kernel's f64
# step to be exact (csrc/fingerprints.cu)
_EXACT_BELOW = 1 << 52
# The most bytes the kernel stages before a chunk (csrc/fingerprints.cu
# kMaxHalo): wider widths roll from global memory.
MAX_HALO = 1024


def _check(blob, starts, lengths, params):
    if not isinstance(blob, torch.Tensor) or blob.dtype != torch.uint8 or blob.dim() != 1:
        raise TypeError("blob must be a 1-D uint8 tensor")
    for name, t in (("starts", starts), ("lengths", lengths)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor")
        if t.device not in (blob.device, torch.device("cpu")):
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


def _export(minimum, count):
    """The outputs' int32 hash bits and counts from int64 minima (``_NONE``
    where no window was seen) and counts."""
    filled = minimum != _NONE
    hashes = torch.where(filled, _wrap_i32(minimum & 0xFFFFFFFF), -1).to(torch.int32)
    return hashes, torch.where(filled, count, 0).to(torch.int32)


def _roll(blob, starts, lengths, params):
    """The plain roll: ``(minimum, count)``, ``(n_docs, ndim)`` int64
    (``_NONE`` where no window) and int32, over the windows of each document
    ``blob[starts : starts + lengths]``; one step per byte over an int64
    state, exact (``x < 2^53``, ``%`` on int64)."""
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
    return minimum, count


def fingerprint_reference(blob, starts, lengths, params):
    """Plain PyTorch version of ``fingerprint_all``: one step per byte over
    a ``(n_docs, ndim)`` int64 state, exact."""
    _check(blob, starts, lengths, params)
    dev = blob.device
    return _export(*_roll(blob, starts.to(dev), lengths.to(dev), params))


# ---------------------------------------------------------------------------
# The plan: whole documents and byte ranges of the longer ones, CTAs of
# about equal work.
# ---------------------------------------------------------------------------


class MinhashPlan(NamedTuple):
    """``minhash_plan``'s cut, host numpy int64 arrays.

    A piece a row of ``doc``, ``s``, ``e`` (P,): a document and the range
    ``[s, e)`` of its window ENDS that the piece covers (a window of width w
    ending at byte t, t >= w - 1), in document order, a document's ranges in
    order and covering ``[0, length)``; ``out`` (P,): the piece's row (its
    document) if the document is whole, else ``-1 - slot``, its partial
    slot; ``cta_first`` (C + 1,): CTA c takes pieces ``cta_first[c] :
    cta_first[c + 1]``; ``cut_docs`` (n_cut,) the cut documents and
    ``cut_first`` (n_cut + 1,) their slot ranges (slots follow the pieces'
    order)."""
    unit: int
    doc: np.ndarray
    s: np.ndarray
    e: np.ndarray
    out: np.ndarray
    cta_first: np.ndarray
    cut_docs: np.ndarray
    cut_first: np.ndarray


def minhash_unit(lengths, sms: int, widest: int = 1) -> int:
    """The plan's unit for documents of these ``lengths`` on a card of
    ``sms`` SMs under windows up to ``widest`` bytes: the bytes over
    ``CTAS_PER_SM * sms`` CTAs of ``UNIT_SHARE`` units each, at least
    ``UNIT_MIN`` and ``WARMUP_SHARE * (widest - 1)``."""
    total = int(np.asarray(lengths, np.int64).sum())
    return max(UNIT_MIN, WARMUP_SHARE * (widest - 1),
               -(-total // (CTAS_PER_SM * sms * UNIT_SHARE)))


def minhash_plan(lengths, unit: int) -> MinhashPlan:
    """Cuts each document longer than ``unit`` bytes into
    ``ceil(length / unit)`` ranges of window ends of about equal size (they
    differ by at most one byte), keeps the others whole (an empty document
    is one empty piece), and hands the pieces, in order, to CTAs of
    ``UNIT_SHARE * unit`` bytes: CTA c takes the pieces that start in
    ``[c, c + 1) * UNIT_SHARE * unit`` of the pieces' bytes end to end. Every
    piece is at most ``unit`` bytes, so every CTA but the last holds more
    than ``(UNIT_SHARE - 1) * unit`` and less than ``(UNIT_SHARE + 1) *
    unit`` bytes, the last less than ``(UNIT_SHARE + 1) * unit``. The kernel
    adds up to ``w - 1`` warm-up steps a dimension to a range that does not
    start a document. Deterministic: a function of ``lengths`` and
    ``unit``. Host work on every call, so a few passes over the lengths."""
    lengths = np.asarray(lengths, np.int64)
    if unit < 1:
        raise ValueError(f"unit must be >= 1, not {unit}")
    if lengths.ndim != 1 or (len(lengths) and lengths.min() < 0):
        raise ValueError("lengths must be a 1-D array of non-negative lengths")
    if not len(lengths) or lengths.max() <= unit:  # nothing to cut: a piece a document
        doc = np.arange(len(lengths), dtype=np.int64)
        s, e, out = np.zeros_like(lengths), lengths, doc
        cut_docs, cut_first = np.zeros(0, np.int64), np.zeros(1, np.int64)
    else:
        ranges = np.maximum(-(-lengths // unit), 1)  # pieces a document
        doc = np.repeat(np.arange(len(lengths), dtype=np.int64), ranges)
        first = np.cumsum(ranges) - ranges  # each document's first piece
        j = np.arange(len(doc), dtype=np.int64) - first[doc]  # the range's index in its document
        # lengths * (j + 1) < 2^63: a range is at most 2^63 / unit pieces
        s = lengths[doc] * j // ranges[doc]
        e = lengths[doc] * (j + 1) // ranges[doc]
        cut = ranges[doc] > 1
        out = np.where(cut, -np.cumsum(cut), doc)  # -1 - slot for a cut range
        cut_docs = np.flatnonzero(ranges > 1).astype(np.int64)
        cut_first = np.concatenate([[0], np.cumsum(ranges[cut_docs])]).astype(np.int64)
    size = e - s
    at = np.cumsum(size) - size  # each piece's first byte, pieces end to end
    share = UNIT_SHARE * unit
    # every CTA up to the last gets a piece (a piece is shorter than a share)
    n_ctas = int(at[-1]) // share + 1 if len(at) else 0
    cta_first = np.searchsorted(at, np.arange(n_ctas + 1, dtype=np.int64) * share)
    return MinhashPlan(int(unit), doc, s, e, out, cta_first.astype(np.int64), cut_docs,
                       cut_first)


class KernelParams(NamedTuple):
    """The kernel's view of a parameter set (``kernel_params``): ``ints``
    int32 ``(2, ndim)`` of width and dimension and ``floats`` f64 ``(4,
    ndim)`` of mult, modulo, fused_disc and 1/modulo rounded up, the
    dimensions ordered by width (stable) so that a warp's threads mostly
    share one; ``halo``, the bytes to stage before a chunk (the widest width
    up to ``MAX_HALO``, rounded up to 32, at least 32); ``widest``, the
    widest width."""
    ints: torch.Tensor
    floats: torch.Tensor
    halo: int
    widest: int


class PlanArrays(NamedTuple):
    """A plan's arrays on a device, from one copy (``plan_arrays``):
    ``pieces`` (P, 4) int64: the blob offset of the piece's document, s, e
    and out; ``cta_first`` (C + 1,); ``cut`` (2 n_cut + 1,): the cut
    documents, then their slot offsets."""
    pieces: torch.Tensor
    cta_first: torch.Tensor
    cut: torch.Tensor
    n_docs: int
    n_slots: int


def plan_arrays(plan: MinhashPlan, starts, device) -> PlanArrays:
    """The kernels' view of ``plan`` for documents at blob offsets
    ``starts`` (host), on ``device``."""
    starts = np.asarray(starts, np.int64)
    p, c = 4 * len(plan.doc), len(plan.cta_first)
    flat = np.empty(p + c + len(plan.cut_docs) + len(plan.cut_first), np.int64)
    pieces = flat[:p].reshape(-1, 4)
    # as many pieces as documents: a piece a document, in order
    pieces[:, 0] = starts if len(plan.doc) == len(starts) else starts[plan.doc]
    pieces[:, 1], pieces[:, 2], pieces[:, 3] = plan.s, plan.e, plan.out
    flat[p:p + c] = plan.cta_first
    flat[p + c:] = np.concatenate([plan.cut_docs, plan.cut_first])
    dev = torch.from_numpy(flat).to(device)
    return PlanArrays(dev[:p].view(-1, 4), dev[p:p + c], dev[p + c:], len(starts),
                      int(plan.cut_first[-1]))


# ---------------------------------------------------------------------------
# The kernels' parameters, made once.
# ---------------------------------------------------------------------------


def _inv_up(m: int) -> float:
    """``1 / m`` rounded up to a double, exactly."""
    inv = 1.0 / m
    return inv if Fraction(inv) * m >= 1 else math.nextafter(inv, math.inf)


def kernel_params(params, device) -> dict:
    """``params`` (the four int64 tensors) on ``device``, plus, under
    ``"kernel"``, the kernel's ``KernelParams``. Raises ``ValueError`` on parameters for which
    the kernel's f64 step is not exact: a width < 1, a negative mult, a
    fused_disc outside ``[0, modulo)`` or ``(modulo - 1) * (mult + 256) +
    256 >= 2^52``. Make it once per parameter set and device (``Fingerprints``
    does) and pass it to ``fingerprint_all``."""
    w, mult, m, fd = (np.asarray(params[k].cpu() if isinstance(params[k], torch.Tensor)
                                 else params[k], np.int64)
                      for k in ("width", "mult", "modulo", "fused_disc"))
    for i in range(len(w)):
        wi, mu, mi, fi = int(w[i]), int(mult[i]), int(m[i]), int(fd[i])
        if wi < 1 or mu < 0 or mi < 1 or not 0 <= fi < mi or \
                (mi - 1) * (mu + 256) + 256 >= _EXACT_BELOW:
            raise ValueError(f"dimension {i}: width {wi}, mult {mu}, modulo {mi}, fused_disc "
                             f"{fi} are outside what the kernel's f64 step keeps exact")
    order = np.argsort(w, kind="stable")
    ints = np.stack([w[order], order]).astype(np.int32)
    inv = np.array([_inv_up(int(x)) for x in m[order]], np.float64)
    floats = np.stack([mult[order], m[order], fd[order]]).astype(np.float64)
    staged = w[w <= MAX_HALO]
    halo = max(32, -(-int(staged.max()) // 32) * 32) if len(staged) else 32
    out = {k: torch.as_tensor(v).to(device) for k, v in params.items() if k != "kernel"}
    out["kernel"] = KernelParams(
        torch.from_numpy(ints).to(device),
        torch.from_numpy(np.concatenate([floats, inv[None]])).to(device), halo,
        int(w.max()) if len(w) else 1)
    return out


def _kernel_arrays(params, device):
    kp = params.get("kernel")
    if kp is None or kp[0].device != device:
        raise ValueError(f"params hold no kernel arrays on {device}: pass "
                         f"kernel_params(params, {str(device)!r}), made once per parameter set")
    return kp


def _raise(lib, name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.sz_cuda_error_string(err).decode()} "
                           f"({err})")


# ---------------------------------------------------------------------------
# The two kernels and their plain versions.
# ---------------------------------------------------------------------------


def ranges_reference(blob, pa: PlanArrays, params):
    """Plain version of ``minhash_ranges``: ``fingerprint_reference``'s roll
    on each piece of the plan, once per window width, each piece's
    sub-document starting ``w - 1`` bytes before its first window end (at
    its document's start on the first range), so that the windows inside it
    are the piece's. Rows of cut documents in ``hashes``/``counts`` stay
    0."""
    dev = blob.device
    ndim = params["width"].numel()
    base, s, e, out = pa.pieces.to(dev).T
    w = params["width"].to(dev, torch.int64)
    minimum = torch.empty((len(base), ndim), dtype=torch.int64, device=dev)
    count = torch.empty((len(base), ndim), dtype=torch.int32, device=dev)
    for width in torch.unique(w).tolist():
        dims = torch.nonzero(w == width).flatten()
        p0 = (s - (width - 1)).clamp(min=0)
        group = {k: params[k].to(dev)[dims] for k in ("width", "mult", "modulo", "fused_disc")}
        minimum[:, dims], count[:, dims] = _roll(blob, base + p0, e - p0, group)
    hashes = torch.zeros((pa.n_docs, ndim), dtype=torch.int32, device=dev)
    counts = torch.zeros_like(hashes)
    whole = out >= 0
    hashes[out[whole]], counts[out[whole]] = _export(minimum[whole], count[whole])
    part_min = torch.empty((pa.n_slots, ndim), dtype=torch.int64, device=dev)
    part_count = torch.empty((pa.n_slots, ndim), dtype=torch.int32, device=dev)
    slots = -1 - out[~whole]
    part_min[slots], part_count[slots] = minimum[~whole], count[~whole]
    return hashes, counts, part_min, part_count


def minhash_ranges(blob, pa: PlanArrays, params):
    """``(hashes, counts, part_min, part_count)``: each piece of the plan
    rolled for every dimension, a whole document's result in its row of the
    ``(n_docs, ndim)`` int32 outputs, a cut range's minimum (int64 value,
    ``2^63 - 1`` if it holds no full window) and count in its partial slot
    ``(n_slots, ndim)``; rows of cut documents are left for
    ``minhash_merge``. The Hopper kernel ``fingerprint_minhash`` for CUDA
    tensors (``params`` from ``kernel_params``), the plain version for CPU
    ones."""
    dev = blob.device
    if dev.type == "cpu":
        return ranges_reference(blob, pa, params)
    if dev.type != "cuda":
        raise ValueError(f"minhash_ranges runs on CUDA or CPU tensors, not {dev}")
    ints, floats, halo, _ = _kernel_arrays(params, dev)
    ndim = ints.shape[1]
    hashes = torch.empty((pa.n_docs, ndim), dtype=torch.int32, device=dev)
    counts = torch.empty_like(hashes)
    part_min = torch.empty((pa.n_slots, ndim), dtype=torch.int64, device=dev)
    part_count = torch.empty((pa.n_slots, ndim), dtype=torch.int32, device=dev)
    n_ctas = pa.cta_first.numel() - 1
    if n_ctas == 0 or ndim == 0:
        return hashes, counts, part_min, part_count
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        f = floats.data_ptr()
        err = lib.sz_fingerprints(blob.data_ptr(), pa.pieces.data_ptr(), pa.cta_first.data_ptr(),
                                  n_ctas, ints[0].data_ptr(), ints[1].data_ptr(), f,
                                  f + 8 * ndim, f + 16 * ndim, f + 24 * ndim, ndim, halo,
                                  hashes.data_ptr(), counts.data_ptr(), part_min.data_ptr(),
                                  part_count.data_ptr(), stream)
    _raise(lib, "sz_fingerprints", err)
    KERNEL_LAUNCHES["fingerprint_minhash"] += 1
    return hashes, counts, part_min, part_count


def merge_reference(pa: PlanArrays, part_min, part_count, hashes, counts):
    """Plain version of ``minhash_merge``: in place, each cut document's row
    from its slots, the smallest minimum and the sum of the counts of the
    slots that reached it."""
    dev = hashes.device
    cut = pa.cut.to(dev)
    n_cut = (cut.numel() - 1) // 2
    if n_cut == 0:
        return hashes, counts
    docs, offs = cut[:n_cut], cut[n_cut:]
    owner = torch.repeat_interleave(torch.arange(n_cut, device=dev), offs[1:] - offs[:-1])
    ndim = part_min.shape[1]
    index = owner[:, None].expand(-1, ndim)
    best = torch.full((n_cut, ndim), _NONE, dtype=torch.int64, device=dev).scatter_reduce_(
        0, index, part_min, "amin")
    hit = torch.where(part_min == best[owner], part_count, 0)
    total = torch.zeros((n_cut, ndim), dtype=torch.int32, device=dev).index_add_(0, owner, hit)
    hashes[docs], counts[docs] = _export(best, total)
    return hashes, counts


def minhash_merge(pa: PlanArrays, part_min, part_count, hashes, counts):
    """Writes each cut document's row of ``hashes``/``counts`` from its
    partial slots, in place: the Hopper kernel ``fingerprint_merge`` for
    CUDA tensors, the plain version for CPU ones."""
    dev = hashes.device
    if dev.type == "cpu":
        return merge_reference(pa, part_min, part_count, hashes, counts)
    if dev.type != "cuda":
        raise ValueError(f"minhash_merge runs on CUDA or CPU tensors, not {dev}")
    n_cut = (pa.cut.numel() - 1) // 2
    if n_cut == 0:
        return hashes, counts
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sz_fingerprints_merge(pa.cut.data_ptr(), n_cut, part_min.data_ptr(),
                                        part_count.data_ptr(), hashes.shape[1],
                                        hashes.data_ptr(), counts.data_ptr(), stream)
    _raise(lib, "sz_fingerprints_merge", err)
    KERNEL_LAUNCHES["fingerprint_merge"] += 1
    return hashes, counts


def fingerprint_all(blob, starts, lengths, params):
    """``(hashes, counts)``, two ``(n_docs, ndim)`` int32 tensors: the plan
    and the two Hopper kernels for CUDA tensors, the plain version for CPU
    ones."""
    _check(blob, starts, lengths, params)
    dev = blob.device
    if dev.type == "cpu":
        return fingerprint_reference(blob, starts, lengths, params)
    if dev.type != "cuda":
        raise ValueError(f"fingerprint_all runs on CUDA or CPU tensors, not {dev}")
    widest = _kernel_arrays(params, dev).widest  # raises before the plan's host work
    lengths = lengths.cpu().numpy()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pa = plan_arrays(minhash_plan(lengths, minhash_unit(lengths, sms, widest)),
                     starts.cpu().numpy(), dev)
    hashes, counts, part_min, part_count = minhash_ranges(blob, pa, params)
    return minhash_merge(pa, part_min, part_count, hashes, counts)
