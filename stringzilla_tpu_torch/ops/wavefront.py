"""Anti-diagonal wavefront DP scores of long pairs — the long-pair tier.

Counterpart of ``stringzilla_tpu/ops/wavefront_pallas.py``'s
``wavefront_score``, ``levenshtein_long_pair`` and ``MAX_FLAT_CELLS``. The
lane-packed kernels score many short pairs at once; a pair with a string
over 4096 bytes instead spreads its own DP matrix over the card.

The flat tier has the semantics of the JAX flat kernel ``_kernel``, for all
16 configurations (min/max, global/local, uniform costs or a 32x32 class
table, linear or Gotoh affine gaps):

* row 0 and column 0 hold ``boundary(k)``: 0 when local, ``gap * k`` for
  linear gaps, ``open + extend * (k - 1)`` for affine ones; the gap
  matrices' border is ``boundary(k) + open + extend``;
* class ids are clamped to [0, 31] (an id >= 32 costs as class 31);
* a global score is cell (m, n); a local one is ``opt(0, every interior
  cell)``, with cells clamped at 0;
* an empty string never reaches the kernel: the score is the other
  string's gap run (0 when local).

The band tier is the JAX band kernel ``_band_kernel``: the exact unit-cost
Levenshtein distance by Ukkonen band doubling. A rung of half-width ``k``
walks only the cells with ``|i - j| <= k``, stops once a row holds no cell
``<= k``, and certifies ``D[m][n] <= k``; otherwise the next rung is priced
from the row where it stopped, up to ``BAND_KMAX``. A pair whose distance
is over ``BAND_KMAX`` goes to the flat tier.

Entry points:

    wavefront_score(a, b, match=0, mismatch=1, gap=1, objective="min",
                    locality="global", table=None, extend=None, *, device=None)
        -> int
    levenshtein_long_pair(a, b, k0=64, *, device=None) -> int
    wavefront_batch(chars, a_off, a_len, b_off, b_len, **costs)
        -> (n_pairs,) int32 tensor on chars.device
    levenshtein_batch(chars, a_off, a_len, b_off, b_len, k0=64)
        -> (n_pairs,) int32 tensor on chars.device
    band_batch(chars, a_off, a_len, b_off, b_len, k0=64, card=None)
        -> (n_pairs, 4) int64 tensor on chars.device
    band_plan(pairs, sms, warps_per_sm) -> BandPlan: how a band launch
        spreads each pair's strips over a circle of warps in CTA groups
    band_card(device) -> (SMs, warps of the band kernel an SM holds)
    flat_plan(pairs, affine, sms, warps_per_sm) -> FlatPlan: how a flat
        launch cuts each pair's rows into strips and the batch into groups
    flat_card(device, config) -> (SMs, warps of the flat kernel an SM holds)

The batched entries take pairs whose chars lie in one int32 tensor (offsets
and lengths are host integer arrays). On CUDA tensors they run the
hand-written Hopper kernels of ``csrc/wavefront.cu``, on CPU tensors the
plain PyTorch versions ``wavefront_reference`` (the JAX kernel's
anti-diagonal recurrence, every pair of the batch at once) and
``band_reference`` (the band kernel's ladder, a pair and a row at a
time).

The meet-in-the-middle tier is the JAX ``wavefront_score_mim`` with its
stage kernel ``_stage_kernel``: uniform costs, linear gaps, min objective.
A forward sweep of ``(a, b)`` to the middle diagonal ``d* = (m + n) // 2``
and one of the reversed strings to ``m + n - d*`` run as ladders of stages
(``ladder``: the JAX package's stage bounds), each stage one launch of
``csrc/wavefront_stage.cu`` for both sweeps, the diagonals staying on the
card; the host combines the four frontiers it pulls once (paths through a
cell of ``d*``, and paths that jump it with one substitution):

    wavefront_score_mim(a, b, match=0, mismatch=1, gap=1, n_stages=4, *,
                        device=None) -> int
    sweep_frontier(a, b, m, n, d_end, match, mismatch, gap, n_stages=4, *,
                   device=None) -> (D[d_end], D[d_end - 1]) as numpy int32
    stage_batch(sweeps, match=0, mismatch=1, gap=1) -> [(D[d1-1], D[d1-2])]
    stage_plan(sweeps, sms, warps_per_sm) -> StagePlan: how a stage
        launch cuts its live rows into strips, CTAs and waves

Where the JAX ``_sweep_frontier``'s last tile holds fewer than ``m + 1``
cells (``m > d_end``), its frontiers come back short and the JAX
``wavefront_score_mim`` raises; the port's frontiers always hold ``m + 1``
cells, ``BIG`` past the diagonal, and its score is exact there too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cuda_build, platform

__all__ = ["wavefront_score", "wavefront_batch", "wavefront_reference",
           "levenshtein_long_pair", "levenshtein_batch", "band_batch",
           "band_reference", "config_costs", "wavefront_score_mim",
           "sweep_frontier", "stage_batch", "stage_reference", "stage_plan", "ladder",
           "initial_state", "band_plan", "band_warps", "band_card", "flat_plan", "flat_card",
           "MAX_FLAT_CELLS", "BAND_KMAX", "KERNEL_LAUNCHES", "SCRATCH_CAP_BYTES"]

BIG = 1 << 28  # the JAX kernel's identity; masked cells take it
# Diagonal cells of one pair, max(m + 1, n): the JAX kernel's VMEM bound,
# kept so both packages accept and refuse the same pairs.
MAX_FLAT_CELLS = 1 << 19
# The widest band: the JAX band kernel's half-width for pairs over 4096
# bytes, (32 * 128 - 2) // 2. The port uses it at every length.
BAND_KMAX = 2047
_CLASSES = 32

# Launches of the CUDA kernels, counted from what the C side launched: one
# per group of pairs (flat), one per call (band), one per ladder stage of up
# to two sweeps (stage).
KERNEL_LAUNCHES = {"wavefront_flat": 0, "wavefront_band": 0, "wavefront_stage": 0}

# Hand-off slots of one group of pairs in the flat kernel; a call whose
# pairs need more is split into several groups, each its own launch.
SCRATCH_CAP_BYTES = 256 << 20


def config_costs(cfg, table=None) -> dict:
    """The cost arguments of ``wavefront_batch`` for an engine's
    ``SimilarityConfig``, as the JAX engine's long-pair tier passes them:
    open and extend for affine gaps, the gap for linear ones, ``table`` for
    class costs, match and mismatch for uniform ones."""
    kw = dict(objective=cfg.objective, locality=cfg.locality)
    if cfg.is_affine:
        kw.update(gap=cfg.gaps.open, extend=cfg.gaps.extend)
    else:
        kw.update(gap=cfg.gaps.open_or_extend)
    if cfg.uses_classes:
        kw["table"] = table
    else:
        kw.update(match=cfg.costs.match, mismatch=cfg.costs.mismatch)
    return kw


def _check_costs(objective, locality, table):
    if objective not in ("min", "max") or locality not in ("global", "local"):
        raise ValueError(f"unknown objective/locality {objective!r}/{locality!r}")
    if table is None:
        return None
    t = torch.as_tensor(table).to("cpu", torch.int64)
    if tuple(t.shape) != (_CLASSES, _CLASSES):
        raise ValueError(f"table must be (32, 32), got {tuple(t.shape)}")
    if int(t.min()) < -128 or int(t.max()) > 127:
        raise ValueError("class costs must fit in int8")
    return t.to(torch.int32)


def _empty_score(m: int, n: int, gap: int, extend, locality: str) -> int:
    """The JAX rule for a pair with an empty string."""
    if locality == "local":
        return 0
    k = m + n
    if extend is not None:
        return gap + extend * (k - 1) if k else 0
    return k * gap


def wavefront_batch(chars: torch.Tensor, a_off, a_len, b_off, b_len, *,
                    match: int = 0, mismatch: int = 1, gap: int = 1,
                    objective: str = "min", locality: str = "global",
                    table=None, extend: int | None = None) -> torch.Tensor:
    """Scores of pairs ``(chars[a_off:a_off+a_len], chars[b_off:b_off+b_len])``
    as an ``(n_pairs,)`` int32 tensor on ``chars.device``: the Hopper kernel
    for CUDA tensors, the plain version for CPU ones. ``chars`` holds raw
    chars, or class ids when ``table`` (32x32 class costs) is given."""
    return _score(chars, a_off, a_len, b_off, b_len, match, mismatch, gap,
                  objective, locality, table, extend, plain=False)


def wavefront_reference(chars: torch.Tensor, a_off, a_len, b_off, b_len, *,
                        match: int = 0, mismatch: int = 1, gap: int = 1,
                        objective: str = "min", locality: str = "global",
                        table=None, extend: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the same
    arguments and results as ``wavefront_batch``."""
    return _score(chars, a_off, a_len, b_off, b_len, match, mismatch, gap,
                  objective, locality, table, extend, plain=True)


def _columns(chars, a_off, a_len, b_off, b_len):
    """The pairs' offsets and lengths as int64 numpy columns, checked
    against ``chars``."""
    if not isinstance(chars, torch.Tensor) or chars.dtype != torch.int32 or chars.dim() != 1:
        raise TypeError("chars must be a 1-D int32 tensor")
    if not chars.is_contiguous():
        raise ValueError("chars must be contiguous")
    if chars.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wavefront runs on CUDA or CPU tensors, not {chars.device}")
    cols = [np.asarray(x, dtype=np.int64).reshape(-1) for x in (a_off, a_len, b_off, b_len)]
    a_off, a_len, b_off, b_len = cols
    if len({len(x) for x in cols}) != 1:
        raise ValueError("a_off, a_len, b_off and b_len must have one length")
    if len(a_len) and (min(a_off.min(), a_len.min(), b_off.min(), b_len.min()) < 0
                       or max((a_off + a_len).max(), (b_off + b_len).max()) > chars.numel()):
        raise ValueError("a pair reaches outside chars")
    return cols


def _score(chars, a_off, a_len, b_off, b_len, match, mismatch, gap, objective,
           locality, table, extend, plain):
    table = _check_costs(objective, locality, table)
    a_off, a_len, b_off, b_len = _columns(chars, a_off, a_len, b_off, b_len)
    empty = (a_len == 0) | (b_len == 0)
    flat = np.where(empty, 0, np.maximum(a_len + 1, b_len))
    if len(flat) and int(flat.max()) > MAX_FLAT_CELLS:
        raise ValueError(f"pair too long for single-chip wavefront "
                         f"({int(flat.max())} cells)")
    dev = chars.device
    out = np.zeros(len(a_len), np.int64)
    for p in np.nonzero(empty)[0]:
        out[p] = _empty_score(int(a_len[p]), int(b_len[p]), gap, extend, locality)
    result = torch.from_numpy(out.astype(np.int32)).to(dev)
    live = np.nonzero(~empty)[0]
    if len(live) == 0:
        return result
    args = (chars, a_off[live], a_len[live], b_off[live], b_len[live], match,
            mismatch, gap, objective, locality,
            None if table is None else table.to(dev), extend)
    scores = (_plain(*args) if plain or dev.type == "cpu" else _launch(*args))
    result[torch.from_numpy(live).to(dev)] = scores
    return result


# The flat kernel's plan: rows a lane it is built for (a strip is a warp of
# 32 * R rows; R = 8 was slower on the long reads and the long pair once
# pairs ran along their shorter string), warps a CTA, steps a strip reads
# from the strip above at once.
FLAT_ROWS = 4
FLAT_WARPS = 4
FLAT_CHUNK = 16
# The most warps a scheduler of an SM runs at once (CTAs an SM, at 4 warps
# a CTA): a strip's step is a short chain of dependent cells, and warps
# sharing a scheduler slow one another's chains. One warp a scheduler is
# fastest for a lone pair, whose chain of strips sets its time; three where
# many pairs' strips run side by side (tools/flat_grid_probe.py; PERF.md).
FLAT_SHARE = 3
_FLAT_HEADER_BYTES = 8  # a group's status and claim counter


class FlatGroup(NamedTuple):
    """One launch of a ``FlatPlan``: pairs ``[first_pair, first_pair +
    pairs)`` (the plan's order), their strips ``[first_claim, first_claim +
    claims)`` of ``FlatPlan.claims``, a grid of ``ctas`` CTAs, and
    ``slot_words`` int64 hand-off slots, two rows of ``n + 1`` (four when
    affine) for each pair of two or more strips."""
    first_pair: int
    pairs: int
    first_claim: int
    claims: int
    ctas: int
    slot_words: int


class FlatPlan(NamedTuple):
    """How ``csrc/wavefront.cu``'s flat kernel runs a batch: at most
    ``ctas_per_sm`` CTAs of ``FLAT_WARPS`` warps an SM (a strip is a warp of
    ``32 * FLAT_ROWS`` rows); of each pair whether it runs ``transposed``
    (its rows the second string's, when that is the shorter), its ``strips``
    and its ``slot_offsets`` (int64 words within its group's slots);
    ``claims`` (an ``(n, 2)`` int32 array: each group's strips in the order
    its warps claim them, ``(pair within the group, strip)``, strip-major
    across the group's pairs), one ``FlatGroup`` a launch, and the hand-off
    buffer's ``handoff_bytes``: 8 a group, then the largest group's
    slots."""
    ctas_per_sm: int
    transposed: tuple
    strips: tuple
    slot_offsets: tuple
    claims: np.ndarray
    groups: tuple
    handoff_bytes: int

    def record(self) -> np.ndarray:
        """The groups as ``sz_wavefront_flat`` reads them."""
        return np.array([list(g) for g in self.groups], dtype=np.int64).reshape(-1, 6)


def flat_plan(pairs, affine: bool, sms: int, warps_per_sm: int) -> FlatPlan:
    """The plan of a flat launch over ``pairs`` ``[(m, n)]`` (m, n >= 1) on
    a card of ``sms`` SMs holding ``warps_per_sm`` warps of the kernel. A
    pair with ``m > n`` runs transposed (the score is the same with the
    class table transposed), so its rows are its shorter string's: fewer
    strips, each longer. A pair takes ``ceil(min(m, n) / (32 FLAT_ROWS))``
    strips, with slots for its ``max(m, n) + 1`` columns; consecutive pairs
    form a group while their slots fit ``SCRATCH_CAP_BYTES``, each group one
    launch: a grid of ``c`` CTAs an SM, ``c`` the strips over ``FLAT_SHARE *
    FLAT_WARPS`` an SM, rounded up, between 1 and ``FLAT_SHARE`` and at most
    what the card holds, and no more CTAs than the strips fill. Raises
    ``ValueError`` when one pair's slots alone exceed the cap."""
    if not pairs or sms < 1:
        raise ValueError(f"a flat plan needs pairs and SMs, not {len(pairs)} pairs, {sms} SMs")
    cap = SCRATCH_CAP_BYTES
    h, W = 32 * FLAT_ROWS, FLAT_WARPS
    ctas_per_sm = warps_per_sm // W
    if ctas_per_sm < 1:
        raise ValueError(f"an SM must hold a CTA of {W} warps, not {warps_per_sm}")
    transposed = tuple(m > n for m, n in pairs)
    strips = [-(-min(m, n) // h) for m, n in pairs]
    words = [2 * (max(m, n) + 1) * (2 if affine else 1) if s > 1 else 0
             for (m, n), s in zip(pairs, strips)]
    offsets, claims, groups = [], [], []
    begin = first = 0
    while begin < len(pairs):
        if 8 * words[begin] > cap:
            m, n = pairs[begin]
            raise ValueError(f"the {m} x {n} pair's hand-off of {8 * words[begin]} bytes "
                             f"exceeds the cap of {cap}")
        end, total = begin, 0
        while end < len(pairs) and 8 * (total + words[end]) <= cap:
            offsets.append(total)
            total += words[end]
            end += 1
        # the group's strips, strip-major: strip s of every pair, then s + 1
        counts = np.asarray(strips[begin:end], np.int64)
        count = int(counts.sum())
        pair = np.repeat(np.arange(end - begin), counts)
        strip = np.arange(count) - np.repeat(np.cumsum(counts) - counts, counts)
        order = np.lexsort((pair, strip))
        claims.append(np.stack([pair[order], strip[order]], axis=1))
        per_sm = min(ctas_per_sm, FLAT_SHARE, -(-count // (sms * W * FLAT_SHARE)))
        groups.append(FlatGroup(begin, end - begin, first, count,
                                min(-(-count // W), sms * per_sm), total))
        first += count
        begin = end
    slot_words = max(g.slot_words for g in groups)
    return FlatPlan(ctas_per_sm, transposed, tuple(strips), tuple(offsets),
                    np.concatenate(claims).astype(np.int32), tuple(groups),
                    _FLAT_HEADER_BYTES * len(groups) + 8 * slot_words)


_FLAT_CARD: dict = {}


def flat_card(device, config: int) -> tuple[int, int]:
    """(SMs, warps of the flat kernel an SM holds) of the CUDA ``device`` for
    ``config`` (max * 8 + local * 4 + affine * 2 + classes), from the
    occupancy API: what ``wavefront_batch`` plans for."""
    dev = torch.device(device)
    key = (dev.index, config)
    if key not in _FLAT_CARD:
        lib = cuda_build.load()
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.sz_wavefront_flat_occupancy(config, ctypes.byref(per_sm))
        _raise_on(lib, err, "sz_wavefront_flat_occupancy")
        _FLAT_CARD[key] = (torch.cuda.get_device_properties(dev).multi_processor_count,
                           per_sm.value * FLAT_WARPS)
    return _FLAT_CARD[key]


def _launch(chars, a_off, a_len, b_off, b_len, match, mismatch, gap, objective,
            locality, table, extend):
    """Every pair through ``csrc/wavefront.cu``'s flat kernel, one launch a
    group of ``flat_plan``. It waits for the launches and raises if a
    strip's wait stalled."""
    dev = chars.device
    affine = extend is not None
    config = 8 * (objective == "max") + 4 * (locality == "local") + 2 * affine + (table is not None)
    plan = flat_plan(list(zip(a_len.tolist(), b_len.tolist())), affine, *flat_card(dev, config))
    tr = np.array(plan.transposed)
    rec = np.stack([np.where(tr, b_off, a_off), np.where(tr, b_len, a_len),
                    np.where(tr, a_off, b_off), np.where(tr, a_len, b_len),
                    np.array(plan.slot_offsets, np.int64), tr.astype(np.int64)], axis=1)
    pairs = torch.from_numpy(np.ascontiguousarray(rec)).to(dev)
    claims = torch.from_numpy(plan.claims).to(dev)
    handoff = torch.empty(plan.handoff_bytes // 8, dtype=torch.int64, device=dev)
    groups = plan.record()
    out = torch.zeros(len(a_len), dtype=torch.int32, device=dev)  # local bests start at 0
    lib = cuda_build.load()
    launches = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = lib.sz_wavefront_flat(
            config, gap, extend if affine else 0, match, mismatch,
            chars.data_ptr(), pairs.data_ptr(), claims.data_ptr(),
            None if table is None else table.data_ptr(), groups.ctypes.data, len(groups),
            handoff.data_ptr(), plan.handoff_bytes, out.data_ptr(), ctypes.byref(launches),
            torch.cuda.current_stream(dev).cuda_stream)
    KERNEL_LAUNCHES["wavefront_flat"] += launches.value
    _raise_on(lib, err, "sz_wavefront_flat")
    status = handoff[: len(groups)].view(torch.int32)[0::2]
    if bool((status != 0).any()):  # a stalled wait: a fault, never an answer
        raise RuntimeError(f"sz_wavefront_flat: a strip's wait stalled (statuses "
                           f"{sorted(set(status.tolist()))})")
    return out


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")


def _plain(chars, a_off, a_len, b_off, b_len, match, mismatch, gap, objective,
           locality, table, extend):
    """The JAX kernel's recurrence, every pair at once: diagonal ``d`` holds
    cells ``(i, d - i)`` at flat index ``i`` of a ``(pairs, max m + 1)``
    int32 row. Cells outside a pair's matrix take the identity, row 0 and
    column 0 ``boundary(d)``. A diagonal that the next step reads shifted
    (``D``, and ``J`` when affine) sits in a buffer behind one identity
    column, so its cells at ``i - 1`` are a view of the same buffer."""
    dev = chars.device
    P = len(a_len)
    M, N = int(a_len.max()), int(b_len.max())
    L = M + 1
    is_min = objective == "min"
    opt = torch.minimum if is_min else torch.maximum
    ident = BIG if is_min else -BIG
    affine = extend is not None
    local = locality == "local"
    ext = extend if affine else 0

    def boundary(k: int) -> int:
        if local:
            return 0
        if affine:
            return gap + ext * (k - 1) if k > 0 else 0
        return gap * k

    def gather(off, lens, width, fill):
        j = torch.arange(width, device=dev)
        lens_t = torch.from_numpy(lens).to(dev)[:, None]
        pos = torch.from_numpy(off).to(dev)[:, None] + j
        ok = j < lens_t
        return torch.where(ok, chars[torch.where(ok, pos, 0)], fill)

    def padded(first):
        buf = torch.full((P, L + 1), ident, dtype=torch.int32, device=dev)
        buf[:, 1:] = first
        return buf

    flat = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    m = torch.from_numpy(a_len.astype(np.int32)).to(dev)[:, None]
    n = torch.from_numpy(b_len.astype(np.int32)).to(dev)[:, None]
    # qm1[i] = a[i - 1]; -2 pads it (the JAX packing), never a b value of -1
    qm1 = torch.cat([torch.full((P, 1), -2, dtype=torch.int32, device=dev),
                     gather(a_off, a_len, M, -2)], dim=1)
    # T[i] = b[d - 1 - i], or -1 outside b: a slice of b reversed, padded L
    # each side, starting at L + N - d
    bpad = torch.full((P, L + N + L), -1, dtype=torch.int32, device=dev)
    bpad[:, L: L + N] = gather(b_off, b_len, N, -1)
    bflip = bpad.flip(1)
    if table is not None:
        qrow = qm1.clamp(0, _CLASSES - 1) * _CLASSES
        bflip = bflip.clamp(0, _CLASSES - 1)
        tab = table.reshape(-1)
    else:
        costs = torch.tensor([mismatch, match], dtype=torch.int32, device=dev)
    ident_t = torch.tensor(ident, dtype=torch.int32, device=dev)

    # diagonals 0 and 1: cell (0, 0) = 0, cells (0, 1) and (1, 0) the border
    D2 = padded(torch.where(flat == 0, 0, ident))
    D1 = padded(torch.where(flat <= 1, boundary(1), ident))
    I1 = torch.where(flat <= 1, boundary(1) + gap + ext, ident).to(torch.int32).expand(P, L)
    J1 = padded(I1)
    best = torch.zeros(P, dtype=torch.int32, device=dev)
    score = torch.zeros(P, dtype=torch.int32, device=dev)
    ends = {}  # global: step -> the pairs whose cell (m, n) it computes
    for p, d in enumerate((a_len + b_len).tolist()):
        ends.setdefault(d, []).append(p)
    reduce = torch.amin if is_min else torch.amax
    for d in range(2, int((a_len + b_len).max()) + 1):
        T = bflip[:, L + N - d: L + N - d + L]
        sub = tab[qrow + T] if table is not None else costs[(qm1 == T).long()]
        # D[d-1][i] is D1[:, 1:], D[d-1][i-1] is D1[:, :-1], D[d-2][i-1] is D2[:, :-1]
        if affine:
            I_new = opt(D1[:, 1:] + gap, I1 + ext)
            J_new = opt(D1[:, :-1] + gap, J1[:, :-1] + ext)
            cand = opt(D2[:, :-1] + sub, opt(I_new, J_new))
        else:
            cand = opt(opt(D1[:, 1:] + gap, D1[:, :-1] + gap), D2[:, :-1] + sub)
        if local:
            cand = cand.clamp(max=0) if is_min else cand.clamp(min=0)
        # cells (0, d) and (d, 0); the mask below takes them out of the
        # pairs whose matrix does not reach them, as every cell outside it
        cand[:, 0] = boundary(d)
        if d < L:
            cand[:, d] = boundary(d)
        valid = (flat >= (d - n).clamp(min=0)) & (flat <= m.clamp(max=d))
        D2, D1 = D1, D2  # D2's buffer takes diagonal d
        torch.where(valid, cand, ident_t, out=D1[:, 1:])
        if affine:
            for g in (I_new, J_new):
                g[:, 0] = boundary(d) + gap + ext
                if d < L:
                    g[:, d] = boundary(d) + gap + ext
            I1 = torch.where(valid, I_new, ident_t)
            torch.where(valid, J_new, ident_t, out=J1[:, 1:])
        if local:
            # the JAX kernel reduces over interior cells only: the border
            # cells are 0 and the rest the identity, which change nothing
            best = opt(best, reduce(D1[:, 1:], dim=1))
        elif d in ends:
            idx = torch.tensor(ends[d], device=dev)
            score[idx] = D1[idx, m[idx, 0].long() + 1]
    return best if local else score


def wavefront_score(a, b, match: int = 0, mismatch: int = 1, gap: int = 1,
                    objective: str = "min", locality: str = "global",
                    table=None, extend: int | None = None, *,
                    device: torch.device | str | None = None) -> int:
    """Score ONE (possibly huge) pair, as the JAX ``wavefront_score``:
    uniform substitution costs, or a 32x32 class-cost ``table`` with ``a``
    and ``b`` pre-mapped to class ids; linear gaps, or Gotoh affine when
    ``extend`` is given (a k-gap costs ``gap + extend * (k - 1)``). Runs on
    ``device``: ``cuda:0`` by default, ``"cpu"`` for the plain version."""
    a = np.asarray(a).astype(np.int32).reshape(-1)
    b = np.asarray(b).astype(np.int32).reshape(-1)
    dev = platform.cuda_device(0) if device is None else torch.device(device)
    chars = torch.from_numpy(np.concatenate([a, b])).to(dev)
    res = wavefront_batch(chars, [0], [len(a)], [len(a)], [len(b)], match=match,
                          mismatch=mismatch, gap=gap, objective=objective,
                          locality=locality, table=table, extend=extend)
    return int(res[0])


def band_batch(chars: torch.Tensor, a_off, a_len, b_off, b_len,
               k0: int = 64, card: tuple[int, int] | None = None) -> torch.Tensor:
    """The band tier on pairs ``(chars[a_off:a_off+a_len],
    chars[b_off:b_off+b_len])``: an ``(n_pairs, 4)`` int64 tensor on
    ``chars.device`` of distance (0 unless certified), status (1 certified,
    2 distance over ``BAND_KMAX``), the last rung's half-width and the band
    cells walked. The Hopper kernel for CUDA tensors, the plain version for
    CPU ones. An empty string certifies ``m + n`` with nothing walked. The
    kernel's launch is planned for ``card``, ``(SMs, warps an SM holds)``,
    when given (a cut of the card, to run the plan's turns on few pairs),
    else for ``band_card(chars.device)``."""
    return _band(chars, a_off, a_len, b_off, b_len, k0, plain=False, card=card)


def band_reference(chars: torch.Tensor, a_off, a_len, b_off, b_len,
                   k0: int = 64, rungs: list | None = None) -> torch.Tensor:
    """Plain PyTorch version of the band kernel, on any device: the same
    arguments and results as ``band_batch``. A list ``rungs`` gets ``(pair,
    k, stop_row)`` for each rung walked, ``stop_row`` 0 when the rung
    reached cell (m, n)."""
    return _band(chars, a_off, a_len, b_off, b_len, k0, plain=True, rungs=rungs)


def _band(chars, a_off, a_len, b_off, b_len, k0, plain, rungs=None, card=None):
    a_off, a_len, b_off, b_len = _columns(chars, a_off, a_len, b_off, b_len)
    dev = chars.device
    # The first rung: k0, doubled until the band holds cell (m, n).
    first = np.full(len(a_len), max(int(k0), 2), np.int64)
    while np.any(grow := first < np.abs(a_len - b_len)):
        first[grow] *= 2
    out = np.zeros((len(a_len), 4), np.int64)
    empty = (a_len == 0) | (b_len == 0)
    out[empty, 0] = (a_len + b_len)[empty]
    out[:, 1] = np.where(empty, 1, 2)
    out[:, 2] = np.where(empty, 0, np.minimum(first, BAND_KMAX))
    result = torch.from_numpy(out).to(dev)
    live = np.nonzero(~empty & (first <= BAND_KMAX))[0]
    if len(live):
        rec = np.ascontiguousarray(np.stack(
            [a_off[live], a_len[live], b_off[live], b_len[live], first[live]], axis=1))
        if plain or dev.type == "cpu":
            walked = []
            scores = _band_plain(chars, rec, walked)
            if rungs is not None:
                rungs.extend((int(live[p]), k, stop) for p, k, stop in walked)
        else:
            scores = _band_launch(chars, rec, card)
        result[torch.from_numpy(live).to(dev)] = scores
    return result


# The band kernel's plan: rows a lane it is built for (a strip is a warp of
# 32 * R rows), warps a CTA (one a scheduler of an SM), steps a strip reads
# from the strip above at once, slots of a hand-off ring, bytes of a CTA
# group's state.
BAND_ROWS = 2
BAND_WARPS = 4
BAND_CHUNK = 16
BAND_RING = 64
_BAND_GROUP_BYTES = 64


def band_warps(m: int, n: int, kmax: int = BAND_KMAX) -> int:
    """Warps in the circle of one ``m x n`` pair's strips of ``h = 32 *
    BAND_ROWS`` rows, strip ``s`` on warp ``s mod W``. A strip runs at most
    ``steps = min(2 kmax, n) + 2 h`` steps. Two bounds, at the widest band
    the ladder can reach:

    * no wait for a warp: where the band has left column 0, strip ``s +
      1`` trails strip ``s`` by at least ``2 h - 1`` steps and a chunk, so
      ``W (2 h - 1 + chunk) >= steps`` frees strip ``s``'s warp before
      strip ``s + W``'s first slot arrives;
    * no cycle of waits: strip ``s`` must be able to finish while strip
      ``s + W``, on its warp, has not started. Each strip of the circle can
      run ahead of the one below by the ``h - 2`` steps its bottom row
      trails its top (strips that share column 0 trail by no more) and the
      ring's slots past a chunk each side and an alignment of the stream,
      ``ring - chunk + 2``; the last one a chunk less. So ``W (h + ring -
      chunk) - chunk >= steps``.

    A pair of fewer strips takes a warp a strip."""
    h = 32 * BAND_ROWS
    steps = min(2 * kmax, n) + 2 * h
    no_wait = -(-steps // (2 * h - 1 + BAND_CHUNK))
    no_cycle = -(-(steps + BAND_CHUNK) // (h + BAND_RING - BAND_CHUNK))
    return max(1, min(max(no_wait, no_cycle), -(-m // h)))


class BandPlan(NamedTuple):
    """How one launch of ``csrc/wavefront.cu``'s band kernel lays out its
    pairs: ``rows_per_lane`` R (``BAND_ROWS``; a strip is a warp of 32 * R
    rows), ``chunk`` (``BAND_CHUNK``), ``warps_per_cta`` (``BAND_WARPS``), a
    circle of ``warps`` warps in ``group_ctas`` CTAs per pair, ``groups``
    such groups (group ``g`` takes pairs ``g``, ``g + groups``, ... in
    turn), the grid's ``ctas`` with at most ``ctas_per_sm`` of them on an SM
    when spread evenly, ``ring`` slots a hand-off ring, and the hand-off
    buffer's ``handoff_bytes``: a group's state each, then two sets of one
    ring a CTA."""
    rows_per_lane: int
    chunk: int
    warps_per_cta: int
    warps: int
    group_ctas: int
    groups: int
    ctas: int
    ctas_per_sm: int
    ring: int
    handoff_bytes: int

    def record(self) -> list[int]:
        """The plan as ``sz_wavefront_band`` reads it."""
        return [self.rows_per_lane, self.chunk, self.warps_per_cta, self.group_ctas,
                self.groups, self.ring, self.handoff_bytes]


def band_plan(pairs, sms: int, warps_per_sm: int, kmax: int = BAND_KMAX) -> BandPlan:
    """The plan of one band launch over ``pairs`` ``[(m, n)]`` on a card of
    ``sms`` SMs, each holding ``warps_per_sm`` warps of the kernel at once.
    Every pair gets a circle of ``band_warps`` warps, the most any pair
    needs, in CTAs of ``BAND_WARPS``; as many groups as the card holds at
    once (the rings and the rung barriers need every CTA resident), at most
    one a pair."""
    if not pairs or sms < 1:
        raise ValueError(f"a band plan needs pairs and SMs, not {len(pairs)} pairs, {sms} SMs")
    ctas = -(-max(band_warps(m, n, kmax) for m, n in pairs) // BAND_WARPS)
    groups = min(len(pairs), sms * (warps_per_sm // BAND_WARPS) // ctas)
    if not groups:
        raise ValueError(f"a circle of {ctas} CTAs does not fit {sms} SMs of {warps_per_sm} warps")
    grid = groups * ctas
    return BandPlan(BAND_ROWS, BAND_CHUNK, BAND_WARPS, ctas * BAND_WARPS, ctas, groups, grid,
                    -(-grid // sms), BAND_RING,
                    groups * _BAND_GROUP_BYTES + 2 * grid * (BAND_RING + 1) * 8)


_BAND_CARD: dict = {}


def band_card(device) -> tuple[int, int]:
    """(SMs, warps of the band kernel an SM holds at once) of the CUDA
    ``device``, from the occupancy API: what ``band_batch`` plans for."""
    dev = torch.device(device)
    if dev.index not in _BAND_CARD:
        lib = cuda_build.load()
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.sz_wavefront_band_occupancy(ctypes.byref(per_sm))
        _raise_on(lib, err, "sz_wavefront_band_occupancy")
        _BAND_CARD[dev.index] = (torch.cuda.get_device_properties(dev).multi_processor_count,
                                 per_sm.value * BAND_WARPS)
    return _BAND_CARD[dev.index]


def _band_launch(chars, rec, card=None):
    """Every pair through ``csrc/wavefront.cu``'s band kernel in one launch,
    on the plan ``band_plan`` makes for ``card`` (``band_card`` of the
    tensors' device when None). It raises when a pipeline wait stalled."""
    dev = chars.device
    lib = cuda_build.load()
    plan = band_plan([(m, n) for _, m, _, n, _ in rec.tolist()], *(card or band_card(dev)))
    out = torch.zeros((len(rec), 4), dtype=torch.int64, device=dev)
    pairs = torch.from_numpy(rec).to(dev)
    handoff = torch.empty(plan.handoff_bytes // 8, dtype=torch.int64, device=dev)
    prec = np.array(plan.record(), dtype=np.int64)
    launches = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = lib.sz_wavefront_band(chars.data_ptr(), pairs.data_ptr(), len(rec), BAND_KMAX,
                                    prec.ctypes.data, handoff.data_ptr(), plan.handoff_bytes,
                                    out.data_ptr(), ctypes.byref(launches),
                                    torch.cuda.current_stream(dev).cuda_stream)
    KERNEL_LAUNCHES["wavefront_band"] += launches.value
    _raise_on(lib, err, "sz_wavefront_band")
    status = out[:, 1]
    if bool(((status != 1) & (status != 2)).any()):  # a stalled wait: a fault, never an answer
        raise RuntimeError(f"sz_wavefront_band: a pipeline wait stalled (statuses "
                           f"{sorted(set(status.tolist()))})")
    return out


def _band_plain(chars, rec, walked):
    """The band kernel's ladder, a pair at a time, each rung a row at a
    time over the band's ``2k + 1`` cells; each rung's ``(pair, k,
    stop_row)`` goes to ``walked``."""
    out = []
    for p, (a_off, m, b_off, n, k) in enumerate(rec.tolist()):
        a, b = chars[a_off: a_off + m], chars[b_off: b_off + n]
        cells, res, status = 0, 0, 0
        while True:
            got, stop_row, rung_cells = _band_rung(a, b, m, n, k)
            walked.append((p, k, stop_row))
            cells += rung_cells
            if not stop_row and got <= k:
                res, status = got, 1
                break
            if k >= BAND_KMAX:
                status = 2
                break
            est = got
            if stop_row:
                est = k * m // stop_row
                est += est // 4
            nxt = 2 * k
            while nxt < min(est, BAND_KMAX):
                nxt *= 2
            k = min(nxt, BAND_KMAX)
        out.append((res, status, k, cells))
    return torch.tensor(out, dtype=torch.int64, device=chars.device)


def _band_rung(a, b, m: int, n: int, k: int):
    """One rung of half-width ``k``: (D[m][n] within the band, the first row
    whose band cells all exceed ``k`` or 0, band cells walked). Row ``i``
    holds the cells ``j = i - k + u``, ``u`` in ``[0, 2k]``; the in-row
    chain ``D[i][j] = min(x[j], D[i][j - 1] + 1)`` is a running minimum of
    ``x - u``, plus ``u``. A stopped rung counts the rows of its 32-row
    strip, as the kernel walks them."""
    dev = a.device
    u = torch.arange(2 * k + 1, device=dev)
    # b_pad[i + u] = b[j - 1]; -1 pads it
    b_pad = torch.full((max(m, n) + 2 * k + 2,), -1, dtype=torch.int32, device=dev)
    b_pad[k + 1: k + 1 + n] = b
    big = torch.full((1,), BIG, dtype=torch.int32, device=dev)
    j = u - k
    prev = torch.where((j >= 0) & (j <= min(n, k)), j, BIG).to(torch.int32)  # row 0
    cells = 0
    for i in range(1, m + 1):
        j = i - k + u
        up = torch.cat([prev[1:], big])  # D[i - 1][j]
        sub = (a[i - 1] != b_pad[i: i + 2 * k + 1]).to(torch.int32)
        x = torch.minimum(up + 1, prev + sub)  # prev[u] is D[i - 1][j - 1]
        valid = (j >= 0) & (j <= n)
        x = torch.where(valid, torch.where(j == 0, i, x), BIG).to(torch.int32)
        cur = torch.cummin(x - u, dim=0).values + u
        prev = torch.where(valid, cur, BIG).to(torch.int32)
        cells += min(n, i + k) - max(0, i - k) + 1
        if not bool((prev <= k).any()):
            for r in range(i + 1, min(m, -(-i // 32) * 32) + 1):
                cells += min(n, r + k) - max(0, r - k) + 1
            return 0, i, cells
    return int(prev[n - m + k]), 0, cells


def levenshtein_batch(chars: torch.Tensor, a_off, a_len, b_off, b_len,
                      k0: int = 64) -> torch.Tensor:
    """Exact unit-cost Levenshtein distances of pairs, as the JAX engine's
    long-pair tier gives them: the band tier first, the flat tier for every
    pair the band cannot certify. An ``(n_pairs,)`` int32 tensor on
    ``chars.device``. Above ``MAX_FLAT_CELLS`` a pair the band does not
    certify raises the flat tier's ``ValueError``."""
    band = band_batch(chars, a_off, a_len, b_off, b_len, k0)
    dist = band[:, 0].to(torch.int32)
    rest = np.nonzero(band[:, 1].cpu().numpy() != 1)[0]
    if len(rest):
        cols = [np.asarray(x, dtype=np.int64).reshape(-1)[rest]
                for x in (a_off, a_len, b_off, b_len)]
        dist[torch.from_numpy(rest).to(chars.device)] = wavefront_batch(chars, *cols)
    return dist


def levenshtein_long_pair(a, b, k0: int = 64, *,
                          device: torch.device | str | None = None) -> int:
    """Exact Levenshtein distance of ONE long pair, as the JAX
    ``levenshtein_long_pair``: band doubling from half-width ``k0``, the
    flat tier when the distance is over ``BAND_KMAX``. Runs on ``device``:
    ``cuda:0`` by default, ``"cpu"`` for the plain versions."""
    a = np.asarray(a).astype(np.int32).reshape(-1)
    b = np.asarray(b).astype(np.int32).reshape(-1)
    dev = platform.cuda_device(0) if device is None else torch.device(device)
    chars = torch.from_numpy(np.concatenate([a, b])).to(dev)
    return int(levenshtein_batch(chars, [0], [len(a)], [len(a)], [len(b)], k0)[0])


# -- meet in the middle ---------------------------------------------------------

def ladder(d_end: int, n_stages: int = 4) -> list[tuple[int, int]]:
    """The stages ``[d0, d1)`` of a sweep to diagonal ``d_end``, cut as the
    JAX ``_sweep_frontier`` cuts them: stage ``s`` ends at ``2 + (d_end - 1)
    * (s + 1) // n_stages``. The first stage always runs, with zero steps
    when it ends at 2; a later one that would not advance is dropped."""
    if d_end < 1 or n_stages < 1:
        raise ValueError(f"a sweep needs d_end >= 1 and n_stages >= 1, not {d_end}, {n_stages}")
    stages, d_prev = [], 2
    for s in range(n_stages):
        d_s = 2 + ((d_end - 1) * (s + 1)) // n_stages
        if s and d_s <= d_prev:
            continue
        stages.append((d_prev, d_s))
        d_prev = d_s
    return stages


def initial_state(m: int, gap: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(D[1], D[0])`` over ``m + 1`` cells, the first stage's input:
    ``gap`` at ``i <= 1`` and 0 at ``i = 0``, ``BIG`` elsewhere."""
    d1 = torch.full((m + 1,), BIG, dtype=torch.int32, device=device)
    d2 = torch.full((m + 1,), BIG, dtype=torch.int32, device=device)
    d1[:2] = gap
    d2[0] = 0
    return d1, d2


def stage_batch(sweeps, match: int = 0, mismatch: int = 1, gap: int = 1) -> list:
    """One ladder stage of each of one or two sweeps ``(a, b, D1, D2, d0,
    d1)`` (a call's forward and backward ones): from ``D1 = D[d0-1]`` and
    ``D2 = D[d0-2]`` through the steps ``d`` in ``[d0, d1)`` to ``(D[d1-1],
    D[d1-2])``, a list of new tensors. ``a`` and ``b`` are 1-D int32
    tensors, ``D1`` and ``D2`` int32 of ``len(a) + 1`` cells, all on one
    device: the Hopper kernel for CUDA tensors (one launch for both sweeps),
    the plain version for CPU ones."""
    if _check_sweeps(sweeps).type == "cpu":
        return stage_reference(sweeps, match, mismatch, gap)
    return _stage_launch(sweeps, match, mismatch, gap)


def stage_reference(sweeps, match: int = 0, mismatch: int = 1, gap: int = 1) -> list:
    """Plain PyTorch version of the stage kernel, on any device: the same
    arguments and results as ``stage_batch``."""
    _check_sweeps(sweeps)
    return [_stage_plain(*sweep, match, mismatch, gap) for sweep in sweeps]


def _check_sweeps(sweeps) -> torch.device:
    if not 1 <= len(sweeps) <= 2:
        raise ValueError(f"a stage takes one or two sweeps, not {len(sweeps)}")
    devices = set()
    for a, b, D1, D2, d0, d1 in sweeps:
        for x in (a, b, D1, D2):
            if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.dim() != 1:
                raise TypeError("a, b, D1 and D2 must be 1-D int32 tensors")
            if not x.is_contiguous():
                raise ValueError("a, b, D1 and D2 must be contiguous")
            devices.add(x.device)
        m, n = a.numel(), b.numel()
        if D1.numel() != m + 1 or D2.numel() != m + 1:
            raise ValueError(f"D1 and D2 must hold len(a) + 1 = {m + 1} cells")
        if not 2 <= d0 <= d1 <= m + n + 1:
            raise ValueError(f"a stage runs 2 <= d0 <= d1 <= m + n + 1, not [{d0}, {d1})")
    if len(devices) != 1:
        raise ValueError(f"the sweeps' tensors must lie on one device, not {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the stage runs on CUDA or CPU tensors, not {dev}")
    return dev


# The stage kernel's plan: rows a lane it is built for, warps a CTA (one a
# scheduler of an SM), slots of a hand-off ring.
STAGE_ROWS_PER_LANE = (1, 2, 4, 6, 8, 12, 16, 24, 32)
STAGE_WARPS = 4
STAGE_RING = 64


def stage_chunk(rows_per_lane: int) -> int:
    """Steps a strip of ``rows_per_lane`` rows a lane reads from the strip
    above at once, as the kernel's ``chunk_of`` fixes them: 16 up to R =
    16; wider strips spill registers at 16 and take 8."""
    return 16 if rows_per_lane <= 16 else 8


class SweepPlan(NamedTuple):
    """One sweep's part of a ``StagePlan``. Its live rows ``[lo, hi]`` (no
    row when ``hi < lo``) lie in ``strips`` strips of ``32 * rows_per_lane``
    rows from strip ``first_strip`` (aligned at row 0), run by ``ctas`` CTAs
    from ``first_cta`` in ``waves`` waves. ``ring_offset`` is the byte
    offset in the hand-off buffer of its finished count (8 bytes), the
    first and last times a strip of its first wave began its steps (16
    bytes, the pipeline's fill) and its CTAs' rings;
    ``column_offset`` that of its two wave columns, -1 in one wave."""
    lo: int
    hi: int
    first_strip: int
    strips: int
    first_cta: int
    ctas: int
    waves: int
    ring_offset: int
    column_offset: int


class StagePlan(NamedTuple):
    """How one launch of ``csrc/wavefront_stage.cu`` lays out its sweeps:
    ``rows_per_lane`` R (a strip is a warp of 32 * R rows), ``chunk`` (steps
    a strip reads from the strip above at once, ``stage_chunk(R)``),
    ``warps_per_cta`` (``STAGE_WARPS``), the grid's ``ctas`` and at most ``ctas_per_sm`` of them on an SM, ``ring``
    slots a hand-off ring, one ``SweepPlan`` a sweep, and the hand-off
    buffer: ``handoff_bytes`` in all, of which the first ``zeroed_bytes``
    (status word, finished counts, rings) are zeroed at each launch;
    ``shared_bytes`` of shared memory a CTA."""
    rows_per_lane: int
    chunk: int
    warps_per_cta: int
    ctas: int
    ctas_per_sm: int
    ring: int
    sweeps: tuple
    zeroed_bytes: int
    handoff_bytes: int
    shared_bytes: int

    def record(self) -> list[int]:
        """The plan as ``sz_wavefront_stage`` reads it."""
        rec = [self.rows_per_lane, self.chunk, self.warps_per_cta, self.ctas, self.ring,
               self.zeroed_bytes]
        for sp in self.sweeps:
            rec += [sp.first_strip, sp.strips, sp.first_cta, sp.ctas, sp.ring_offset,
                    sp.column_offset]
        return rec


def stage_plan(sweeps, sms: int, warps_per_sm: int) -> StagePlan:
    """The strip plan of one stage launch of ``sweeps`` ``[(m, n, d0, d1)]``
    on a card of ``sms`` SMs, each holding ``warps_per_sm`` warps of the
    kernel at once. A row is live when some step of ``[d0, d1)`` has it in
    the matrix's band, ``max(d0 - n, 0) <= i <= min(d1 - 1, m)``; only live
    rows get strips. R is the smallest of ``STAGE_ROWS_PER_LANE`` whose
    strips fit one CTA an SM, so the rows spread over every SM; past R = 32
    more CTAs share an SM, up to what it holds, then the strips run in
    waves, the CTAs split between the sweeps by strips."""
    W = STAGE_WARPS
    if sms < 1 or warps_per_sm < W:
        raise ValueError(f"an SM must hold a CTA of {W} warps, not {warps_per_sm} ({sms} SMs)")
    live = []
    for m, n, d0, d1 in sweeps:
        lo, hi = max(d0 - n, 0), min(d1 - 1, m)
        live.append((lo, hi) if d1 > d0 and lo <= hi else (1, 0))
    for r in STAGE_ROWS_PER_LANE:
        h = 32 * r
        strips = [hi // h - lo // h + 1 if lo <= hi else 0 for lo, hi in live]
        ctas = [-(-s // W) for s in strips]
        if sum(ctas) <= sms:
            break
    budget = sms * (warps_per_sm // W)
    if sum(ctas) > budget:  # waves: every CTA the card holds, split by strips
        busy = [k for k, s in enumerate(strips) if s]
        if len(busy) > budget:
            raise ValueError(f"{len(busy)} sweeps need a CTA each, the card holds {budget}")
        total = sum(strips)
        ctas = [max(1, budget * s // total) if s else 0 for s in strips]
        while sum(ctas) < budget:  # the spare CTAs to the sweep with most strips a warp
            k = max(busy, key=lambda k: strips[k] / ctas[k])
            ctas[k] += 1
    plans, first_cta, off = [], 0, 8  # the status word first
    for (lo, hi), s, c in zip(live, strips, ctas):
        plans.append([lo, hi, lo // h if s else 0, s, first_cta, c,
                      -(-s // (c * W)) if s else 0, off, -1])
        first_cta += c
        off += 24 + c * (STAGE_RING + 1) * 8  # count, start times, rings
    zeroed = off
    for p, (_, _, d0, d1) in zip(plans, sweeps):
        if p[6] > 1:
            p[8] = off
            off += 16 * (d1 - d0)  # two columns of 8-byte slots
    grid = max(1, first_cta)
    return StagePlan(r, stage_chunk(r), W, grid, -(-grid // sms), STAGE_RING,
                     tuple(SweepPlan(*p) for p in plans), zeroed, off,
                     W * (STAGE_RING + 1) * 8)


_STAGE_CARD: dict = {}


def _stage_card(lib, dev) -> tuple[int, int]:
    """(SMs, warps of the stage kernel an SM holds), the latter for the
    widest strips, which need the most registers."""
    if dev.index not in _STAGE_CARD:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = lib.sz_wavefront_stage_occupancy(STAGE_ROWS_PER_LANE[-1],
                                                   ctypes.byref(per_sm))
        _raise_on(lib, err, "sz_wavefront_stage_occupancy")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _STAGE_CARD[dev.index] = (sms, per_sm.value * STAGE_WARPS)
    return _STAGE_CARD[dev.index]


def _stage_launch(sweeps, match, mismatch, gap, fills=None, words=None, sms=None,
                  warps_per_sm=None) -> list:
    """The sweeps in one cooperative launch of ``csrc/wavefront_stage.cu``
    on the plan ``stage_plan`` makes for this card, or for a card cut to
    ``sms`` SMs of ``warps_per_sm`` warps each. It waits for the launch and
    raises if a wait in it stalled, unless a list ``words`` takes its
    status word (a device tensor) for the caller to read. A list ``fills``
    gets, for each sweep, its pipeline fill in ns: from the first to the
    last time a strip of its first wave began its steps."""
    dev = sweeps[0][0].device
    lib = cuda_build.load()
    card_sms, card_per_sm = _stage_card(lib, dev)
    plan = stage_plan([(a.numel(), b.numel(), d0, d1) for a, b, _, _, d0, d1 in sweeps],
                      sms or card_sms, warps_per_sm or card_per_sm)
    out, fields = [], []
    for a, b, D1, D2, d0, d1 in sweeps:
        o1, o2 = torch.empty_like(D1), torch.empty_like(D2)
        fields.append([a.data_ptr(), b.data_ptr(), D1.data_ptr(), D2.data_ptr(), o1.data_ptr(),
                       o2.data_ptr(), a.numel(), b.numel(), d0, d1])
        out.append((o1, o2))
    rec = np.array(fields, dtype=np.int64)
    prec = np.array(plan.record(), dtype=np.int64)
    handoff = torch.empty(plan.handoff_bytes // 8, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.sz_wavefront_stage(rec.ctypes.data, len(sweeps), prec.ctypes.data, match,
                                     mismatch, gap, handoff.data_ptr(), plan.handoff_bytes,
                                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "sz_wavefront_stage")
    KERNEL_LAUNCHES["wavefront_stage"] += 1
    if words is not None:
        words.append(handoff[:1])
    else:
        _raise_stalled(handoff[:1])
    if fills is not None:
        for sp in plan.sweeps:
            first, last = handoff[sp.ring_offset // 8 + 1:sp.ring_offset // 8 + 3].tolist()
            fills.append(last - ~first if sp.strips else 0)
    return out


def _raise_stalled(*words) -> None:
    """Raises if a stage's status word (int64 tensors of one cell) says a
    strip's wait stalled: a fault, never an answer."""
    status = int(torch.cat(words).max()) & 0xFFFFFFFF
    if status != 0:
        raise RuntimeError(f"sz_wavefront_stage: a strip's wait stalled (status {status})")


def _stage_plain(a, b, D1, D2, d0, d1, match, mismatch, gap):
    """The recurrence a diagonal at a time over its live cells ``i`` in
    ``[max(d - n, 0), min(d, m)]``; every other cell holds ``BIG``. The
    substitution compares ``a[i - 1]`` with ``b[d - 1 - i]``, which is
    ``b`` reversed at ``n - d + i``: a slice."""
    m, n = a.numel(), b.numel()
    dev = a.device
    b_rev = b.flip(0)
    costs = (torch.tensor(match, dtype=torch.int32, device=dev),
             torch.tensor(mismatch, dtype=torch.int32, device=dev))
    for d in range(d0, d1):
        lo, hi = max(d - n, 0), min(d, m)
        new = torch.full_like(D1, BIG)
        i0, i1 = max(lo, 1), min(hi, d - 1)  # the interior cells
        if i0 <= i1:
            sub = torch.where(a[i0 - 1: i1] == b_rev[n - d + i0: n - d + i1 + 1], *costs)
            step = torch.minimum(D1[i0: i1 + 1], D1[i0 - 1: i1]) + gap
            torch.minimum(step, D2[i0 - 1: i1] + sub, out=new[i0: i1 + 1])
        if lo == 0:
            new[0] = gap * d
        if hi == d:
            new[d] = gap * d
        D1, D2 = new, D1
    return D1, D2


def _sweeps(jobs, match, mismatch, gap, n_stages, stage) -> list:
    """Each job ``(a, b, d_end)`` (int32 tensors on one device) swept to
    ``(D[d_end], D[d_end - 1])``: stage ``s`` of every job in one ``stage``
    call (``stage_batch`` or ``stage_reference``), the diagonals staying on
    the device."""
    states = [initial_state(a.numel(), gap, a.device) for a, _, _ in jobs]
    stages = [ladder(d_end, n_stages) for _, _, d_end in jobs]
    for s in range(max(map(len, stages))):
        live = [k for k in range(len(jobs)) if s < len(stages[k])]
        got = stage([(jobs[k][0], jobs[k][1], *states[k], *stages[k][s]) for k in live],
                    match, mismatch, gap)
        for k, state in zip(live, got):
            states[k] = state
    return states


def _sweep_stages(jobs, match, mismatch, gap, n_stages) -> list:
    """``_sweeps`` on the jobs' device: the plain version for CPU tensors;
    on the card each stage is queued behind the last without waiting for
    it, and the stages' status words are read once, before any result is
    returned (a stalled stage raises as ``stage_batch`` does)."""
    if jobs[0][0].device.type == "cpu":
        return _sweeps(jobs, match, mismatch, gap, n_stages, stage_reference)
    words = []

    def stage(sweeps, *costs):
        _check_sweeps(sweeps)
        return _stage_launch(sweeps, *costs, words=words)

    states = _sweeps(jobs, match, mismatch, gap, n_stages, stage)
    _raise_stalled(*words)
    return states


def _as_chars(x) -> np.ndarray:
    return np.asarray(x).astype(np.int32).reshape(-1)


def sweep_frontier(a, b, m: int, n: int, d_end: int, match: int, mismatch: int, gap: int,
                   n_stages: int = 4, *, device: torch.device | str | None = None):
    """Forward staged sweep of ``(a, b)`` to diagonal ``d_end``, as the JAX
    ``_sweep_frontier``: ``(D[d_end], D[d_end - 1])`` as numpy int32 arrays
    of ``m + 1`` cells, ``BIG`` outside the matrix. Runs on ``device``:
    ``cuda:0`` by default, ``"cpu"`` for the plain version."""
    a, b = _as_chars(a), _as_chars(b)
    if (len(a), len(b)) != (m, n):
        raise ValueError(f"m, n = {m}, {n} but the strings hold {len(a)}, {len(b)} chars")
    if d_end > m + n:
        raise ValueError(f"d_end {d_end} is past the last diagonal {m + n}")
    dev = platform.cuda_device(0) if device is None else torch.device(device)
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    (f1, f2), = _sweep_stages([(at, bt, d_end)], match, mismatch, gap, n_stages)
    return f1.cpu().numpy(), f2.cpu().numpy()


def wavefront_score_mim(a, b, match: int = 0, mismatch: int = 1, gap: int = 1,
                        n_stages: int = 4, *,
                        device: torch.device | str | None = None) -> int:
    """Global min-cost alignment score of ONE long pair, as the JAX
    ``wavefront_score_mim``: uniform substitution costs, linear gaps, a
    staged meet-in-the-middle wavefront. Exact: equals ``wavefront_score``
    and Wagner-Fischer. Runs on ``device``: ``cuda:0`` by default, ``"cpu"``
    for the plain version."""
    a, b = _as_chars(a), _as_chars(b)
    dev = platform.cuda_device(0) if device is None else torch.device(device)
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return (m + n) * gap
    d_star = (m + n) // 2
    if d_star < 2 or (m + n) - d_star < 2:
        return wavefront_score(a, b, match, mismatch, gap, device=dev)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    jobs = [(up(a), up(b), d_star), (up(a[::-1]), up(b[::-1]), (m + n) - d_star)]
    (F1, F0), (B1, B0) = _sweep_stages(jobs, match, mismatch, gap, n_stages)
    F1, F0, B1, B0 = torch.stack([F1, F0, B1, B0]).cpu().numpy()
    # The host combine of the JAX function. Paths through a cell of d*:
    # F[d*][i] + B[m+n-d*][m-i], each frontier a path cost to or from it.
    i = np.arange(m + 1)
    big = np.int64(BIG)
    f1 = F1.astype(np.int64)
    b1 = B1[::-1].astype(np.int64)  # b1[i] = B[m+n-d*][m-i]
    through = np.where((f1 < big) & (b1 < big), f1 + b1, 2 * big)
    total = int(through.min())
    # Paths jumping d*-1 -> d*+1 with one substitution or match step:
    # F[d*-1][i] + sub(a[i], b[d*-1-i]) + B[m+n-d*-1][m-i-1].
    f0 = F0.astype(np.int64)
    b0 = np.full(m + 1, 2 * big, np.int64)
    b0[:m] = B0[::-1][1:].astype(np.int64)  # b0[i] = B[m+n-d*-1][m-i-1]
    j = d_star - 1 - i  # the jumped cell's column, 0-based char b[j]
    ok = (i < m) & (j >= 0) & (j < n)
    sub = np.where(ok & (a[np.clip(i, 0, m - 1)] == b[np.clip(j, 0, n - 1)]), match, mismatch)
    jump = np.where(ok & (f0 < big) & (b0 < big), f0 + sub + b0, 2 * big)
    return min(total, int(jump.min()))
