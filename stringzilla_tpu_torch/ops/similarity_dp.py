"""Column-DP similarity scores of every (query, candidate) pair.

Counterpart of ``stringzilla_tpu/ops/similarity_pallas.py``, with the same
layouts at the public function, so the two are compared like with like:

    similarity(q_ext_t, qlens, cands_t, clens, cfg, table=None)
        -> (n_queries, n_cands) int32

* ``q_ext_t``  ``(rows, n_queries)`` int32 query chars shifted down by one
  (row 0 unused, padding 0); ``rows`` is at most 4104;
* ``qlens``    ``(n_queries, 1)`` int32;
* ``cands_t``  ``(cand_len, n_cands)`` int32 candidate chars, cand_len <= 4096;
* ``clens``    ``(1, n_cands)`` int32;
* ``table``    ``(32, 32)`` int32 class costs when ``cfg`` uses classes
  (the chars are then class ids).

``similarity`` runs the hand-written Hopper kernels (``csrc/similarity.cu``)
on CUDA tensors and the plain PyTorch version ``similarity_reference``
(``ops/similarity.py``) on CPU tensors. Two kernels place the DP's strips of
32 query rows: ``similarity_dp`` gives each pair a thread, which walks its
strips one after the other; ``similarity_dp_warp`` gives each pair a warp,
whose lanes hold 32 strips (a pass of 1,024 rows) one column apart.
``dp_plan``, pure arithmetic on the shapes and the SM count, picks the route
and cuts the launch over query and candidate ranges so that the strip
hand-off buffer stays within ``SCRATCH_CAP_BYTES``. The JAX package's
lane-block sizing (``pick_lane_block``) has no counterpart: there is no
VMEM budget.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import cuda_build
from .similarity import SimilarityConfig, check_inputs, similarity_reference

__all__ = ["similarity", "dp_plan", "DpPlan", "warp_lanes", "KERNEL_LAUNCHES",
           "SCRATCH_CAP_BYTES", "ROUTES", "STRIP", "PASS_ROWS", "WARP_CROSSOVER"]

# Launches of the CUDA kernels, counted where the wrapper launches them: the
# thread route's and the warp route's.
KERNEL_LAUNCHES = {"similarity_dp": 0, "similarity_dp_warp": 0}
ROUTES = {"thread": "similarity_dp", "warp": "similarity_dp_warp"}

# Strip hand-off buffer of one launch; larger blocks are split into several
# launches over query and candidate ranges.
SCRATCH_CAP_BYTES = 256 << 20
STRIP = 32  # query rows a lane keeps in registers (csrc/similarity.cu kStrip)
LANES = 32
PASS_ROWS = LANES * STRIP  # rows of one warp-route pass (kPassRows)
_THREADS = 64  # pairs a CTA, thread route (kThreads)
_WARPS = 16  # pairs a CTA, warp route (kWarps): one CTA an SM
_INT_MAX = (1 << 31) - 1
# The crossover: the warp route is the faster below sms * lanes**2 *
# WARP_CROSSOVER pairs, lanes = min(32, ceil((rows - 1) / 32)) the lanes a
# pass gives rows. Measured by tools/dp_hash_sweep.py on an NVIDIA H100
# (132 SMs, 700 W; weighted Levenshtein on m x m pairs, both routes
# forced): the warp route won up to
# 1,024 pairs at m = 128 (a tie), 4,096 at m = 256 and 16,384 at m = 512,
# the thread route from 4,096, 16,384 and 65,536; on the proteins (m ~ 1,000,
# class costs) the warp route won at every count from 8,192 to 65,536.
WARP_CROSSOVER = 0.5


@dataclasses.dataclass(frozen=True)
class DpPlan:
    """How one ``similarity`` call runs on the card.

    ``route``: ``"thread"`` (a thread a pair) or ``"warp"`` (a warp a pair);
    ``q_size``, ``c_size``: queries and candidates a launch; ``launches``;
    ``scratch_bytes``: the strip hand-off buffer one launch uses (0 when one
    strip or pass holds every query). The kernel works out its strips,
    passes and lanes from ``rows`` itself."""

    route: str
    q_size: int
    c_size: int
    launches: int
    scratch_bytes: int


def warp_lanes(rows: int) -> int:
    """Lanes of a warp-route pass that hold rows of a ``rows``-row block."""
    return min(LANES, max(1, -(-(rows - 1) // STRIP)))


def dp_plan(rows: int, nq: int, cand_len: int, nc: int, affine: bool, sms: int,
            route: str | None = None) -> DpPlan:
    """The route and launch cut of a ``(rows, nq) x (cand_len, nc)`` block
    on a card of ``sms`` SMs: the warp route below the measured crossover
    (``WARP_CROSSOVER``), else the thread route (``route`` forces one), and
    the fewest launches whose hand-off buffer fits ``SCRATCH_CAP_BYTES``.
    Raises on a block it cannot place."""
    if route is None:
        warp = nq * nc < sms * warp_lanes(rows) ** 2 * WARP_CROSSOVER
        route = "warp" if warp else "thread"
    if route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)} or None, not {route!r}")
    if rows < 1 or nq < 0 or nc < 0 or cand_len < 0 or sms < 1:
        raise ValueError(f"no plan for rows {rows}, {nq} x {nc} pairs, cand_len "
                         f"{cand_len} on {sms} SMs")
    # a hand-off row a pair, (D, Dd) or D alone on the linear thread route,
    # where a second strip (thread) or pass (warp) exists
    if route == "thread":
        per_pair = cand_len * (8 if affine else 4) if rows - 1 > STRIP else 0
    else:
        per_pair = cand_len * 8 if rows - 1 > PASS_ROWS else 0
    q_size, c_size = max(nq, 1), max(nc, 1)
    if per_pair:
        cap = SCRATCH_CAP_BYTES
        if per_pair > cap:
            raise ValueError(f"one pair's hand-off row of {per_pair} bytes exceeds "
                             f"SCRATCH_CAP_BYTES = {cap}")
        q_size = min(q_size, cap // per_pair)
        c_size = min(c_size, cap // (q_size * per_pair))
    per_block = _THREADS if route == "thread" else _WARPS
    if q_size * -(-c_size // per_block) > _INT_MAX:
        raise ValueError(f"a launch of {q_size} x {c_size} pairs exceeds the grid")
    launches = -(-nq // q_size) * -(-nc // c_size)
    return DpPlan(route, q_size, c_size, launches, q_size * c_size * per_pair)


def _chunks(total: int, size: int):
    return [(b, min(size, total - b)) for b in range(0, total, size)]


def similarity(q_ext_t, qlens, cands_t, clens, cfg: SimilarityConfig,
               table=None, *, route: str | None = None) -> torch.Tensor:
    """All-pairs DP scores ``(n_queries, n_cands) int32``: a Hopper kernel
    for CUDA tensors (``route`` forces ``"thread"`` or ``"warp"``, else
    ``dp_plan`` picks), the plain version for CPU ones."""
    check_inputs(q_ext_t, qlens, cands_t, clens, cfg, table)
    if q_ext_t.device.type == "cpu":
        return similarity_reference(q_ext_t, qlens, cands_t, clens, cfg, table)
    if q_ext_t.device.type != "cuda":
        raise ValueError(f"similarity runs on CUDA or CPU tensors, not {q_ext_t.device}")
    rows, nq = q_ext_t.shape
    cand_len, nc = cands_t.shape
    dev = q_ext_t.device
    out = torch.empty((nq, nc), dtype=torch.int32, device=dev)
    if nq == 0 or nc == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dp_plan(rows, nq, cand_len, nc, cfg.is_affine, sms, route)
    scratch = torch.empty(max(1, plan.scratch_bytes // 4), dtype=torch.int32, device=dev)

    if cfg.is_affine:
        gap, extend = cfg.gaps.open, cfg.gaps.extend
    else:
        gap, extend = cfg.gaps.open_or_extend, 0
    if cfg.uses_classes:
        match = mismatch = 0
        table_ptr = table.data_ptr()
    else:
        match, mismatch = cfg.costs.match, cfg.costs.mismatch
        table_ptr = None
    name = ROUTES[plan.route]
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for q0, q_count in _chunks(nq, plan.q_size):
            for c0, c_count in _chunks(nc, plan.c_size):
                err = lib.sz_similarity(
                    plan.route == "warp", cfg.objective == "max", cfg.is_local,
                    cfg.is_affine, cfg.uses_classes, gap, extend, match, mismatch,
                    q_ext_t.data_ptr(), rows, qlens.data_ptr(), nq,
                    cands_t.data_ptr(), clens.data_ptr(), cand_len, nc,
                    q0, q_count, c0, c_count, table_ptr, scratch.data_ptr(),
                    out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(
                        f"sz_similarity ({name}) launch failed: "
                        f"{lib.sz_cuda_error_string(err).decode()} ({err})")
                KERNEL_LAUNCHES[name] += 1
    return out
