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

``similarity`` runs the hand-written Hopper kernel (``csrc/similarity.cu``)
on CUDA tensors and the plain PyTorch version ``similarity_reference``
(``ops/similarity.py``) on CPU tensors. The JAX package's lane-block sizing
(``pick_lane_block``) has no counterpart: there is no VMEM budget. The
kernel's only buffer, the strip hand-off, is bounded instead.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .similarity import SimilarityConfig, check_inputs, similarity_reference

__all__ = ["similarity", "KERNEL_LAUNCHES", "SCRATCH_CAP_BYTES"]

# Launches of the CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"similarity_dp": 0}

# Strip hand-off buffer of one launch; larger blocks are split into several
# launches over query and candidate ranges.
SCRATCH_CAP_BYTES = 256 << 20
_STRIP = 32  # query rows a thread keeps in registers (csrc/similarity.cu kStrip)


def _chunks(total: int, size: int):
    return [(b, min(size, total - b)) for b in range(0, total, size)]


def similarity(q_ext_t, qlens, cands_t, clens, cfg: SimilarityConfig,
               table=None) -> torch.Tensor:
    """All-pairs DP scores ``(n_queries, n_cands) int32``: the Hopper kernel
    for CUDA tensors, the plain version for CPU ones."""
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

    # One thread per pair hands each strip's bottom row to the next strip:
    # cand_len int32 words per pair, two when gaps are affine.
    words = 2 if cfg.is_affine else 1
    per_pair = cand_len * words * 4 if rows - 1 > _STRIP else 0
    q_size, c_size = nq, nc
    if per_pair:
        q_size = min(nq, max(1, SCRATCH_CAP_BYTES // per_pair))
        c_size = min(nc, max(1, SCRATCH_CAP_BYTES // (q_size * per_pair)))
    scratch = torch.empty(max(1, q_size * c_size * per_pair // 4),
                          dtype=torch.int32, device=dev)

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
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for q0, q_count in _chunks(nq, q_size):
            for c0, c_count in _chunks(nc, c_size):
                err = lib.sz_similarity(
                    cfg.objective == "max", cfg.is_local, cfg.is_affine,
                    cfg.uses_classes, gap, extend, match, mismatch,
                    q_ext_t.data_ptr(), rows, qlens.data_ptr(), nq,
                    cands_t.data_ptr(), clens.data_ptr(), cand_len, nc,
                    q0, q_count, c0, c_count, table_ptr, scratch.data_ptr(),
                    out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(
                        f"sz_similarity launch failed: "
                        f"{lib.sz_cuda_error_string(err).decode()} ({err})")
                KERNEL_LAUNCHES["similarity_dp"] += 1
    return out
