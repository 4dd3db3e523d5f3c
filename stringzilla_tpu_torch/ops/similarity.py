"""Similarity engine configuration and the column-DP cell math.

Counterpart of ``stringzilla_tpu/ops/similarity.py``, with the same config
fields, so one configuration describes an engine of either package
(``config_from`` builds this package's config from any object with those
fields). The cell math is the same recurrence as the JAX package's, in plain
PyTorch on int32 tensors: candidates run across lanes, one query down the
rows, and the DP advances one candidate char per step. The in-column chain
``new[i] = opt(a[i], new[i-1] + gap)`` is solved exactly as
``cum_opt(a - gap*i) + gap*i`` with ``torch.cummin``/``torch.cummax``.

Shape conventions follow the JAX module; every array may carry leading batch
dims, with rows on dim -2 and lanes on dim -1:

* ``q_ext``:  ``(..., rows, 1)``    query chars shifted down by one; row 0 unused
* ``c_row``:  ``(..., 1, lanes)``   current candidate char per lane
* ``clens``:  ``(..., 1, lanes)``   candidate lengths
* ``D/I``:    ``(..., rows, lanes)`` int32 DP columns
* results:    ``(..., 1, lanes)``   int32

``similarity_reference`` is the plain version of the column-DP kernel
(``csrc/similarity.cu``): the layouts of ``similarity_pallas``, every query
at once as one ``(n_queries, rows, lanes)`` state. ``score_block`` is the
one-query form the JAX package's tests call.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

__all__ = ["UniformCosts", "ClassCosts", "LinearGaps", "AffineGaps",
           "SimilarityConfig", "config_from", "check_inputs", "score_block",
           "similarity_reference", "BIG", "MAX_ROWS", "MAX_CAND_LEN"]

# Large-but-overflow-safe sentinel: adding gap*rows or cost magnitudes on top
# of it stays far below int32 limits (the reference's "higher magnitude is
# equivalent to discarding" trick, serial.hpp:1139-1146).
BIG = 1 << 28
# The engines' blocks: queries of up to 4096 chars plus the shifted row,
# rounded to 8; candidates of up to 4096 chars. At |cost| <= 128 no score
# overflows int32 there.
MAX_ROWS = 4104
MAX_CAND_LEN = 4096
_CLASSES = 32


@dataclasses.dataclass(frozen=True)
class UniformCosts:
    """Match/mismatch substitution costs (``uniform_substitution_costs_t``,
    reference ``serial.hpp:102-111``)."""

    match: int = 0
    mismatch: int = 1


@dataclasses.dataclass(frozen=True)
class ClassCosts:
    """256→32-class map + 32x32 signed cost table (``error_costs_32x32_t``,
    reference ``serial.hpp:118-189``), stored as nested tuples so the
    config stays hashable."""

    byte_to_class: tuple  # length-256 tuple of ints
    table: tuple  # 32x32 nested tuple of ints

    @classmethod
    def from_arrays(cls, byte_to_class, table) -> "ClassCosts":
        b = np.asarray(byte_to_class, dtype=np.uint8)
        t = np.asarray(table, dtype=np.int32)
        if b.shape != (256,) or t.shape != (32, 32):
            raise ValueError("byte_to_class must be [256], table must be [32,32]")
        return cls(
            byte_to_class=tuple(int(x) for x in b),
            table=tuple(tuple(int(x) for x in row) for row in t),
        )

    def byte_to_class_np(self) -> np.ndarray:
        return np.asarray(self.byte_to_class, dtype=np.uint8)

    def table_np(self) -> np.ndarray:
        return np.asarray(self.table, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class LinearGaps:
    """``linear_gap_costs_t`` (reference ``serial.hpp:70-75``)."""

    open_or_extend: int = 1


@dataclasses.dataclass(frozen=True)
class AffineGaps:
    """``affine_gap_costs_t`` — a run of k gaps costs ``open + extend*(k-1)``
    (reference ``serial.hpp:77-88,1135-1146``)."""

    open: int = 1
    extend: int = 1


@dataclasses.dataclass(frozen=True)
class SimilarityConfig:
    """What an engine computes: objective, locality, gaps and costs."""

    objective: Literal["min", "max"] = "min"
    locality: Literal["global", "local"] = "global"
    gaps: LinearGaps | AffineGaps = LinearGaps(1)
    costs: UniformCosts | ClassCosts = UniformCosts(0, 1)

    @property
    def is_affine(self) -> bool:
        return isinstance(self.gaps, AffineGaps)

    @property
    def is_local(self) -> bool:
        return self.locality == "local"

    @property
    def uses_classes(self) -> bool:
        return isinstance(self.costs, ClassCosts)

    def opt(self, a, b):
        """Elementwise min or max; ``b`` may be a Python int."""
        if self.objective == "min":
            return torch.minimum(a, b) if isinstance(b, torch.Tensor) else a.clamp(max=b)
        return torch.maximum(a, b) if isinstance(b, torch.Tensor) else a.clamp(min=b)

    @property
    def ident(self) -> int:
        """Identity for opt-reductions (discard sentinel)."""
        return BIG if self.objective == "min" else -BIG

    def reduce_rows(self, x):
        fn = torch.amin if self.objective == "min" else torch.amax
        return fn(x, dim=-2, keepdim=True)


def config_from(obj) -> SimilarityConfig:
    """This package's config from any object with the same four fields —
    a JAX ``SimilarityConfig`` included — read by attribute, class costs
    through their numpy arrays."""
    gaps, costs = obj.gaps, obj.costs
    if hasattr(gaps, "open_or_extend"):
        gaps = LinearGaps(int(gaps.open_or_extend))
    else:
        gaps = AffineGaps(int(gaps.open), int(gaps.extend))
    if hasattr(costs, "byte_to_class"):
        costs = ClassCosts.from_arrays(np.asarray(costs.byte_to_class),
                                       np.asarray(costs.table))
    else:
        costs = UniformCosts(int(costs.match), int(costs.mismatch))
    if obj.objective not in ("min", "max") or obj.locality not in ("global", "local"):
        raise ValueError(f"unknown objective/locality {obj.objective!r}/{obj.locality!r}")
    return SimilarityConfig(str(obj.objective), str(obj.locality), gaps, costs)


def _rows_iota(rows: int, device) -> torch.Tensor:
    return torch.arange(rows, dtype=torch.int32, device=device).view(rows, 1)


def _shift_down(x: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """``y[i] = x[i-d]`` along the row axis, filling rows ``< d``."""
    pad = torch.full_like(x[..., :d, :], fill)
    return torch.cat([pad, x[..., :-d, :]], dim=-2)


def _chain_scan(a: torch.Tensor, gap: int, cfg: SimilarityConfig) -> torch.Tensor:
    """Solve ``new[i] = opt(a[i], new[i-1] + gap)`` exactly: min and max are
    exact on int32, so the running opt of ``a - gap*i`` is the chain."""
    iota = _rows_iota(a.shape[-2], a.device) * gap
    cum = torch.cummin if cfg.objective == "min" else torch.cummax
    return cum(a - iota, dim=-2).values + iota


def _boundary_primary(j, cfg: SimilarityConfig):
    """Top-row/left-column boundary D[0][j] (reference ``init_score``: linear
    ``serial.hpp:912-914``; affine ``:1134-1137``; local: 0). ``j`` is an
    int or an int32 tensor."""
    if cfg.is_local:
        return j * 0
    if cfg.is_affine:
        o, e = cfg.gaps.open, cfg.gaps.extend
        if isinstance(j, torch.Tensor):
            return torch.where(j > 0, o + e * (j - 1), 0).to(torch.int32)
        return o + e * (j - 1) if j > 0 else 0
    return cfg.gaps.open_or_extend * j


def _boundary_gap(j, cfg: SimilarityConfig):
    """Gap-matrix boundary (reference ``init_gap``, ``serial.hpp:1139-1146``:
    primary boundary plus ``open+extend`` — a magnitude-padded discard)."""
    assert cfg.is_affine
    return _boundary_primary(j, cfg) + (cfg.gaps.open + cfg.gaps.extend)


def build_sq(q_ext: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-query cost slice ``Sq[..., i, c] = table[q_class[i], c]`` as int32
    ``(..., rows, 33)``. A query class outside ``[0, 32)`` gets a row of
    zeros and column 32 is all zeros, for candidate classes outside it:
    the JAX package's one-hot products give exactly those zeros."""
    q = q_ext[..., 0].long()
    padded = torch.zeros(_CLASSES + 1, _CLASSES + 1, dtype=torch.int32,
                         device=table.device)
    padded[:_CLASSES, :_CLASSES] = table
    return padded[torch.where((q >= 0) & (q < _CLASSES), q, _CLASSES)]


def _substitution_column(q_ext, c_row, cfg: SimilarityConfig, sq=None):
    """Cost column ``sub[..., i, lane] = cost(q[i-1], c_row[lane])`` of shape
    ``(..., rows, lanes)``. Row 0 is garbage (overwritten by the boundary)."""
    if cfg.uses_classes:
        c = c_row.reshape(-1).long()
        return sq[..., torch.where((c >= 0) & (c < _CLASSES), c, _CLASSES)]
    eq = q_ext == c_row
    return torch.where(eq, cfg.costs.match, cfg.costs.mismatch).to(torch.int32)


def _column_step_linear(D, j, c_row, q_ext, clens, cfg: SimilarityConfig,
                        sq=None, sub=None):
    g = cfg.gaps.open_or_extend
    if sub is None:
        sub = _substitution_column(q_ext, c_row, cfg, sq)
    Dm1 = _shift_down(D, 1, cfg.ident)
    # a[i] = opt(horizontal D[i][j-1]+g, diagonal D[i-1][j-1]+sub, (0 if local))
    a = cfg.opt(D + g, Dm1 + sub)
    if cfg.is_local:
        a = cfg.opt(a, 0)
    # Row 0 carries the boundary value and seeds the vertical chain.
    rows = _rows_iota(a.shape[-2], a.device)
    a = torch.where(rows == 0, _boundary_primary(j, cfg), a)
    D_new = _chain_scan(a, g, cfg)
    # Freeze lanes whose candidate already ended: their column stays final.
    return torch.where(j <= clens, D_new, D)


def _column_step_affine(D, I, j, c_row, q_ext, clens, cfg: SimilarityConfig,
                        sq=None, sub=None):
    o, e = cfg.gaps.open, cfg.gaps.extend
    if sub is None:
        sub = _substitution_column(q_ext, c_row, cfg, sq)
    rows = _rows_iota(D.shape[-2], D.device)

    # Horizontal gap matrix (propagates along j only): I[i][j] =
    # opt(D[i][j-1]+open, I[i][j-1]+extend); row 0 takes the boundary init_gap.
    I_new = cfg.opt(D + o, I + e)
    I_new = torch.where(rows == 0, _boundary_gap(j, cfg), I_new)

    # a[i] = chain-free part of the cell: diagonal + horizontal (+ local reset).
    Dm1 = _shift_down(D, 1, cfg.ident)
    a = cfg.opt(Dm1 + sub, I_new)
    if cfg.is_local:
        a = cfg.opt(a, 0)
    a = torch.where(rows == 0, _boundary_primary(j, cfg), a)

    # Vertical gap matrix (within-column): Dd[i] = opt(D[i-1]+open, Dd[i-1]+ext)
    # with D[i-1] = opt(a[i-1], Dd[i-1]) folds to the exact linear chain
    #   Dd[i] = opt(a[i-1]+open, Dd[i-1] + opt(open, extend)).
    g_chain = min(o, e) if cfg.objective == "min" else max(o, e)
    b = _shift_down(a, 1, cfg.ident) + o
    b = torch.where(rows == 0, _boundary_gap(j, cfg), b)
    Dd = _chain_scan(b, g_chain, cfg)

    D_new = cfg.opt(a, Dd)
    live = j <= clens
    return torch.where(live, D_new, D), torch.where(live, I_new, I)


def init_columns(rows: int, lanes: int, cfg: SimilarityConfig, device=None):
    """Column state at j=0: the left DP boundary."""
    i = _rows_iota(rows, device).expand(rows, lanes)
    D0 = _boundary_primary(i, cfg)
    if not cfg.is_affine:
        return (D0,)
    return (D0, _boundary_gap(i, cfg))


def column_step(state, j, c_row, q_ext, clens, cfg: SimilarityConfig, sq=None,
                sub=None):
    """Advance the lane-packed DP by one candidate char: ``state`` is
    ``(D,)`` for linear gaps or ``(D, I)`` for affine ones."""
    if cfg.is_affine:
        D, I = state
        return _column_step_affine(D, I, j, c_row, q_ext, clens, cfg, sq, sub=sub)
    (D,) = state
    return (_column_step_linear(D, j, c_row, q_ext, clens, cfg, sq, sub=sub),)


def extract_result(D, qlen, clens, cfg: SimilarityConfig, best=None):
    """Global: D[qlen][clen] per lane (the column freezes at each lane's final
    j). Local: reduce the elementwise running best over rows 1..qlen, then
    opt with 0 (reference ``serial.hpp:1016,1327-1337``)."""
    rows = _rows_iota(D.shape[-2], D.device)
    if cfg.is_local:
        valid = (rows >= 1) & (rows <= qlen)
        masked = torch.where(valid, best, cfg.ident)
        return cfg.opt(cfg.reduce_rows(masked), 0)
    masked = torch.where(rows == qlen, D, cfg.ident)
    return cfg.reduce_rows(masked)


def update_best(best, D, cfg: SimilarityConfig):
    """Accumulate the local-alignment optimum elementwise; row validity and
    the 0 seed are applied once in ``extract_result``. Frozen lanes repeat
    their final column, which min/max absorbs."""
    return cfg.opt(best, D)


def score_block(q_ext, qlen, cands_t, clens, cfg: SimilarityConfig, table=None):
    """Score queries ``q_ext (..., rows, 1)`` of lengths ``qlen`` against a
    lane-packed candidate block ``cands_t (Lc, lanes)``; ``(..., 1, lanes)``
    int32 (one query: ``(rows, 1)`` in, ``(1, lanes)`` out, as the JAX
    function). Steps stop at the longest candidate: later steps would only
    repeat frozen columns."""
    rows = q_ext.shape[-2]
    cand_len, lanes = cands_t.shape
    batch = q_ext.shape[:-2]
    sq = build_sq(q_ext, table) if cfg.uses_classes else None
    state = tuple(s.expand(*batch, rows, lanes).clone()
                  for s in init_columns(rows, lanes, cfg, q_ext.device))
    best = (torch.zeros(*batch, rows, lanes, dtype=torch.int32, device=q_ext.device)
            if cfg.is_local else None)
    steps = int(clens.max().clamp(0, cand_len)) if lanes else 0
    for j in range(1, steps + 1):
        c_row = cands_t[j - 1].view(1, lanes)
        state = column_step(state, j, c_row, q_ext, clens, cfg, sq)
        if cfg.is_local:
            best = update_best(best, state[0], cfg)
    return extract_result(state[0], qlen, clens, cfg, best)


def check_inputs(q_ext_t, qlens, cands_t, clens, cfg: SimilarityConfig, table):
    """Raise on anything the column-DP kernel does not take."""
    named = [("q_ext_t", q_ext_t), ("qlens", qlens), ("cands_t", cands_t),
             ("clens", clens)]
    if cfg.uses_classes:
        named.append(("table", table))
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D int32 tensor")
        if t.device != q_ext_t.device:
            raise ValueError(f"{name} is on {t.device}, q_ext_t on {q_ext_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows, nq = q_ext_t.shape
    cand_len, nc = cands_t.shape
    if not 1 <= rows <= MAX_ROWS or cand_len > MAX_CAND_LEN:
        raise ValueError(f"rows {rows} must be in [1, {MAX_ROWS}] and cand_len "
                         f"{cand_len} at most {MAX_CAND_LEN}")
    if tuple(qlens.shape) != (nq, 1) or tuple(clens.shape) != (1, nc):
        raise ValueError(f"qlens must be ({nq}, 1) and clens (1, {nc}), got "
                         f"{tuple(qlens.shape)} and {tuple(clens.shape)}")
    if cfg.uses_classes and tuple(table.shape) != (_CLASSES, _CLASSES):
        raise ValueError(f"table must be (32, 32), got {tuple(table.shape)}")


def similarity_reference(q_ext_t, qlens, cands_t, clens, cfg: SimilarityConfig,
                         table=None) -> torch.Tensor:
    """Plain PyTorch version of the column-DP kernel: all-pairs scores
    ``(n_queries, n_cands)`` int32 in the layouts of ``similarity_pallas``
    (``q_ext_t (rows, n_queries)`` with row 0 unused, ``qlens (n_queries,
    1)``, ``cands_t (cand_len, n_cands)``, ``clens (1, n_cands)``, ``table
    (32, 32)`` for class costs)."""
    check_inputs(q_ext_t, qlens, cands_t, clens, cfg, table)
    nq, nc = q_ext_t.shape[1], cands_t.shape[1]
    if nq == 0 or nc == 0:
        return torch.empty((nq, nc), dtype=torch.int32, device=q_ext_t.device)
    q_ext = q_ext_t.T.unsqueeze(-1)  # (nq, rows, 1)
    res = score_block(q_ext, qlens.view(nq, 1, 1), cands_t, clens, cfg, table)
    return res.view(nq, nc)
