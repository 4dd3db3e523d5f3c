"""The ring wavefront tier: ONE pair's DP matrix scored across the devices
of a ``DeviceScope``.

Counterpart of ``stringzilla_tpu/parallel/ring.py``, which runs one
``shard_map`` program over a mesh. The first string's rows are cut into D
contiguous chunks of ``mb = ceil(m / D)`` rows, one an entry of the scope
(D is its ``device_count``; a device may repeat), and the second string
into blocks of C columns. At macro-step t entry d scores the tile of its
rows and block t - d: a systolic pipeline D stages deep. A tile takes the
row above it from the entry above (the border for entry 0) and the column
before it from the entry's own previous block (the border for the first
block), and hands its bottom row to the entry below. An entry whose chunk
lies past row m (m < D mb) has no rows and scores nothing.

Each entry runs on a CUDA stream of its own. After its tile of block j,
entry d records an event; entry d + 1 waits on it on its own stream and
copies the rows it needs (D, and F when affine) into its own frontier
buffer: a copy within the card when both entries share one, a peer copy
across cards. No kernel waits on another stream or device, so a scope that
lists one card several times (``["cuda:0"] * 4``) runs the same program
on it. At the end the entry that holds row m gives the global score, and a
local score is the entries' bests combined with the objective; either is
pulled once, with each entry's fault status. On CPU tensors the same loop
runs ``ring_tile_reference``, the tile's plain PyTorch version; on CUDA
tensors it always launches ``csrc/ring.cu``'s ``ring_tile``.

The recurrence is the JAX ring's, cell for cell (``csrc/ring.cu`` writes
it out). Like the JAX ring it is Gotoh's exactly where reopening a gap
never pays (min objective with open >= extend, max with open <= extend):
its vertical-gap chain starts from the cell before that chain is applied,
and elsewhere it gives the JAX ring's answer, which may differ from
Gotoh's. A min-objective local score is 0, as the JAX ring gives. Both
are copied from the JAX package as they are.

    ring_wavefront_score(a, b, scope, match=0, mismatch=1, gap=1,
                         objective="min", locality="global", table=None,
                         extend=None, block_cols=None) -> int
    ring_tile(a, b, top_d, top_f, bottom_d, bottom_f, left_d, left_e, best,
              costs, *, status=None, scratch=None) -> None
    ring_tile_reference(...)  # the same arguments, on any device
    ring_block_cols(m, n, entries) -> the default column block
    tile_plan(rows, w, sms) -> the CTAs of a launch
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.wavefront import BIG, _check_costs, _empty_score, _raise_on
from ..utils import cuda_build

__all__ = ["ring_wavefront_score", "ring_tile", "ring_tile_reference", "ring_block_cols",
           "tile_plan", "TileCosts", "KERNEL_LAUNCHES", "GEOMETRY"]

# Launches of csrc/ring.cu's kernel, one a tile.
KERNEL_LAUNCHES = {"ring_tile": 0}

# csrc/ring.cu's geometry, as its sz_ring_geometry reports it (checked
# before the first launch): rows a lane (a strip is a warp of 32 of them a
# lane), warps a CTA (the consecutive strips it claims at once), steps a
# strip takes from the strip above at once.
GEOMETRY = (4, 4, 16)
RING_ROWS, RING_WARPS, RING_CHUNK = GEOMETRY
# The most CTAs an SM a launch takes, as ops.wavefront.FLAT_SHARE.
RING_SHARE = 3


class TileCosts(NamedTuple):
    """A tile's configuration: the objective ("min"/"max"), the locality
    ("global"/"local"), ``gap`` (linear) or the open cost (affine),
    ``extend`` (None for linear gaps), ``match``/``mismatch`` (uniform
    costs), and ``table``: a ``(32, 32)`` int32 tensor of class costs on
    the tile's device, or None for uniform costs."""
    objective: str
    locality: str
    gap: int
    extend: int | None
    match: int
    mismatch: int
    table: torch.Tensor | None

    @property
    def config(self) -> int:
        """max * 8 + local * 4 + affine * 2 + classes, as the kernel takes it."""
        return (8 * (self.objective == "max") + 4 * (self.locality == "local")
                + 2 * (self.extend is not None) + (self.table is not None))


def ring_block_cols(m: int, n: int, entries: int) -> int:
    """The default column block of an m x n pair over ``entries`` entries,
    a multiple of 128. A tile is one launch whose chain is its mb rows plus
    its C columns of anti-diagonal steps (a strip of 128 rows trails the
    one above by its height and a chunk), and the loop runs NB + D - 1
    macro-steps one after another, so the critical path is about (n / C +
    D - 1)(mb + C) steps, least at C = sqrt(n mb / (D - 1)), and C = n on
    one entry; the blocks that width gives are then made even. The JAX
    ring's 256 would make a 600,000-char pair 2,344 blocks, each a chain of
    150,000 steps on four entries; this makes it 4 blocks of 150,016
    columns. The result does not depend on C."""
    mb = -(-m // entries)
    c = n if entries == 1 else math.isqrt(n * mb // (entries - 1)) + 1
    blocks = -(-n // c)
    return max(128, -(-n // (blocks * 128)) * 128)


def tile_plan(rows: int, w: int, sms: int) -> int:
    """The CTAs of a ``ring_tile`` launch of ``rows`` x ``w`` on a card of
    ``sms`` SMs. A CTA claims ``RING_WARPS`` strips of ``h = 32 RING_ROWS``
    rows at once; strip s + 1 starts about its height and a chunk of steps
    after strip s and runs ``w + h`` steps, so a claim is busy for
    ``(W - 1)(h + chunk) + w + h`` steps and a new one starts every
    ``W (h + chunk)``: the grid holds that many claims in flight and one
    more, at most the claims and at most ``RING_SHARE`` CTAs an SM. Past
    one CTA an SM it is rounded to a whole number of CTAs an SM: a strip on
    a scheduler that holds more warps than the others slows every strip
    after it. (The launch's scratch is ``csrc/ring.cu``'s
    ``sz_ring_scratch_bytes``.)"""
    return _claims_plan(rows, w, sms, *GEOMETRY, RING_SHARE)


def _claims_plan(rows: int, w: int, sms: int, r: int, warps: int, chunk: int,
                 share: int) -> int:
    """``tile_plan`` for a kernel of ``r`` rows a lane, ``warps`` warps a
    CTA and chunks of ``chunk`` steps, at most ``share`` CTAs an SM."""
    h = 32 * r
    claims = -(-rows // (h * warps))
    in_flight = -(-((warps - 1) * (h + chunk) + w + h) // (warps * (h + chunk))) + 1
    ctas = min(claims, in_flight, sms * share)
    return ctas if ctas <= sms else round(ctas / sms) * sms


_LIB: list = []


def _lib():
    """The built library, its ring geometry checked once against
    ``GEOMETRY`` (a mismatch would launch the wrong grid)."""
    if not _LIB:
        lib = cuda_build.load()
        got = (ctypes.c_int * 3)()
        lib.sz_ring_geometry(got)
        if tuple(got) != GEOMETRY:
            raise RuntimeError(f"sz_ring_geometry {tuple(got)} != parallel/ring.py's {GEOMETRY}")
        _LIB.append(lib)
    return _LIB[0]


def _scratch(rows: int, w: int, affine: bool, dev) -> torch.Tensor:
    """int64 scratch for a launch of ``rows`` x ``w`` on ``dev``."""
    need = _lib().sz_ring_scratch_bytes(rows, w, int(affine))
    return torch.empty(-(-need // 8), dtype=torch.int64, device=dev)


def _check_tile(tensors: dict, costs: TileCosts) -> tuple[int, int]:
    """(rows, w) of a tile, its tensors checked: 1-D contiguous int32 on one
    CPU or CUDA device, of the lengths the tile needs."""
    dev = tensors["a"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ring_tile runs on CUDA or CPU tensors, not {dev}")
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous and on {dev}")
    rows, w = tensors["a"].numel(), tensors["b"].numel()
    if rows < 1 or w < 1:
        raise ValueError(f"a tile needs rows and columns, not {rows} x {w}")
    for name in ("top_d", "top_f", "bottom_d", "bottom_f"):
        if tensors[name].numel() != w + 1:
            raise ValueError(f"{name} must hold w + 1 = {w + 1} values")
    for name in ("left_d", "left_e"):
        if tensors[name].numel() != rows:
            raise ValueError(f"{name} must hold a value a row ({rows})")
    if tensors["best"].numel() < 1:
        raise ValueError("best must hold a value")
    t = costs.table
    if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != (32, 32)
                          or not t.is_contiguous() or t.device != dev):
        raise ValueError(f"table must be a contiguous (32, 32) int32 tensor on {dev}")
    return rows, w


def ring_tile(a, b, top_d, top_f, bottom_d, bottom_f, left_d, left_e, best,
              costs: TileCosts, *, status=None, scratch=None) -> None:
    """One tile of the ring: the ``len(a)`` rows of one entry across a
    block of ``w = len(b)`` columns, starting at column ``col_base + 1``.
    ``top_d``/``top_f`` (``w + 1``): the row above, ``[0]`` the corner
    ``D[row_base][col_base]``; ``left_d``/``left_e``: the column
    ``col_base``, overwritten with the block's last column; ``bottom_d``/
    ``bottom_f`` (``w + 1``) get the tile's last row at ``[1..w]``; ``best``
    is raised to the best cell for max-objective local scores. The ``_f``
    and ``_e`` arrays are read and written only when affine. On CUDA
    tensors it launches ``csrc/ring.cu``'s kernel on the current stream
    without waiting: ``status`` (an int32 the caller zeroed) is set to 3 if
    a wait of the kernel stalled, and ``scratch`` (int64, at least
    ``sz_ring_scratch_bytes``) holds its hand-off; given neither, the call
    makes both and waits to check the status. On CPU tensors it runs
    ``ring_tile_reference``."""
    tensors = dict(a=a, b=b, top_d=top_d, top_f=top_f, bottom_d=bottom_d, bottom_f=bottom_f,
                   left_d=left_d, left_e=left_e, best=best)
    rows, w = _check_tile(tensors, costs)
    if a.device.type == "cpu":
        ring_tile_reference(**tensors, costs=costs)
        return
    _launch(rows, w, tensors, costs, status, scratch)


_SMS: dict = {}


def _launch(rows: int, w: int, t: dict, costs: TileCosts, status, scratch) -> None:
    dev = t["a"].device
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = tile_plan(rows, w, _SMS[dev.index])
    checked = status is None
    if checked:
        status = torch.zeros(1, dtype=torch.int32, device=dev)
    if scratch is None:
        scratch = _scratch(rows, w, costs.extend is not None, dev)
    lib = _lib()
    launches = ctypes.c_longlong(0)
    ptr = {k: v.data_ptr() for k, v in t.items()}
    with torch.cuda.device(dev):
        err = lib.sz_ring_tile(
            costs.config, costs.gap, costs.extend or 0, costs.match, costs.mismatch,
            ptr["a"], rows, ptr["b"], w, None if costs.table is None else costs.table.data_ptr(),
            ptr["top_d"], ptr["top_f"], ptr["bottom_d"], ptr["bottom_f"], ptr["left_d"],
            ptr["left_e"], ptr["best"], status.data_ptr(), scratch.data_ptr(),
            scratch.numel() * scratch.element_size(), ctas, ctypes.byref(launches),
            torch.cuda.current_stream(dev).cuda_stream)
    KERNEL_LAUNCHES["ring_tile"] += launches.value
    _raise_on(lib, err, "sz_ring_tile")
    if checked and int(status.item()) != 0:  # a stalled wait: a fault, never an answer
        raise RuntimeError("sz_ring_tile: a strip's wait stalled")


# Past this many rows a column's running min/max is taken in two levels:
# PyTorch's CUDA scan of one long 1-D tensor runs in a single block.
SCAN_WIDTH = 1024


def _running(x: torch.Tensor, is_min: bool) -> torch.Tensor:
    """The running min (or max) of 1-D ``x``, as ``torch.cummin`` (or
    ``cummax``) gives it: past ``SCAN_WIDTH`` elements, each row of that
    width scanned on its own, then each row raised (or lowered) by the
    running result of the rows before it. Exact: min and max associate."""
    scan = torch.cummin if is_min else torch.cummax
    n = x.numel()
    if n <= SCAN_WIDTH:
        return scan(x, 0).values
    k = -(-n // SCAN_WIDTH)
    rows = torch.cat([x, x.new_zeros(k * SCAN_WIDTH - n)]).view(k, SCAN_WIDTH)  # padded at the end
    part = scan(rows, 1).values
    carry = scan(part[:, -1], 0).values  # through the end of each row
    part[1:] = (torch.minimum if is_min else torch.maximum)(part[1:], carry[:-1, None])
    return part.view(-1)[:n]


def ring_tile_reference(a, b, top_d, top_f, bottom_d, bottom_f, left_d, left_e, best,
                        costs: TileCosts, *, status=None, scratch=None) -> None:
    """Plain PyTorch version of ``ring_tile``, on any device, with the same
    arguments (``status`` and ``scratch`` are not used: it never waits).
    The JAX ring's ``tile`` a column at a time, each column vectorised over
    the rows: the vertical-gap chain ``F[i] = opt(F[i-1] + ext, base[i])``
    is solved exactly as the running min/max of ``base - ext * i``, plus
    ``ext * i`` (``_running``). Each column's costs are made in its step,
    so the memory is O(rows + w) whatever the tile's size."""
    dev = a.device
    rows, w = a.numel(), b.numel()
    is_min = costs.objective == "min"
    opt = torch.minimum if is_min else torch.maximum
    affine = costs.extend is not None
    local = costs.locality == "local"
    gap = costs.gap
    ext = costs.extend if affine else gap
    ramp = ext * torch.arange(rows, dtype=torch.int32, device=dev)
    # base - ramp, made a column at a time: row 0 from the row above (its D
    # plus the gap, or F plus extend when that is better), row i > 0 from
    # row i - 1's D0 plus chain[i - 1].
    chain = gap - ramp[1:]
    first = top_d[1:] + gap
    if affine:
        first = opt(first, top_f[1:] + costs.extend)
    first, corner = first.split(1), top_d[:-1].split(1)  # column j's: first[j], corner[j]
    b_host = b.tolist()
    if costs.table is not None:  # column j's costs: table[a[i]][b[j]], ids clamped to [0, 31]
        by_class = costs.table.t()[:, a.clamp(0, 31).long()].contiguous()  # [k][i]: table[a[i]][k]
        sub_of = lambda j: by_class[min(max(b_host[j], 0), 31)]
    else:
        match, mismatch = (torch.tensor(x, dtype=torch.int32, device=dev)
                           for x in (costs.match, costs.mismatch))
        sub_of = lambda j: torch.where(a == b_host[j], match, mismatch)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    clamp = (lambda x: opt(x, zero)) if local else (lambda x: x)
    D, E = left_d.clone(), left_e.clone()
    tops = None  # each row's best cell so far (max-objective local)
    for j in range(w):
        E = opt(E + costs.extend, D + gap) if affine else D + gap
        D0 = clamp(opt(torch.cat([corner[j], D[:-1]]) + sub_of(j), E))
        F = _running(torch.cat([first[j], D0[:-1] + chain]), is_min) + ramp
        D = clamp(opt(D0, F))
        bottom_d[j + 1: j + 2] = D[-1:]
        if affine:
            bottom_f[j + 1: j + 2] = F[-1:]
        if local and not is_min:
            tops = D if tops is None else torch.maximum(tops, D)
    left_d.copy_(D)
    if affine:
        left_e.copy_(E)
    if tops is not None:
        best.copy_(torch.maximum(best, tops.max()))


def _chars(x) -> torch.Tensor:
    """A string's chars as a 1-D int32 tensor: bytes, a numpy array or an
    integer tensor (left on its device)."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 1 or x.is_floating_point() or x.is_complex():
            raise TypeError("a tensor operand must be 1-D and of an integer type")
        return x.to(torch.int32).contiguous()
    if isinstance(x, (bytes, bytearray, memoryview)):
        return torch.from_numpy(np.frombuffer(bytes(x), np.uint8).astype(np.int32))
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).reshape(-1), dtype=np.int32))


class _Entry(NamedTuple):
    """One entry of a ring: its device and stream (None on the CPU), its
    rows' chars, its left column's border (``left0``) and working copy
    (``left``, 2 x rows: D, E), its frontier buffers over the pair's n + 1
    columns (``top``: the row above, ``bottom``: its last row; 2 x (n + 1):
    D, F), its best cell, fault status, the kernel's scratch and costs."""
    device: torch.device
    stream: object
    a: torch.Tensor
    left0: torch.Tensor
    left: torch.Tensor
    top: torch.Tensor
    bottom: torch.Tensor
    best: torch.Tensor
    status: torch.Tensor
    scratch: torch.Tensor | None
    costs: TileCosts


class _Ring:
    """One pair's ring over a scope's devices, ready to run: the column
    blocks, and each entry's rows, buffers and stream (``_ring_plan``)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, scope, objective, locality, gap,
                 extend, match, mismatch, table, block_cols):
        m, n = a.numel(), b.numel()
        D = scope.device_count
        mb = -(-m // D)
        C = min(block_cols or ring_block_cols(m, n, D), n)
        self.blocks = [(c0, min(C, n - c0)) for c0 in range(0, n, C)]
        self.m, self.mb, self.first = m, mb, scope.device
        self.local, self.is_min = locality == "local", objective == "min"
        affine = extend is not None
        self.frontier_rows = 2 if affine else 1
        ext = extend if affine else gap
        ident = BIG if self.is_min else -BIG

        def border(k: np.ndarray) -> np.ndarray:  # D of row 0 / column 0 at k
            if self.local:
                return np.zeros(len(k), np.int64)
            if affine:
                return np.where(k > 0, gap + extend * (k - 1), 0)
            return gap * k

        def rows2(d: np.ndarray) -> torch.Tensor:  # (D, its gap matrix) a column or a row
            g = np.full(len(d), ident // 2) if self.local else d + gap + ext
            return torch.from_numpy(np.stack([d, g]).astype(np.int32))

        self.b = {}
        self.entries = []
        for d in range(D):
            row_base = d * mb
            rows = min(mb, m - row_base)
            if rows <= 0:
                break
            dev = scope.devices[d]
            cuda = dev.type == "cuda"
            self.b.setdefault(dev, b.to(dev))
            tab = None if table is None else table.to(dev)
            if d == 0:
                top = rows2(border(np.arange(n + 1))).to(dev)
            else:
                top = torch.zeros((2, n + 1), dtype=torch.int32, device=dev)
                top[0, 0] = int(border(np.array([row_base]))[0])  # the corner of block 0
            left0 = rows2(border(row_base + 1 + np.arange(rows))).to(dev)
            costs = TileCosts(objective, locality, gap, extend, match, mismatch, tab)
            scratch = _scratch(rows, C, affine, dev) if cuda else None
            self.entries.append(_Entry(
                dev, torch.cuda.Stream(device=dev) if cuda else None,
                a[row_base: row_base + rows].to(dev), left0, torch.empty_like(left0), top,
                torch.zeros((2, n + 1), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), scratch, costs))

    def run(self) -> torch.Tensor:
        """Enqueues every tile through ``ring_tile`` and returns ``[score,
        each entry's status]`` as int32 on the scope's first device, not
        pulled: the work is ordered before anything later on each device's
        current stream."""
        entries, blocks = self.entries, self.blocks
        for e in entries:
            e.left.copy_(e.left0)
            e.best.zero_()
            e.status.zero_()
            if e.stream is not None:
                e.stream.wait_stream(torch.cuda.current_stream(e.device))
        k = self.frontier_rows
        events = {}
        for t in range(len(blocks) + len(entries) - 1):
            for d, e in enumerate(entries):
                j = t - d
                if not 0 <= j < len(blocks):
                    continue
                c0, w = blocks[j]
                cols = slice(c0, c0 + w + 1)
                ctx = torch.cuda.stream(e.stream) if e.stream is not None else contextlib.nullcontext()
                with ctx:
                    if d > 0:  # the rows of the block from the entry above
                        if e.stream is not None:
                            e.stream.wait_event(events.pop((d - 1, j)))
                        e.top[:k, c0 + 1: c0 + w + 1].copy_(
                            entries[d - 1].bottom[:k, c0 + 1: c0 + w + 1])
                    ring_tile(e.a, self.b[e.device][c0: c0 + w], e.top[0, cols],
                              e.top[1, cols], e.bottom[0, cols], e.bottom[1, cols], e.left[0],
                              e.left[1], e.best, e.costs, status=e.status, scratch=e.scratch)
                    if d + 1 < len(entries) and e.stream is not None:
                        events[(d, j)] = torch.cuda.Event()
                        events[(d, j)].record(e.stream)
        for e in entries:
            if e.stream is not None:
                torch.cuda.current_stream(e.device).wait_stream(e.stream)
        if not self.local:  # D[m][n]: the last column's row m, on its entry
            owner = entries[(self.m - 1) // self.mb]
            row = (self.m - 1) % self.mb
            score = owner.left[0, row: row + 1].to(self.first)
        elif self.is_min:
            score = torch.zeros(1, dtype=torch.int32, device=self.first)
        else:
            score = torch.cat([e.best.to(self.first) for e in entries]).max().reshape(1)
        return torch.cat([score, *(e.status.to(self.first) for e in entries)])


def _ring_plan(a, b, scope, match, mismatch, gap, objective, locality, table, extend,
               block_cols):
    """``(early, ring)``: the score of a pair with an empty string (the JAX
    rule: 0 when local, else the other string's gap run), or a ``_Ring``
    with the pair's rows cut over the scope's entries."""
    table = _check_costs(objective, locality, table)
    a, b = _chars(a), _chars(b)
    m, n = a.numel(), b.numel()
    if m == 0 or n == 0:
        return _empty_score(m, n, gap, extend, locality), None
    if block_cols is not None and block_cols < 1:
        raise ValueError(f"block_cols must be positive, not {block_cols}")
    return None, _Ring(a, b, scope, objective, locality, gap, extend, match, mismatch, table,
                       block_cols)


def ring_wavefront_score(a, b, scope, match: int = 0, mismatch: int = 1, gap: int = 1,
                         objective: str = "min", locality: str = "global", table=None,
                         extend: int | None = None, block_cols: int | None = None) -> int:
    """Score of ONE pair with its DP matrix cut across ``scope``'s devices
    (a ``DeviceScope``, where the JAX function takes a mesh). The JAX
    function's configurations: uniform ``match``/``mismatch`` costs or a
    32x32 class-cost ``table`` (operands given as class ids, clamped to
    [0, 31]); linear gaps, or Gotoh affine ones (``gap`` opens, ``extend``
    extends); global or ``locality="local"`` alignment; min or max
    ``objective``. ``a`` and ``b`` are bytes, numpy arrays or integer
    tensors. ``block_cols`` is the column block (``ring_block_cols`` when
    None); the score does not depend on it or on the device count.
    Raises ``RuntimeError`` if a kernel's wait stalled."""
    early, ring = _ring_plan(a, b, scope, match, mismatch, gap, objective, locality, table,
                             extend, block_cols)
    if ring is None:
        return early
    out = ring.run().tolist()
    if any(out[1:]):
        raise RuntimeError(f"sz_ring_tile: a strip's wait stalled (statuses {out[1:]})")
    return int(out[0])
