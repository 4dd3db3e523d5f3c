#!/usr/bin/env python
"""Times the ring's tile kernel (``csrc/ring.cu`` ``ring_tile``) of two trees
of the repository on the same inputs in one process, on one NVIDIA GPU; and
this tree's kernel at other geometries and by its SASS.

    python3 tools/ring_ab.py OTHER_ROOT            # the A/B
    python3 tools/ring_ab.py --geometry            # R, warps a CTA, chunk, CTAs an SM, block
    python3 tools/ring_ab.py --sass [OTHER_ROOT]   # SASS instructions a warp-step by configuration
    ... --only tile,strip                          # some of the A/B's workloads

The inputs are ``chip_smoke.py`` phase 6's, made by its helpers from their
seeds: the 600,000-base DNA pair and its copy with 0.5% edits, scored with
the NW costs of ``NeedlemanWunschScores(b2c, dna, open=-7, extend=-2)``
(affine, a class table) and as Levenshtein distances. The workloads:
``edges`` (every configuration on ``chip_smoke.RING_TILES``, random
frontiers, against ``ring_tile_reference`` on the card; checked, not
timed), ``tile`` (the main-path tile: entry 0's rows across block 0 of
the NW pair's ring over 4 entries, 150,000 x 150,016), ``strip`` (its
first 128 rows alone: one warp's step latency with nothing to hide it),
``one`` (the 1-entry ring's one tile, the whole 600,000 x 600,000 pair:
a full card's instruction rate) and ``rings`` (the whole NW and Levenshtein
rings over 1, 2 and 4 entries of the card, each tile through the tree's
kernel and the tree's own blocks).

OTHER_ROOT is another tree (the parent, from ``git archive``). Each tree's
``ring.cu`` is built alone with ``nvcc`` into ``build/ring_ab/`` and its
tiles launched raw, each with the grid its own ``parallel/ring.py``
``tile_plan`` gives (asked in a subprocess of that tree; its
``ring_block_cols`` too), in the order other, this, this, other. Every
result of the two trees must be equal (the tiles' four outputs, the rings'
scores, which must also equal each other over 1, 2 and 4 entries). Each
time is the median of CUDA-event batches (``chip_smoke._time_ms``) with
their spread. Prints the card's name and power limit, a line a workload a
turn, each workload's medians of the two trees' turns, their ratio, the
bound (``chip_smoke._bound`` of ``_dp_ops_per_cell`` a cell and the
tile's bytes) and each tree's share of it, and a JSON summary last; exits
non-zero if a result differs.

``--geometry`` builds copies of this ``ring.cu`` with other rows a lane
(R), warps a CTA and chunk, and times each (and this one) on ``tile``
and ``one`` with ``tile_plan`` of its geometry, in turns forwards then
backwards, each result equal to this tree's; then this build on the same
two tiles at other CTA counts (1, 2 and 3 an SM, and the plan's count
before it is cut to a whole number an SM), and the NW and Levenshtein
rings over 4 entries at other column blocks. ``--sass`` builds each tree's
``ring.cu`` (and the geometry copies) with every chunk in its unmasked
form into a cubin and counts, for each of the 16 configurations, the
instructions on the shortest path through the loop of chunks, over its
steps: SASS instructions a warp-step, with the opcodes, and registers and
spills from ``nvcc``'s report. The SASS is written to ``build/ring_ab/``.
"""

import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))
import chip_smoke  # noqa: E402
import cuda_tools  # noqa: E402

OUT = os.path.join(HERE, "build", "ring_ab")
SOURCE = os.path.join("stringzilla_tpu_torch", "csrc", "ring.cu")
WORKLOADS = ("edges", "tile", "strip", "one", "rings")
STRIP_ROWS = 128
ENTRIES = (1, 2, 4)
# (rows a lane, warps a CTA, chunk) that --geometry builds beside this one
GEOMETRIES = [(8, 4, 16), (16, 4, 16), (4, 2, 16), (4, 8, 16), (4, 4, 8)]
# column blocks of the 4-entry rings that --geometry times beside the default
BLOCKS = (75_008, 100_096, 200_064, 300_032)
CONSTANTS = {"rows": r"constexpr int kRingRows = \d+;", "warps": r"constexpr int kRingWarps = \d+;",
             "chunk": r"constexpr int kRingChunk = \d+;"}


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sz_ring_tile.argtypes = [i] * 5 + [p, i, p, i] + [p] * 9 + [p, ll, i, p, p]
    lib.sz_ring_tile.restype = i
    lib.sz_ring_geometry.argtypes = [p]
    lib.sz_ring_geometry.restype = None
    lib.sz_ring_scratch_bytes.argtypes = [i, i, i]
    lib.sz_ring_scratch_bytes.restype = ll
    got = (ctypes.c_int * 3)()
    lib.sz_ring_geometry(got)
    lib.geometry = tuple(got)
    return lib


def _builds(jobs: dict, cubin: bool = False) -> dict:
    """{tag: source (as ``cuda_tools.build`` takes it)} built together into
    build/ring_ab/; {tag: bound library} (or {tag: cubin path})."""
    return cuda_tools.builds(jobs, OUT, _bind, cubin)


def _variant(text: str, geometry) -> str:
    """``ring.cu``'s text with rows a lane, warps a CTA and chunk set."""
    for (key, pattern), value in zip(CONSTANTS.items(), geometry):
        text, n = re.subn(pattern, pattern.split(" = ")[0].replace("\\", "") + f" = {value};", text)
        if n != 1:
            raise RuntimeError(f"ring.cu has no single {key} constant")
    return text


def _write(tag: str, text: str, like: str) -> tuple:
    """``text`` written to build/ring_ab/<tag>.cu; (its path, the directory
    of ``like``, whose headers it includes)."""
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{tag}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path, os.path.dirname(like)


# -- plans: each tree's own tile_plan and ring_block_cols ---------------------------

_PLAN_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from stringzilla_tpu_torch.parallel.ring import ring_block_cols, tile_plan
ask = json.loads(sys.argv[2])
print(json.dumps({"blocks": [ring_block_cols(m, n, d) for m, n, d in ask["rings"]],
                  "plans": [tile_plan(r, w, ask["sms"]) for r, w in ask["tiles"]]}))
"""


def _tree_plans(root: str, sms: int, rings: list, tiles: list) -> tuple:
    """(blocks of each ring (m, n, entries), {(rows, w): CTAs}) as the tree
    at ``root`` plans them, with every tile of those rings planned too."""
    ask = lambda tiles_: json.dumps({"sms": sms, "rings": rings, "tiles": tiles_})
    run = lambda a: json.loads(subprocess.run(
        [sys.executable, "-c", _PLAN_SCRIPT, root, a], capture_output=True, text=True,
        check=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout)
    blocks = run(ask([]))["blocks"]
    shapes = set(map(tuple, tiles))
    for (m, n, d), c in zip(rings, blocks):
        mb = -(-m // d)
        for r in {min(mb, m - k * mb) for k in range(d)}:
            for w in {min(c, n), n - (-(-n // c) - 1) * c}:
                if r > 0:
                    shapes.add((r, w))
    shapes = sorted(shapes)
    return blocks, dict(zip(shapes, run(ask(shapes))["plans"]))


# -- launches ---------------------------------------------------------------------

def _launcher(lib, ctas: int, t: list, costs, dev, status=None, scratch=None):
    """A function that launches one ``ring_tile`` of ``lib`` on the tensors
    ``t`` (``ring_tile``'s nine, in order) with ``ctas`` CTAs on the current
    stream, with the given status and scratch (``lib``'s size at least) or
    fresh ones; and the status."""
    import torch

    rows, w = t[0].numel(), t[1].numel()
    nbytes = lib.sz_ring_scratch_bytes(rows, w, int(costs.extend is not None))
    if scratch is None:
        scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=dev)
    if status is None:
        status = torch.zeros(1, dtype=torch.int32, device=dev)
    launches = ctypes.c_longlong(0)
    table = None if costs.table is None else costs.table.data_ptr()
    ptr = [x.data_ptr() for x in t]

    def launch():
        err = lib.sz_ring_tile(costs.config, costs.gap, costs.extend or 0, costs.match,
                               costs.mismatch, ptr[0], rows, ptr[1], w, table, *ptr[2:],
                               status.data_ptr(), scratch.data_ptr(), nbytes, ctas,
                               ctypes.byref(launches),
                               torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"sz_ring_tile: error {err}")

    return launch, status


def _tile_fn(lib, plans: dict, dev):
    """A stand-in for ``parallel/ring.py``'s ``ring_tile`` that launches
    each tile raw through ``lib`` with the grid of ``plans`` and scratch of
    ``lib``'s size, one scratch an entry (the loop's own scratch tensors
    are not used); for ``chip_smoke._ring_tile_as``."""
    import torch

    scratches = {}

    def tile(a, b, top_d, top_f, bottom_d, bottom_f, left_d, left_e, best, costs, *,
             status=None, scratch=None):
        rows, w = a.numel(), b.numel()
        nbytes = lib.sz_ring_scratch_bytes(rows, w, int(costs.extend is not None))
        key = left_d.data_ptr()  # one an entry
        if key not in scratches or scratches[key].numel() * 8 < nbytes:
            scratches[key] = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=dev)
        t = [a, b, top_d, top_f, bottom_d, bottom_f, left_d, left_e, best]
        _launcher(lib, plans[(rows, w)], t, costs, dev, status, scratches[key])[0]()

    return tile


@contextlib.contextmanager
def _placeholder_scratch():
    """``parallel/ring.py`` without its own library: the loop's scratch
    tensors are one int64 each (``_tile_fn`` makes the real ones)."""
    import torch
    from stringzilla_tpu_torch.parallel import ring as ring_mod

    keep = ring_mod._scratch
    ring_mod._scratch = lambda rows, w, affine, dev: torch.zeros(1, dtype=torch.int64, device=dev)
    try:
        yield
    finally:
        ring_mod._scratch = keep


# -- workloads ---------------------------------------------------------------------

def _pair(dev):
    """The phase-6 pair as chars of each engine's configuration: {name:
    (a, b, ring keywords, SimilarityConfig)} on ``dev``."""
    import torch
    from stringzilla_tpu_torch import LevenshteinDistances, NeedlemanWunschScores
    from stringzilla_tpu_torch.ops.wavefront import config_costs

    a, b = chip_smoke._ring_pair()
    b2c = np.zeros(256, np.uint8)
    b2c[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    dna = np.full((32, 32), -3, np.int32)
    np.fill_diagonal(dna, 2)
    out = {}
    for name, engine in (("NW", NeedlemanWunschScores(b2c, dna, open=-7, extend=-2)),
                         ("Levenshtein", LevenshteinDistances())):
        cfg = engine.config
        ids = (lambda s: b2c[s]) if cfg.uses_classes else (lambda s: s)
        kw = config_costs(cfg, None)
        if cfg.uses_classes:
            kw["table"] = dna
        up = lambda s: torch.from_numpy(ids(s).astype(np.int32)).to(dev)
        out[name] = (up(a), up(b), kw, cfg)
    return out


def _ring(pair, entries: int, block, dev):
    """The ``_Ring`` of ``pair`` over ``entries`` entries of ``dev``."""
    from stringzilla_tpu_torch import DeviceScope
    from stringzilla_tpu_torch.parallel import ring as ring_mod

    a, b, kw, _ = pair
    with _placeholder_scratch():
        _, r = ring_mod._ring_plan(a, b, DeviceScope(devices=[dev] * entries),
                                   kw.get("match", 0), kw.get("mismatch", 1), kw["gap"],
                                   kw["objective"], kw["locality"], kw.get("table"),
                                   kw.get("extend"), block)
    return r


def _main_tile(pair, dev, rows=None):
    """(tensors, costs) of entry 0's rows (its first ``rows``) across block
    0 of the NW pair's ring over 4 entries, from the inputs it is given
    there."""
    import torch

    r = _ring(pair, 4, None, dev)
    e = r.entries[0]
    _, w = r.blocks[0]
    k = e.a.numel() if rows is None else rows
    zeros = lambda n: torch.zeros(n, dtype=torch.int32, device=dev)
    return [e.a[:k], r.b[e.device][:w], e.top[0, :w + 1], e.top[1, :w + 1], zeros(w + 1),
            zeros(w + 1), e.left0[0, :k], e.left0[1, :k], zeros(1)], e.costs


def _one_tile(pair, dev):
    """(tensors, costs) of the 1-entry ring's one tile (the whole pair)."""
    import torch

    r = _ring(pair, 1, None, dev)
    e = r.entries[0]
    w = r.blocks[0][1]
    zeros = lambda n: torch.zeros(n, dtype=torch.int32, device=dev)
    return [e.a, r.b[e.device][:w], e.top[0, :w + 1], e.top[1, :w + 1], zeros(w + 1),
            zeros(w + 1), e.left0[0], e.left0[1], zeros(1)], e.costs


def _tile_bound(cfg, rows: int, w: int):
    cells = rows * w
    return chip_smoke._bound(chip_smoke._dp_ops_per_cell(cfg) * cells, 4.0 * 5 * (rows + w))


def _run_tile(lib, ctas, tensors, costs, dev):
    """The tile's four outputs (and best) from fresh inputs through ``lib``."""
    t = [x.clone() for x in tensors]
    launch, status = _launcher(lib, ctas, t, costs, dev)
    launch()
    import torch

    torch.cuda.synchronize()
    chip_smoke._check(int(status.item()) == 0, "ring_tile: a wait stalled")
    return t[4:]


def _time_tile(lib, ctas, tensors, costs, dev, batches=5):
    """CUDA-event time of one launch on a working copy (each run rewrites
    its last column in place: the same cells again)."""
    import torch

    t = [x.clone() for x in tensors]
    launch, status = _launcher(lib, ctas, t, costs, dev)
    ms = chip_smoke._time_ms(launch, 1, torch.cuda.synchronize, batches=batches)
    chip_smoke._check(int(status.item()) == 0, "ring_tile: a wait stalled while timed")
    return ms


def _same(x, y) -> bool:
    import torch

    return all(torch.equal(a, b) for a, b in zip(x, y))


def _check_edges(lib, plans: dict, dev, label: str) -> int:
    """Every configuration on chip_smoke.RING_TILES with random frontiers
    through ``lib`` against ``ring_tile_reference`` on the card; the tiles
    that differ."""
    import torch
    from stringzilla_tpu_torch.parallel.ring import TileCosts, ring_tile_reference

    rng = np.random.default_rng(chip_smoke.SEED + 61)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)
    bad = 0
    for k in range(16):
        kw, table = chip_smoke._ring_config(k, dev)
        costs = TileCosts(kw["objective"], kw["locality"], kw["gap"], kw.get("extend"),
                          kw.get("match", 0), kw.get("mismatch", 1), table)
        for rows, w in chip_smoke.RING_TILES:
            hi = 40 if k & 1 else 4
            inputs = [up(rng.integers(0, hi, rows)), up(rng.integers(0, hi, w)),
                      up(rng.integers(-1000, 1000, w + 1)), up(rng.integers(-1000, 1000, w + 1)),
                      up(np.zeros(w + 1)), up(np.zeros(w + 1)),
                      up(rng.integers(-1000, 1000, rows)), up(rng.integers(-1000, 1000, rows)),
                      up(rng.integers(0, 50, 1))]
            want = [x.clone() for x in inputs]
            ring_tile_reference(*want, costs)
            got = _run_tile(lib, plans[(rows, w)], inputs, costs, dev)
            if not _same(got, want[4:]):
                bad += 1
                print(f"[ring ab] {label}: configuration {k} tile {rows} x {w} differs from "
                      f"ring_tile_reference", flush=True)
    print(f"[ring ab] {label}: {16 * len(chip_smoke.RING_TILES)} edge tiles (16 configurations "
          f"x {len(chip_smoke.RING_TILES)} shapes), {bad} differing from ring_tile_reference",
          flush=True)
    return bad


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _median(xs) -> float:
    return float(np.median(xs))


def _ab(other: str, only, dev) -> int:
    import torch

    card = _card()
    chip_smoke.CARD = card
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    this = os.path.abspath(HERE)
    other = os.path.abspath(other)
    libs = _builds({"this": os.path.join(this, SOURCE), "other": os.path.join(other, SOURCE)})
    for tag, lib in libs.items():
        print(f"[ring ab] {tag}: geometry {lib.geometry}", flush=True)
    pairs = _pair(dev)
    m, n = pairs["NW"][0].numel(), pairs["NW"][1].numel()
    rings = [(m, n, d) for d in ENTRIES]
    main_t, main_c = _main_tile(pairs["NW"], dev)
    strip_t, _ = _main_tile(pairs["NW"], dev, STRIP_ROWS)
    one_t, one_c = _one_tile(pairs["NW"], dev)
    tiles = {"tile": (main_t, main_c), "strip": (strip_t, main_c), "one": (one_t, one_c)}
    asked = [[t[0].numel(), t[1].numel()] for t, _ in tiles.values()]
    asked += [list(s) for s in chip_smoke.RING_TILES]
    plans = {tag: _tree_plans(root, sms, rings, asked)
             for tag, root in (("this", this), ("other", other))}
    for tag, (blocks, _) in plans.items():
        print(f"[ring ab] {tag}: blocks of the rings over {ENTRIES} entries {blocks}; CTAs "
              + ", ".join(f"{k} {plans[tag][1][(t[0].numel(), t[1].numel())]}"
                          for k, (t, _) in tiles.items()), flush=True)
    order = ["other", "this", "this", "other"]
    bad = 0
    summary = {"card": card, "other": other, "workloads": {}}
    if "edges" in only:
        for tag in ("other", "this"):
            bad += _check_edges(libs[tag], plans[tag][1], dev, tag)
    cfg_nw = pairs["NW"][3]
    for name, (t, costs) in tiles.items():
        if name not in only:
            continue
        rows, w = t[0].numel(), t[1].numel()
        outs = {tag: _run_tile(libs[tag], plans[tag][1][(rows, w)], t, costs, dev)
                for tag in ("other", "this")}
        same = _same(outs["this"], outs["other"])
        bad += not same
        times = {"this": [], "other": []}
        spread = {"this": [], "other": []}
        batches = 3 if name == "one" else 5
        for turn, tag in enumerate(order):
            ms = _time_tile(libs[tag], plans[tag][1][(rows, w)], t, costs, dev, batches)
            times[tag].append(float(ms))
            spread[tag] += [ms.lo, ms.hi]
            print(f"[ring ab] {name} {rows} x {w} turn {turn} {tag}: {float(ms):.4f} ms "
                  f"[{ms.lo:.4f}-{ms.hi:.4f}] ({card})", flush=True)
        bound, by = _tile_bound(cfg_nw, rows, w)
        med = {k: _median(v) for k, v in times.items()}
        print(f"[ring ab] {name} {rows} x {w}: this {med['this']:.4f} ms "
              f"[{min(spread['this']):.4f}-{max(spread['this']):.4f}], other {med['other']:.4f} "
              f"[{min(spread['other']):.4f}-{max(spread['other']):.4f}], other/this "
              f"{med['other'] / med['this']:.3f}x; bound {bound:.4f} ms ({by}): this "
              f"{100 * bound / med['this']:.1f}%, other {100 * bound / med['other']:.1f}%; "
              f"outputs {'equal' if same else 'DIFFER'} ({card})", flush=True)
        summary["workloads"][name] = {
            "rows": rows, "w": w, "this_ms": med["this"], "other_ms": med["other"],
            "this_spread": [min(spread["this"]), max(spread["this"])],
            "other_spread": [min(spread["other"]), max(spread["other"])],
            "ratio": med["other"] / med["this"], "bound_ms": bound, "bound_by": by,
            "ctas": {k: plans[k][1][(rows, w)] for k in plans}, "equal": same}
    if "rings" in only:
        for name, pair in pairs.items():
            cfg = pair[3]
            bound, by = chip_smoke._bound(chip_smoke._dp_ops_per_cell(cfg) * m * n, 4.0 * (m + n))
            for d, blk in zip(ENTRIES, plans["this"][0]):
                scores, times, spread = {}, {"this": [], "other": []}, {"this": [], "other": []}
                for turn, tag in enumerate(order):
                    r = _ring(pair, d, plans[tag][0][ENTRIES.index(d)], dev)
                    with chip_smoke._ring_tile_as(_tile_fn(libs[tag], plans[tag][1], dev)):
                        out = r.run().tolist()
                        ms = chip_smoke._time_ms(r.run, 1, torch.cuda.synchronize, batches=3)
                        again = r.run().tolist()
                    chip_smoke._check(not any(out[1:]) and out == again,
                                      f"ring {name} over {d} ({tag}): {out} then {again}")
                    scores.setdefault(tag, out[0])
                    times[tag].append(float(ms))
                    spread[tag] += [ms.lo, ms.hi]
                    print(f"[ring ab] ring {name} over {d} entries turn {turn} {tag}: "
                          f"{float(ms):.3f} ms [{ms.lo:.3f}-{ms.hi:.3f}] score {out[0]} ({card})",
                          flush=True)
                same = scores["this"] == scores["other"]
                bad += not same
                med = {k: _median(v) for k, v in times.items()}
                print(f"[ring ab] ring {name} {m} x {n} over {d} entries: this {med['this']:.3f} "
                      f"ms [{min(spread['this']):.3f}-{max(spread['this']):.3f}], other "
                      f"{med['other']:.3f} [{min(spread['other']):.3f}-{max(spread['other']):.3f}]"
                      f", other/this {med['other'] / med['this']:.3f}x; bound {bound:.3f} ms "
                      f"({by}): this {100 * bound / med['this']:.1f}%, other "
                      f"{100 * bound / med['other']:.1f}%; scores {scores} ({card})", flush=True)
                summary["workloads"][f"ring {name} x{d}"] = {
                    "this_ms": med["this"], "other_ms": med["other"],
                    "this_spread": [min(spread["this"]), max(spread["this"])],
                    "other_spread": [min(spread["other"]), max(spread["other"])],
                    "ratio": med["other"] / med["this"], "bound_ms": bound, "bound_by": by,
                    "score": scores["this"], "equal": same,
                    "blocks": {k: plans[k][0][ENTRIES.index(d)] for k in plans}}
            got = {summary["workloads"][f"ring {name} x{d}"]["score"] for d in ENTRIES}
            bad += len(got) != 1
    summary["differing"] = bad
    print(json.dumps(summary))
    return 1 if bad else 0


# -- --geometry ----------------------------------------------------------------------

def _geometry(dev) -> int:
    import torch
    from stringzilla_tpu_torch.parallel.ring import (RING_SHARE, _claims_plan, ring_block_cols,
                                                     tile_plan)

    card = _card()
    chip_smoke.CARD = card
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = os.path.join(HERE, SOURCE)
    text = open(src).read()
    jobs = {"this": src}
    for g in GEOMETRIES:
        tag = "geo_" + "_".join(map(str, g))
        jobs[tag] = _write(tag, _variant(text, g), src)
    libs = _builds(jobs)
    pairs = _pair(dev)
    tiles = {"tile": _main_tile(pairs["NW"], dev), "one": _one_tile(pairs["NW"], dev)}
    want = {k: _run_tile(libs["this"], tile_plan(t[0].numel(), t[1].numel(), sms), t, c, dev)
            for k, (t, c) in tiles.items()}
    bad = 0
    result = {"card": card, "geometries": {}, "ctas": {}, "blocks": {}}
    tags = list(libs)
    for name, (t, costs) in tiles.items():
        rows, w = t[0].numel(), t[1].numel()
        times = {tag: [] for tag in tags}
        for tag in tags + tags[::-1]:
            lib = libs[tag]
            ctas = _claims_plan(rows, w, sms, *lib.geometry, RING_SHARE)
            if len(times[tag]) == 0:
                same = _same(_run_tile(lib, ctas, t, costs, dev), want[name])
                bad += not same
                if not same:
                    print(f"[ring geometry] {tag} on {name}: outputs DIFFER", flush=True)
            ms = _time_tile(lib, ctas, t, costs, dev, 3)
            times[tag].append(float(ms))
            print(f"[ring geometry] {name} {rows} x {w} {tag} {lib.geometry} {ctas} CTAs: "
                  f"{float(ms):.4f} ms [{ms.lo:.4f}-{ms.hi:.4f}] ({card})", flush=True)
        for tag in tags:
            result["geometries"].setdefault(tag, {"geometry": libs[tag].geometry})[name] = \
                _median(times[tag])
        bound, by = _tile_bound(pairs["NW"][3], rows, w)
        print(f"[ring geometry] {name}: " + ", ".join(
            f"{tag} {_median(times[tag]):.4f} ms ({100 * bound / _median(times[tag]):.1f}%)"
            for tag in tags) + f" of the bound {bound:.4f} ms ({by}) ({card})", flush=True)
        # this build at other CTA counts
        plan = tile_plan(rows, w, sms)
        uncut = _claims_plan(rows, w, 10 ** 6, *libs["this"].geometry, 1)
        counts = sorted({plan, sms, 2 * sms, 3 * sms, min(uncut, 3 * sms)})
        for ctas in counts:
            ms = _time_tile(libs["this"], ctas, t, costs, dev, 3)
            result["ctas"].setdefault(name, {})[ctas] = float(ms)
            print(f"[ring geometry] {name} this at {ctas} CTAs{' (the plan)' if ctas == plan else ''}"
                  f": {float(ms):.4f} ms [{ms.lo:.4f}-{ms.hi:.4f}] ({card})", flush=True)
    # the 4-entry rings at other column blocks, this build
    m, n = pairs["NW"][0].numel(), pairs["NW"][1].numel()
    default = ring_block_cols(m, n, 4)
    for name, pair in pairs.items():
        scores = set()
        for block in (default, *BLOCKS):
            r = _ring(pair, 4, block, dev)
            plans = {}
            for rows, w in {(e.a.numel(), bw) for e in r.entries for _, bw in r.blocks}:
                plans[(rows, w)] = tile_plan(rows, w, sms)
            with chip_smoke._ring_tile_as(_tile_fn(libs["this"], plans, dev)):
                out = r.run().tolist()
                ms = chip_smoke._time_ms(r.run, 1, torch.cuda.synchronize, batches=3)
            scores.add(out[0])
            bad += any(out[1:])
            result["blocks"].setdefault(name, {})[block] = float(ms)
            print(f"[ring geometry] ring {name} over 4 entries, blocks of {block}"
                  f"{' (the default)' if block == default else ''} ({len(r.blocks)} blocks): "
                  f"{float(ms):.3f} ms [{ms.lo:.3f}-{ms.hi:.3f}] score {out[0]} ({card})",
                  flush=True)
        bad += len(scores) != 1
    result["differing"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


# -- --sass -----------------------------------------------------------------------------

def _configs_of(sass: str) -> dict:
    """{config: SASS function name} of the 16 ring_tile kernels."""
    out = {}
    for name in re.findall(r"Function : (\S+)", sass):
        m = re.search(r"ring_tile\w*?ILb([01])ELb([01])ELb([01])ELb([01])E", name)
        if m:
            out[int("".join(m.groups()), 2)] = name
    return out


def _chunk_loop(code: list) -> list:
    """The basic blocks of the loop of chunks, as ``cuda_tools.loop_blocks``
    gives them: the smallest loop (a predicated backward branch) that holds
    nine tenths of the DPX min/max instructions the most holding loop
    does (the claim loop around it holds a few more; the waits inside it
    hold none; the copy of a chunk for a diverged warp, after BRA.DIV, may
    lie outside both)."""
    dpx = [a for a, i in code if cuda_tools.opcode(i).startswith(("VIADDMNMX", "VIMNMX"))]
    loops = [(int(m.group(1), 16), at) for at, ins in code
             for m in [re.search(r"BRA (0x[0-9a-f]+)", ins)]
             if m and int(m.group(1), 16) < at and ins.startswith("@")]
    held = {fl: sum(fl[0] <= a <= fl[1] for a in dpx) for fl in loops}
    if not held or max(held.values()) == 0:
        raise RuntimeError("no loop holds DPX instructions")
    most = max(held.values())
    first, last = min((fl for fl in loops if held[fl] >= 0.9 * most),
                      key=lambda fl: fl[1] - fl[0])
    # cuda_tools.loop_blocks takes the longest loop of the code it is given
    body = [(a, i) for a, i in code if first <= a <= last]
    return cuda_tools.loop_blocks(body)


def _registers(log: str) -> dict:
    """{config: (registers, spill stores, spill loads)} from ptxas's report."""
    out, config = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"ring_tile\w*?ILb([01])ELb([01])ELb([01])ELb([01])E", m.group(1))
            config = int("".join(k.groups()), 2) if k else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and config is not None:
            out.setdefault(config, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and config is not None:
            out.setdefault(config, [0, 0, 0])[0] = int(m.group(1))
    return out


def _sass(other) -> int:
    trees = {"this": os.path.join(HERE, SOURCE)}
    if other:
        trees["other"] = os.path.join(os.path.abspath(other), SOURCE)
    base = open(trees["this"]).read()
    texts = {tag: open(path).read() for tag, path in trees.items()}
    for g in GEOMETRIES:
        texts["geo_" + "_".join(map(str, g))] = _variant(base, g)
    jobs = {}
    for tag, text in texts.items():
        unmasked, k = re.subn(r"chunk\(std::false_type\{\}\);", "chunk(std::true_type{});", text)
        if k != 1:
            raise RuntimeError(f"{tag}: no single masked chunk call to replace")
        like = trees.get(tag, trees["this"])
        jobs[f"sass_{tag}"] = _write(f"sass_{tag}", unmasked, like)
    cubins = _builds(jobs, cubin=True)
    result = {}
    for tag, cubin in cubins.items():
        geometry = None
        text = texts[tag[5:]]
        chunk = int(re.search(r"constexpr int kRingChunk = (\d+);", text).group(1))
        rows = int(re.search(r"constexpr int kRingRows = (\d+);", text).group(1))
        sass = cuda_tools.sass(cubin)
        regs = _registers(open(os.path.join(OUT, f"{tag}.log")).read())
        names = _configs_of(sass)
        per = {}
        for config, name in sorted(names.items()):
            code = cuda_tools.function(sass, name)
            with open(os.path.join(OUT, f"{tag}_config{config}.sass"), "w") as f:
                f.writelines(f"{a:06x} {i}\n" for a, i in code)
            path = cuda_tools.shortest(_chunk_loop(code))
            if path is None:
                per[config] = {"error": "no forward path through the loop"}
                continue
            per[config] = {"per_warp_step": len(path) / chunk,
                           "per_cell": len(path) / chunk / (32 * rows),
                           "registers_spills": regs.get(config),
                           "opcodes": cuda_tools.histogram(path)}
            print(f"[ring sass] {tag} config {config:2d}: {len(path) / chunk:.2f} SASS "
                  f"instructions a warp-step ({32 * rows} cells; "
                  f"{len(path) / chunk / (32 * rows):.3f} a cell), registers and spills "
                  f"{regs.get(config)}", flush=True)
        result[tag] = per
    print(json.dumps(result))
    return 0


def main(args) -> int:
    only = set(WORKLOADS)
    if "--only" in args:
        k = args.index("--only")
        only = set(args[k + 1].split(","))
        if not only <= set(WORKLOADS):
            print(f"--only takes some of {','.join(WORKLOADS)}", file=sys.stderr)
            return 2
        args = args[:k] + args[k + 2:]
    import torch

    if not torch.cuda.is_available():
        print("ring_ab: no CUDA device; this tool runs only on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args == ["--geometry"]:
        return _geometry(dev)
    if args[:1] == ["--sass"] and len(args) <= 2:
        return _sass(args[1] if len(args) == 2 else None)
    if len(args) == 1 and not args[0].startswith("-"):
        return _ab(args[0], only, dev)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
