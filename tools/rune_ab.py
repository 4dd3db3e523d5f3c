#!/usr/bin/env python
"""Times the Myers kernel's rune route, and its byte route beside it, on two
trees of the repository in turns, on one NVIDIA GPU.

    python3 tools/rune_ab.py OTHER_ROOT

The workloads are ``chip_smoke.py``'s, built by this tree's helpers:
phase 4d's mixed-script and CJK-wide sets each as one rune block (tier A
runes on the mixed one's 128 rows, tier B runes on the CJK one's 416), the
rune blocks the engine itself launches on both sets (the CJK set's 128-
and 256-row blocks on tier A, its 512-row ones on tier B), and phase 4's
``headline`` and ``long`` byte sets as one block each (tier A and tier B
over bytes). Each block is timed by its raw launch (``sz_myers_runes`` or
``sz_myers`` with the tables, the candidates' order and the segment width
made beforehand: ``chip_smoke.rune_launch``, ``chip_smoke.tier_b_launch``)
and through the ``myers`` wrapper, which builds them each call; the
engine's blocks by raw launch, one by one and summed a tier; and the byte
route on the rune blocks' shapes (each rune's low byte), the rune route's
time less its lookup. Each tree runs in its own
process, in the order other, this, this, other: it builds its kernels (into
its own ``build/``), checks every result against the plain version on the
card (exact), and times each launch by CUDA events, the median of 5 batches
with their spread. Prints the card's name and power limit, a line a
workload a run, each workload's ratio of the other tree's time to this
one's (the medians of each tree's two runs), and a JSON summary last;
exits non-zero if a run fails.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402


def _time_tree(root: str) -> dict:
    """One run on the tree at ``root`` (its package imported from there)."""
    sys.path.insert(0, root)
    import torch
    from stringzilla_tpu_torch import LevenshteinDistancesUTF8
    from stringzilla_tpu_torch.ops.myers import myers, myers_reference

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    times = {}

    def timed(name, fn, out, want):
        if not torch.equal(out, want):
            raise RuntimeError(f"{root}: {name} != the plain version")
        times[name] = chip_smoke._time_ms(fn, 10, sync)
        fn()
        sync()
        if not torch.equal(out, want):
            raise RuntimeError(f"{root}: {name} != the plain version after timing")

    engine = LevenshteinDistancesUTF8()
    for name, qs, cs in chip_smoke._utf8_sets():
        block = chip_smoke.utf8_block(qs, cs, dev)
        want = myers_reference(*block, alphabet=None)
        launch, out = chip_smoke.rune_launch(block, dev)
        launch()
        timed(f"{name} raw", launch, out, want)
        timed(f"{name} wrapper", lambda: myers(*block, alphabet=None),
              myers(*block, alphabet=None), want)
        # the byte route on the same shapes, each rune's low byte: the rune
        # route's time less its lookup
        q_t, qlens, cands_t, clens = block
        as_bytes = (torch.where(q_t >= 0, q_t & 0xFF, -1), qlens, cands_t & 0xFF, clens)
        launch, out = chip_smoke.tier_b_launch(as_bytes, dev)
        launch()
        timed(f"{name} as bytes raw", launch, out, myers_reference(*as_bytes))
        engine_blocks = chip_smoke._engine_runes(engine, qs, cs, dev, sync)
        for tier in ("myers_tier_a_runes", "myers_tier_b_runes"):
            mine = [t for t in engine_blocks if t[0] == tier]
            if mine:
                t = chip_smoke.Timing(sum(m[4] for m in mine))
                t.lo, t.hi = sum(m[4].lo for m in mine), sum(m[4].hi for m in mine)
                times[f"{name} engine {tier} x{len(mine)}"] = t
            for _, rows, nq, nc, t, _, _ in mine:
                times[f"{name} engine {rows} rows {nq}x{nc}"] = t
    for name, (qs, cs) in (("headline", chip_smoke.headline_strings()),
                           ("long", chip_smoke.long_strings())):
        block = chip_smoke.myers_block(qs, cs, dev)
        want = myers_reference(*block)
        launch, out = chip_smoke.tier_b_launch(block, dev)
        launch()
        timed(f"{name} bytes raw", launch, out, want)
        timed(f"{name} bytes wrapper", lambda: myers(*block), myers(*block), want)
    return {"root": root, "ms": {k: [float(t), t.lo, t.hi] for k, t in times.items()}}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_time_tree(os.path.abspath(sys.argv[2]))))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here, other = HERE, os.path.abspath(sys.argv[1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        for name, (ms, lo, hi) in runs[-1]["ms"].items():
            print(f"[rune a/b] {root}: {name} {ms:.4f} ms [{lo:.4f}-{hi:.4f}], exact")
    ratios = {}
    for name in runs[1]["ms"]:
        theirs = np.median([r["ms"][name][0] for r in (runs[0], runs[3])])
        ours = np.median([r["ms"][name][0] for r in (runs[1], runs[2])])
        ratios[name] = float(theirs / ours)
        print(f"[rune a/b] {name}: other {theirs:.4f} ms, this {ours:.4f} ms, "
              f"other / this {theirs / ours:.3f}")
    print(json.dumps({"card": card, "runs": runs, "other_over_this": ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
