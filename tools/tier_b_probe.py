#!/usr/bin/env python
"""Times Myers tier B in each of its segment widths
(``ops.myers.TIER_B_SEGMENTS``: 8 and 32 lanes a candidate) on one NVIDIA
GPU: the measurement behind ``ops.myers.TIER_B_WIDEN_BELOW``, the warps an
SM below which ``tier_b_plan`` widens a launch's segments.

    python3 tools/tier_b_probe.py

Workloads, built by ``chip_smoke.py``'s helpers: phase 4's ``long`` set as
one block (16 x 2048 of 300-4096 bytes), the tier-B blocks the engine
itself launches for it (each its raw ``sz_myers`` launch), and phase 4d's
CJK-wide set as one rune block. Each runs with the width forced to each
of them, and every result is checked against the plain version on the
card. Times are CUDA-event medians of 5 batches with their spread, beside
each launch's warps and the plan's own pick. Prints the card's name and
power limit first and a JSON summary last.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    from stringzilla_tpu_torch import LevenshteinDistances
    from stringzilla_tpu_torch.ops import myers as myers_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_out = []

    def report(name, words, nq, nc, seg, ms):
        warps = nq * -(-nc * seg // 32)
        pick = myers_mod.tier_b_plan(words, nq, nc, sms)
        rows_out.append([name, words, nq, nc, seg, warps, float(ms), ms.lo, ms.hi, pick])
        print(f"[tier B] {name} ({words} words, {nq}x{nc}) S={seg}: {warps} warps, "
              f"{float(ms):.4f} ms [{ms.lo:.4f}-{ms.hi:.4f}], exact; the plan picks {pick}",
              flush=True)

    long_q, long_c = chip_smoke.long_strings()
    (_, *cjk), = [s for s in chip_smoke._utf8_sets() if s[0] == "utf8-cjk"]
    blocks = [("long block", chip_smoke.myers_block(long_q, long_c, dev), 256),
              ("cjk-wide runes", chip_smoke.utf8_block(*cjk, dev), None)]
    for name, args, alphabet in blocks:
        want = myers_mod.myers_reference(*args, alphabet=alphabet)
        (rows, nq), (_, nc) = args[0].shape, args[2].shape
        for seg in myers_mod.TIER_B_SEGMENTS:
            with chip_smoke._tier_b_segments(seg):
                if not torch.equal(myers_mod.myers(*args, alphabet=alphabet), want):
                    raise RuntimeError(f"tier B at S={seg} on the {name} != the plain version")
                ms = chip_smoke._time_ms(lambda: myers_mod.myers(*args, alphabet=alphabet), 10,
                                         sync)
            report(name, myers_mod.words_of(rows), nq, nc, seg, ms)
    engine = LevenshteinDistances()
    for seg in myers_mod.TIER_B_SEGMENTS:
        timed = chip_smoke._engine_tier_b(
            engine, long_q, long_c, dev, sync,
            lambda block, d, seg=seg: chip_smoke.tier_b_launch(block, d, seg))
        for rows, nq, nc, ms, _, _ in timed:
            report(f"engine {rows}-row block", myers_mod.words_of(rows), nq, nc, seg, ms)
        print(f"[tier B] the engine's {len(timed)} blocks at S={seg}: "
              f"{sum(float(t[3]) for t in timed):.4f} ms summed", flush=True)
    print(json.dumps({"card": card, "sms": sms, "rows": rows_out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
