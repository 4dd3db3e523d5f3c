#!/usr/bin/env python
"""Times the flat wavefront kernel and Myers tier B on two trees of the
repository in turns, on one NVIDIA GPU.

    python3 tools/flat_myers_ab.py OTHER_ROOT

The workloads are ``chip_smoke.py``'s, built by this tree's helpers:
``wavefront_batch`` on phase 4c's long reads (NW with affine gaps -7/-2 and
a 32 x 32 class table on the 96 pairs with a read over 4096 bases) and on
its long pair (100,000 chars, unit costs, all of it through the flat
kernel); ``myers`` on phase 4's ``long`` set as one block (16 x 2048 of
300-4096 bytes), on the tier-B blocks the engine itself launches for it
(each its raw ``sz_myers`` launch, summed, with the segment width
the plan picked), and on phase 4d's CJK-wide set
as one rune block (tier B runes). Each tree runs in its own process, in the
order other, this, this, other: it builds its kernels (into its own
``build/``), checks every result against the plain version on the card
(exact; the long pair against its distance, its 500 flips, which phase 4c
holds against the plain version), and times each call by CUDA events, the
median of 5 batches with their spread. Prints the card's name and power
limit, a line a workload a run and a JSON summary last; exits non-zero if a
run fails.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402


def _flat_workloads(dev):
    """(name, packed pairs, costs) of phase 4c's long reads and long pair."""
    import torch
    from stringzilla_tpu_torch import NeedlemanWunschScores
    from stringzilla_tpu_torch.ops.wavefront import config_costs

    qs, cs = chip_smoke._long_reads(np.random.default_rng(chip_smoke.SEED + 2))
    b2c = np.zeros(256, np.uint8)
    b2c[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    dna = np.full((32, 32), -3, np.int32)
    np.fill_diagonal(dna, 2)
    cfg = NeedlemanWunschScores(b2c, dna, open=-7, extend=-2).config
    ql, cl = np.array([len(q) for q in qs]), np.array([len(c) for c in cs])
    qi, cj = np.nonzero((ql[:, None] > 4096) | (cl[None, :] > 4096))
    strings = [b2c[np.frombuffer(x, np.uint8)] for x in qs + cs]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in strings])[:-1]])
    chars = torch.from_numpy(np.concatenate(strings).astype(np.int32)).to(dev)
    reads = (chars, offs[qi], ql[qi], offs[len(qs) + cj], cl[cj])
    rng = np.random.default_rng(chip_smoke.SEED)  # phase 4c's draws of the long pair
    a = rng.integers(97, 123, chip_smoke.LONG_PAIR).astype(np.uint8)
    b = a.copy()
    b[rng.choice(chip_smoke.LONG_PAIR, 500, replace=False)] ^= 1
    pair = (torch.from_numpy(np.concatenate([a, b]).astype(np.int32)).to(dev), [0], [len(a)],
            [len(a)], [len(b)])
    return [("long reads", reads, config_costs(cfg, torch.from_numpy(dna).to(dev))),
            ("long pair", pair, {})]


def _time_tree(root: str) -> dict:
    """One run on the tree at ``root`` (its package imported from there)."""
    sys.path.insert(0, root)
    import torch
    from stringzilla_tpu_torch import LevenshteinDistances
    from stringzilla_tpu_torch.ops.myers import myers, myers_reference
    from stringzilla_tpu_torch.ops.wavefront import wavefront_batch, wavefront_reference

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    times, extra = {}, {}
    for name, args, kw in _flat_workloads(dev):
        got = wavefront_batch(*args, **kw)
        # the plain version steps the long pair's 200,000 diagonals for
        # minutes: its distance is its 500 flips (phase 4c checks it so)
        want = (wavefront_reference(*args, **kw) if name != "long pair"
                else torch.tensor([500], dtype=torch.int32, device=dev))
        if not torch.equal(got, want):
            raise RuntimeError(f"{root}: wavefront_batch on the {name} != the plain version")
        times[name] = chip_smoke._time_ms(lambda: wavefront_batch(*args, **kw), 3, sync)
    long_q, long_c = chip_smoke.long_strings()
    (_, *cjk), = [s for s in chip_smoke._utf8_sets() if s[0] == "utf8-cjk"]
    blocks = [("long block", chip_smoke.myers_block(long_q, long_c, dev), 256),
              ("cjk-wide runes", chip_smoke.utf8_block(*cjk, dev), None)]
    for name, args, alphabet in blocks:
        got = myers(*args, alphabet=alphabet)
        if not torch.equal(got, myers_reference(*args, alphabet=alphabet)):
            raise RuntimeError(f"{root}: myers on the {name} != the plain version")
        times[name] = chip_smoke._time_ms(lambda: myers(*args, alphabet=alphabet), 10, sync)
    timed = chip_smoke._engine_tier_b(LevenshteinDistances(), long_q, long_c, dev, sync)
    ms = [float(t[3]) for t in timed]
    times["engine tier B"] = chip_smoke.Timing(sum(ms))
    times["engine tier B"].lo = sum(t[3].lo for t in timed)
    times["engine tier B"].hi = sum(t[3].hi for t in timed)
    extra["engine tier B blocks"] = [[r, q, c, float(t), g] for r, q, c, t, _, g in timed]
    return {"root": root, "ms": {k: [float(t), t.lo, t.hi] for k, t in times.items()}, **extra}


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
            print(f"[flat/myers a/b] {root}: {name} {ms:.4f} ms [{lo:.4f}-{hi:.4f}], exact")
        print(f"[flat/myers a/b] {root}: engine tier-B blocks (rows, queries, candidates, ms, "
              f"lanes a candidate) "
              f"{runs[-1]['engine tier B blocks']}")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
