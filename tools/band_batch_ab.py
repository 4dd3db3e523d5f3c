#!/usr/bin/env python
"""Times the band kernel on a batch of 64 long pairs, on two trees of the
repository in turns, on one NVIDIA GPU.

    python3 tools/band_batch_ab.py OTHER_ROOT

The batch: ``chip_smoke.band_batch_strings()`` of this tree, 8 x 8
strings, each a copy of one 20,000-char lowercase string (seed 51) with
100 random positions flipped by ``^= 1``, every query against every
candidate (distances up to 200: two rungs from the default first rung of
64). Each tree runs in its own
process, in the order other, this, this, other: it builds its kernels (into
its own ``build/``), checks that ``band_batch`` certifies every pair with
the distance its flat kernel ``wavefront_batch`` gives, and times
``band_batch`` by CUDA events, the median of 5 batches of 5 calls with
their spread. Prints the card's name and power limit, a line per run and a
JSON summary last; exits non-zero if a run fails.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import band_batch_strings  # noqa: E402


def _time_tree(root: str) -> dict:
    """One run on the tree at ``root`` (its package imported from there)."""
    sys.path.insert(0, root)
    import torch
    from stringzilla_tpu_torch.ops.wavefront import band_batch, wavefront_batch

    qs, cs = band_batch_strings()
    strings = [np.frombuffer(x, np.uint8) for x in qs + cs]
    lens = np.array([len(x) for x in strings])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    qi, cj = (x.reshape(-1) for x in np.meshgrid(np.arange(len(qs)), np.arange(len(cs)),
                                                 indexing="ij"))
    dev = torch.device("cuda", 0)
    chars = torch.from_numpy(np.concatenate(strings).astype(np.int32)).to(dev)
    cols = (chars, offs[qi], lens[qi], offs[len(qs) + cj], lens[len(qs) + cj])
    got = band_batch(*cols)
    flat = wavefront_batch(*cols)
    torch.cuda.synchronize()
    if not (bool((got[:, 1] == 1).all()) and torch.equal(got[:, 0], flat.long())):
        raise RuntimeError(f"{root}: band_batch {got[:, :2].tolist()} != flat {flat.tolist()}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        for _ in range(5):
            band_batch(*cols)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 5)
    return {"root": root, "ms": float(np.median(times)), "lo": min(times), "hi": max(times),
            "pairs": len(qi), "max_distance": int(got[:, 0].max()),
            "last_k": sorted(set(got[:, 2].tolist()))}


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
        r = runs[-1]
        print(f"[band batch] {r['root']}: band_batch on {r['pairs']} pairs {r['ms']:.4f} ms "
              f"[{r['lo']:.4f}-{r['hi']:.4f}], distances up to {r['max_distance']}, "
              f"last k {r['last_k']}")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
