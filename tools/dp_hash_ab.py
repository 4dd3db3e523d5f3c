#!/usr/bin/env python
"""Times the column DP and hash_long on two trees of the repository in
turns, on one NVIDIA GPU.

    python3 tools/dp_hash_ab.py OTHER_ROOT

The workloads are ``chip_smoke.py``'s, built by this tree's helpers:
``similarity`` on phase 4b's five (NW and SW with linear gaps -5 and affine
gaps -10/-1 on 16 x 512 proteins with a 32 x 32 table, and weighted
Levenshtein (0, 2, 3, 1) on 64 x 4096 lines), each block packed as the
engines pack it; ``hash_long`` on phase 4f's documents (1,000 x 100 KB and
one 3 MiB string) and on the lines of its 256 MiB log, launching the
kernels that ``Strs.hashes`` would launch. Each tree runs in its
own process, in the order other, this, this, other: it builds its kernels
(into its own ``build/``), checks every result against the plain version on
the card (exact), and times each call by CUDA events, the median of 5
batches with their spread. Prints the card's name and power limit, a line a
workload a run and a JSON summary last; exits non-zero if a run fails.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402


def _dp_workloads(dev):
    """(name, config, packed inputs, table) of phase 4b's five workloads."""
    import torch
    from stringzilla_tpu_torch import (LevenshteinDistances, NeedlemanWunschScores,
                                       SmithWatermanScores, Tape)
    from stringzilla_tpu_torch.ops.pack_device import device_tape, pack_chars

    b2c, table, prot_q, prot_c = chip_smoke._proteins(np.random.default_rng(chip_smoke.SEED))
    line_q, line_c = chip_smoke._lines(np.random.default_rng(chip_smoke.SEED))

    def packed(qs, cs, to_chars):
        rows = -(-(max(map(len, qs)) + 1) // 8) * 8
        qdt = device_tape(Tape.from_strings([to_chars(q) for q in qs]), dev)
        cdt = device_tape(Tape.from_strings([to_chars(c) for c in cs]), dev)
        q_offs, q_lens = qdt.bucket_arrays(np.arange(len(qs)))
        c_offs, c_lens = cdt.bucket_arrays(np.arange(len(cs)))
        return (pack_chars(qdt.data, q_offs, q_lens, row_len=rows - 1, transpose=True, fill=0,
                           shift=True), q_lens.view(-1, 1),
                pack_chars(cdt.data, c_offs, c_lens, row_len=max(map(len, cs)), transpose=True,
                           fill=0), c_lens.view(1, -1))

    prot = packed(prot_q, prot_c, lambda s: b2c[np.frombuffer(s, np.uint8)].tobytes())
    lines = packed(line_q, line_c, lambda s: s)
    tab = torch.from_numpy(table).to(dev)
    return [
        ("nw-linear", NeedlemanWunschScores(b2c, table, open=-5, extend=-5).config, prot, tab),
        ("sw-linear", SmithWatermanScores(b2c, table, open=-5, extend=-5).config, prot, tab),
        ("nw-affine", NeedlemanWunschScores(b2c, table, open=-10, extend=-1).config, prot, tab),
        ("sw-affine", SmithWatermanScores(b2c, table, open=-10, extend=-1).config, prot, tab),
        ("lev-weighted", LevenshteinDistances(match=0, mismatch=2, open=3, extend=1).config,
         lines, None),
    ]


def _hash_workloads(dev, root):
    """(name, (blob, starts, lengths)) of phase 4f's documents and log lines."""
    import torch

    drng = np.random.default_rng(chip_smoke.SEED + 43)
    count, size = chip_smoke.DOCS
    docs = drng.integers(0, 256, count * size, dtype=np.uint8).tobytes()
    big = drng.integers(0, 256, chip_smoke.DOC_BIG, dtype=np.uint8).tobytes()
    lens = np.array([size] * count + [chip_smoke.DOC_BIG], np.int64)
    blob = np.frombuffer(docs + big + b"\0", np.uint8)
    doc_args = (torch.from_numpy(blob.copy()).to(dev),
                torch.from_numpy(np.concatenate([[0], np.cumsum(lens)[:-1]])).to(dev),
                torch.from_numpy(lens).to(dev))
    path = os.path.join(root, "build", "dp_hash_ab_log.txt")
    try:
        body = np.frombuffer(chip_smoke._write_log(path), np.uint8)
    finally:
        if os.path.exists(path):
            os.unlink(path)
    ends = np.flatnonzero(body == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    line_args = (torch.from_numpy(np.append(body, np.uint8(0))).to(dev),
                 torch.from_numpy(starts).to(dev),
                 torch.from_numpy(ends - starts).to(dev))
    return [("documents", doc_args), ("lines", line_args)]


def _time_tree(root: str) -> dict:
    """One run on the tree at ``root`` (its package imported from there)."""
    sys.path.insert(0, root)
    import torch
    from stringzilla_tpu_torch.ops import hash_kernel
    from stringzilla_tpu_torch.ops.hash_kernel import hash_long, hash_long_reference
    from stringzilla_tpu_torch.ops.similarity import similarity_reference
    from stringzilla_tpu_torch.ops.similarity_dp import similarity

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    times = {}
    for name, cfg, args, tab in _dp_workloads(dev):
        got = similarity(*args, cfg, tab)
        if not torch.equal(got, similarity_reference(*args, cfg, tab)):
            raise RuntimeError(f"{root}: similarity on {name} != the plain version")
        times[name] = chip_smoke._time_ms(lambda: similarity(*args, cfg, tab), 5, sync)
    for name, args in _hash_workloads(dev, root):
        # the kernels a tree with two long-path kernels launches, read from
        # host lengths as its Strs.hashes reads them
        kw = {}
        if hasattr(hash_kernel, "kernel_routes"):
            routes = hash_kernel.kernel_routes(args[2].cpu().numpy())
            kw = {"quad": routes["quad"], "wide": routes["wide"]}
        got = hash_long(*args, 0, **kw)
        if not torch.equal(got, hash_long_reference(*args, 0)):
            raise RuntimeError(f"{root}: hash_long on the {name} != the plain version")
        times[name] = chip_smoke._time_ms(lambda: hash_long(*args, 0, **kw), 3, sync)
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
            print(f"[dp/hash a/b] {root}: {name} {ms:.4f} ms [{lo:.4f}-{hi:.4f}], exact")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
