#!/usr/bin/env python
"""Measures the choices the column DP's and hash_long's plans make, on one
NVIDIA GPU: the crossover between the DP's thread and warp routes, the
string length from which hash_long_wide beats the quad kernel, and the
issue rate of the DPX instructions the DP bound counts.

    python3 tools/dp_hash_sweep.py [dp] [hash] [dpx]    (all three when none)

* The DP routes, both forced, on m x m weighted Levenshtein (match 0,
  mismatch 2, affine gaps 3/1, random chars over 4 letters, seed 5) for m =
  64, 128, 256 and 512 at 1,024 to 262,144 pairs, and on ``chip_smoke.py``'s
  proteins (NW, affine -10/-1) at 8,192 to 65,536 pairs (their candidates
  repeated); each line gives both times, the faster route and the one
  ``dp_plan`` picks. The two routes' scores are checked equal.
* ``hash``: ``hash_long``'s two kernels, each forced by setting
  ``WIDE_BYTES`` past every string or under all of them, on random strings
  of 256 B to 64 KiB, in batches of 64 MiB (the card full) and of 1,056
  strings (8 an SM); each line gives both times and the faster kernel, and
  both kernels' digests are checked equal to the plain version's. Then both
  on phase 4f's documents (1,000 x 100 KB and one 3 MiB string) and on the
  lines of its 256 MiB log.
* ``dpx``: ``tools/dpx_rate.cu``, built with ``nvcc``, runs chains of
  ``__viaddmin_s32``, ``__viaddmax_s32_relu`` and a plain int32 min on one
  CTA of 1,024 threads an SM and prints each one's rate in operations an SM
  a clock (from the SMs' own clock counters), and the SASS instructions
  each kernel compiled to.

Times are medians of CUDA-event batches with their spread. Prints the
card's name and power limit first and a JSON summary last.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402
from dp_hash_ab import _dp_workloads, _hash_workloads  # noqa: E402
from stringzilla_tpu_torch.ops import hash_kernel  # noqa: E402
from stringzilla_tpu_torch.ops.hash_kernel import hash_long, hash_long_reference  # noqa: E402
from stringzilla_tpu_torch.ops.similarity import (AffineGaps, SimilarityConfig,  # noqa: E402
                                                  UniformCosts)
from stringzilla_tpu_torch.ops.similarity_dp import ROUTES, dp_plan, similarity  # noqa: E402


def _routes(name, args, cfg, table, sync, sms, summary):
    """Both routes on one block: their times, the faster one and the plan's."""
    got = {r: similarity(*args, cfg, table, route=r) for r in ROUTES}
    if not torch.equal(got["thread"], got["warp"]):
        raise RuntimeError(f"{name}: the thread and warp routes differ")
    ms = {r: chip_smoke._time_ms(lambda: similarity(*args, cfg, table, route=r), 3, sync, 3)
          for r in ROUTES}
    rows, nq = args[0].shape
    cand_len, nc = args[2].shape
    pick = dp_plan(rows, nq, cand_len, nc, cfg.is_affine, sms).route
    faster = min(ms, key=ms.get)
    print(f"[dp routes] {name} pairs={nq * nc}: thread {ms['thread']:.4f} ms "
          f"[{ms['thread'].lo:.4f}-{ms['thread'].hi:.4f}], warp {ms['warp']:.4f} ms "
          f"[{ms['warp'].lo:.4f}-{ms['warp'].hi:.4f}]; faster {faster}; plan {pick}")
    summary.append({"block": name, "pairs": nq * nc, "thread_ms": float(ms["thread"]),
                    "warp_ms": float(ms["warp"]), "faster": faster, "plan": pick})


def _forced(kernel, args):
    """``hash_long`` with every long string routed to ``kernel``."""
    saved = hash_kernel.WIDE_BYTES
    hash_kernel.WIDE_BYTES = 65 if kernel == "hash_long_wide" else 1 << 62
    try:
        return hash_long(*args, 0, quad=kernel == "hash_long", wide=kernel == "hash_long_wide")
    finally:
        hash_kernel.WIDE_BYTES = saved


def _hash_kernels(dev, sync, summary):
    """Both long-path kernels on batches of one length, and on 4f's data."""
    import torch

    kernels = ("hash_long", "hash_long_wide")
    blocks = []
    for length in (256, 1024, 2048, 4096, 8192, 16384, 65536):
        for count, label in (((64 << 20) // length, "64 MiB"), (1056, "1,056 strings")):
            gen = torch.Generator(device=dev).manual_seed(length + count)
            blob = torch.randint(0, 256, (count * length + 1,), dtype=torch.uint8, device=dev,
                                 generator=gen)
            starts = torch.arange(count, dtype=torch.int64, device=dev) * length
            lengths = torch.full((count,), length, dtype=torch.int64, device=dev)
            blocks.append((f"{count} x {length} B ({label})", (blob, starts, lengths)))
    blocks += _hash_workloads(dev, HERE)
    for label, args in blocks:
        want = hash_long_reference(*args, 0)
        ms = {}
        for kernel in kernels:
            if not torch.equal(_forced(kernel, args), want):
                raise RuntimeError(f"{kernel} on {label} != the plain version")
            ms[kernel] = chip_smoke._time_ms(lambda k=kernel: _forced(k, args), 3, sync, 3)
        faster = min(ms, key=ms.get)
        print(f"[hash kernels] {label}: hash_long {ms['hash_long']:.4f} ms "
              f"[{ms['hash_long'].lo:.4f}-{ms['hash_long'].hi:.4f}], hash_long_wide "
              f"{ms['hash_long_wide']:.4f} ms [{ms['hash_long_wide'].lo:.4f}-"
              f"{ms['hash_long_wide'].hi:.4f}]; faster {faster}")
        summary.append({"block": label, **{k: float(v) for k, v in ms.items()},
                        "faster": faster})
        del args, want


def _dpx_rates(summary):
    """Operations an SM a clock of tools/dpx_rate.cu's three kernels."""
    import ctypes

    import torch

    out_dir = os.path.join(HERE, "build", "dpx_rate")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "dpx_rate.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, os.path.join(HERE, "tools", "dpx_rate.cu")],
                   check=True, timeout=300)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
                          capture_output=True, text=True, timeout=120).stdout
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.sz_dpx_rate.argtypes = [ctypes.c_int] * 4 + [p, p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, chains, threads = 1 << 16, 8, 1024
    out = torch.empty(sms * threads, dtype=torch.int32, device="cuda")
    clocks = torch.empty(sms, dtype=torch.int64, device="cuda")
    for op, name in enumerate(("__viaddmin_s32", "__viaddmax_s32_relu", "int32 min")):
        for _ in range(2):  # the first run warms the clocks up
            err = lib.sz_dpx_rate(op, sms, iters, 3, out.data_ptr(), clocks.data_ptr())
            if err:
                raise RuntimeError(f"dpx_rate {name}: CUDA error {err}")
        cycles = clocks.double()
        rate = threads * iters * chains / cycles
        print(f"[dpx] {name}: {float(rate.median()):.2f} operations an SM a clock "
              f"(SMs {float(rate.min()):.2f}-{float(rate.max()):.2f}), {sms} SMs x {threads} "
              f"threads x {chains} chains x {iters} steps")
        summary.append({"op": name, "per_sm_clock": float(rate.median())})
    counts = {ins: sass.count(ins) for ins in ("VIADDMNMX", "IMNMX", "VIMNMX")}
    print(f"[dpx] SASS instructions in dpx_rate.so: {counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_hash_sweep: no CUDA device", file=sys.stderr)
        return 1
    parts = set(sys.argv[1:]) or {"dp", "hash", "dpx"}
    if parts - {"dp", "hash", "dpx"}:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    routes, hashes, dpx = [], [], []

    if "dp" in parts:
        cfg = SimilarityConfig("min", "global", AffineGaps(3, 1), UniformCosts(0, 2))
        rng = np.random.default_rng(5)
        for m in (64, 128, 256, 512):
            for nq, nc in ((16, 64), (16, 256), (16, 1024), (64, 1024), (64, 4096)):
                q_t = np.zeros((m + 8, nq), np.int32)
                q_t[1: m + 1] = rng.integers(97, 101, (m, nq))
                args = [torch.from_numpy(q_t).to(dev),
                        torch.full((nq, 1), m, dtype=torch.int32, device=dev),
                        torch.from_numpy(rng.integers(97, 101, (m, nc)).astype(np.int32)).to(dev),
                        torch.full((1, nc), m, dtype=torch.int32, device=dev)]
                _routes(f"weighted m=n={m}", args, cfg, None, sync, sms, routes)
        name, cfg, (q, ql, c, cl), table = _dp_workloads(dev)[2]  # the proteins, NW affine
        for reps in (1, 2, 4, 8):
            args = (q, ql, c.repeat(1, reps).contiguous(), cl.repeat(1, reps).contiguous())
            _routes(f"proteins {name}", args, cfg, table, sync, sms, routes)
    if "hash" in parts:
        _hash_kernels(dev, sync, hashes)
    if "dpx" in parts:
        _dpx_rates(dpx)
    print(json.dumps({"card": card, "routes": routes, "hash_kernels": hashes, "dpx": dpx}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
