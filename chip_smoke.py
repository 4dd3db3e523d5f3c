#!/usr/bin/env python
"""Smoke run of stringzilla_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit.
2. Build: compiles ``stringzilla_tpu_torch/csrc/*.cu`` with ``nvcc`` into
   ``build/stringzilla_tpu_torch/`` and prints the time and ptxas report.
3. Kernel vs plain version on the card: ``ops.myers.myers`` against
   ``myers_reference`` on the same device tensors, exact int32 equality, at
   both kernel tiers (1-4 words per thread; 5-64 words per warp), word
   boundary lengths, empty strings and out-of-range char values.
4. Main path: ``LevenshteinDistances()`` through the default scope on the
   ``bench.py`` workload (128 x 32768 lowercase lines, lengths N(100, 12.5)
   clipped to [8, 128], seed ``STRINGWARS_SEED`` = 42) and on long queries
   (16 x 2048, lengths uniform in 300-4096). Launch counts are reset just
   before these two calls and read just after. Each result must equal the
   plain version on the same packed device inputs and Wagner-Fischer on
   sampled pairs. Then times the engine (host pull included), the kernel
   alone and the plain version, in GCUPS (sum of len_q * len_c per second).

Prints one JSON line of per-kernel results, then, last, the device line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = int(os.environ.get("STRINGWARS_SEED", "42"))


def _check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _wagner_fischer(a: bytes, b: bytes) -> int:
    """Row-at-a-time Wagner-Fischer in numpy: the in-row dependency
    cur[j] = min(x[j], cur[j-1] + 1) is solved exactly as a running minimum
    of x[j] - j, plus j."""
    a = np.frombuffer(a, np.uint8)
    b = np.frombuffer(b, np.uint8)
    j = np.arange(len(b) + 1, dtype=np.int64)
    prev = j.copy()
    for i in range(1, len(a) + 1):
        x = np.empty_like(prev)
        x[0] = i
        x[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(x - j) + j
    return int(prev[-1])


def _block(rng, q_lens, c_lens, rows, cand_len, lo, hi):
    """Random query/candidate blocks in the ``myers`` layouts; every third
    candidate is a mutated copy of a query, so distances span small to
    large."""
    nq, nc = len(q_lens), len(c_lens)
    q_t = np.full((rows, nq), -1, np.int32)
    for i, m in enumerate(q_lens):
        q_t[:m, i] = rng.integers(lo, hi, m)
    c_t = np.zeros((cand_len, nc), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = rng.integers(lo, hi, n)
        if j % 3 == 0 and nq:
            src = q_t[: q_lens[j % nq], j % nq]
            k = min(n, len(src))
            keep = rng.random(k) > 0.1
            c_t[:k, j] = np.where(keep, src[:k], c_t[:k, j])
    return (q_t, np.asarray(q_lens, np.int32).reshape(-1, 1), c_t,
            np.asarray(c_lens, np.int32).reshape(1, -1))


def _time_ms(fn, iters, sync):
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from stringzilla_tpu_torch import LevenshteinDistances, Tape
    from stringzilla_tpu_torch.ops import myers as myers_mod
    from stringzilla_tpu_torch.ops.myers import myers, myers_reference, words_of
    from stringzilla_tpu_torch.ops.pack_device import device_tape, pack_chars
    from stringzilla_tpu_torch.utils import cuda_build
    from tests.oracles import levenshtein

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # -- phase 1: device ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} capability "
          f"{torch.cuda.get_device_capability(0)}")

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load()
    print(f"[build] csrc/*.cu -> sm_90a in {time.perf_counter() - t0:.3f} s")
    for line in cuda_build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # -- phase 3: kernel vs plain version ------------------------------------
    rng = np.random.default_rng(SEED)
    cases = [  # name, query lengths, candidate lengths, rows, cand_len, chars
        ("w1 abcd", rng.integers(0, 65, 6), rng.integers(0, 101, 300), 64, 100, (97, 101)),
        ("w2 bytes+out-of-range", rng.integers(0, 129, 6), rng.integers(0, 161, 300), 128, 160, (-2, 260)),
        ("w3 ab", rng.integers(0, 193, 5), rng.integers(0, 201, 257), 192, 200, (97, 99)),
        ("w4 lower", rng.integers(0, 257, 5), rng.integers(0, 301, 300), 256, 300, (97, 123)),
        ("w8 ab", rng.integers(257, 513, 4), rng.integers(0, 601, 99), 512, 600, (97, 99)),
        ("w33 lower", rng.integers(2049, 2113, 3), rng.integers(0, 2200, 40), 2112, 2200, (97, 123)),
        ("w64 bytes", rng.integers(3000, 4097, 3), rng.integers(0, 4097, 40), 4096, 4096, (0, 256)),
        ("bounds w1", [0, 1, 63, 64], [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257], 64, 257, (97, 99)),
        ("bounds w2", [0, 63, 64, 65, 127, 128], [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257], 128, 257, (97, 99)),
        ("bounds w4", [0, 127, 128, 129, 255, 256], [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257], 256, 257, (97, 99)),
        ("bounds w8", [255, 256, 257, 511, 512], [0, 1, 255, 256, 257, 511, 512, 513], 512, 513, (97, 99)),
        ("bounds w64", [0, 257, 2047, 2048, 2049, 4095, 4096], [0, 1, 64, 257, 2048, 4095, 4096], 4096, 4096, (97, 99)),
    ]
    max_err = {"myers_tier_a": 0, "myers_tier_b": 0}
    for name, q_lens, c_lens, rows, cand_len, (lo, hi) in cases:
        args = [torch.from_numpy(x).to(dev) for x in
                _block(rng, q_lens, c_lens, rows, cand_len, lo, hi)]
        got = myers(*args)
        want = myers_reference(*args)
        sync()
        err = int((got.long() - want.long()).abs().max())
        tier = "myers_tier_a" if words_of(rows) <= 4 else "myers_tier_b"
        max_err[tier] = max(max_err[tier], err)
        print(f"[kernel] {name:22s} {tier} rows={rows} cand_len={cand_len} "
              f"{len(q_lens)}x{len(c_lens)} max_abs_err={err}")
        _check(torch.equal(got, want), f"kernel != plain version in case {name}")

    # -- phase 4: the main path through the engine --------------------------
    rng = np.random.default_rng(SEED)  # bench.py's draws, in bench.py's order

    def make_batch(count, maxlen, mean_len=100):
        lens = np.clip(rng.normal(mean_len, mean_len / 8, count).astype(np.int32),
                       8, maxlen)
        chars = rng.integers(97, 123, size=(maxlen, count), dtype=np.int32)
        return [chars[: lens[i], i].astype(np.uint8).tobytes()
                for i in range(count)]

    head_q = make_batch(128, 128)
    head_c = make_batch(32768, 128)
    long_rng = np.random.default_rng(SEED + 1)
    long_q = [long_rng.integers(97, 123, n).astype(np.uint8).tobytes()
              for n in long_rng.integers(300, 4097, 16)]
    long_c = []
    for j, n in enumerate(long_rng.integers(300, 4097, 2048)):
        chars = long_rng.integers(97, 123, n).astype(np.uint8)
        if j % 4 == 0:  # near-duplicates of a query as well as random lines
            src = np.frombuffer(long_q[j % 16], np.uint8)[:n]
            keep = long_rng.random(len(src)) > 0.05
            chars[: len(src)] = np.where(keep, src, chars[: len(src)])
        long_c.append(chars.tobytes())

    engine = LevenshteinDistances()
    sync()
    for k in myers_mod.KERNEL_LAUNCHES:
        myers_mod.KERNEL_LAUNCHES[k] = 0
    head = engine(head_q, head_c)
    long_ = engine(long_q, long_c)
    launches = dict(myers_mod.KERNEL_LAUNCHES)
    print(f"[engine] launches on the main path: {launches}")
    for k, n in launches.items():
        _check(n > 0, f"{k} was not launched on the main path")

    report = {}
    for name, qs, cs, res, n_wf, tier in (
            ("headline", head_q, head_c, head, 256, "myers_tier_a"),
            ("long", long_q, long_c, long_, 16, "myers_tier_b")):
        _check(res.dtype == np.uint64 and res.shape == (len(qs), len(cs)),
               f"{name}: result {res.dtype} {res.shape}")
        # the same packed device inputs for the kernel alone and the plain
        # version: one block of every query and one of every candidate
        rows = max(32, -(-max(map(len, qs)) // 32) * 32)
        cand_len = max(map(len, cs))
        qdt = device_tape(Tape.from_strings(qs), dev)
        cdt = device_tape(Tape.from_strings(cs), dev)
        q_offs, q_lens = qdt.bucket_arrays(np.arange(len(qs)))
        c_offs, c_lens = cdt.bucket_arrays(np.arange(len(cs)))
        packed = (pack_chars(qdt.data, q_offs, q_lens, row_len=rows,
                             transpose=True, fill=-1), q_lens.view(-1, 1),
                  pack_chars(cdt.data, c_offs, c_lens, row_len=cand_len,
                             transpose=True, fill=0), c_lens.view(1, -1))
        plain = myers_reference(*packed)
        _check(np.array_equal(res.astype(np.int64), plain.cpu().numpy()),
               f"{name}: engine result != plain version on the card")
        pick = np.random.default_rng(SEED + 2)
        wf = levenshtein if name == "headline" else _wagner_fischer
        for i, j in zip(pick.integers(0, len(qs), n_wf), pick.integers(0, len(cs), n_wf)):
            _check(int(res[i, j]) == wf(qs[i], cs[j]),
                   f"{name}: pair ({i}, {j}) != Wagner-Fischer")
        print(f"[engine] {name}: {len(qs)}x{len(cs)} equals the plain version "
              f"and Wagner-Fischer on {n_wf} pairs")

        cells = float(sum(map(len, qs))) * float(sum(map(len, cs)))
        t0 = time.perf_counter()
        engine_runs = 3
        for _ in range(engine_runs):
            engine(qs, cs)
        engine_s = (time.perf_counter() - t0) / engine_runs
        kernel_ms = _time_ms(lambda: myers(*packed), 10, sync)
        plain_ms = _time_ms(lambda: myers_reference(*packed), 1, sync)
        report[tier] = (kernel_ms, plain_ms)
        print(f"[perf] {name} rows={rows} cand_len={cand_len} cells={cells:.0f}: "
              f"engine+pull {engine_s * 1e3:.3f} ms = {cells / engine_s / 1e9:.3f} GCUPS; "
              f"kernel {kernel_ms:.4f} ms = {cells / kernel_ms / 1e6:.3f} GCUPS; "
              f"plain {plain_ms:.3f} ms = {cells / plain_ms / 1e6:.3f} GCUPS")

    # -- report ---------------------------------------------------------------
    replaces = {"myers_tier_a": "stringzilla_tpu/ops/myers_pallas.py:396",
                "myers_tier_b": "stringzilla_tpu/ops/myers_pallas.py:89"}
    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": "stringzilla_tpu_torch/csrc/myers.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": max_err[k], "ms": report[k][0],
         "plain_ms": report[k][1]} for k in replaces]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
