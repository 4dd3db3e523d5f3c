#!/usr/bin/env python
"""Times the MinHash kernel on two trees of the repository in turns, on one
NVIDIA GPU; or probes this tree's plan constants.

    python3 tools/minhash_ab.py OTHER_ROOT
    python3 tools/minhash_ab.py --probe
    python3 tools/minhash_ab.py --unroll

The workloads are ``chip_smoke.py``'s phase 4d, built by this tree's
helpers: ``Fingerprints(ndim=256, seed=42)``'s parameters on
``bench_fingerprints``' lines (32,768 docs of 60-179 printable bytes) and on
2,048 web-page-sized docs of 2-16 KB; and, in the A/B, the documents under
256 dimensions of one width each, 64 and 512 (``window_widths=(64,)``,
``(512,)``: widths wider than the default halo). Each tree runs in its own process, in
the order other, this, this, other: it builds its kernels (into its own
``build/``), checks ``fingerprint_all``'s result against its plain version
``fingerprint_reference`` on the card (exact), and times
``fingerprint_all`` called as that tree's ``Fingerprints`` calls it (host
starts and lengths and parameters prepared once where the tree takes them,
device ones where it does not) by CUDA events, the median of 5 batches of
10 with their spread; where the tree has the planned kernels
(``minhash_plan``), also their raw launches with the plan made once.
``--probe`` times this tree's two kernels, by raw launch, under the plans
that ``CTAS_PER_SM`` of 4, 8, 16, 32, 64, ``UNIT_SHARE`` of 2, 4, 8 and
``UNIT_MIN`` of 128, 256, 512, 1024 give (a plan timed once however many
settings give it), each result checked against the plain version, and
names the settings whose two times summed, each over its workload's
fastest, are least: the measurement behind the plan's constants; and counts the instructions of ``fingerprint_minhash``'s
steady loop in the built library's SASS (``cuobjdump -sass``; the loop
with the most ``DFMA.RM``, one a step), the count behind
``chip_smoke.FINGERPRINT_OPS_PER_STEP``. ``--unroll`` builds the kernel
library with its steady loop unrolled 4, 8, 16 and 32 steps
(``cuda_build.load_variant`` with ``SZ_MINHASH_UNROLL``) and times each
one's raw launches on both workloads, twice in turns, each result checked
against the plain version: the measurement behind the kernel's unroll. Prints the card's name and power
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


def _inputs(docs, dev):
    """A workload's blob on the card and its host starts and lengths."""
    import torch

    lens = np.array([len(d) for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = torch.from_numpy(np.frombuffer(b"".join(docs) + b"\0", np.uint8).copy()).to(dev)
    return blob, starts, lens


def _raw_kernels(blob, pa, plan, params, stream, lib=None):
    """One function that launches both planned kernels by their raw ctypes
    entry points (of ``lib``, by default the tree's library) into outputs
    made once; it holds every tensor whose address the launches take."""
    import torch
    from stringzilla_tpu_torch.utils import cuda_build

    lib = lib or cuda_build.load()
    ints, floats, halo, _ = params["kernel"]
    ndim = ints.shape[1]
    f = floats.data_ptr()
    h = torch.empty((pa.n_docs, ndim), dtype=torch.int32, device=blob.device)
    c = torch.empty_like(h)
    pm = torch.empty((pa.n_slots, ndim), dtype=torch.int64, device=blob.device)
    pc = torch.empty((pa.n_slots, ndim), dtype=torch.int32, device=blob.device)
    n_cut = len(plan.cut_docs)

    def run():
        err = lib.sz_fingerprints(
            blob.data_ptr(), pa.pieces.data_ptr(), pa.cta_first.data_ptr(),
            pa.cta_first.numel() - 1, ints[0].data_ptr(), ints[1].data_ptr(), f, f + 8 * ndim,
            f + 16 * ndim, f + 24 * ndim, ndim, halo, h.data_ptr(), c.data_ptr(), pm.data_ptr(),
            pc.data_ptr(), stream)
        if not err and n_cut:
            err = lib.sz_fingerprints_merge(pa.cut.data_ptr(), n_cut, pm.data_ptr(),
                                            pc.data_ptr(), ndim, h.data_ptr(), c.data_ptr(),
                                            stream)
        if err:
            raise RuntimeError(f"minhash launch: {lib.sz_cuda_error_string(err).decode()} ({err})")
        return h, c

    run.buffers = (blob, pa, params, h, c, pm, pc)  # alive while the raw launches use them
    return run


def _time_tree(root: str) -> dict:
    """One run on the tree at ``root`` (its package imported from there)."""
    sys.path.insert(0, root)
    import torch
    from stringzilla_tpu_torch.ops import fingerprints_kernel as fk
    from stringzilla_tpu_torch.ops.fingerprints import derive_params

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    planned = hasattr(fk, "minhash_plan")
    lines, pages = chip_smoke._fp_workloads()
    times = {}
    for name, docs, widths in (("lines", lines, None), ("documents", pages, None),
                               ("documents, width 64", pages, (64,)),
                               ("documents, width 512", pages, (512,))):
        raw = {k: torch.from_numpy(v) for k, v in derive_params(256, widths, 42).items()}
        params = fk.kernel_params(raw, dev) if planned else {k: v.to(dev) for k, v in raw.items()}
        blob, starts, lens = _inputs(docs, dev)
        if planned:
            args = (blob, torch.from_numpy(starts), torch.from_numpy(lens), params)
        else:
            args = (blob, torch.from_numpy(starts).to(dev), torch.from_numpy(lens).to(dev),
                    params)
        got = fk.fingerprint_all(*args)
        want = fk.fingerprint_reference(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"{root}: fingerprint_all on the {name} != the plain version")
        times[f"{name} fingerprint_all"] = chip_smoke._time_ms(
            lambda: fk.fingerprint_all(*args), 10, sync)
        if planned:
            sms, stream = chip_smoke._launch_env(dev)
            plan = fk.minhash_plan(lens, fk.minhash_unit(lens, sms, params["kernel"].widest))
            run = _raw_kernels(blob, fk.plan_arrays(plan, starts, dev), plan, params, stream)
            got = run()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{root}: the raw kernels on the {name} != the plain version")
            times[f"{name} kernels, raw"] = chip_smoke._time_ms(run, 10, sync)
    return {"root": root, "ms": {k: [float(t), t.lo, t.hi] for k, t in times.items()}}


PROBE_CTAS = (4, 8, 16, 32, 64)
PROBE_SHARES = (2, 4, 8)
PROBE_UNIT_MINS = (128, 256, 512, 1024)


def _probe() -> dict:
    """This tree's kernels under the plans of other constants, and the
    settings with the least sum of their two times over each workload's
    fastest."""
    import itertools

    import torch
    from stringzilla_tpu_torch.ops import fingerprints_kernel as fk
    from stringzilla_tpu_torch.ops.fingerprints import derive_params

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    params = fk.kernel_params(derive_params(256, None, 42), dev)
    sms, stream = chip_smoke._launch_env(dev)
    settings = list(itertools.product(PROBE_CTAS, PROBE_SHARES, PROBE_UNIT_MINS))
    kept = fk.CTAS_PER_SM, fk.UNIT_SHARE, fk.UNIT_MIN
    rows, ms = [], {}  # ms[(workload, setting)]
    try:
        for name, docs in zip(("lines", "documents"), chip_smoke._fp_workloads()):
            blob, starts, lens = _inputs(docs, dev)
            want = fk.fingerprint_reference(blob, torch.from_numpy(starts),
                                            torch.from_numpy(lens), params)
            timed = {}  # (unit, share) -> timing: the plan is a function of them
            for setting in settings:
                fk.CTAS_PER_SM, fk.UNIT_SHARE, fk.UNIT_MIN = setting
                unit = fk.minhash_unit(lens, sms)
                if (unit, fk.UNIT_SHARE) not in timed:
                    plan = fk.minhash_plan(lens, unit)
                    run = _raw_kernels(blob, fk.plan_arrays(plan, starts, dev), plan, params,
                                       stream)
                    got = run()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise RuntimeError(f"probe: {name} at {setting} != plain version")
                    t = chip_smoke._time_ms(run, 10, sync)
                    timed[unit, fk.UNIT_SHARE] = t
                    print(f"[minhash probe] {name}: unit {unit}, UNIT_SHARE {fk.UNIT_SHARE} "
                          f"(first from CTAS_PER_SM, UNIT_SHARE, UNIT_MIN = {setting}): "
                          f"{len(plan.cta_first) - 1} CTAs, {len(plan.out)} pieces, "
                          f"{len(plan.cut_docs)} cut docs; {t:.4f} ms [{t.lo:.4f}-{t.hi:.4f}], "
                          f"exact", flush=True)
                    rows.append({"workload": name, "unit": unit, "unit_share": fk.UNIT_SHARE,
                                 "first_setting": setting, "ms": [float(t), t.lo, t.hi]})
                ms[name, setting] = timed[unit, fk.UNIT_SHARE]
    finally:
        fk.CTAS_PER_SM, fk.UNIT_SHARE, fk.UNIT_MIN = kept
    fastest = {w: min(t for (n, _), t in ms.items() if n == w) for w in ("lines", "documents")}
    score = {st: sum(ms[w, st] / fastest[w] for w in fastest) for st in settings}
    best = sorted(settings, key=score.get)
    for st in best[:8] + ([kept] if kept not in best[:8] else []):
        print(f"[minhash probe] CTAS_PER_SM, UNIT_SHARE, UNIT_MIN = {st}: lines "
              f"{ms['lines', st]:.4f}, documents {ms['documents', st]:.4f} ms; "
              f"{score[st]:.4f} over the fastest summed{' (kept now)' if st == kept else ''}")
    return {"rows": rows, "best": best[0], "kept": kept,
            "score": {str(st): score[st] for st in settings}}


# the opcodes that issue to the f64 pipe, conversions to and from f64 included
F64_OPS = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX", "DSET", "F2F.F64", "I2F.F64", "F2I.F64",
           "FRND.F64")


def _sass_counts() -> dict:
    """Instructions a step of ``fingerprint_minhash``'s steady loop: of the
    innermost loops (backward branches with no other inside) that read
    shared memory, the one that holds the most ``DFMA.RM`` (the rounded
    quotient, one a step), the longest on a tie (the warm-up's push loop
    unrolls as far, but has no old byte and no minimum to keep); its f64-pipe instructions, shared
    memory loads and all instructions over its ``DFMA.RM`` count."""
    import re

    from stringzilla_tpu_torch.utils import cuda_build

    so = cuda_build._build()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    body = sass[sass.index("fingerprint_minhash"):]
    body = body[:body.find("Function :")] if "Function :" in body else body
    code = [(int(a, 16), ins.strip()) for a, ins in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []  # (first, last) address of each backward branch's body
    for at, ins in code:
        branch = re.search(r"BRA (0x[0-9a-f]+)", ins)
        if branch and int(branch.group(1), 16) < at:
            loops.append((int(branch.group(1), 16), at))
    best = None
    for first, last in loops:
        if any(first <= a < b <= last and (a, b) != (first, last) for a, b in loops):
            continue  # not innermost
        loop = [i for a, i in code if first <= a <= last]
        steps = sum("DFMA.RM" in i for i in loop)
        if steps and any(i.split()[0].startswith("LDS") for i in loop) and \
                (best is None or (steps, len(loop)) > (best[0], len(best[1]))):
            best = (steps, loop)
    if best is None:
        raise RuntimeError("no loop with DFMA.RM in fingerprint_minhash's SASS")
    steps, loop = best
    opcode = [i.split()[1] if i.startswith("@") else i.split()[0] for i in loop]
    f64 = sum(any(o.startswith(op) for op in F64_OPS) for o in opcode)
    # instructions in all count the rarely taken branch to a new minimum too
    return {"steps_unrolled": steps, "f64_per_step": f64 / steps,
            "lds_per_step": sum(o.startswith("LDS") for o in opcode) / steps,
            "instructions_per_step": len(loop) / steps,
            "f64_opcodes": sorted({o for o in opcode if any(o.startswith(p) for p in F64_OPS)})}


UNROLLS = (4, 8, 16, 32)


def _unroll() -> list:
    """The kernel with its steady loop unrolled ``UNROLLS`` steps, each a
    build of the library (built together), timed by raw launch."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from stringzilla_tpu_torch.ops import fingerprints_kernel as fk
    from stringzilla_tpu_torch.ops.fingerprints import derive_params
    from stringzilla_tpu_torch.utils import cuda_build

    with ThreadPoolExecutor(len(UNROLLS)) as pool:
        libs = dict(zip(UNROLLS, pool.map(
            lambda n: cuda_build.load_variant([f"SZ_MINHASH_UNROLL={n}"]), UNROLLS)))
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    params = fk.kernel_params(derive_params(256, None, 42), dev)
    sms, stream = chip_smoke._launch_env(dev)
    rows = []
    for name, docs in zip(("lines", "documents"), chip_smoke._fp_workloads()):
        blob, starts, lens = _inputs(docs, dev)
        want = fk.fingerprint_reference(blob, torch.from_numpy(starts), torch.from_numpy(lens),
                                        params)
        plan = fk.minhash_plan(lens, fk.minhash_unit(lens, sms))
        pa = fk.plan_arrays(plan, starts, dev)
        runs = {n: _raw_kernels(blob, pa, plan, params, stream, lib) for n, lib in libs.items()}
        for rnd in range(2):  # every build twice, in turns
            for steps, run in runs.items():
                got = run()
                sync()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"unroll {steps}: {name} != the plain version")
                t = chip_smoke._time_ms(run, 10, sync)
                print(f"[minhash unroll] {name}, round {rnd}: {steps} steps {t:.4f} ms "
                      f"[{t.lo:.4f}-{t.hi:.4f}], exact", flush=True)
                rows.append({"workload": name, "round": rnd, "unroll": steps,
                             "ms": [float(t), t.lo, t.hi]})
    return rows


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_time_tree(os.path.abspath(sys.argv[2]))))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    if sys.argv[1] == "--unroll":
        print(json.dumps({"card": card, "unroll": _unroll()}))
        return 0
    if sys.argv[1] == "--probe":
        probe = _probe()
        sass = _sass_counts()
        print(f"[minhash sass] fingerprint_minhash's steady loop, unrolled "
              f"{sass['steps_unrolled']} steps: {sass['f64_per_step']:.2f} f64-pipe instructions a step "
              f"({', '.join(sass['f64_opcodes'])}), {sass['lds_per_step']:.2f} shared-memory "
              f"loads, {sass['instructions_per_step']:.2f} instructions in all")
        print(json.dumps({"card": card, "probe": probe, "sass": sass}))
        return 0
    here, other = HERE, os.path.abspath(sys.argv[1])
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        for name, (ms, lo, hi) in runs[-1]["ms"].items():
            print(f"[minhash a/b] {root}: {name} {ms:.4f} ms [{lo:.4f}-{hi:.4f}], exact")
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
