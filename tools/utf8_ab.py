#!/usr/bin/env python
"""Times the UTF-8 validation and count kernel on two trees of the
repository in turns, on one NVIDIA GPU, and counts its SASS instructions.

    python3 tools/utf8_ab.py OTHER_ROOT           # the A/B
    python3 tools/utf8_ab.py --probe [OTHER_ROOT]  # the SASS counts

The buffers are ``chip_smoke.py``'s, made by this tree's helpers from their
seeds: the 256 MiB blob (printable ASCII, an "é" every 4096 bytes), a 256
MiB valid mixed-script buffer (``chip_smoke.utf8_mixed``: an assumed mix,
mostly 3-byte runes), the 256 MiB log (``chip_smoke.log_body``), the mixed
buffer seen from its second byte (a view that is not 16-byte aligned), and
256 MiB of random bytes (dense violations). Each tree runs in its own
process, in the order other, this, this, other: it builds its kernels
(into its own ``build/``), launches ``sz_utf8_validate_count`` raw
(``_launch``: output and arguments made beforehand, as that tree's
wrapper passes them), checks the result against the plain version on the
card (exact, both numbers), times
it by CUDA events (the median of 5 batches of 10, with their spread), and
times ``Str.utf8_count`` on the blob with its mirror cached. Prints the
card's name and power limit, a line a buffer a run, each buffer's ratio
of the other tree's time to this one's (the medians of each tree's two
runs), each buffer's bytes bound and this tree's share of it, and a JSON
summary last; exits non-zero if a run fails.

``--probe`` counts instructions in ``cuobjdump -sass`` of each tree's
built library: the kernel's grid-stride loop (for a tree whose loop has
one path, every block of the loop but those with byte loads, which only
unaligned or edge vectors take, over its 4 words a vector), and this
tree's word step by branch (``tools/utf8_probe.cu``: each branch alone in
a loop, its shortest path less the loop and load's own, over 4 words).
"""

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
from cuda_tools import function, histogram, loop_blocks, opcode, shortest  # noqa: E402


def _buffers():
    n = chip_smoke.UTF8_BYTES
    mixed = chip_smoke.utf8_mixed(n)
    return {"blob": chip_smoke.utf8_blob(n), "mixed": mixed,
            "log": np.frombuffer(chip_smoke.log_body(), np.uint8),
            "mixed from byte 1": (mixed, 1),
            "random bytes": np.random.default_rng(chip_smoke.SEED + 41).integers(
                0, 256, n, dtype=np.uint8)}


def _launch(mirror, n):
    """``chip_smoke.utf8_launch`` for the tree whose package is imported. A
    tree from before the step's masks became a launch argument (its
    ``ops.utf8_device`` has no ``MASKS``) takes (s, n, out, sm_count,
    stream), as its wrapper passes them."""
    import torch
    from stringzilla_tpu_torch.ops import utf8_device

    if hasattr(utf8_device, "MASKS"):
        return chip_smoke.utf8_launch(mirror, n)
    sms, stream = chip_smoke._launch_env(mirror.device)
    out = torch.empty(2, dtype=torch.int64, device=mirror.device)
    launch = chip_smoke._raw_launch("sz_utf8_validate_count", mirror.data_ptr(), n,
                                    out.data_ptr(), sms, stream)
    launch.out = out
    return launch


def _time_tree(root: str) -> dict:
    """One run on the tree at ``root`` (its package imported from there)."""
    sys.path.insert(0, root)
    import torch
    import stringzilla_tpu_torch as szt
    from stringzilla_tpu_torch.ops.utf8_device import validate_count_reference

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    times, counts = {}, {}
    for name, buf in _buffers().items():
        buf, offset = buf if isinstance(buf, tuple) else (buf, 0)
        mirror = torch.from_numpy(buf).to(dev)[offset:]
        n = len(buf) - offset
        launch = _launch(mirror, n)
        want = validate_count_reference(mirror, n)
        launch()
        sync()
        if not torch.equal(launch.out, want):
            raise RuntimeError(f"{root}: {name}: {launch.out.tolist()} != plain {want.tolist()}")
        times[name] = chip_smoke._time_ms(launch, 10, sync)
        if not torch.equal(launch.out, want):
            raise RuntimeError(f"{root}: {name} != the plain version after timing")
        counts[name] = want.tolist() + [n]
        del mirror, launch, want
    s = szt.Str(chip_smoke.utf8_blob(chip_smoke.UTF8_BYTES))
    s.utf8_count()
    calls = [chip_smoke._host_ms(lambda: s.utf8_count(), sync, runs=1) for _ in range(21)]
    t = chip_smoke.Timing(np.median(calls))
    t.lo, t.hi = min(calls), max(calls)
    times["Str.utf8_count blob, mirror cached (host clock, median of 21)"] = t
    return {"root": root, "counts": counts,
            "ms": {k: [float(t), t.lo, t.hi] for k, t in times.items()}}


def _probe(other: str | None) -> dict:
    """SASS instruction counts of each tree's kernel loop and this tree's
    step branches."""
    from stringzilla_tpu_torch.utils import cuda_build

    result = {}
    for label, root in (("this", HERE), ("other", other)):
        if root is None:
            continue
        if root == HERE:
            so = cuda_build._build()
        else:
            so = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                                 "from stringzilla_tpu_torch.utils import cuda_build;"
                                 "print(cuda_build._build())", root],
                                capture_output=True, text=True, check=True, timeout=900
                                ).stdout.strip().splitlines()[-1]
        code = function(cuda_tools.sass(so), "utf8_validate_count")
        _dump(f"utf8_sass_{label}.txt", code)
        blocks = loop_blocks(code)
        ins = [i for _, b, _ in blocks for i in b]
        single = [i for _, b, _ in blocks for i in b
                  if not any(re.match(r"LDG\.E\.(U8|S8)", opcode(x)) for x in b)]
        result[label] = {"loop_instructions": len(ins),
                         "loop_without_byte_loads": len(single),
                         "per_word_one_path": len(single) / 4,
                         "opcodes_without_byte_loads": histogram(single),
                         "vset4_like": sum(opcode(i).startswith(("VSET", "VABSDIFF", "VMNMX"))
                                           for i in ins)}
    # this tree's step by branch
    cubin = cuda_tools.build(os.path.join(HERE, "tools", "utf8_probe.cu"),
                             os.path.join(HERE, "build", "utf8_probe"), "utf8_probe", cubin=True)
    sass = cuda_tools.sass(cubin)
    paths = {}
    for k in ("load", "lite", "four", "row"):
        code = function(sass, f"utf8_probe_{k}")
        _dump(f"utf8_sass_probe_{k}.txt", code)
        paths[k] = shortest(loop_blocks(code))
    if paths["load"] is None:
        raise RuntimeError("no path through utf8_probe_load's loop")
    base = len(paths["load"])
    result["this_step"] = {"loop_and_load": base}
    for k in ("lite", "four", "row"):
        if paths[k] is None:
            result["this_step"][k] = "no forward path through the loop (SASS in build/utf8_probe/)"
            continue
        result["this_step"][k] = {"per_word": (len(paths[k]) - base) / 4,
                                  "opcodes": histogram(paths[k])}
    return result


def _dump(name: str, code: list) -> None:
    """The function's SASS into build/utf8_probe/, for reading after the run."""
    out = os.path.join(HERE, "build", "utf8_probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as f:
        f.writelines(f"{a:06x} {i}\n" for a, i in code)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_time_tree(os.path.abspath(sys.argv[2]))))
        return 0
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--probe":
        other = os.path.abspath(sys.argv[2]) if len(sys.argv) == 3 else None
        probe = _probe(other)
        for k, v in probe.items():
            print(f"[utf8 probe] {k}: {json.dumps(v)}")
        print(json.dumps({"probe": probe}))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here, other = HERE, os.path.abspath(sys.argv[1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        for name, (ms, lo, hi) in runs[-1]["ms"].items():
            print(f"[utf8 a/b] {root}: {name} {ms:.4f} ms [{lo:.4f}-{hi:.4f}], exact", flush=True)
    ratios = {}
    for name in runs[1]["ms"]:
        theirs = np.median([r["ms"][name][0] for r in (runs[0], runs[3])])
        ours = np.median([r["ms"][name][0] for r in (runs[1], runs[2])])
        ratios[name] = float(theirs / ours)
        line = f"[utf8 a/b] {name}: other {theirs:.4f} ms, this {ours:.4f} ms, other / this " \
               f"{theirs / ours:.3f}"
        if name in runs[1]["counts"]:
            nbytes = runs[1]["counts"][name][2]
            bound = chip_smoke._bound(0, nbytes)[0]
            line += f"; bytes bound {bound:.4f} ms, this {100 * bound / ours:.1f}%, " \
                    f"[violations, runes] {runs[1]['counts'][name][:2]}"
        print(line, flush=True)
    print(json.dumps({"card": card, "runs": runs, "other_over_this": ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
