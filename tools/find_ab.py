#!/usr/bin/env python
"""Times the streaming search kernel (``csrc/find.cu``) of two trees of the
repository on the same buffers in one process, on one NVIDIA GPU; and this
tree's kernel under each filter plan and tile geometry, and its filter's
SASS.

    python3 tools/find_ab.py OTHER_ROOT   # the A/B, and each tree's wrapper
    python3 tools/find_ab.py --plans      # this kernel under each filter plan
    python3 tools/find_ab.py --geometry   # ... at other tiles, stages, CTAs an SM
    python3 tools/find_ab.py --exact      # ... with and without its exact filter
    python3 tools/find_ab.py --sass       # SASS instructions a word of each filter

The buffers are ``chip_smoke.py``'s, made by this tree's helpers from their
seeds: phase 4e's 1 GiB find haystack (its full scan for ``XqZwV``, the
130-byte needle first and last, its first 16 bytes, ``count ab``, the
``first_of`` and ``last_of`` bytesets), phase 4h's folded 256 MiB text
(the absent needle, whose prefix ``worker-`` is in every line; the same
with its first byte made ``\\x01``; its first 16 bytes) and the 256 MiB
log's byteset search for the next byte >= 0x80 from the end of its 32nd
non-ASCII run, as the uncased round makes it. Each tree's ``find.cu`` is
built alone with ``nvcc`` into ``build/find_ab/`` and launched raw
(``sz_find_search`` with every argument made beforehand, as that tree's
wrapper passes them), in the order other, this, this, other; each result
is checked against the plain version on the card (exact), and each launch
is timed by CUDA events, queued alone behind a short spin of the card
(``chip_smoke._time_queued_ms``), the median of 5 batches of 10 with
their spread.
Then each tree's own ``search_positions`` on the log's byteset search,
``int()`` pull included, on the host clock, in a process of its own.
Prints the card's name and power limit, a line a workload a run, each
workload's ratio of the other tree's time to this one's (the medians of
each tree's two runs), its bytes bound and this tree's share of it, and a
JSON summary last; exits non-zero if a run fails.

``--plans`` times this kernel with its filter's offsets from each plan
(the first and last reachable byte; ``filter_offsets`` at
``FILTER_OFFSETS`` of 2, 3 and 4, the last on a copy of ``find.cu`` built
with ``kMaxOffsets = 4``), in turns forwards then backwards.
``--geometry`` builds copies of ``find.cu`` with other ``kTile``,
``kStages`` and ``kCtasPerSm`` (builds started together) and times each
the same way. ``--exact`` times ``count ab``, a count and an absent
search of one byte and a count of 3 bytes, whose every needle byte is an
offset of the plan, on this ``find.cu`` and on a copy that verifies them
instead of deciding by the exact filter, in turns with, without,
without, with, with, without. ``--sass`` builds
``tools/find_probe.cu`` (each filter alone on a thread's 16 words of a
shared-memory tile, in a loop over tiles) and counts its loop's SASS
instructions a word, beside the int32 bound of a 256 MiB scan at that
count and its bytes bound; it writes the probe's and the kernel's SASS of
each filter to ``build/find_ab/*.sass.txt``.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))
import chip_smoke  # noqa: E402
import cuda_tools  # noqa: E402

OUT = os.path.join(HERE, "build", "find_ab")
MODES = {"first": 0, "last": 1, "count": 2}
# the plans --plans times: the first and last reachable byte, and
# filter_offsets' rule at FILTER_OFFSETS of 2, 3 and 4
PLANS = ["first and last", "rarest 2", "rarest 3", "rarest 4"]
WORDS_PER_THREAD = 16  # csrc/find.cu kWordsPerThread: a probe loop's words
GEOMETRIES = [(16384, 4, 2), (16384, 6, 2), (24576, 4, 2), (32768, 2, 2), (32768, 3, 2),
              (49152, 2, 2), (16384, 8, 1), (32768, 6, 1)]
SOURCE = os.path.join(HERE, "stringzilla_tpu_torch", "csrc", "find.cu")


def _builds(jobs: dict) -> dict:
    """{tag: src} built together into build/find_ab/; {tag: library}."""
    return cuda_tools.builds(jobs, OUT)


def _variant(tag: str, subs: dict) -> str:
    """A copy of this tree's ``find.cu`` at build/find_ab/<tag>.cu with each
    regular expression of ``subs`` (each must match once) replaced."""
    import re

    with open(SOURCE) as f:
        text = f.read()
    for pattern, repl in subs.items():
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise RuntimeError(f"{tag}: {pattern!r} matched {n} times in find.cu")
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{tag}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def _constexpr(name: str, value: int) -> dict:
    return {rf"constexpr int {name} = \d+;": f"constexpr int {name} = {value};"}


def _workloads(dev) -> dict:
    """{name: (hay, n, mode, needle or None, byteset words or None, lo, bytes read)}
    on the card, from chip_smoke's buffers; ``bytes read`` is what the
    search must read (up to a "first" hit, from a "last" one, all for a
    count or a miss)."""
    import torch
    from stringzilla_tpu_torch.ops import utf8 as U
    from stringzilla_tpu_torch.ops.find import byteset_mask

    out = {}
    rng = np.random.default_rng(chip_smoke.SEED)  # phase 4e's haystack
    n = chip_smoke.FIND_BYTES
    hay = rng.integers(97, 123, n, dtype=np.uint8)
    hay[n - 4096: n - 4091] = np.frombuffer(b"XqZwV", np.uint8)
    long = rng.integers(97, 123, 130, dtype=np.uint8)
    for p in (n // 3, 2 * n // 3):
        hay[p: p + 130] = long
    big = torch.from_numpy(hay).to(dev)
    del hay
    out["1 GiB XqZwV first (full scan)"] = (big, n, "first", b"XqZwV", None, 0, n - 4091)
    out["1 GiB 130 first"] = (big, n, "first", long.tobytes(), None, 0, n // 3 + 130)
    out["1 GiB 130's first 16 bytes, first"] = (big, n, "first", long[:16].tobytes(), None, 0,
                                               n // 3 + 16)
    out["1 GiB 130 last"] = (big, n, "last", long.tobytes(), None, 0, n - 2 * n // 3)
    out["1 GiB count ab"] = (big, n, "count", b"ab", None, 0, n)
    out["1 GiB byteset first_of"] = (big, n, "first", None, byteset_mask(b"\n\r"), 0, n)
    out["1 GiB byteset last_of"] = (big, n, "last", None, byteset_mask(b" \t\n\r\x0b\x0c"), 0, n)
    text = chip_smoke.uncased_text().lower()  # the folded mirror: ASCII letters lowered
    folded = torch.from_numpy(np.frombuffer(text, np.uint8).copy()).to(dev)
    absent = U.utf8_fold(chip_smoke.UNCASED_NEEDLES["absent"])
    m = len(text)
    out["256 MiB folded text, dense prefix (absent needle)"] = (folded, m, "first", absent, None,
                                                                0, m)
    out["256 MiB folded text, first byte made \\x01"] = (folded, m, "first", b"\x01" + absent[1:],
                                                        None, 0, m)
    out["256 MiB folded text, first 16 bytes"] = (folded, m, "first", absent[:16], None, 0, m)
    del text
    body = chip_smoke.log_body()
    arr = np.frombuffer(body, np.uint8)
    lo = chip_smoke._runs(arr)[31][1]
    nxt = lo + int(np.argmax(arr[lo:] >= 0x80))
    log = torch.from_numpy(arr.copy()).to(dev)
    out["256 MiB log, byteset >= 0x80 from the 32nd run"] = (
        log, len(body), "first", None, byteset_mask(bytes(range(128, 256))), lo, nxt - lo + 1)
    return out


def _this_launch(lib, hay, n, mode, needle, words, lo, plan=None):
    """A raw launch of this tree's ``sz_find_search`` (arguments as
    ``ops.find_kernel.search_positions`` makes them) and its answer's
    tensor. ``plan``: the filter's offsets, else ``filter_offsets``'."""
    import torch
    from stringzilla_tpu_torch.ops import find_kernel as F

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sz_find_search.argtypes = [p, ll, i, i, p, p, ll, p, i, p, ll, ll, p, i, p]
    lib.sz_find_search.restype = i
    k = 1 if needle is None else len(needle)
    keep = {"head": np.zeros(F.HEAD_BYTES, np.uint8), "offs": np.zeros(4, np.int32),
            "words": np.zeros(8, np.uint32) if words is None else np.asarray(words, np.uint32),
            "scratch": torch.empty(3, dtype=torch.int64, device=hay.device)}
    n_off = 0
    if needle is not None:
        keep["head"][: min(k, F.HEAD_BYTES)] = np.frombuffer(needle[: F.HEAD_BYTES], np.uint8)
        plan = F.filter_offsets(needle) if plan is None else plan
        keep["offs"][: len(plan)] = plan
        n_off = len(plan)
        if k > F.HEAD_BYTES:
            keep["dev"] = torch.from_numpy(np.frombuffer(needle, np.uint8).copy()).to(hay.device)
    sms, stream = chip_smoke._launch_env(hay.device)
    args = (hay.data_ptr(), n, MODES[mode], 0 if needle is not None else 1,
            keep["head"].ctypes.data, keep["dev"].data_ptr() if "dev" in keep else None, k,
            keep["offs"].ctypes.data, n_off, keep["words"].ctypes.data, lo, n - k,
            keep["scratch"].data_ptr(), sms, stream)

    def launch():
        err = lib.sz_find_search(*args)
        if err:
            raise RuntimeError(f"sz_find_search (this tree): error {err}")

    launch.keep = keep
    return launch, keep["scratch"][2]


def _parent_launch(lib, hay, n, mode, needle, words, lo):
    """A raw launch of the parent's ``sz_find_search`` (13 arguments: the
    needle's first 16 bytes on the host, all of it on the device past 16, a
    2-word scratch whose second word is the answer) and its answer's
    tensor."""
    import torch

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sz_find_search.argtypes = [p, ll, i, i, p, p, ll, p, ll, ll, p, i, p]
    lib.sz_find_search.restype = i
    k = 1 if needle is None else len(needle)
    keep = {"head": np.zeros(16, np.uint8),
            "words": np.zeros(8, np.uint32) if words is None else np.asarray(words, np.uint32),
            "scratch": torch.empty(2, dtype=torch.int64, device=hay.device)}
    if needle is not None:
        keep["head"][: min(k, 16)] = np.frombuffer(needle[:16], np.uint8)
        if k > 16:
            keep["dev"] = torch.from_numpy(np.frombuffer(needle, np.uint8).copy()).to(hay.device)
    sms, stream = chip_smoke._launch_env(hay.device)
    args = (hay.data_ptr(), n, MODES[mode], 0 if needle is not None else 1,
            keep["head"].ctypes.data, keep["dev"].data_ptr() if "dev" in keep else None, k,
            keep["words"].ctypes.data, lo, n - k, keep["scratch"].data_ptr(), sms, stream)

    def launch():
        err = lib.sz_find_search(*args)
        if err:
            raise RuntimeError(f"sz_find_search (other tree): error {err}")

    launch.keep = keep
    return launch, keep["scratch"][1]


def _plain(work: dict) -> dict:
    from stringzilla_tpu_torch.ops.find_kernel import search_positions_reference

    return {name: int(search_positions_reference(
        hay, n, mode, needle=None if nd is None else np.frombuffer(nd, np.uint8),
        byteset_words=ws, lo=lo)) for name, (hay, n, mode, nd, ws, lo, _) in work.items()}


def _timed(name, launch, out, want, sync) -> list:
    launch()
    sync()
    if int(out) != want:
        raise RuntimeError(f"{name}: {int(out)} != plain {want}")
    t = chip_smoke._time_queued_ms(launch, 10, sync)
    if int(out) != want:
        raise RuntimeError(f"{name}: {int(out)} != plain {want} after timing")
    return [float(t), t.lo, t.hi]


def _turns(makers: dict, order: list, work: dict, want: dict, sync, label: str) -> dict:
    """{maker: {workload: [[ms, lo, hi] a turn]}}: each maker's launches of
    each workload timed in ``order``."""
    runs = {m: {w: [] for w in work} for m in makers}
    for m in order:
        for name, (hay, n, mode, nd, ws, lo, _) in work.items():
            launch, out = makers[m](hay, n, mode, nd, ws, lo)
            runs[m][name].append(_timed(f"{m} {name}", launch, out, want[name], sync))
            print(f"[find {label}] {m}: {name} {runs[m][name][-1][0]:.4f} ms "
                  f"[{runs[m][name][-1][1]:.4f}-{runs[m][name][-1][2]:.4f}], exact", flush=True)
    return runs


def _summary(runs: dict, work: dict) -> dict:
    """Each maker's median of its turns' medians, with the spread of all."""
    out = {}
    for m, per in runs.items():
        out[m] = {}
        for name, ts in per.items():
            out[m][name] = [float(np.median([t[0] for t in ts])), min(t[1] for t in ts),
                            max(t[2] for t in ts)]
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _wrapper_ms(root: str) -> dict:
    """(In its own process) the tree at ``root``: its ``search_positions``
    on the log's byteset search from the 32nd run, ``int()`` included, host
    clock, mean of 200 calls after a warm-up."""
    sys.path.insert(0, root)
    import torch
    from stringzilla_tpu_torch.ops.find import byteset_mask
    from stringzilla_tpu_torch.ops.find_kernel import search_positions

    dev = torch.device("cuda", 0)
    body = chip_smoke.log_body()
    arr = np.frombuffer(body, np.uint8)
    lo = chip_smoke._runs(arr)[31][1]
    log = torch.from_numpy(arr.copy()).to(dev)
    ws = byteset_mask(bytes(range(128, 256)))
    call = lambda: int(search_positions(log, len(body), "first", byteset_words=ws, lo=lo))
    got = call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    return {"root": root, "answer": got, "ms": (time.perf_counter() - t0) / 200 * 1e3}


def _ab(other: str) -> int:
    import torch

    card = _card()
    print(card, flush=True)
    libs = _builds({"other": os.path.join(other, "stringzilla_tpu_torch", "csrc", "find.cu"),
                    "this": SOURCE})
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    work = _workloads(dev)
    want = _plain(work)
    makers = {"other": lambda *a: _parent_launch(libs["other"], *a),
              "this": lambda *a: _this_launch(libs["this"], *a)}
    runs = _turns(makers, ["other", "this", "this", "other"], work, want, sync, "a/b")
    med = _summary(runs, work)
    ratios = {}
    for name, (*_, nbytes) in work.items():
        theirs, ours = med["other"][name][0], med["this"][name][0]
        bound = chip_smoke._bound(0, nbytes)[0]
        ratios[name] = theirs / ours
        print(f"[find a/b] {name}: other {theirs:.4f} ms [{med['other'][name][1]:.4f}-"
              f"{med['other'][name][2]:.4f}], this {ours:.4f} ms [{med['this'][name][1]:.4f}-"
              f"{med['this'][name][2]:.4f}], other / this {theirs / ours:.3f}; bytes bound "
              f"{bound:.4f} ms, this {100 * bound / ours:.1f}% of it, answer {want[name]}",
              flush=True)
    wrappers = []
    for root in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--wrapper", root],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        wrappers.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[find a/b] {root}: search_positions + int() on the log's byteset search, host "
              f"clock {wrappers[-1]['ms']:.4f} ms (answer {wrappers[-1]['answer']})", flush=True)
    print(json.dumps({"card": card, "medians": med, "other_over_this": ratios, "answers": want,
                      "wrapper_ms": wrappers}))
    return 0


def _plans() -> int:
    import torch
    from stringzilla_tpu_torch.ops import find_kernel as F

    card = _card()
    print(card, flush=True)
    libs = _builds({"this": SOURCE, "four": _variant("four", _constexpr("kMaxOffsets", 4))})
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    work = {k: v for k, v in _workloads(dev).items() if v[3] is not None}
    want = _plain(work)

    def plan_of(name, nd):
        """The offsets of plan ``name`` for needle ``nd``."""
        if name == "first and last":
            return tuple(sorted({0, min(len(nd) - 1, F.REACH)}))
        saved, F.FILTER_OFFSETS = F.FILTER_OFFSETS, int(name.split()[1])
        try:
            return F.filter_offsets(nd)
        finally:
            F.FILTER_OFFSETS = saved

    def maker(name):
        lib = libs["four" if name == "rarest 4" else "this"]
        return lambda hay, n, mode, nd, ws, lo: _this_launch(lib, hay, n, mode, nd, ws, lo,
                                                             plan=plan_of(name, nd))

    makers = {name: maker(name) for name in PLANS}
    for name, (*_, nd, _ws, _lo, _b) in work.items():
        print(f"[find plans] {name}: offsets " + ", ".join(
            f"{p} {plan_of(p, nd)}" for p in PLANS), flush=True)
    order = list(makers) + list(makers)[::-1]
    runs = _turns(makers, order, work, want, sync, "plans")
    med = _summary(runs, work)
    for name in work:
        print(f"[find plans] {name}: " + ", ".join(
            f"{m} {med[m][name][0]:.4f} ms [{med[m][name][1]:.4f}-{med[m][name][2]:.4f}]"
            for m in makers), flush=True)
    print(json.dumps({"card": card, "medians": med}))
    return 0


def _geometry() -> int:
    import torch

    card = _card()
    print(card, flush=True)
    jobs = {f"t{t}_s{s}_c{c}": _variant(f"t{t}_s{s}_c{c}", {
        **_constexpr("kTile", t), **_constexpr("kStages", s), **_constexpr("kCtasPerSm", c)})
        for t, s, c in GEOMETRIES}
    libs = _builds(jobs)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    keep = ("1 GiB XqZwV first (full scan)", "1 GiB count ab",
            "256 MiB folded text, dense prefix (absent needle)",
            "256 MiB log, byteset >= 0x80 from the 32nd run")
    work = {k: v for k, v in _workloads(dev).items() if k in keep}
    want = _plain(work)
    makers = {tag: (lambda lib: lambda *a: _this_launch(lib, *a))(lib) for tag, lib in libs.items()}
    runs = _turns(makers, list(makers) + list(makers)[::-1], work, want, sync, "geometry")
    med = _summary(runs, work)
    for name in work:
        print(f"[find geometry] {name}: " + ", ".join(
            f"{m} {med[m][name][0]:.4f} ms [{med[m][name][1]:.4f}-{med[m][name][2]:.4f}]"
            for m in makers), flush=True)
    print(json.dumps({"card": card, "medians": med}))
    return 0


def _exact() -> int:
    import torch

    card = _card()
    print(card, flush=True)
    libs = _builds({"with": SOURCE, "without": _variant(
        "without_exact", {r"if \(n_off == P\.k\)": "if (false)"})})
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    every = _workloads(dev)
    big, n = every["1 GiB count ab"][:2]
    folded, m = every["256 MiB folded text, first 16 bytes"][:2]
    work = {"1 GiB count ab": every["1 GiB count ab"],
            "1 GiB count e (k = 1)": (big, n, "count", b"e", None, 0, n),
            "1 GiB first # (k = 1, absent: a full scan)": (big, n, "first", b"#", None, 0, n),
            "256 MiB folded text, count wor (k = 3)": (folded, m, "count", b"wor", None, 0, m)}
    del every
    want = _plain(work)
    makers = {tag: (lambda lib: lambda *a: _this_launch(lib, *a))(lib) for tag, lib in libs.items()}
    order = ["with", "without", "without", "with", "with", "without"]
    runs = _turns(makers, order, work, want, sync, "exact")
    med = _summary(runs, work)
    for name in work:
        (w, wlo, whi), (o, olo, ohi) = med["with"][name], med["without"][name]
        verdict = ("with wins beyond the spread" if whi < olo else
                   "without wins beyond the spread" if ohi < wlo else "within the spread")
        print(f"[find exact] {name}: with {w:.4f} ms [{wlo:.4f}-{whi:.4f}], without {o:.4f} ms "
              f"[{olo:.4f}-{ohi:.4f}], without / with {o / w:.3f}: {verdict}", flush=True)
    print(json.dumps({"card": card, "medians": med, "answers": want}))
    return 0


def _sass_function(sass: str, name: str) -> list:
    """(address, instruction) of the SASS function whose mangled name holds
    ``name``."""
    import re

    at = [m.start() for m in re.finditer(r"Function : (\S+)", sass) if name in m.group(1)]
    if not at:
        raise RuntimeError(f"no function {name} in the SASS")
    body = sass[at[0]:]
    end = body.find("Function :", 10)
    body = body if end < 0 else body[:end]
    return [(int(a, 16), ins.strip()) for a, ins in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]


def _sass() -> int:
    cubins = cuda_tools.builds({"find_probe": os.path.join(HERE, "tools", "find_probe.cu"),
                                "find": SOURCE}, OUT, cubin=True)
    sass = cuda_tools.sass(cubins["find_probe"])
    kernel_sass = cuda_tools.sass(cubins["find"])
    for k in range(4):  # for reading: the probe's and the kernel's SASS
        for name, text in ((f"find_probe_{k}", sass), (f"find_search_{k}", kernel_sass)):
            code = _sass_function(text, f"{name[:-2]}ILi{k}E" + ("Lb0E" if "search" in name
                                                                   else ""))
            with open(os.path.join(OUT, f"{name}.sass.txt"), "w") as f:
                f.writelines(f"{a:06x} {i}\n" for a, i in code)
    n = chip_smoke.UTF8_BYTES
    bytes_ms = chip_smoke._bound(0, n)[0]
    result = {}
    for k in range(4):
        code = _sass_function(sass, f"find_probeILi{k}E")
        blocks = cuda_tools.loop_blocks(code)
        ins = [i for _, b, _ in blocks for i in b]
        per_word = len(ins) / WORDS_PER_THREAD
        ops_ms = per_word / 4 * n / chip_smoke.INT32_OPS_PER_S * 1e3
        result[f"filter<{k}>"] = {"per_word": per_word, "per_byte": per_word / 4,
                                  "opcodes": cuda_tools.histogram(ins),
                                  "int32_bound_256MiB_ms": ops_ms, "bytes_bound_256MiB_ms": bytes_ms}
        print(f"[find sass] filter<{k}> ({'a byteset' if k == 0 else f'{k} offsets'}): "
              f"{per_word:.2f} instructions a word, {per_word / 4:.2f} a byte; a 256 MiB scan at "
              f"that count: int32 bound {ops_ms:.4f} ms, bytes bound {bytes_ms:.4f} ms; "
              f"{json.dumps(result[f'filter<{k}>']['opcodes'])}", flush=True)
    print(json.dumps({"sass": result}))
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--wrapper":
        print(json.dumps(_wrapper_ms(os.path.abspath(sys.argv[2]))))
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--plans":
        return _plans()
    if len(sys.argv) == 2 and sys.argv[1] == "--geometry":
        return _geometry()
    if len(sys.argv) == 2 and sys.argv[1] == "--exact":
        return _exact()
    if len(sys.argv) == 2 and sys.argv[1] == "--sass":
        return _sass()
    if len(sys.argv) != 2 or sys.argv[1].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    return _ab(os.path.abspath(sys.argv[1]))


if __name__ == "__main__":
    sys.exit(main())
