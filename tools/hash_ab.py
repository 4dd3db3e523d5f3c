#!/usr/bin/env python
"""Times the hash kernels (``csrc/hash.cu``) of two trees of the repository
on the same inputs in one process, on one NVIDIA GPU; and this tree's
``hash_short`` against its alternative designs, at other launch
geometries, and by its SASS.

    python3 tools/hash_ab.py OTHER_ROOT          # the A/B of every hash kernel
    python3 tools/hash_ab.py --probe OTHER_ROOT  # what costs OTHER's hash_short its time
    python3 tools/hash_ab.py --designs           # hash_short's lookup designs
    python3 tools/hash_ab.py --geometry          # ... at other G, CTA sizes, CTAs an SM
    python3 tools/hash_ab.py --sass              # SASS instructions an AESENC, and its rate
    python3 tools/hash_ab.py --ablate            # this hash_short less one part of its work

The inputs are ``chip_smoke.py`` phase 4f's, made by its helpers from their
seeds: the words of the 256 MiB log's first 64 MiB split on spaces (the
log's ``Strs.hashes``), ``intersect``'s distinct tokens of its first side
(4-12 bytes), 2**20 strings of 65 bytes that ``hash_short`` skips (its
fixed cost: the table built by every CTA of a full grid and the lengths
read), the log's lines (``hash_long``), the 1,000 documents of 100 KB and
the 3 MiB string (``hash_long_wide``) and 256 MiB of ``fill_random``.

The A/B builds each tree's ``hash.cu`` alone with ``nvcc`` into
``build/hash_ab/`` and launches its kernels raw (every argument made
beforehand, as the wrappers pass them: ``sz_hash_short`` takes the same
arguments in both trees), in the order other, this, this, other. Each
``hash_short`` result is checked against ``hash_short_reference`` on the
card, the lines against ``hash_long_reference``, ``fill_random`` against
its plain version, the documents against the other tree's digests and the
host ``sz_hash`` on samples (exact). Each launch is timed by CUDA events,
the median of 5 batches (``chip_smoke._time_ms``) with their spread.
Prints the card's name and power limit, a line a workload a turn, each
workload's medians of the two trees' turns with the spread of all their
batches, their ratio, the bound (``chip_smoke._bound`` of ``_hash_ops`` and
``_hash_bytes``) and this tree's share of it, and a JSON summary last;
exits non-zero if a result differs.

``--probe`` times copies of OTHER's ``hash.cu`` in which (a) each table
lookup of ``aesenc`` reads its lane's own bank (index ``(x & 0xE0) |
lane``: conflict-free by construction, its digests wrong and not checked),
(b) every short string is cut to one block, (c) both, beside the copy as
it is, in turns forwards then backwards, on the words and the tokens.
``--ablate`` times copies of this ``hash.cu`` whose ``hash_short`` has
one part of its work taken out (digests wrong, unchecked): the lookups
(each AESENC a rotation and xors), blocks past the first, the blob's loads
(each block made from its address and length), the hashing (a digest is
the start xor its order entry), beside the copy as it is, in turns.
``--designs`` builds copies of this ``hash.cu`` with the lookup region
replaced by each design of ``tools/hash_designs.cu`` (at the geometry its
section names) and times them beside this tree's in turns, every result
exact. ``--geometry`` builds copies with other ``kShortGroup`` (G),
``kShortThreads`` and ``kShortCtasPerSm`` and times each the same way.
``--sass`` appends ``tools/hash_probe.cu`` to each design's copy, builds it
into a cubin and counts the instructions of its loop of 8 AESENC (and of
the ``T[4][256]`` ``aesenc`` the other kernels keep), then times the same
loops on the card: warp AESENC an SM a clock at the card's SM clock. The
SASS of each probe and of each copy's ``hash_short``, and ``nvcc``'s
register and spill reports, are written to ``build/hash_ab/``.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))
import chip_smoke  # noqa: E402
import cuda_tools  # noqa: E402

OUT = os.path.join(HERE, "build", "hash_ab")
SOURCE = os.path.join(HERE, "stringzilla_tpu_torch", "csrc", "hash.cu")
DESIGNS = os.path.join(HERE, "tools", "hash_designs.cu")
PROBE = os.path.join(HERE, "tools", "hash_probe.cu")
REGION = re.compile(r"// -- hash_short's lookups.*?// -- end of hash_short's lookups[^\n]*\n",
                    re.S)
SHORT = ("words", "tokens", "skipped 2^20")
# (G, threads a CTA, CTAs an SM) that --geometry times (G even: a lane reads
# its G lengths in pairs)
GEOMETRIES = [(2, 1024, 1), (4, 1024, 1), (6, 1024, 1), (8, 1024, 1), (4, 768, 1), (4, 512, 1)]


def _bind(lib):
    p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    lib.sz_hash_short.argtypes = [p, ll, p, p, ll, u64, p, i, p]
    for name in ("sz_hash_long", "sz_hash_long_wide"):
        getattr(lib, name).argtypes = [p, ll, p, p, ll, u64, ll, p, i, i, p]
    lib.sz_fill_random.argtypes = [u64, ll, p, i, p]
    return lib


def _builds(jobs: dict) -> dict:
    """{tag: src} built together into build/hash_ab/; {tag: bound library}."""
    return cuda_tools.builds(jobs, OUT, _bind)


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _write(tag: str, text: str) -> str:
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{tag}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def _sub(text: str, subs: dict, what: str) -> str:
    """``text`` with each regular expression of ``subs`` (each must match
    once) replaced."""
    for pattern, repl in subs.items():
        text, n = re.subn(pattern, lambda _m, r=repl: r, text, flags=re.S)
        if n != 1:
            raise RuntimeError(f"{what}: {pattern[:60]!r} matched {n} times")
    return text


def _geometry_subs(group: int, threads: int, ctas: int) -> dict:
    return {r"constexpr int kShortGroup = \d+;": f"constexpr int kShortGroup = {group};",
            r"constexpr int kShortThreads = \d+;": f"constexpr int kShortThreads = {threads};",
            r"constexpr int kShortCtasPerSm = \d+;": f"constexpr int kShortCtasPerSm = {ctas};"}


def _geometry_of(text: str) -> tuple:
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
                 for k in ("kShortGroup", "kShortThreads", "kShortCtasPerSm"))


def _designs() -> dict:
    """{name: hash.cu text}: this tree's lookups ("kept") and each design of
    tools/hash_designs.cu in the lookup region, at the geometry its section
    names (this tree's G)."""
    this = _read(SOURCE)
    group = _geometry_of(this)[0]
    out = {"kept": this}
    body = _read(DESIGNS)
    for m in re.finditer(r"// == design (\w+) threads=(\d+) ctas=(\d+)\n(.*?)(?=// == design |\Z)",
                         body, re.S):
        name, threads, ctas, code = m.group(1), int(m.group(2)), int(m.group(3)), m.group(4)
        region = f"// -- hash_short's lookups (design {name}) --\n{code}" \
                 f"// -- end of hash_short's lookups --\n"
        text = REGION.sub(lambda _m: region, this, count=1)
        out[name] = _sub(text, _geometry_subs(group, threads, ctas), name)
    return out


# -- inputs ---------------------------------------------------------------------

def _short_work(dev) -> dict:
    """{name: (blob, starts, lengths)} on the card for hash_short."""
    import torch
    from stringzilla_tpu_torch.ops import intersect as ix
    from stringzilla_tpu_torch.ops.pack_device import device_tape
    from stringzilla_tpu_torch.ops.tape import Tape

    head = np.frombuffer(chip_smoke.log_body()[: chip_smoke.WORDS_BYTES], np.uint8)
    gaps = np.flatnonzero(head == 32)
    starts = np.concatenate([[0], gaps + 1])
    lengths = np.concatenate([gaps, [len(head)]]) - starts
    blob = torch.zeros(len(head) + 16, dtype=torch.uint8, device=dev)
    blob[: len(head)] = torch.from_numpy(head.copy()).to(dev)
    work = {"words": (blob, torch.from_numpy(starts).to(dev), torch.from_numpy(lengths).to(dev))}
    tokens, _ = ix._distinct(chip_smoke.intersect_tokens()[0])
    dt = device_tape(Tape.from_strings(tokens), dev)
    work["tokens"] = (dt.data, torch.from_numpy(dt.starts).to(dev),
                      torch.from_numpy(dt.lengths).to(dev))
    n = 1 << 20
    work["skipped 2^20"] = (torch.zeros(65 * n, dtype=torch.uint8, device=dev),
                            torch.arange(0, 65 * n, 65, dtype=torch.int64, device=dev),
                            torch.full((n,), 65, dtype=torch.int64, device=dev))
    return work


def _long_work(dev) -> dict:
    """{name: (kind, args)}: the lines and the documents (blob, starts,
    lengths), fill_random's byte count."""
    import torch
    from stringzilla_tpu_torch.ops.pack_device import device_tape
    from stringzilla_tpu_torch.ops.tape import Tape

    body = np.frombuffer(chip_smoke.log_body(), np.uint8)
    ends = np.flatnonzero(body == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    blob = torch.zeros(len(body) + 16, dtype=torch.uint8, device=dev)
    blob[: len(body)] = torch.from_numpy(body.copy()).to(dev)
    work = {"lines": ("hash_long", (blob, torch.from_numpy(starts).to(dev),
                                    torch.from_numpy(ends - starts).to(dev)))}
    drng = np.random.default_rng(chip_smoke.SEED + 43)
    count, size = chip_smoke.DOCS
    docs_blob = drng.integers(0, 256, count * size, dtype=np.uint8).tobytes()
    docs = [docs_blob[i * size: (i + 1) * size] for i in range(count)]
    docs.append(drng.integers(0, 256, chip_smoke.DOC_BIG, dtype=np.uint8).tobytes())
    dt = device_tape(Tape.from_strings(docs), dev)
    work["documents"] = ("hash_long_wide", (dt.data, torch.from_numpy(dt.starts).to(dev),
                                            torch.from_numpy(dt.lengths).to(dev)))
    work["documents"] += (docs,)
    work["fill 256 MiB"] = ("fill_random", chip_smoke.FILL_BYTES)
    return work


def _short_launch(lib, blob, starts, lengths, out, seed=0):
    sms, stream = chip_smoke._launch_env(blob.device)
    args = (blob.data_ptr(), blob.numel(), starts.data_ptr(), lengths.data_ptr(), starts.numel(),
            seed, out.data_ptr(), sms, stream)

    def launch():
        err = lib.sz_hash_short(*args)
        if err:
            raise RuntimeError(f"sz_hash_short: error {err}")

    return launch


def _long_launch(lib, kind, args, out):
    """A raw launch of ``kind`` on ``args`` into ``out`` (a tensor)."""
    from stringzilla_tpu_torch.ops import hash_kernel

    sms, stream = chip_smoke._launch_env(out.device)
    if kind == "fill_random":
        call = (lib.sz_fill_random, 42, args // 16, out.data_ptr(), sms, stream)
    else:
        blob, starts, lengths = args
        call = (getattr(lib, "sz_" + kind), blob.data_ptr(), blob.numel(), starts.data_ptr(),
                lengths.data_ptr(), starts.numel(), 0, hash_kernel.WIDE_BYTES, out.data_ptr(),
                *hash_kernel.hash_long_plan(starts.numel(), sms, kind), stream)

    def launch():
        err = call[0](*call[1:])
        if err:
            raise RuntimeError(f"{kind}: error {err}")

    return launch


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _timed(launch, iters, sync, check) -> list:
    launch()
    sync()
    check()
    t = chip_smoke._time_ms(launch, iters, sync)
    check()
    return [float(t), t.lo, t.hi]


def _short_turns(libs: dict, order: list, work: dict, want: dict, sync, label: str,
                 checked=lambda tag: True) -> dict:
    """{lib: {workload: [[ms, lo, hi] a turn]}} of hash_short, each library's
    launches of each workload timed in ``order``; results exact against
    ``want`` where ``checked(tag)``."""
    import torch

    runs = {t: {w: [] for w in work} for t in libs}
    for tag in order:
        for name, (blob, starts, lengths) in work.items():
            out = torch.zeros(starts.numel(), dtype=torch.int64, device=blob.device)
            launch = _short_launch(libs[tag], blob, starts, lengths, out)

            def check():
                if checked(tag) and not torch.equal(out, want[name]):
                    bad = int((out != want[name]).sum())
                    raise RuntimeError(f"{label} {tag} {name}: {bad} digests != plain")

            runs[tag][name].append(_timed(launch, 20 if name != "words" else 10, sync, check))
            ms, lo, hi = runs[tag][name][-1]
            print(f"[hash {label}] {tag}: {name} {ms:.4f} ms [{lo:.4f}-{hi:.4f}]"
                  f"{', exact' if checked(tag) else ''}", flush=True)
    return runs


def _summary(runs: dict) -> dict:
    """Each library's median of its turns' medians, with the spread of all."""
    return {t: {w: [float(np.median([x[0] for x in ts])), min(x[1] for x in ts),
                    max(x[2] for x in ts)] for w, ts in per.items()} for t, per in runs.items()}


def _short_want(work: dict) -> dict:
    from stringzilla_tpu_torch.ops.hash_kernel import hash_short_reference

    return {name: hash_short_reference(*args, 0) for name, args in work.items()}


def _bounds(work: dict) -> dict:
    out = {}
    for name, (_, _, lengths) in work.items():
        lens = lengths.cpu().numpy()
        lens = lens[lens <= 64]
        out[name] = chip_smoke._bound(chip_smoke._hash_ops(lens), chip_smoke._hash_bytes(lens))[0]
    return out


def _print_medians(label: str, med: dict, work, bounds: dict) -> None:
    for name in work:
        print(f"[hash {label}] {name}: " + ", ".join(
            f"{t} {m[name][0]:.4f} ms [{m[name][1]:.4f}-{m[name][2]:.4f}]"
            + (f" ({100 * bounds[name] / m[name][0]:.1f}% of {bounds[name]:.4f})"
               if bounds.get(name) else "")
            for t, m in med.items()), flush=True)


def _ab(other: str) -> int:
    import torch
    from stringzilla_tpu_torch.ops import hash as host_hash
    from stringzilla_tpu_torch.ops.aes_kernel import fill_random_reference
    from stringzilla_tpu_torch.ops.hash_kernel import hash_long_reference

    card = _card()
    print(card, flush=True)
    libs = _builds({"other": os.path.join(other, "stringzilla_tpu_torch", "csrc", "hash.cu"),
                    "this": SOURCE})
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    order = ["other", "this", "this", "other"]
    work = _short_work(dev)
    want = _short_want(work)
    runs = _short_turns(libs, order, work, want, sync, "a/b")
    bounds = _bounds(work)
    del work, want
    # the long kernels, unchanged: the same times within the spread
    long_work = _long_work(dev)
    long_runs = {t: {w: [] for w in long_work} for t in libs}
    outputs = {}
    for tag in order:
        for name, (kind, args, *rest) in long_work.items():
            if kind == "fill_random":
                out = torch.empty(args, dtype=torch.uint8, device=dev)
                plain = lambda: fill_random_reference(args, 42, dev)
            else:
                out = torch.zeros(args[1].numel(), dtype=torch.int64, device=dev)
                plain = (None if kind == "hash_long_wide" else
                         lambda: hash_long_reference(*args, 0))
            if name not in outputs:
                outputs[name] = plain() if plain else None
            launch = _long_launch(libs[tag], kind, args, out)

            def check():
                if outputs[name] is not None:
                    if not torch.equal(out, outputs[name]):
                        raise RuntimeError(f"a/b {tag} {name} != plain (or the other tree)")
                    return
                outputs[name] = out.clone()  # the documents: the first tree's digests
                got = out.cpu().numpy().view(np.uint64)
                for i in (0, len(rest[0]) // 2, len(rest[0]) - 1):
                    if int(got[i]) != int(host_hash.hash_multiseed(rest[0][i], [0])[0]):
                        raise RuntimeError(f"a/b {tag} {name}: document {i} != host sz_hash")

            long_runs[tag][name].append(_timed(launch, 3 if name == "documents" else 10, sync,
                                               check))
            ms, lo, hi = long_runs[tag][name][-1]
            print(f"[hash a/b] {tag}: {name} ({kind}) {ms:.4f} ms [{lo:.4f}-{hi:.4f}], exact",
                  flush=True)
    med = _summary(runs)
    long_med = _summary(long_runs)
    _print_medians("a/b", med, SHORT, bounds)
    _print_medians("a/b", long_med, long_work, {})
    ratios = {w: med["other"][w][0] / med["this"][w][0] for w in SHORT}
    ratios.update({w: long_med["other"][w][0] / long_med["this"][w][0] for w in long_work})
    for w, r in ratios.items():
        print(f"[hash a/b] {w}: other / this {r:.3f}", flush=True)
    print(json.dumps({"card": card, "hash_short": med, "long": long_med,
                      "bounds_ms": bounds, "other_over_this": ratios}))
    return 0


_LANE_AESENC = '''__device__ __forceinline__ Block aesenc(const Block& s, const Block& key, Tables T) {
  const uint32_t lane = threadIdx.x & 31;  // probe: every lookup in the lane's own bank
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    o.w[c] = T[0][(s.w[c] & 0xE0u) | lane] ^ T[1][((s.w[(c + 1) & 3] >> 8) & 0xE0u) | lane] ^
             T[2][((s.w[(c + 2) & 3] >> 16) & 0xE0u) | lane] ^
             T[3][((s.w[(c + 3) & 3] >> 24) & 0xE0u) | lane] ^ key.w[c];
  return o;
}'''
_AESENC = r"__device__ __forceinline__ Block aesenc\(const Block& s, const Block& key, Tables T\) \{.*?\n  return o;\n\}"
_BLOCKS = r"const int blocks = length <= 16 \? 1 : \(length \+ 15\) >> 4;"


def _probe(other: str) -> int:
    import torch

    card = _card()
    print(card, flush=True)
    text = _read(os.path.join(other, "stringzilla_tpu_torch", "csrc", "hash.cu"))
    variants = {"as is": text,
                "own banks": _sub(text, {_AESENC: _LANE_AESENC}, "own banks"),
                "one block": _sub(text, {_BLOCKS: "const int blocks = 1;"}, "one block")}
    variants["both"] = _sub(variants["own banks"], {_BLOCKS: "const int blocks = 1;"}, "both")
    tags = {name: name.replace(" ", "_") for name in variants}
    libs = _builds({name: _write(f"probe_{tags[name]}", t) for name, t in variants.items()})
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    work = {k: v for k, v in _short_work(dev).items() if k != "skipped 2^20"}
    want = _short_want(work)
    order = list(libs) + list(libs)[::-1]
    runs = _short_turns(libs, order, work, want, sync, "probe", checked=lambda t: t == "as is")
    med = _summary(runs)
    _print_medians("probe", med, work, _bounds(work))
    split = {}
    for name in work:
        t = {k: med[k][name][0] for k in med}
        split[name] = {"conflicts": t["as is"] - t["own banks"],
                       "divergence": t["as is"] - t["one block"],
                       "both": t["as is"] - t["both"]}
        print(f"[hash probe] {name}: as is {t['as is']:.4f} ms; the lookups in their own banks "
              f"save {split[name]['conflicts']:.4f}, one block a string saves "
              f"{split[name]['divergence']:.4f}, both {split[name]['both']:.4f}", flush=True)
    print(json.dumps({"card": card, "medians": med, "saved_ms": split}))
    return 0


# --ablate: this tree's hash_short with one part of its work taken out
_ABLATE_AESENC = r"__device__ __forceinline__ Block short_aesenc\(const Block& s, const Block& key,\s*const uint32_t\* T, uint32_t lane\) \{.*?\n\}"
_CHEAP_AESENC = r"""__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key, const uint32_t*,
                                              uint32_t) {
  Block o;  // ablation: no lookups, the columns mixed by a rotation each
#pragma unroll
  for (int c = 0; c < 4; ++c) o.w[c] = s.w[c] ^ __funnelshift_l(s.w[(c + 1) & 3], s.w[(c + 1) & 3], 8) ^ key.w[c];
  return o;
}"""
_ABLATIONS = {
    "no lookups": {_ABLATE_AESENC: _CHEAP_AESENC},
    "one block": {_BLOCKS: "const int blocks = 1;"},
    "no blob loads": {
        r"uint4 cur = inside \? __ldg\(v\) : make_uint4\(0u, 0u, 0u, 0u\);":
            "uint4 cur = make_uint4(static_cast<uint32_t>(addr), length, 0u, 0u);",
        r"if \(b > 0 && shift == 0\) cur = __ldg\(v \+ b\);": "",
        r"const uint4 next = shift \+ count > 16 \? __ldg\(v \+ b \+ 1\) : make_uint4\(0u, 0u, 0u, 0u\);":
            "const uint4 next = make_uint4(b, count, 0u, 0u);"},
    "no hashing": {
        r"hash_short_string\(blob, n, start, static_cast<int>\(e >> 9\), seed, table, lane\)":
            "(static_cast<uint64_t>(start) ^ e)"},
}


def _ablate() -> int:
    """This tree's hash_short as it is and with each part of its work taken
    out (digests wrong, unchecked), in turns forwards then backwards."""
    import torch

    card = _card()
    print(card, flush=True)
    this = _read(SOURCE)
    variants = {"as is": this}
    variants.update({name: _sub(this, subs, name) for name, subs in _ABLATIONS.items()})
    libs = _builds({name: _write(f"ablate_{name.replace(' ', '_')}", t)
                    for name, t in variants.items()})
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    work = {k: v for k, v in _short_work(dev).items() if k != "skipped 2^20"}
    want = _short_want(work)
    order = list(libs) + list(libs)[::-1]
    runs = _short_turns(libs, order, work, want, sync, "ablate", checked=lambda t: t == "as is")
    med = _summary(runs)
    _print_medians("ablate", med, work, _bounds(work))
    for name in work:
        whole = med["as is"][name][0]
        print(f"[hash ablate] {name}: as is {whole:.4f} ms; " + ", ".join(
            f"{v} saves {whole - med[v][name][0]:.4f}" for v in _ABLATIONS), flush=True)
    print(json.dumps({"card": card, "medians": med}))
    return 0


def _time_libs(texts: dict, label: str) -> int:
    """Builds each hash.cu text and times its hash_short on the short
    workloads in turns forwards then backwards, every result exact."""
    import torch

    card = _card()
    print(card, flush=True)
    libs = _builds({tag: _write(f"{label}_{tag}", t) for tag, t in texts.items()})
    for tag, lib in libs.items():
        geometry = (ctypes.c_int * 4)()
        lib.sz_hash_short_geometry(geometry)
        g, threads, ctas, smem = tuple(geometry)
        print(f"[hash {label}] {tag}: G {g}, {threads} threads a CTA, {ctas} CTAs an SM, "
              f"{smem} B of shared memory a CTA ({ctas * smem} an SM); ptxas: {_registers(tag)}",
              flush=True)
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    work = _short_work(dev)
    want = _short_want(work)
    order = list(libs) + list(libs)[::-1]
    runs = _short_turns(libs, order, work, want, sync, label)
    med = _summary(runs)
    _print_medians(label, med, work, _bounds(work))
    print(json.dumps({"card": card, "medians": med}))
    return 0


def _registers(tag: str) -> str:
    """ptxas' line on hash_short's registers and spills in <tag>.log."""
    lines = _read(os.path.join(OUT, f"{tag}.log")).splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry" in line and "hash_short" in line:
            return " ".join(x.strip() for x in lines[k + 1: k + 4] if "Used" in x or "spill" in x)
    return "not found"


def _sass() -> int:
    import torch
    card = _card()
    print(card, flush=True)
    sources = {}
    for name, text in _designs().items():
        sources[name] = _write(f"sass_{name}", text + f'\n#include "{PROBE}"\n')
    with ThreadPoolExecutor(2 * len(sources)) as pool:
        cubins = dict(zip(sources, pool.map(lambda n: cuda_tools.build(sources[n], OUT, f"sass_{n}", True),
                                            sources)))
        libs = dict(zip(sources, pool.map(lambda n: cuda_tools.build(sources[n], OUT, f"so_{n}"),
                                          sources)))
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip()
    mhz = float(clock.split(",")[0])
    threads, blocks, trips = 1024, sms, 4000  # 32 warps an SM for every design
    data = torch.randint(0, 2**31, (4 * threads * blocks,), dtype=torch.int64, device=dev)
    data = data.to(torch.int32)
    out = torch.empty(threads * blocks, dtype=torch.int32, device=dev)
    result = {}
    for name in sources:
        sass = cuda_tools.sass(cubins[name])
        with open(os.path.join(OUT, f"sass_{name}_hash_short.txt"), "w") as f:
            f.writelines(f"{a:06x} {i}\n" for a, i in cuda_tools.function(sass, "hash_short"))
        for kernel in ("hash_probe_short", "hash_probe_tables"):
            if kernel == "hash_probe_tables" and name != "kept":
                continue
            code = cuda_tools.function(sass, kernel)
            with open(os.path.join(OUT, f"sass_{name}_{kernel}.txt"), "w") as f:
                f.writelines(f"{a:06x} {i}\n" for a, i in code)
            blocks_ = cuda_tools.loop_blocks(code)
            ins = [i for _, b, _ in blocks_ for i in b]
            lib = ctypes.CDLL(libs[name])
            fn = getattr(lib, "hash_probe_launch")
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            stream = torch.cuda.current_stream(dev).cuda_stream
            tables = int(kernel == "hash_probe_tables")

            def launch():
                err = fn(tables, data.data_ptr(), out.data_ptr(), trips, blocks, threads, stream)
                if err:
                    raise RuntimeError(f"{name} {kernel}: error {err}")

            t = chip_smoke._time_ms(launch, 3, torch.cuda.synchronize)
            warp_aes = blocks * threads // 32 * trips * 8
            per_sm_clock = warp_aes / sms / (float(t) * 1e-3 * mhz * 1e6)
            key = name if kernel == "hash_probe_short" else "T[4][256] (hash_long, fill_random)"
            result[key] = {"per_aesenc": len(ins) / 8, "opcodes": cuda_tools.histogram(ins),
                           "ms": [float(t), t.lo, t.hi],
                           "warp_aesenc_per_sm_clock": per_sm_clock}
            print(f"[hash sass] {key}: {len(ins) / 8:.2f} SASS instructions an AESENC (a loop of "
                  f"8); {per_sm_clock:.4f} warp AESENC an SM a clock at {mhz:.0f} MHz "
                  f"({1 / per_sm_clock:.2f} clocks each; {float(t):.4f} ms [{t.lo:.4f}-"
                  f"{t.hi:.4f}]); {json.dumps(result[key]['opcodes'])}", flush=True)
    print(json.dumps({"card": card, "clocks_max_sm_and_sm_mhz": clock, "sass": result}))
    return 0


def main() -> int:
    return _main(sys.argv[1:])


def _main(args) -> int:
    if len(args) == 2 and args[0] == "--probe":
        return _probe(os.path.abspath(args[1]))
    if args == ["--ablate"]:
        return _ablate()
    if args == ["--designs"]:
        return _time_libs(_designs(), "designs")
    if args == ["--geometry"]:
        this = _read(SOURCE)
        return _time_libs({f"g{g}_t{t}_c{c}": _sub(this, _geometry_subs(g, t, c), "geometry")
                           for g, t, c in GEOMETRIES}, "geometry")
    if args == ["--sass"]:
        return _sass()
    if len(args) != 1 or args[0].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    return _ab(os.path.abspath(args[0]))


if __name__ == "__main__":
    sys.exit(main())
