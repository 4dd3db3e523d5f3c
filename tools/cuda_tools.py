"""Helpers the A/B tools share: building one CUDA source alone with
``nvcc`` for the H100 (``sm_90a``), several of them at once, and reading
the SASS of what was built (``cuobjdump -sass``).

Used by ``tools/ring_ab.py``, ``tools/hash_ab.py``, ``tools/find_ab.py``
and ``tools/utf8_ab.py``; they run only where ``nvcc`` is, on the GPU.
"""

import ctypes
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor


def nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(src, out: str, tag: str, cubin: bool = False) -> str:
    """``src`` alone built into ``out``/<tag>.so (or .cubin), with
    ``nvcc``'s register and spill report beside it (<tag>.log). ``src`` is
    a path, or (path, directory of the headers it includes)."""
    src, include = src if isinstance(src, tuple) else (src, None)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{tag}.{'cubin' if cubin else 'so'}")
    kind = ["-cubin"] if cubin else ["-Xcompiler", "-fPIC", "-shared"]
    proc = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                           "-O3", "-Xptxas", "-v", *(["-I", include] if include else []), *kind,
                           "-o", path, src], timeout=900, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(out, f"{tag}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    return path


def builds(jobs: dict, out: str, bind=lambda lib: lib, cubin: bool = False) -> dict:
    """{tag: source (as ``build`` takes it)} built together into ``out``;
    {tag: ``bind`` of the loaded library} (or {tag: cubin path})."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = dict(zip(jobs, pool.map(lambda t: build(jobs[t], out, t, cubin), jobs)))
    return paths if cubin else {t: bind(ctypes.CDLL(p)) for t, p in paths.items()}


def sass(path: str) -> str:
    return subprocess.run([os.path.join(os.path.dirname(nvcc()), "cuobjdump"), "-sass", path],
                          capture_output=True, text=True, timeout=300, check=True).stdout


def function(sass: str, name: str) -> list:
    """(address, instruction) of the SASS function whose name holds ``name``
    (and not "probe", unless it is ``name``)."""
    at = [m.start() for m in re.finditer(r"Function : (\S+)", sass)
          if name in m.group(1) and "probe" not in m.group(1) or m.group(1) == name]
    if not at:
        raise RuntimeError(f"no function {name} in the SASS")
    body = sass[at[0]:]
    end = body.find("Function :", 10)
    body = body if end < 0 else body[:end]
    return [(int(a, 16), ins.strip()) for a, ins in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]


def opcode(ins: str) -> str:
    return ins.split()[1] if ins.startswith("@") else ins.split()[0]


def loop_blocks(code: list):
    """The basic blocks of the loop of the longest predicated backward branch
    (an unpredicated one jumps back from code laid out after the function's
    end, such as a vote's divergence path): a list of (first address,
    instructions, successors), successors within the loop."""
    loops = [(int(m.group(1), 16), at) for at, ins in code
             for m in [re.search(r"BRA (0x[0-9a-f]+)", ins)]
             if m and int(m.group(1), 16) < at and ins.startswith("@")]
    if not loops:
        raise RuntimeError("no loop in the SASS")
    first, last = max(loops, key=lambda fl: fl[1] - fl[0])
    body = [(a, i) for a, i in code if first <= a <= last and opcode(i) != "NOP"]
    targets = {int(m.group(1), 16) for _, i in body for m in [re.search(r"BRA (0x[0-9a-f]+)", i)]
               if m}
    blocks, cur = [], []
    for a, i in body:
        if cur and a in targets:
            blocks.append(cur)
            cur = []
        cur.append((a, i))
        if opcode(i).split(".")[0] in ("BRA", "EXIT", "RET", "BRX", "JMP"):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    starts = [b[0][0] for b in blocks]
    out = []
    for k, b in enumerate(blocks):
        a, i = b[-1]
        succ = []
        m = re.search(r"BRA (0x[0-9a-f]+)", i)
        if m and first < int(m.group(1), 16) <= last and int(m.group(1), 16) in starts:
            succ.append(starts.index(int(m.group(1), 16)))
        # an unpredicated BRA, EXIT or RET never falls through; BRA.DIV
        # (taken only when the warp has diverged) and predicated ones may
        if not (opcode(i) in ("BRA", "EXIT", "RET") and not i.startswith("@")) \
                and k + 1 < len(blocks):
            succ.append(k + 1)
        out.append((b[0][0], [x for _, x in b], [s for s in succ if s > k]))
    return out


def shortest(blocks) -> list:
    """The instructions on the shortest path from the loop's first block to
    its last (the backward branch); None if no forward path reaches it."""
    best = [None] * len(blocks)
    best[0] = list(blocks[0][1])
    for k, (_, ins, succ) in enumerate(blocks):
        if best[k] is None:
            continue
        for s in succ:
            path = best[k] + blocks[s][1]
            if best[s] is None or len(path) < len(best[s]):
                best[s] = path
    return best[-1]


def histogram(ins: list) -> dict:
    hist = {}
    for i in ins:
        op = opcode(i).split(".")[0]
        hist[op] = hist.get(op, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: -kv[1]))
