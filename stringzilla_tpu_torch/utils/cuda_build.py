"""Builds the Hopper kernels in ``csrc/`` and loads them with ctypes.

The pattern follows the JAX package's host runtime (``utils/native.py``):
the shared library is keyed by a hash of its sources and flags (mtime is
meaningless after a checkout), written under a temporary name and renamed
into place atomically, then loaded with ``ctypes``. The sources have a
plain C interface and include no PyTorch header, so ``nvcc`` compiles them
in seconds rather than the minutes a ``torch/extension.h`` build takes.
Each source compiles in its own ``nvcc`` process, all started together,
and one more links the objects into the library.

The library lands in ``build/stringzilla_tpu_torch/`` beside the package
(ignored by git) on first use, so a fresh checkout builds it by itself.
Nothing here runs at import time. A failed compile raises with ``nvcc``'s
own output; there is no fallback. ``load_variant`` builds the same sources
with extra preprocessor definitions into a library of its own, bound the
same way: for tools that time a kernel's compile-time variants.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

__all__ = ["load", "load_variant", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "stringzilla_tpu_torch")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_log_path: str | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA toolkit is needed to build csrc/*.cu")
    return path


def _build(defines=()) -> str:
    """The library's path, built first if no library of these sources and
    flags (``_FLAGS`` and ``-D`` each of ``defines``) is there."""
    flags = [*_FLAGS, *(f"-D{d}" for d in defines)]
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    so = os.path.join(_BUILD_DIR, f"libsz_kernels-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.tmp{os.getpid()}"
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    commands = [[nvcc, *flags, "-c", "-o", obj, src]
                for src, obj in zip(sources, objects)]
    commands.append([nvcc, *_ARCH, "-shared", "-o", tmp, *objects])
    run = lambda cmd: subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=600)
    try:
        with ThreadPoolExecutor(len(sources)) as pool:
            procs = list(pool.map(run, commands[:-1]))
        if all(p.returncode == 0 for p in procs):
            procs.append(run(commands[-1]))
        log = "".join(p.stdout + p.stderr for p in procs)
        failed = [p for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed (exit {failed[0].returncode}) on "
                               f"{failed[0].args[-1]}:\n{log}")
        with open(so[:-3] + ".log", "w") as f:  # ptxas register/spill report
            f.write(log)
        os.replace(tmp, so)  # atomic when several processes build at once
    finally:
        for path in [tmp, *objects]:
            if os.path.exists(path):
                os.unlink(path)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with every entry point's argument and result types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sz_myers.argtypes = [p, i, p, i, p, p, p, i, i, i, p, p]
    lib.sz_myers.restype = i
    lib.sz_myers_runes.argtypes = [p, p, p, i, p, i, p, p, p, i, i, i, p, p]
    lib.sz_myers_runes.restype = i
    lib.sz_similarity.argtypes = [i] * 9 + [p, i, p, i, p, p] + [i] * 6 + [p, p, p, p]
    lib.sz_similarity.restype = i
    lib.sz_lookup.argtypes = [p, ctypes.c_size_t, p, p, i, p]
    lib.sz_lookup.restype = i
    ll = ctypes.c_longlong
    lib.sz_wavefront_flat.argtypes = [i] * 5 + [p, p, p, p, p, i, p, ll, p, p, p]
    lib.sz_wavefront_flat.restype = i
    lib.sz_wavefront_flat_occupancy.argtypes = [i, p]
    lib.sz_wavefront_flat_occupancy.restype = i
    lib.sz_wavefront_band.argtypes = [p, p, i, i, p, p, ll, p, p, p]
    lib.sz_wavefront_band.restype = i
    lib.sz_wavefront_band_occupancy.argtypes = [p]
    lib.sz_wavefront_band_occupancy.restype = i
    lib.sz_ring_tile.argtypes = [i] * 5 + [p, i, p, i] + [p] * 9 + [p, ll, i, p, p]
    lib.sz_ring_tile.restype = i
    lib.sz_ring_geometry.argtypes = [p]
    lib.sz_ring_geometry.restype = None
    lib.sz_ring_scratch_bytes.argtypes = [i, i, i]
    lib.sz_ring_scratch_bytes.restype = ll
    lib.sz_wavefront_stage.argtypes = [p, i, p, i, i, i, p, ll, p]
    lib.sz_wavefront_stage.restype = i
    lib.sz_wavefront_stage_occupancy.argtypes = [i, p]
    lib.sz_wavefront_stage_occupancy.restype = i
    lib.sz_fingerprints.argtypes = [p, p, p, i, p, p, p, p, p, p, i, i, p, p, p, p, p]
    lib.sz_fingerprints.restype = i
    lib.sz_fingerprints_merge.argtypes = [p, i, p, p, i, p, p, p]
    lib.sz_fingerprints_merge.restype = i
    lib.sz_find_search.argtypes = [p, ll, i, i, p, p, ll, p, i, p, ll, ll, p, i, p]
    lib.sz_find_search.restype = i
    lib.sz_find_geometry.argtypes = [p]
    lib.sz_find_geometry.restype = None
    lib.sz_utf8_validate_count.argtypes = [p, ll, p, p, i, p]
    lib.sz_utf8_validate_count.restype = i
    lib.sz_utf8_geometry.argtypes = [p]
    lib.sz_utf8_geometry.restype = None
    u64 = ctypes.c_ulonglong
    lib.sz_hash_short.argtypes = [p, ll, p, p, ll, u64, p, i, p]
    lib.sz_hash_short.restype = i
    lib.sz_hash_short_geometry.argtypes = [p]
    lib.sz_hash_short_geometry.restype = None
    for name in ("sz_hash_long", "sz_hash_long_wide"):
        getattr(lib, name).argtypes = [p, ll, p, p, ll, u64, ll, p, i, i, p]
        getattr(lib, name).restype = i
    lib.sz_fill_random.argtypes = [u64, ll, p, i, p]
    lib.sz_fill_random.restype = i
    lib.sz_cuda_error_string.argtypes = [i]
    lib.sz_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _log_path
    with _lock:
        if _lib is None:
            so = _build()
            _lib, _log_path = _bind(ctypes.CDLL(so)), so[:-3] + ".log"
        return _lib


def load_variant(defines) -> ctypes.CDLL:
    """The kernel library built with ``-D`` each of ``defines`` (``"NAME"``
    or ``"NAME=VALUE"``), bound like ``load``'s. Each call loads it anew;
    the build is kept on disk like ``load``'s."""
    return _bind(ctypes.CDLL(_build(tuple(defines))))


def build_log() -> str:
    """``nvcc``'s report from building the loaded library (``-Xptxas -v``:
    registers, shared memory and spills per kernel); empty before ``load``."""
    if _log_path is None or not os.path.exists(_log_path):
        return ""
    with open(_log_path) as f:
        return f.read()
