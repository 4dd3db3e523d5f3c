"""ctypes bridge to the native host runtime (``native/tapecraft.cpp``).

Counterpart of ``stringzilla_tpu/utils/native.py``, with its own copy of
the C++ source (importing any ``stringzilla_tpu`` module imports jax). The
shared library is built with ``g++`` on first use into
``build/stringzilla_tpu_torch/`` beside the package (ignored by git, where
``utils/cuda_build.py`` puts the kernel library), under a name keyed by a
hash of the source, the flags and what ``-march=native`` means on this
machine: code built for one CPU may not run on another that shares the
directory. It is written
under a temporary name and renamed into place atomically, and a lock file
lets one process build while the others (test workers) wait for it.

``lib()`` returns None when the build fails, as the JAX package's does, and
every caller then takes its numpy or Python path, with the same results;
``load()`` raises with ``g++``'s message instead, for callers that must not
run those paths unnoticed. This module wires the UTF-8 layer: decode,
encode, case folding, uncased search, the UAX-29/14 segmentation automata
and the Unicode sort keys of ``ops.sort``. Packing, hashing, SHA-256 and
the argsort of the JAX package's native tier are not wired here.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["lib", "load", "available", "utf8_decode", "utf8_encode",
           "fold_runes", "utf8_fold_bytes", "utf8_uncased_find", "wb_breaks", "gb_breaks",
           "sb_breaks", "lb_breaks", "pgram_keys_unicode"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "tapecraft.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "stringzilla_tpu_torch")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_error: str | None = None  # why the build or load failed, once tried


def _native_target() -> bytes:
    """What ``-march=native`` means here: ``g++``'s predefined macros for it
    (the instruction sets it enables)."""
    proc = subprocess.run(["g++", "-march=native", "-E", "-dM", "-x", "c++", "-"], input="",
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.encode()


def _build() -> str:
    """The library's path, built first if no library of this source, these
    flags and this target is there. Raises with ``g++``'s output on failure."""
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_FLAGS).encode() + _native_target()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libtapecraft-{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one process builds; the others wait, then load
        if os.path.exists(so):
            return so
        tmp = f"{so}.tmp{os.getpid()}"
        try:
            proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed (exit {proc.returncode}) on {_SRC}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic when several processes build at once
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    c_i64, c_p = ctypes.c_int64, ctypes.c_void_p
    L.tc_utf8_decode.argtypes = [c_p, c_i64, c_p, c_p]
    L.tc_utf8_decode.restype = c_i64
    L.tc_utf8_encode.argtypes = [c_p, c_i64, c_p]
    L.tc_utf8_encode.restype = c_i64
    L.tc_fold_runes.argtypes = [c_p, c_i64, c_p, c_p, c_p, c_p, c_i64, c_p, c_p]
    L.tc_fold_runes.restype = c_i64
    L.tc_utf8_fold_bytes.argtypes = [c_p, c_i64, c_p, c_p, c_p, c_p, c_i64, c_p]
    L.tc_utf8_fold_bytes.restype = c_i64
    L.tc_utf8_uncased_find.argtypes = [c_p, c_i64, c_p, c_i64, c_i64,
                                       c_p, c_p, c_p, c_p, c_i64, c_p, c_p]
    L.tc_utf8_uncased_find.restype = ctypes.c_int
    L.tc_pgram_keys_unicode.argtypes = [c_p, c_p, c_p, c_i64, c_p, c_i64, ctypes.c_int,
                                        c_p, c_p, c_p, c_p, c_i64]
    L.tc_sb_breaks.argtypes = [c_p, c_i64, c_p, c_p, c_i64]
    L.tc_wb_breaks.argtypes = [c_p, c_i64, c_p, c_p, c_p, c_i64]
    L.tc_gb_breaks.argtypes = [c_p, c_i64, c_p, c_p, c_p, c_i64]
    L.tc_lb_breaks.argtypes = [c_p, c_i64, c_p, c_p, c_p, c_i64]
    for nm in ("tc_sb_breaks", "tc_wb_breaks", "tc_gb_breaks", "tc_lb_breaks"):
        getattr(L, nm).restype = c_i64
        fn = getattr(L, nm + "32")
        fn.argtypes = getattr(L, nm).argtypes
        fn.restype = c_i64
    return L


def lib():
    """The loaded ctypes library, or None when it cannot be built or loaded
    (``load()`` raises with the reason)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(ctypes.CDLL(_build()))
            except Exception as exc:  # no compiler, a failed build, a bad library
                _error = str(exc) or type(exc).__name__
        return _lib


def load() -> ctypes.CDLL:
    """The loaded library; raises with ``g++``'s message when there is none."""
    L = lib()
    if L is None:
        raise RuntimeError(f"the native host runtime is unavailable: {_error}")
    return L


def available() -> bool:
    return lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def utf8_decode(data: np.ndarray):
    """Decode UTF-8 to ``(runes u32[k], offsets i32[k+1])`` with U+FFFD per
    maximal subpart (Python ``errors="replace"`` semantics). None when the
    native library is unavailable."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    runes = np.empty(n, dtype=np.uint32)  # never more runes than bytes
    offsets = np.empty(n + 1, dtype=np.int32)
    count = L.tc_utf8_decode(_ptr(data), n, _ptr(runes), _ptr(offsets))
    return runes[:count], offsets[: count + 1]


def utf8_encode(runes: np.ndarray) -> np.ndarray | None:
    L = lib()
    if L is None:
        return None
    runes = np.ascontiguousarray(runes, dtype=np.uint32)
    out = np.empty(4 * runes.shape[0] + 4, dtype=np.uint8)
    n = L.tc_utf8_encode(_ptr(runes), runes.shape[0], _ptr(out))
    return out[:n]


def fold_runes(runes: np.ndarray, fold1: np.ndarray, mkeys: np.ndarray,
               moffs: np.ndarray, mvals: np.ndarray, with_src: bool = True):
    """Full case folding over a rune array; returns (folded u32[m],
    src_index i64[m] | None). None when native is unavailable."""
    L = lib()
    if L is None:
        return None
    runes = np.ascontiguousarray(runes, dtype=np.uint32)
    k = runes.shape[0]
    out = np.empty(3 * k + 4, dtype=np.uint32)
    src = np.empty(3 * k + 4, dtype=np.int64) if with_src else None
    m = L.tc_fold_runes(_ptr(runes), k, _ptr(np.ascontiguousarray(fold1)),
                        _ptr(np.ascontiguousarray(mkeys)),
                        _ptr(np.ascontiguousarray(moffs)),
                        _ptr(np.ascontiguousarray(mvals)), len(mkeys),
                        _ptr(out), _ptr(src) if with_src else None)
    return out[:m], (src[:m] if with_src else None)


def utf8_fold_bytes(data: np.ndarray, fold1: np.ndarray, mkeys: np.ndarray,
                    moffs: np.ndarray, mvals: np.ndarray) -> np.ndarray | None:
    """Fused decode→fold→encode of a UTF-8 buffer (ASCII fast path).
    Returns a view into per-thread scratch — copy (``bytes(...)``) before
    the next native call on this thread."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    out = _scratch_u8(3 * n + 16)  # caller copies (bytes()) before reuse
    m = L.tc_utf8_fold_bytes(_ptr(data), n, _ptr(np.ascontiguousarray(fold1)),
                             _ptr(np.ascontiguousarray(mkeys)),
                             _ptr(np.ascontiguousarray(moffs)),
                             _ptr(np.ascontiguousarray(mvals)), len(mkeys),
                             _ptr(out))
    return out[:m]


def utf8_uncased_find(data: np.ndarray, needle_folded: np.ndarray,
                      start_rune: int, fold1, mkeys, moffs, mvals):
    """Fused on-the-fly case-insensitive search (no folded-haystack
    materialization). Returns (byte_off, byte_len) or (-1, 0); None when the
    native library is unavailable."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    nd = np.ascontiguousarray(needle_folded, dtype=np.uint32)
    off = ctypes.c_int64(0)
    ln = ctypes.c_int64(0)
    hit = L.tc_utf8_uncased_find(
        _ptr(data), data.shape[0], _ptr(nd), nd.shape[0], int(start_rune),
        _ptr(np.ascontiguousarray(fold1)), _ptr(np.ascontiguousarray(mkeys)),
        _ptr(np.ascontiguousarray(moffs)), _ptr(np.ascontiguousarray(mvals)),
        len(mkeys), ctypes.byref(off), ctypes.byref(ln))
    return (off.value, ln.value) if hit else (-1, 0)


_seg_scratch = threading.local()


def _scratch(kind: str, dtype, cap: int) -> np.ndarray:
    """Reusable per-thread scratch for the emitters: a fresh ``np.empty``
    per call costs more than the automaton itself at GB/s rates (page
    faults on tens of MB); the scratch is faulted once and reused, with one
    element per page touched on growth."""
    buf = getattr(_seg_scratch, kind, None)
    if buf is None or buf.shape[0] < cap:
        buf = np.empty(int(cap * 5 // 4) + 64, dtype)
        buf[:: 4096 // buf.itemsize] = 0  # pre-touch one element per page
        setattr(_seg_scratch, kind, buf)
    return buf


def _scratch_i64(cap: int) -> np.ndarray:
    return _scratch("i64", np.int64, cap)


def _scratch_i32(cap: int) -> np.ndarray:
    """The export fast path (n < 2^31 byte offsets): half the write and
    copy bandwidth of the int64 scratch, which dominates when a boundary
    lands on nearly every byte (plain-text graphemes)."""
    return _scratch("i32", np.int32, cap)


def _scratch_u8(cap: int) -> np.ndarray:
    return _scratch("u8", np.uint8, cap)


def wb_breaks(data: np.ndarray, wb_table: np.ndarray,
              ep_table: np.ndarray, count_only: bool = False):
    """UAX-29 word-boundary byte offsets; None when native is absent.
    ``count_only`` runs the drain/enumerate mode (no output array)."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    wb = np.ascontiguousarray(wb_table, np.uint8)
    ep = np.ascontiguousarray(ep_table, np.uint8)
    if count_only:
        return int(L.tc_wb_breaks(_ptr(data), n, _ptr(wb), _ptr(ep), None, 0))
    # one pass with a word-text-sized guess (~2 boundaries per 6-byte word);
    # rare overflow pays a second exact pass
    fn, scratch, dt = ((L.tc_wb_breaks32, _scratch_i32, np.int32)
                       if n < 2**31 else
                       (L.tc_wb_breaks, _scratch_i64, np.int64))
    cap = n // 2 + 64
    out = scratch(cap)
    cap = out.shape[0]
    cnt = fn(_ptr(data), n, _ptr(wb), _ptr(ep), _ptr(out), cap)
    if cnt > cap:
        out = np.empty(cnt, dtype=dt)
        fn(_ptr(data), n, _ptr(wb), _ptr(ep), _ptr(out), cnt)
        return out
    return out[:cnt].copy()


def gb_breaks(data: np.ndarray, gcb_table: np.ndarray,
              ep_table: np.ndarray, count_only: bool = False):
    """UAX-29 grapheme-boundary byte offsets; None when native is absent."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    gcb = np.ascontiguousarray(gcb_table, np.uint8)
    ep = np.ascontiguousarray(ep_table, np.uint8)
    if count_only:
        return int(L.tc_gb_breaks(_ptr(data), n, _ptr(gcb), _ptr(ep), None, 0))
    fn, scratch = ((L.tc_gb_breaks32, _scratch_i32) if n < 2**31 else
                   (L.tc_gb_breaks, _scratch_i64))
    out = scratch(n + 1)
    cnt = fn(_ptr(data), n, _ptr(gcb), _ptr(ep), _ptr(out), out.shape[0])
    return out[:cnt].copy()


def sb_breaks(data: np.ndarray, sb_table: np.ndarray,
              count_only: bool = False):
    """UAX-29 sentence-break byte offsets; None when native is absent."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    sb = np.ascontiguousarray(sb_table, np.uint8)
    if count_only:
        return int(L.tc_sb_breaks(_ptr(data), n, _ptr(sb), None, 0))
    fn, scratch = ((L.tc_sb_breaks32, _scratch_i32) if n < 2**31 else
                   (L.tc_sb_breaks, _scratch_i64))
    out = scratch(n + 1)
    cnt = fn(_ptr(data), n, _ptr(sb), _ptr(out), out.shape[0])
    return out[:cnt].copy()


def lb_breaks(data: np.ndarray, lb_table: np.ndarray,
              count_only: bool = False):
    """UAX-14 line-break (offsets, mandatory) arrays; None when absent."""
    L = lib()
    if L is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    lb = np.ascontiguousarray(lb_table, np.uint8)
    if count_only:
        return int(L.tc_lb_breaks(_ptr(data), n, _ptr(lb), None, None, 0))
    fn, scratch = ((L.tc_lb_breaks32, _scratch_i32) if n < 2**31 else
                   (L.tc_lb_breaks, _scratch_i64))
    out = scratch(n + 1)
    mand = np.empty(n + 1, dtype=np.uint8)
    cnt = fn(_ptr(data), n, _ptr(lb), _ptr(out), _ptr(mand), out.shape[0])
    return out[:cnt].copy(), mand[:cnt].astype(bool)


def pgram_keys_unicode(data: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                       words_per_str: int, reverse: bool, fold1, mkeys,
                       moffs, mvals) -> np.ndarray | None:
    """Uncased sort keys with full Unicode case folding during export
    (``sz_sequence_argsort_uncased``, reference ``sort.h:18-22``): key bytes
    come from the progressively folded string; malformed UTF-8 orders as
    U+FFFD. Shape (count, words_per_str + 1) uint32. None when native is
    absent."""
    count = len(starts)
    L = lib()
    if L is None:
        return None
    out = np.empty((count, words_per_str + 1), dtype=np.uint32)
    L.tc_pgram_keys_unicode(
        _ptr(np.ascontiguousarray(data)),
        _ptr(np.ascontiguousarray(starts, dtype=np.int64)),
        _ptr(np.ascontiguousarray(ends, dtype=np.int64)),
        count, _ptr(out), words_per_str, int(reverse),
        _ptr(np.ascontiguousarray(fold1)),
        _ptr(np.ascontiguousarray(mkeys)),
        _ptr(np.ascontiguousarray(moffs)),
        _ptr(np.ascontiguousarray(mvals)), len(mkeys))
    return out
