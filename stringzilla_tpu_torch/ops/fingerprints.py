"""Rolling MinHash / Count-Min fingerprints: parameters, exact oracle, bands.

Counterpart of ``stringzilla_tpu/ops/fingerprints.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax). It follows
the reference's production engine (``floating_rolling_hashers<f64>``,
reference ``include/stringzillas/fingerprints/serial.hpp:1111-1330``):

* per-dimension multiplier ``256 + splitmix64(seed+dim) % 384`` and modulo
  ``4503599626977 - splitmix64(splitmix64(seed+dim)) % 2^20``
  (``serial.hpp:1322-1336``);
* the roll ``state = (state*mult + fused_disc*old + new) mod m`` with
  ``new``/``old`` the entering/leaving byte + 1 (``serial.hpp:500-560``),
  every value an integer below 2^53;
* per dimension the running minimum of the window hashes and a count of the
  windows that reached it (``serial.hpp:1260-1280``);
* a doc shorter than the window gives ``min_hash = 0xFFFFFFFF`` and
  ``count = 0``; the 42-bit minimum is cut to its low 32 bits on export.

Dimension d takes its window width by the rule of ``szs_fingerprints_init``
(reference ``c/stringzillas/fingerprints.cuh:31-170``): when ``ndim`` splits
evenly into 64-dim slices per width, slice i takes ``widths[i % len]``;
otherwise dimension d takes ``widths[d % len]``.

Everything here but ``band_keys`` is exact host-side numpy.
``band_keys`` runs where its input lives (a tensor on any device, or numpy).
``params_from`` carries parameters over from the JAX package's engine or its
``derive_params`` dict, checking them against ``derive_params`` here.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DEFAULT_WINDOW_WIDTHS",
    "FINGERPRINT_SLICE",
    "MODULO_BASE",
    "band_keys",
    "buz_rolling_hash",
    "derive_params",
    "dim_window_widths",
    "fingerprint_oracle",
    "multiplying_rolling_hash",
    "params_from",
    "rabin_karp_rolling_hash",
    "splitmix64",
]

DEFAULT_WINDOW_WIDTHS = (3, 4, 5, 7, 9, 11, 15, 31)  # fingerprints.cuh:42
MODULO_BASE = 4503599626977  # serial.hpp:1247 default_modulo_base_k
FINGERPRINT_SLICE = 64  # stringzillas.cuh:771
MAX_HASH_U32 = np.uint32(0xFFFFFFFF)
PARAM_KEYS = ("width", "mult", "modulo", "neg_disc", "fused_disc")

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2^32 / phi, the band fold's multiplier
_AVALANCHE = 0x85EBCA6B  # murmur3's fmix32 multiplier


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for ``a`` in ``[0, 2^32)``, in 16-bit halves so no
    int64 product overflows."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def band_keys(min_hashes, bands: int):
    """Per-band LSH bucket keys: ``(n, ndim)`` 32-bit hashes ->
    ``(n, bands)``.

    Each band's ``ndim // bands`` hashes fold through a golden-ratio
    multiply-add chain with a final avalanche, so equal band slices always
    map to equal keys. The bits equal the JAX ``band_keys``.

    Takes a tensor on any device (``Fingerprints(..., device_out=True)``'s
    int32 output: only ``4 * bands`` bytes a doc then leave the device) and
    returns an int32 tensor of the key bits there, as ``device_out`` does;
    or a numpy array, and returns ``uint32`` numpy. Arithmetic is int64
    masked to 32 bits, so every product and shift is defined and the shifts
    are logical.
    """
    as_numpy = not isinstance(min_hashes, torch.Tensor)
    x = (torch.from_numpy(np.ascontiguousarray(min_hashes, dtype=np.uint32))
         if as_numpy else min_hashes)
    if x.dim() != 2:
        raise ValueError(f"min_hashes must be (n, ndim), got {tuple(x.shape)}")
    n, ndim = x.shape
    if ndim % bands:
        raise ValueError(f"ndim {ndim} not divisible into {bands} bands")
    if x.dtype in (torch.uint32, torch.int32):
        x = x.view(torch.int32)
    t = (x.to(torch.int64) & _MASK32).reshape(n, bands, ndim // bands)
    key = torch.zeros((n, bands), dtype=torch.int64, device=x.device)
    for j in range(t.shape[2]):
        key = (_mul32(key, _GOLDEN) + t[:, :, j]) & _MASK32
    key = key ^ (key >> 16)
    key = _mul32(key, _AVALANCHE)
    key = key ^ (key >> 13)
    key = (key - ((key >> 31) << 32)).to(torch.int32)  # the same 32 bits
    return key.numpy().view(np.uint32) if as_numpy else key


def splitmix64(state: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 finalizer (reference ``serial.hpp:44-50``)."""
    state = np.asarray(state, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = state + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def dim_window_widths(ndim: int, widths: tuple[int, ...]) -> np.ndarray:
    """Per-dimension window width, following the sliced/fallback rule of
    ``szs_fingerprints_init`` (fingerprints.cuh:54-58)."""
    widths = tuple(int(w) for w in widths)
    n_widths = len(widths)
    per_w_min = ndim // n_widths
    sliced = (ndim % n_widths == 0) and (per_w_min % FINGERPRINT_SLICE == 0)
    dims = np.arange(ndim)
    if sliced:
        return np.array(widths, dtype=np.int64)[(dims // FINGERPRINT_SLICE) % n_widths]
    return np.array(widths, dtype=np.int64)[dims % n_widths]


def derive_params(ndim: int, window_widths=None, seed: int = 0):
    """Per-dimension ``width``, ``mult``, ``modulo``, ``neg_disc`` and
    ``fused_disc`` as int64 arrays of shape ``(ndim,)``. ``neg_disc`` is
    ``mult^(w-1) mod m`` (the reference negates it; this keeps the positive
    magnitude) and ``fused_disc`` the non-negative complement
    ``(m - neg_disc*mult mod m)`` of the fused roll (serial.hpp:500-506)."""
    widths = tuple(window_widths) if window_widths else DEFAULT_WINDOW_WIDTHS
    w = dim_window_widths(ndim, widths)
    dims = np.arange(ndim, dtype=np.uint64)
    seed_u = np.uint64(seed)
    with np.errstate(over="ignore"):
        mult = (256 + (splitmix64(seed_u + dims) % np.uint64(384))).astype(np.int64)
        modulo = (np.uint64(MODULO_BASE) - (splitmix64(splitmix64(seed_u + dims))
                                            % np.uint64(1 << 20))).astype(np.int64)
    # mult^(w-1) mod m per dimension, in Python ints: exact.
    neg_disc = np.array(
        [pow(int(m_), int(w_) - 1, int(mod_)) for m_, w_, mod_ in zip(mult, w, modulo)],
        dtype=np.int64,
    )
    fused_disc = np.array(
        [(int(mod_) - (int(nd_) * int(m_)) % int(mod_)) % int(mod_)
         for nd_, m_, mod_ in zip(neg_disc, mult, modulo)],
        dtype=np.int64,
    )
    return {
        "width": w.astype(np.int64),
        "mult": mult,
        "modulo": modulo,
        "neg_disc": neg_disc,
        "fused_disc": fused_disc,
    }


def params_from(obj, seed: int | None = None, window_widths=None) -> dict:
    """The port's per-dimension parameters (a dict of CPU int64 tensors
    keyed by ``PARAM_KEYS``) from the JAX package's: its ``Fingerprints``
    engine (read through ``ndim``, ``window_widths``, ``seed`` and
    ``_params``), or a dict of arrays shaped like its ``derive_params``
    output, with the ``seed`` that made it (and ``window_widths`` when the
    first appearance of each width in ``width`` does not give their order).
    Raises ``ValueError`` unless they equal ``derive_params`` here for the
    same ``(ndim, widths, seed)``."""
    if isinstance(obj, dict):
        if seed is None:
            raise ValueError("a params dict needs the seed that made it")
        arrays = obj
        width = np.asarray(arrays["width"], dtype=np.int64)
        ndim = len(width)
        if window_widths is None:
            window_widths = tuple(int(w) for w in dict.fromkeys(width.tolist()))
    else:
        arrays, ndim = obj._params, int(obj.ndim)
        seed = int(obj.seed) if seed is None else seed
        window_widths = tuple(obj.window_widths) if window_widths is None else window_widths
    want = derive_params(ndim, tuple(window_widths), int(seed))
    for key in PARAM_KEYS:
        got = np.asarray(arrays[key], dtype=np.int64)
        if got.shape != want[key].shape or not np.array_equal(got, want[key]):
            raise ValueError(f"params[{key!r}] differ from derive_params({ndim}, "
                             f"{tuple(window_widths)}, seed={seed})")
    return {key: torch.from_numpy(want[key].copy()) for key in PARAM_KEYS}


def fingerprint_oracle(doc: bytes, params) -> tuple[np.ndarray, np.ndarray]:
    """Exact reference fingerprint of one document: ``(min_hashes u32[ndim],
    min_counts u32[ndim])``. Vectorized over dimensions; all intermediate
    values are integers < 2^52, exact in f64."""
    w = np.asarray(params["width"])
    mult = np.asarray(params["mult"]).astype(np.float64)
    modulo = np.asarray(params["modulo"]).astype(np.float64)
    neg_disc = np.asarray(params["neg_disc"]).astype(np.float64)
    ndim = len(w)
    data = np.frombuffer(doc, dtype=np.uint8).astype(np.float64)
    n = len(data)

    state = np.zeros(ndim, dtype=np.float64)
    minimum = np.full(ndim, np.inf)
    count = np.zeros(ndim, dtype=np.uint32)
    alive = np.zeros(ndim, dtype=bool)  # window filled at least once

    for t in range(n):
        new_term = data[t] + 1.0
        pushing = t < w
        # push: state = (state*mult + term) mod m
        pushed = np.mod(state * mult + new_term, modulo)
        # roll: discard the char leaving the window, then push; the index of
        # the leaving char t - w differs per dim.
        old_idx = t - w
        old_terms = np.where(old_idx >= 0, data[np.clip(old_idx, 0, None)] + 1.0, 0.0)
        without_old = np.mod(state - neg_disc * old_terms, modulo)
        rolled = np.mod(without_old * mult + new_term, modulo)
        state = np.where(pushing, pushed, rolled)

        # First full window: min = state, count = 1.
        first_full = t == (w - 1)
        became = first_full & ~alive
        minimum = np.where(became, state, minimum)
        count = np.where(became, 1, count).astype(np.uint32)
        alive = alive | became
        # Later windows: branchless count-min update.
        update = alive & ~first_full & (t >= w)
        count = np.where(update & (state < minimum), 1, count).astype(np.uint32)
        count = np.where(update & (state == minimum), count + 1, count).astype(np.uint32)
        minimum = np.where(update, np.minimum(minimum, state), minimum)

    finite_min = np.where(alive, minimum, 0.0)  # dead dims hold inf
    min_hashes = np.where(
        alive, (finite_min.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        MAX_HASH_U32
    ).astype(np.uint32)
    min_counts = np.where(alive, count, np.uint32(0)).astype(np.uint32)
    return min_hashes, min_counts


# ---------------------------------------------------------------------------
# Baseline rolling hashers (reference ``fingerprints/serial.hpp:56-263``):
# the reference keeps these as validation baselines for the production
# floating hasher; same role here, in numpy.
# ---------------------------------------------------------------------------


def multiplying_rolling_hash(doc: bytes, window: int, multiplier: int = 257,
                             bits: int = 32) -> np.ndarray:
    """Power-of-two-modulo polynomial roll (``multiplying_rolling_hasher``,
    reference ``serial.hpp:56-95``): one hash per full window."""
    data = np.frombuffer(doc, dtype=np.uint8).astype(np.uint64)
    n = len(data)
    if n < window:
        return np.zeros(0, dtype=np.uint64)
    mask = np.uint64((1 << bits) - 1)
    mult = np.uint64(multiplier)
    with np.errstate(over="ignore"):
        disc = np.uint64(pow(multiplier, window - 1, 1 << bits))
        out = np.empty(n - window + 1, dtype=np.uint64)
        state = np.uint64(0)
        for t in range(window):
            state = (state * mult + data[t] + np.uint64(1)) & mask
        out[0] = state
        for t in range(window, n):
            state = ((state - disc * (data[t - window] + np.uint64(1))) * mult
                     + data[t] + np.uint64(1)) & mask
            out[t - window + 1] = state
    return out


def rabin_karp_rolling_hash(doc: bytes, window: int, multiplier: int = 257,
                            modulo: int = MODULO_BASE) -> np.ndarray:
    """Modular polynomial roll with a co-prime modulo
    (``rabin_karp_rolling_hasher``, reference ``serial.hpp:109-188``)."""
    data = np.frombuffer(doc, dtype=np.uint8).astype(object)
    n = len(data)
    if n < window:
        return np.zeros(0, dtype=np.uint64)
    disc = pow(multiplier, window - 1, modulo)
    out = np.empty(n - window + 1, dtype=np.uint64)
    state = 0
    for t in range(window):
        state = (state * multiplier + int(data[t]) + 1) % modulo
    out[0] = state
    for t in range(window, n):
        state = ((state - disc * (int(data[t - window]) + 1)) * multiplier
                 + int(data[t]) + 1) % modulo
        out[t - window + 1] = state
    return out


def buz_rolling_hash(doc: bytes, window: int, seed: int = 0) -> np.ndarray:
    """BuzHash: rotate-XOR with a random byte table
    (``buz_rolling_hasher``, reference ``serial.hpp:195-263``)."""
    table = splitmix64(np.uint64(seed) + np.arange(256, dtype=np.uint64))
    data = np.frombuffer(doc, dtype=np.uint8)
    n = len(data)
    if n < window:
        return np.zeros(0, dtype=np.uint64)

    def rotl(x, k):
        k = np.uint64(k % 64)
        return (x << k | x >> (np.uint64(64) - k)) & np.uint64(0xFFFFFFFFFFFFFFFF) if k else x

    with np.errstate(over="ignore"):
        out = np.empty(n - window + 1, dtype=np.uint64)
        state = np.uint64(0)
        for t in range(window):
            state = rotl(state, 1) ^ table[data[t]]
        out[0] = state
        for t in range(window, n):
            state = (rotl(state, 1) ^ rotl(table[data[t - window]], window)
                     ^ table[data[t]])
            out[t - window + 1] = state
    return out
