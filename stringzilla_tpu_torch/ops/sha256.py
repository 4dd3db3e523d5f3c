"""FIPS 180-4 SHA-256: host streaming, and a batch in plain PyTorch.

Counterpart of ``stringzilla_tpu/ops/sha256.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax). The
reference implements SHA-256 per ISA tier with a streaming state
(``sz_sha256_state_t``: init/update/digest, reference
``include/stringzilla/hash.h:244-300``).

* ``Sha256``, ``sha256`` and ``hmac_sha256`` are host code: an exact numpy
  compression function (the JAX module's native SHA-NI tier is not ported;
  it computes the same digests);
* ``sha256_tape`` and ``sha256_batch`` hash a whole collection on a device
  (``cuda:0`` unless the caller names another): messages are grouped by
  padded block count, and each group's gather, FIPS padding, big-endian
  packing and rounds run in plain PyTorch across the message axis, u32
  arithmetic in int64 tensors masked to 32 bits. The JAX module computes
  this in XLA ``jit`` code (``_jit_batch``, ``_jit_tape_batch``), with no
  Pallas kernel, so plain torch is its port. Each round is a handful of
  tensor operations, so a message of ``b`` blocks costs ``b`` x 64 rounds
  of launches: a kernel of its own is later speed work.

The round constants are derived from integer cube and square roots of the
first primes, as FIPS 180-4 section 4.2.2 defines them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import platform

__all__ = ["Sha256", "sha256", "sha256_batch", "sha256_tape", "hmac_sha256"]


def _first_primes(n: int) -> list[int]:
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return out


def _iroot(x: int, k: int) -> int:
    """Floor k-th root of a big integer (exact, no float rounding)."""
    r = int(round(x ** (1.0 / k)))
    while r ** k > x:
        r -= 1
    while (r + 1) ** k <= x:
        r += 1
    return r


_PRIMES = _first_primes(64)
# H0: first 32 bits of the fractional parts of sqrt(p), p in first 8 primes
_H0 = np.array([_iroot(p << 64, 2) & 0xFFFFFFFF for p in _PRIMES[:8]], dtype=np.uint32)
# K: first 32 bits of the fractional parts of cbrt(p), p in first 64 primes
_K = np.array([_iroot(p << 96, 3) & 0xFFFFFFFF for p in _PRIMES], dtype=np.uint32)


def _rotr(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _compress_np(state: np.ndarray, block: bytes | np.ndarray) -> np.ndarray:
    """One 64-byte block through the compression function (numpy u32)."""
    with np.errstate(over="ignore"):
        w = np.frombuffer(bytes(block), dtype=">u4").astype(np.uint32)
        W = np.empty(64, dtype=np.uint32)
        W[:16] = w
        for t in range(16, 64):
            s0 = _rotr(W[t - 15], 7) ^ _rotr(W[t - 15], 18) ^ (W[t - 15] >> np.uint32(3))
            s1 = _rotr(W[t - 2], 17) ^ _rotr(W[t - 2], 19) ^ (W[t - 2] >> np.uint32(10))
            W[t] = W[t - 16] + s0 + W[t - 7] + s1
        a, b, c, d, e, f, g, h = state
        kw = _K + W
        for t in range(64):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + S1 + ch + kw[t]
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = S0 + maj
            h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
        return state + np.array([a, b, c, d, e, f, g, h], dtype=np.uint32)


def _compress_many(state: np.ndarray, buf: bytes) -> np.ndarray:
    """All full 64-byte blocks of ``buf`` through the compressor. Returns the
    NEW state; never mutates the argument."""
    for i in range(len(buf) // 64):
        state = _compress_np(state, buf[i * 64: (i + 1) * 64])
    return state


class Sha256:
    """Streaming SHA-256 (``sz_sha256_state_init/update/digest``, reference
    ``hash.h:283-300``): own FIPS 180-4 implementation, no hashlib."""

    def __init__(self, data: bytes = b""):
        self._state = _H0.copy()
        self._buffer = b""
        self._length = 0  # total bytes absorbed
        if data:
            self.update(data)

    def update(self, data: bytes) -> "Sha256":
        data = bytes(data)
        self._length += len(data)
        buf = self._buffer + data
        n_full = len(buf) // 64
        if n_full:
            self._state = _compress_many(self._state, buf[: n_full * 64])
        self._buffer = buf[n_full * 64:]
        return self

    def copy(self) -> "Sha256":
        out = Sha256()
        out._state = self._state.copy()
        out._buffer = self._buffer
        out._length = self._length
        return out

    def digest(self) -> bytes:
        state, buf = self._state, self._buffer
        pad = b"\x80" + b"\x00" * ((55 - self._length) % 64)
        tail = buf + pad + (self._length * 8).to_bytes(8, "big")
        return _compress_many(state, tail).astype(">u4").tobytes()

    def hexdigest(self) -> str:
        return self.digest().hex()

    def reset(self) -> "Sha256":
        """Return to the empty-message state (``Sha256.reset``, reference
        ``python/stringzilla.c:7513``)."""
        self._state = _H0.copy()
        self._buffer = b""
        self._length = 0
        return self


def sha256(data) -> bytes:
    """One-shot SHA-256 digest."""
    return Sha256(bytes(data)).digest()


# ---------------------------------------------------------------------------
# Batched device path: rounds vectorised across the message axis
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotr_t(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x >> k) | (x << (32 - k))) & _M32


def _compress_batch(state: list, block: torch.Tensor) -> list:
    """One block of every message: ``state`` 8 int64 ``(G,)`` u32 words,
    ``block`` ``(G, 16)`` int64 u32 words."""
    W = [block[:, t] for t in range(16)]
    for t in range(16, 64):
        w15, w2 = W[t - 15], W[t - 2]
        s0 = _rotr_t(w15, 7) ^ _rotr_t(w15, 18) ^ (w15 >> 3)
        s1 = _rotr_t(w2, 17) ^ _rotr_t(w2, 19) ^ (w2 >> 10)
        W.append((W[t - 16] + s0 + W[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _rotr_t(e, 6) ^ _rotr_t(e, 11) ^ _rotr_t(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = h + S1 + ch + int(_K[t]) + W[t]
        S0 = _rotr_t(a, 2) ^ _rotr_t(a, 13) ^ _rotr_t(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + S0 + maj) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _padded_words(blob, offs, lens, n_blocks: int) -> torch.Tensor:
    """``(G, n_blocks * 16)`` int64 big-endian words of each message with its
    FIPS padding: the 0x80 marker and the 64-bit bit length at the end."""
    L = n_blocks * 64
    j = torch.arange(L, device=blob.device)
    valid = j[None, :] < lens[:, None]
    b = torch.where(valid, blob[torch.where(valid, offs[:, None] + j, 0)].long(), 0)
    b = torch.where(j[None, :] == lens[:, None], 0x80, b)
    bits = lens * 8  # messages are < 2^28 bytes: < 2^31 bits
    k = j - (L - 8)  # byte k of the big-endian length
    tail = (bits[:, None] >> (8 * (7 - k).clamp(0, 7))[None, :]) & 0xFF
    b = torch.where((k >= 0)[None, :], tail, b)
    bb = b.view(-1, L // 4, 4)
    return (bb[:, :, 0] << 24) | (bb[:, :, 1] << 16) | (bb[:, :, 2] << 8) | bb[:, :, 3]


# Messages at or above this are refused, as in the JAX module (whose device
# program carries the bit length as two u32 halves).
_TAPE_MAX_LEN = 1 << 28


def sha256_tape(tape, indices: np.ndarray | None = None, device=None) -> np.ndarray:
    """SHA-256 over a ``Tape`` (or a ``DeviceTape``), shape ``(n, 32) uint8``:
    raw bytes up once, padding, packing and rounds on the device, 32 bytes a
    digest back. Reference contract: ``sz_sha256_state_*``
    (``hash.h:283-300``) applied per collection element."""
    from .pack_device import DeviceTape, device_tape

    if isinstance(tape, DeviceTape):
        dt = tape
    else:
        dt = device_tape(tape, platform.resolve_device(device))
    if indices is None:
        indices = np.arange(len(dt))
    indices = np.asarray(indices, dtype=np.int64)
    out = np.empty((len(indices), 32), dtype=np.uint8)
    if len(indices) == 0:
        return out
    all_lens = dt.lengths[indices]
    if int(all_lens.max()) >= _TAPE_MAX_LEN:
        raise ValueError("sha256_tape: messages must be < 256 MB")
    blocks = (all_lens + 8) // 64 + 1
    h0 = [int(h) for h in _H0]
    pending = []
    for n_blocks in np.unique(blocks):
        rows = np.nonzero(blocks == n_blocks)[0]
        offs = torch.from_numpy(dt.starts[indices[rows]]).to(dt.device)
        lens = torch.from_numpy(dt.lengths[indices[rows]]).to(dt.device)
        words = _padded_words(dt.data, offs, lens, int(n_blocks))
        state = [torch.full((len(rows),), h, dtype=torch.int64, device=dt.device) for h in h0]
        for blk in range(int(n_blocks)):
            state = _compress_batch(state, words[:, 16 * blk: 16 * blk + 16])
        pending.append((rows, torch.stack(state, dim=1)))
    for rows, digests in pending:  # every group enqueued before the first pull
        out[rows] = digests.cpu().numpy().astype(">u4").view(np.uint8).reshape(len(rows), 32)
    return out


def sha256_batch(items, device=None) -> np.ndarray:
    """SHA-256 digests of a collection (a ``Tape`` or byte strings), shape
    ``(n, 32) uint8``, through ``sha256_tape`` on ``device``."""
    from .tape import Tape

    tape = items if isinstance(items, Tape) else Tape.from_strings([bytes(s) for s in items])
    return sha256_tape(tape, device=device)


def hmac_sha256(key: bytes, message: bytes) -> bytes:
    """RFC 2104 HMAC over the own SHA-256 (the reference exposes
    ``hmac_sha256`` in its Python binding)."""
    key = bytes(key)
    if len(key) > 64:
        key = sha256(key)
    key = key.ljust(64, b"\x00")
    ipad = bytes(b ^ 0x36 for b in key)
    opad = bytes(b ^ 0x5C for b in key)
    return sha256(opad + sha256(ipad + bytes(message)))
