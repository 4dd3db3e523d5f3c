"""Bit-identical StringZilla hashing — host (NumPy) implementations.

Counterpart of ``stringzilla_tpu/ops/hash.py``, copied rather than imported
(importing any ``stringzilla_tpu`` module imports jax). Clean-room
re-implementation of the reference's seeded AES-mixing 64-bit hash from its
published spec (pseudocode in reference ``README.md:758-814``; serial
semantics in ``include/stringzilla/hash/serial.h``):

* dual state — an AES lane advanced one AESENC round per 16-byte block, and a
  shuffle+add "sum" lane (``hash/serial.h:297-303``);
* ≤64-byte inputs use a minimal 128-bit state over 1..4 zero-padded 16-byte
  blocks (``hash/serial.h:506-579``); longer inputs a 512-bit 4-lane state
  absorbing 64-byte chunks, with the final (possibly partial) block deferred to
  finalization (``hash/serial.h:587-599,443-500``);
* finalization mixes the length into the key and runs two more AES rounds.

Everything here is validated against golden vectors generated from the
reference's own serial build (``tests/golden/hash_vectors.json``) — bit-exact
for every length/seed combination.

Also: ``bytesum`` (``hash.h:110``), the AES-CTR ``fill_random``
(``hash/serial.h:953-968``), ``hash_multiseed`` (``hash.h:173``) and the
streaming ``Hasher`` (``hash.h:259-276``). The JAX module's native (AES-NI)
tier, its device kernels and SHA-256 are not part of this module yet: the
numpy tier computes the same values.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "sz_hash",
    "bytesum",
    "fill_random",
    "hash_multiseed",
    "Hasher",
    "hash_batch",
    "random",
    "PI",
    "SBOX",
    "SHUFFLE",
    "aesenc",
]

# 1024 bits of pi (BBP hexadecimal digits; public constant, README.md:766-773).
PI = np.array([
    0x243F6A8885A308D3, 0x13198A2E03707344, 0xA4093822299F31D0, 0x082EFA98EC4E6C89,
    0x452821E638D01377, 0xBE5466CF34E90C6C, 0xC0AC29B7C97C50DD, 0x3F84D5B5B5470917,
    0x9216D5D98979FB1B, 0xD1310BA698DFB5AC, 0x2FFD72DBD01ADFB7, 0xB8E1AFED6A267E96,
    0xBA7C9045F12C7F99, 0x24A19947B3916CF7, 0x0801F2E2858EFC16, 0x636920D871574E69,
], dtype=np.uint64)

# Standard AES (FIPS-197) S-box — a public constant.
SBOX = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
], dtype=np.uint8)

# AESENC byte routing: output position p takes SubBytes(input[(5p) mod 16])
# (the combined ShiftRows∘SubBytes of hash/serial.h:82-103).
SHIFTROWS_SRC = np.array([(5 * p) % 16 for p in range(16)], dtype=np.int64)

# Sum-lane byte permutation, identical to aHash (hash/serial.h:220-231).
SHUFFLE = np.array([
    0x04, 0x0B, 0x09, 0x06, 0x08, 0x0D, 0x0F, 0x05,
    0x0E, 0x03, 0x01, 0x0C, 0x00, 0x07, 0x0A, 0x02,
], dtype=np.int64)


def _gf2_double(x: np.ndarray) -> np.ndarray:
    return (((x.astype(np.uint16) << 1) ^ ((x.astype(np.uint16) >> 7) * 0x1B)) & 0xFF).astype(np.uint8)


def aesenc(state: np.ndarray, key: np.ndarray) -> np.ndarray:
    """One AES encryption round (SubBytes∘ShiftRows∘MixColumns ⊕ key) on
    ``(..., 16) uint8`` blocks, batched."""
    shifted = SBOX[state][..., SHIFTROWS_SRC]
    cols = shifted.reshape(*shifted.shape[:-1], 4, 4)
    rot = np.roll(cols, -1, axis=-1)
    xor_all = np.bitwise_xor.reduce(cols, axis=-1, keepdims=True)
    mixed = cols ^ xor_all ^ _gf2_double(cols ^ rot)
    return mixed.reshape(*state.shape[:-1], 16) ^ key


def _u64s(block16: np.ndarray) -> np.ndarray:
    """View ``(..., 16) uint8`` as ``(..., 2) uint64`` little-endian."""
    return block16.view(np.uint64) if block16.flags["C_CONTIGUOUS"] else np.ascontiguousarray(block16).view(np.uint64)


def _from_u64s(words: np.ndarray) -> np.ndarray:
    return words.astype("<u8").view(np.uint8)


def _sum_update(sum_block: np.ndarray, data_block: np.ndarray) -> np.ndarray:
    """shuffle(sum) + data as two wrapping u64 lanes (hash/serial.h:299-302)."""
    shuffled = sum_block[..., SHUFFLE]
    with np.errstate(over="ignore"):
        return _from_u64s(_u64s(shuffled) + _u64s(np.ascontiguousarray(data_block)))


def _seed_block(seed: int, pi_lo: int, pi_hi: int) -> np.ndarray:
    words = np.array([np.uint64(seed) ^ np.uint64(pi_lo), np.uint64(seed) ^ np.uint64(pi_hi)], dtype=np.uint64)
    return _from_u64s(words)


def _key_with_length(seed: int, length: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _from_u64s(np.array(
            [np.uint64(seed) + np.uint64(length), np.uint64(seed)], dtype=np.uint64))


def _finalize_short(aes: np.ndarray, summ: np.ndarray, seed: int, length: int) -> int:
    key_with_length = _key_with_length(seed, length)
    mixed = aesenc(summ, aes)
    result = aesenc(aesenc(mixed, key_with_length), mixed)
    return int(_u64s(result)[0])


def sz_hash(data: bytes, seed: int = 0) -> int:
    """64-bit seeded hash, bit-identical to ``sz_hash`` (reference
    ``hash.h:139``; serial path ``hash/serial.h:506-599``)."""
    data = bytes(data)
    length = len(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    if length <= 64:
        aes = _seed_block(seed, PI[0], PI[1])
        summ = _seed_block(seed, PI[8], PI[9])
        n_blocks = max(1, -(-length // 16))
        padded = np.zeros(n_blocks * 16, dtype=np.uint8)
        padded[:length] = buf
        for b in range(n_blocks):
            block = padded[b * 16 : (b + 1) * 16]
            aes = aesenc(aes, block)
            summ = _sum_update(summ, block)
        return _finalize_short(aes, summ, seed, length)

    # Long path: 512-bit state, last block deferred to finalization.
    aes = _from_u64s(np.uint64(seed) ^ PI[:8])
    summ = _from_u64s(np.uint64(seed) ^ PI[8:])
    offset = 0
    while offset + 64 < length:
        chunk = buf[offset : offset + 64]
        for lane in range(4):
            blk = chunk[lane * 16 : (lane + 1) * 16]
            aes[lane * 16 : (lane + 1) * 16] = aesenc(aes[lane * 16 : (lane + 1) * 16], blk)
            summ[lane * 16 : (lane + 1) * 16] = _sum_update(summ[lane * 16 : (lane + 1) * 16], blk)
        offset += 64
    ins = np.zeros(64, dtype=np.uint8)
    ins[: length - offset] = buf[offset:]
    return _finalize_long(aes, summ, ins, seed, length)


def _finalize_long(aes: np.ndarray, summ: np.ndarray, ins: np.ndarray, seed: int, length: int) -> int:
    """Fold the deferred block and collapse 4 lanes (hash/serial.h:443-500)."""
    key_with_length = _key_with_length(seed, length)
    lanes_aes, lanes_sum = [], []
    for lane in range(4):
        blk = ins[lane * 16 : (lane + 1) * 16]
        lanes_aes.append(aesenc(aes[lane * 16 : (lane + 1) * 16], blk))
        lanes_sum.append(_sum_update(summ[lane * 16 : (lane + 1) * 16], blk))
    mixed = [aesenc(lanes_sum[i], lanes_aes[i]) for i in range(4)]
    mixed01 = aesenc(mixed[0], mixed[1])
    mixed23 = aesenc(mixed[2], mixed[3])
    mixed_all = aesenc(mixed01, mixed23)
    result = aesenc(aesenc(mixed_all, key_with_length), mixed_all)
    return int(_u64s(result)[0])


def _seed_blocks(seeds: np.ndarray, pi_lo, pi_hi) -> np.ndarray:
    """(S, 16) seed-xor-pi blocks for a vector of seeds."""
    w = np.stack([seeds ^ pi_lo, seeds ^ pi_hi], axis=-1)
    return _from_u64s(w).reshape(len(seeds), 16)


def hash_multiseed(data: bytes, seeds) -> np.ndarray:
    """One hash per seed over the same input (``sz_hash_multiseed``,
    ``hash.h:173``) — bit-identical to per-seed ``sz_hash`` calls, but all
    seed states advance together in one batched AES pipeline (the reference's
    input-prep amortization, ``hash.h:151-157``)."""
    seeds = np.asarray(list(seeds), dtype=np.uint64)
    S = len(seeds)
    data = bytes(data)
    length = len(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    with np.errstate(over="ignore"):
        if length <= 64:
            aes = _seed_blocks(seeds, PI[0], PI[1])
            summ = _seed_blocks(seeds, PI[8], PI[9])
            n_blocks = max(1, -(-length // 16))
            padded = np.zeros(n_blocks * 16, dtype=np.uint8)
            padded[:length] = buf
            for b in range(n_blocks):
                block = np.broadcast_to(padded[b * 16 : (b + 1) * 16], (S, 16))
                aes = aesenc(aes, block)
                summ = _sum_update(summ, block)
            kwl = _from_u64s(np.stack([seeds + np.uint64(length), seeds], -1)).reshape(S, 16)
            mixed = aesenc(summ, aes)
            result = aesenc(aesenc(mixed, kwl), mixed)
            return _u64s(result)[:, 0].copy()
        # Long path: 4 lanes per seed → (S, 4, 16) states.
        aes = _from_u64s(seeds[:, None] ^ PI[None, :8]).reshape(S, 4, 16)
        summ = _from_u64s(seeds[:, None] ^ PI[None, 8:]).reshape(S, 4, 16)
        offset = 0
        while offset + 64 < length:
            chunk = np.broadcast_to(
                buf[offset : offset + 64].reshape(4, 16), (S, 4, 16))
            aes = aesenc(aes, chunk)
            summ = _sum_update(summ, chunk)
            offset += 64
        ins = np.zeros(64, dtype=np.uint8)
        ins[: length - offset] = buf[offset:]
        blk = np.broadcast_to(ins.reshape(4, 16), (S, 4, 16))
        lanes_aes = aesenc(aes, blk)
        lanes_sum = _sum_update(summ, blk)
        mixed = aesenc(lanes_sum, lanes_aes)
        mixed01 = aesenc(mixed[:, 0], mixed[:, 1])
        mixed23 = aesenc(mixed[:, 2], mixed[:, 3])
        mixed_all = aesenc(mixed01, mixed23)
        kwl = _from_u64s(np.stack([seeds + np.uint64(length), seeds], -1)).reshape(S, 16)
        result = aesenc(aesenc(mixed_all, kwl), mixed_all)
        return _u64s(result)[:, 0].copy()


def hash_batch(items, seed: int = 0) -> np.ndarray:
    """Vectorized ``sz_hash`` over a collection — strings grouped by 16-byte
    block count advance through the AES pipeline together (the batch analog
    of the reference's per-call kernel; bit-identical outputs). Accepts a
    :class:`~stringzilla_tpu_torch.ops.tape.Tape` directly."""
    from .tape import Tape

    if isinstance(items, Tape):
        items = [bytes(items[i]) for i in range(len(items))]
    else:
        items = [bytes(s) for s in items]
    out = np.zeros(len(items), dtype=np.uint64)
    short_groups: dict[int, list[int]] = {}
    for i, s in enumerate(items):
        if len(s) <= 64:
            short_groups.setdefault(max(1, -(-len(s) // 16)), []).append(i)
        else:
            out[i] = sz_hash(s, seed)
    seed_u = np.uint64(seed)
    with np.errstate(over="ignore"):
        for n_blocks, idx in short_groups.items():
            G = len(idx)
            padded = np.zeros((G, n_blocks * 16), dtype=np.uint8)
            lengths = np.empty(G, dtype=np.uint64)
            for row, i in enumerate(idx):
                s = items[i]
                padded[row, : len(s)] = np.frombuffer(s, dtype=np.uint8)
                lengths[row] = len(s)
            aes = np.broadcast_to(_seed_block(seed, PI[0], PI[1]), (G, 16)).copy()
            summ = np.broadcast_to(_seed_block(seed, PI[8], PI[9]), (G, 16)).copy()
            for b in range(n_blocks):
                block = padded[:, b * 16 : (b + 1) * 16]
                aes = aesenc(aes, block)
                summ = _sum_update(summ, block)
            kwl = _from_u64s(np.stack(
                [seed_u + lengths, np.broadcast_to(seed_u, lengths.shape)], -1
            )).reshape(G, 16)
            mixed = aesenc(summ, aes)
            result = aesenc(aesenc(mixed, kwl), mixed)
            out[np.asarray(idx)] = _u64s(result)[:, 0]
    return out


def bytesum(data: bytes) -> int:
    """64-bit byte checksum (``sz_bytesum``, ``hash.h:110``)."""
    return int(np.frombuffer(bytes(data), dtype=np.uint8).astype(np.uint64).sum())


def fill_random(length: int, nonce: int = 0) -> bytes:
    """AES-CTR pseudo-random bytes, reproducible per nonce across backends
    (``sz_fill_random``, ``hash/serial.h:953-968``). One batched AES round
    over all counter blocks — the whole buffer is generated in a single
    vectorized pass."""
    if length <= 0:
        return b""
    n_blocks = -(-length // 16)
    lanes = np.arange(n_blocks, dtype=np.uint64)
    with np.errstate(over="ignore"):
        ctr = np.uint64(nonce) + lanes
    inp = _from_u64s(np.stack([ctr, ctr], axis=-1)).reshape(n_blocks, 16)
    pi_idx = (lanes % np.uint64(4)).astype(np.int64) * 2
    keys_u64 = np.uint64(nonce) ^ np.stack([PI[pi_idx], PI[pi_idx + 1]], axis=-1)
    keys = _from_u64s(keys_u64).reshape(n_blocks, 16)
    out = aesenc(inp, keys).reshape(-1)
    return out[:length].tobytes()


def random(length: int, nonce: int = 0, *, alphabet=None) -> bytes:
    """AES-CTR random bytes, optionally remapped onto an alphabet with
    ``alphabet[b % len(alphabet)]`` (``sz.random``, reference
    ``python/stringzilla.c:1781-1843``)."""
    raw = fill_random(length, nonce)
    if alphabet is None:
        return raw
    alph = alphabet.encode() if isinstance(alphabet, str) else bytes(alphabet)
    if not alph:
        raise ValueError("alphabet must be non-empty")
    lut = np.frombuffer(alph, dtype=np.uint8)
    src = np.frombuffer(raw, dtype=np.uint8)
    return lut[src.astype(np.int64) % len(alph)].tobytes()


class Hasher:
    """Streaming hash state (``sz_hash_state_init/update/digest``,
    ``hash.h:259-276``): buffers a 64-byte block, defers the final block so
    the digest matches one-shot ``sz_hash`` exactly for any split pattern
    (``hash/serial.h:603-661``)."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._aes = _from_u64s(np.uint64(self._seed) ^ PI[:8])
        self._sum = _from_u64s(np.uint64(self._seed) ^ PI[8:])
        self._ins = np.zeros(64, dtype=np.uint8)
        self._length = 0

    def update(self, data: bytes) -> "Hasher":
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
        pos = 0
        while pos < len(buf):
            in_block = self._length % 64
            if in_block == 0 and self._length != 0:
                self._absorb()
                self._ins[:] = 0
            take = min(len(buf) - pos, 64 - in_block)
            self._ins[in_block : in_block + take] = buf[pos : pos + take]
            self._length += take
            pos += take
        return self

    def _absorb(self):
        for lane in range(4):
            blk = self._ins[lane * 16 : (lane + 1) * 16]
            self._aes[lane * 16 : (lane + 1) * 16] = aesenc(self._aes[lane * 16 : (lane + 1) * 16], blk)
            self._sum[lane * 16 : (lane + 1) * 16] = _sum_update(self._sum[lane * 16 : (lane + 1) * 16], blk)

    def digest(self) -> int:
        length = self._length
        if length > 64:
            return _finalize_long(self._aes.copy(), self._sum.copy(), self._ins.copy(), self._seed, length)
        aes = self._aes[:16].copy()
        summ = self._sum[:16].copy()
        n_blocks = max(1, -(-length // 16))
        for b in range(n_blocks):
            blk = self._ins[b * 16 : (b + 1) * 16]
            aes = aesenc(aes, blk)
            summ = _sum_update(summ, blk)
        return _finalize_short(aes, summ, self._seed, length)

    def hexdigest(self) -> str:
        return f"{self.digest():016x}"

    def reset(self) -> "Hasher":
        """Return to the freshly-seeded state (``Hasher.reset``, reference
        ``python/stringzilla.c:7340``)."""
        self.__init__(self._seed)
        return self

    def copy(self) -> "Hasher":
        """Independent clone of the streaming state, so one prefix can fork
        into several continuations."""
        out = Hasher(self._seed)
        out._aes = self._aes.copy()
        out._sum = self._sum.copy()
        out._ins = self._ins.copy()
        out._length = self._length
        return out
