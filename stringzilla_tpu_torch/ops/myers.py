"""Myers bit-parallel unit-cost Levenshtein over byte strings.

Counterpart of ``stringzilla_tpu/ops/myers_pallas.py``, with the same
layouts at the public function, so the two are compared like with like:

    myers(q_t, qlens, cands_t, clens, alphabet=256) -> (n_queries, n_cands) int32

* ``q_t``      ``(rows, n_queries)`` int32 query chars, padded with -1;
  ``rows`` is a multiple of 32 and at most 4096;
* ``qlens``    ``(n_queries, 1)`` int32;
* ``cands_t``  ``(cand_len, n_cands)`` int32 candidate chars;
* ``clens``    ``(1, n_cands)`` int32.

With ``alphabet=256`` chars are bytes: a value outside ``[0, 256)`` matches
nothing (the JAX kernel's ``alphabet=256`` contract). Each query of length
m occupies ``W = ceil(rows / 64)`` 64-bit words; its match table
``peq[c][w]`` (bit i set iff query char ``64 w + i == c``, the reference's
256-entry PEQ, ``serial.hpp:2189``) is built here with torch ops.

With ``alphabet=None`` chars are runes (UTF-32 code points, or any int32
values; the JAX kernel's ``alphabet=None``): equal values match, U+0000
included, and the query padding -1 lies past the query's end. The kernel
then reads each query's sorted distinct runes and a match table of one row
per distinct rune (``build_rune_tables``, which a caller may run once for
a query block and pass to every call on it), and finds a candidate rune's row
in a hash table of the query's runes that each CTA builds in shared memory
(``rune_table`` and ``rune_probe`` are its plain numpy version); the plain
version compares runes directly.

Per candidate char the recurrence is

    Xv = Eq | VN
    Xh = (((Eq & VP) + VP) ^ VP) | Eq          (carry chained across words)
    Ph = VN | ~(Xh | VP);  Mh = VP & Xh
    Ph = (Ph << 1) | 1;  Mh <<= 1              (top bit carried across words)
    VP = Mh | ~(Xv | Ph);  VN = Ph & Xv

and after a candidate's last char ``D = n + popcount(VP & mask) -
popcount(VN & mask)`` with ``mask`` the query's bits ``[0, m)``.

``myers`` runs the hand-written Hopper kernel (``csrc/myers.cu``) on CUDA
tensors and the plain PyTorch version ``myers_reference`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build

__all__ = ["myers", "myers_reference", "build_rune_tables", "rune_table", "rune_probe",
           "rune_table_bits", "tier_b_plan", "KERNEL_LAUNCHES", "TABLE_BUILDS", "MAX_ROWS",
           "TIER_B_SEGMENTS", "TIER_B_WIDEN_BELOW"]

MAX_ROWS = 4096  # longer queries wait for the wavefront tier
_TIER_A_WORDS = 4  # csrc/myers.cu keeps up to 4 words per thread in registers

# Launches of each CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"myers_tier_a": 0, "myers_tier_b": 0,
                   "myers_tier_a_runes": 0, "myers_tier_b_runes": 0}
# Rune match tables built for the kernel (``build_rune_tables``).
TABLE_BUILDS = {"rune_tables": 0}

_INT64_MIN = -(1 << 63)
# Bit k as an int64 value (bit 63 is INT64_MIN), and the masks of bits [0, k).
_BIT = [1 << k for k in range(63)] + [_INT64_MIN]
_LOW = [(1 << k) - 1 for k in range(64)] + [-1]


def words_of(rows: int) -> int:
    """64-bit words a query block of ``rows`` chars occupies."""
    return max(1, -(-rows // 64))


# csrc/myers.cu's tier B: lanes a candidate (32 / S candidates a warp), and
# the warps an SM of an 8-lane launch below which it takes 32 lanes, for
# blocks of at most 8 words (24 lanes of 32 then idle) and of more
# (tools/tier_b_probe.py; PERF.md).
TIER_B_SEGMENTS = (8, 32)
TIER_B_WIDEN_BELOW = (2, 15)


def tier_b_plan(words: int, nq: int, nc: int, sms: int) -> int:
    """Lanes a candidate that ``csrc/myers.cu``'s tier B takes for a block
    of ``words`` words, ``nq`` queries and ``nc`` candidates on a card of
    ``sms`` SMs: 8 (the fewest idle lanes and ballots a word), or 32 (a
    warp a candidate, each lane's run of words 4 times shorter) where 8
    would give the launch, ``nq * ceil(nc / 4)`` warps, fewer than
    ``TIER_B_WIDEN_BELOW`` warps an SM."""
    narrow, wide = TIER_B_SEGMENTS
    warps = nq * -(-nc // (32 // narrow))
    return wide if warps < TIER_B_WIDEN_BELOW[words > narrow] * sms else narrow


def _check(q_t, qlens, cands_t, clens, alphabet):
    if alphabet not in (256, None):
        raise ValueError(f"alphabet must be 256 (bytes) or None (runes), not {alphabet}")
    for name, t in (("q_t", q_t), ("qlens", qlens), ("cands_t", cands_t),
                    ("clens", clens)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D int32 tensor")
        if t.device != q_t.device:
            raise ValueError(f"{name} is on {t.device}, q_t on {q_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows, nq = q_t.shape
    cand_len, nc = cands_t.shape
    if rows % 32 or rows > MAX_ROWS:
        raise ValueError(f"rows {rows} must be a multiple of 32 and <= {MAX_ROWS}")
    if tuple(qlens.shape) != (nq, 1) or tuple(clens.shape) != (1, nc):
        raise ValueError(f"qlens must be ({nq}, 1) and clens (1, {nc}), got "
                         f"{tuple(qlens.shape)} and {tuple(clens.shape)}")


def _check_tables(tables, nq: int, words: int, device) -> None:
    """Raises unless ``tables`` are ``build_rune_tables``' of a block of
    ``nq`` queries and ``words`` words on ``device``."""
    keys, key_offs, peq = tables
    for name, t, dtype in (("keys", keys, torch.int32), ("key_offs", key_offs, torch.int32),
                           ("peq", peq, torch.int64)):
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"rune_tables' {name} must be contiguous {dtype} on {device}")
    if key_offs.shape != (nq + 1,) or peq.dim() != 2 or peq.shape[1] != words:
        raise ValueError(f"rune_tables are not of a block of {nq} queries and {words} words")


def _peq(q_t: torch.Tensor, qlens: torch.Tensor, words: int) -> torch.Tensor:
    """``(n_queries, 256, words)`` int64 match table; chars past a query's
    length and values outside ``[0, 256)`` (the -1 padding) set no bit."""
    rows, nq = q_t.shape
    dev = q_t.device
    i = torch.arange(rows, device=dev)[:, None]
    c = q_t.long()
    valid = (i < qlens.view(1, nq)) & (c >= 0) & (c < 256)
    q = torch.arange(nq, device=dev)[None, :]
    idx = (q * 256 + torch.where(valid, c, 0)) * words + i // 64
    bits = torch.tensor(_BIT, dtype=torch.int64, device=dev)[i % 64]
    bits = torch.where(valid, bits, 0)
    peq = torch.zeros(nq * 256 * words, dtype=torch.int64, device=dev)
    # Distinct bits of one word never carry, so summing them is OR-ing them.
    peq.index_put_((idx.reshape(-1),), bits.reshape(-1), accumulate=True)
    return peq.view(nq, 256, words)


def _rune_peq(q_t: torch.Tensor, qlens: torch.Tensor, words: int):
    """The rune route's match tables: ``keys`` int32, each query's distinct
    runes ascending (query q's are ``keys[key_offs[q]:key_offs[q + 1]]``),
    ``key_offs`` int32 ``(n_queries + 1,)``, and ``peq`` int64
    ``(len(keys), words)``, row k's bit i of word w set iff query char
    ``64 w + i == keys[k]``. Chars past a query's length set no bit."""
    rows, nq = q_t.shape
    dev = q_t.device
    i = torch.arange(rows, device=dev)[:, None].expand(rows, nq)
    q = torch.arange(nq, device=dev)[None, :].expand(rows, nq)
    valid = i < qlens.view(1, nq)
    i, q = i[valid], q[valid]
    # one sort key per (query, rune): queries apart, runes as signed int32
    key = (q << 32) | (q_t[valid].long() + (1 << 31))
    uniq, row = torch.unique(key, sorted=True, return_inverse=True)
    keys = ((uniq & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    key_offs = torch.zeros(nq + 1, dtype=torch.int32, device=dev)
    key_offs[1:] = torch.cumsum(torch.bincount(uniq >> 32, minlength=nq), 0)
    bits = torch.tensor(_BIT, dtype=torch.int64, device=dev)[i % 64]
    peq = torch.zeros(max(uniq.numel(), 1) * words, dtype=torch.int64, device=dev)
    # Distinct bits of one word never carry, so summing them is OR-ing them.
    peq.index_put_((row * words + i // 64,), bits, accumulate=True)
    return keys, key_offs, peq.view(-1, words)


def build_rune_tables(q_t: torch.Tensor, qlens: torch.Tensor):
    """The rune route's tables of a query block, ``(keys, key_offs, peq)``
    (``_rune_peq`` at the block's words), to pass to every ``myers`` call
    on the block as ``rune_tables``; None for CPU tensors, whose plain
    version reads no tables. Each build is counted in ``TABLE_BUILDS``."""
    if q_t.device.type == "cpu":
        return None
    TABLE_BUILDS["rune_tables"] += 1
    return _rune_peq(q_t, qlens, words_of(q_t.shape[0]))


# csrc/myers.cu's rune table: open addressing with linear probing, 2^bits
# slots (the power of two at least 128 * words, so at most half full), a
# rune's home slot the top bits of its 32 bits times the Fibonacci constant,
# an empty slot marked by row -1.
RUNE_HASH = 0x9E3779B9


def rune_table_bits(words: int) -> int:
    """log2 of the rune table's slots for a block of ``words`` words."""
    return max(7, (128 * words - 1).bit_length())


def _home(runes, bits: int) -> np.ndarray:
    c = np.asarray(runes, np.int64) & 0xFFFFFFFF
    return ((c * RUNE_HASH) & 0xFFFFFFFF) >> (32 - bits)


def rune_table(keys, bits: int, order=None):
    """Plain version of the kernel's table of the distinct runes ``keys``
    (rune i on row i), inserted in ``order`` (rows, by default 0, 1, ...;
    the kernel's threads race): ``(slot_runes, slot_rows)``, int64 arrays
    of ``2^bits`` slots, row -1 where empty."""
    keys = np.asarray(keys, np.int64)
    slots = 1 << bits
    if 2 * len(keys) > slots:
        raise ValueError(f"{len(keys)} runes need more than {slots} slots")
    slot_runes = np.full(slots, -1, np.int64)
    slot_rows = np.full(slots, -1, np.int64)
    homes = _home(keys, bits)
    for row in (range(len(keys)) if order is None else order):
        h = int(homes[row])
        while slot_rows[h] >= 0:
            h = (h + 1) & (slots - 1)
        slot_runes[h], slot_rows[h] = keys[row], row
    return slot_runes, slot_rows


def rune_probe(table, runes):
    """The kernel's lookup of each of ``runes`` in ``rune_table``'s
    ``table``: ``(rows, reads)``, int64 arrays of each rune's row (-1 where
    it is not there) and the slots its probe read."""
    slot_runes, slot_rows = table
    mask = len(slot_rows) - 1
    runes = np.asarray(runes, np.int64)
    h = _home(runes, mask.bit_length())
    reads = np.ones(len(runes), np.int64)
    going = (slot_rows[h] >= 0) & (slot_runes[h] != runes)
    while going.any():
        h = np.where(going, (h + 1) & mask, h)
        reads += going
        going &= (slot_rows[h] >= 0) & (slot_runes[h] != runes)
    return slot_rows[h], reads


def _rune_eq(q_t: torch.Tensor, qlens: torch.Tensor, c: torch.Tensor, words: int):
    """``(n_queries, n_cands, words)`` int64 match masks of candidate runes
    ``c`` by direct comparison with every query rune."""
    rows, nq = q_t.shape
    dev = q_t.device
    valid = torch.arange(64 * words, device=dev)[:, None] < qlens.view(1, nq).clamp(max=rows)
    q = torch.cat([q_t, q_t.new_zeros(64 * words - rows, nq)])
    hit = (q[:, :, None] == c[None, None, :]) & valid[:, :, None]
    bits = torch.tensor(_BIT, dtype=torch.int64, device=dev).view(1, 64, 1, 1)
    # Distinct bits of one word never carry, so summing them is OR-ing them.
    eq = (hit.view(words, 64, nq, -1).long() * bits).sum(dim=1)
    return eq.permute(1, 2, 0)


def _uless(a, b):
    """Unsigned a < b on int64 (sign-flip trick)."""
    return (a ^ _INT64_MIN) < (b ^ _INT64_MIN)


def _popcount(v):
    """Per-element popcount of int64 (SWAR; every shift stays exact under
    torch's arithmetic >> because each mask clears the smeared sign bits)."""
    v = v - ((v >> 1) & 0x5555555555555555)
    v = (v & 0x3333333333333333) + ((v >> 2) & 0x3333333333333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)
    return v & 0x7F


def _shift_words(x, d: int, fill):
    """``y[..., w] = x[..., w - d]`` along the word axis, ``fill`` below d."""
    pad = torch.full_like(x[..., :d], fill)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def myers_reference(q_t, qlens, cands_t, clens, alphabet=256) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same recurrence over an
    ``(n_queries, n_cands, W)`` int64 state, one candidate char per step,
    with lanes frozen past their own candidate's end. Bytes read the PEQ;
    runes are compared directly with every query rune."""
    _check(q_t, qlens, cands_t, clens, alphabet)
    rows, nq = q_t.shape
    cand_len, nc = cands_t.shape
    dev = q_t.device
    words = words_of(rows)
    if alphabet is not None:
        peq = torch.cat([_peq(q_t, qlens, words),
                         torch.zeros(nq, 1, words, dtype=torch.int64, device=dev)],
                        dim=1)  # row 256: chars outside [0, 256) match nothing
    m = qlens.view(nq, 1, 1).long().clamp(0, 64 * words)
    w_idx = torch.arange(words, device=dev).view(1, 1, words)
    low = torch.tensor(_LOW, dtype=torch.int64, device=dev)
    mask = low[(m - 64 * w_idx).clamp(0, 64)]  # (nq, 1, words)
    n = clens.view(1, nc).long().clamp(0, cand_len)
    vp = mask.expand(nq, nc, words).clone()
    vn = torch.zeros_like(vp)
    steps = int(n.max()) if nc else 0
    for j in range(steps):
        if alphabet is None:
            eq = _rune_eq(q_t, qlens, cands_t[j], words)
        else:
            c = cands_t[j].long()
            eq = peq[:, torch.where((c >= 0) & (c < 256), c, 256), :]
        xv = eq | vn
        t = eq & vp
        s = t + vp
        if words > 1:
            # Kogge-Stone prefix over the word axis: g = carry out of a word,
            # p = the word passes an incoming carry on (its raw sum is ~0).
            g = _uless(s, t)
            p = s == -1
            d = 1
            while d < words:
                g = g | (p & _shift_words(g, d, False))
                p = p & _shift_words(p, d, False)
                d *= 2
            s = s + _shift_words(g, 1, False).long()
        xh = (s ^ vp) | eq
        ph = vn | ~(xh | vp)
        mh = vp & xh
        ph = (ph << 1) | _shift_words((ph >> 63) & 1, 1, 1)
        mh = (mh << 1) | _shift_words((mh >> 63) & 1, 1, 0)
        live = (j < n).view(1, nc, 1)
        vp = torch.where(live, mh | ~(xv | ph), vp)
        vn = torch.where(live, ph & xv, vn)
    delta = (_popcount(vp & mask) - _popcount(vn & mask)).sum(dim=-1)
    return (n + delta).to(torch.int32)


def myers(q_t, qlens, cands_t, clens, alphabet=256, *, rune_tables=None) -> torch.Tensor:
    """All-pairs unit-cost edit distances ``(n_queries, n_cands) int32``
    over bytes (``alphabet=256``) or runes (``alphabet=None``): the Hopper
    kernel for CUDA tensors, the plain version for CPU ones. Runes on CUDA
    take ``rune_tables`` (the query block's ``build_rune_tables(q_t,
    qlens)``) where the caller built them, or build them here."""
    _check(q_t, qlens, cands_t, clens, alphabet)
    if q_t.device.type == "cpu":
        return myers_reference(q_t, qlens, cands_t, clens, alphabet)
    if q_t.device.type != "cuda":
        raise ValueError(f"myers runs on CUDA or CPU tensors, not {q_t.device}")
    rows, nq = q_t.shape
    cand_len, nc = cands_t.shape
    out = torch.empty((nq, nc), dtype=torch.int32, device=q_t.device)
    if nq == 0 or nc == 0:
        return out
    words = words_of(rows)
    if alphabet is None:
        if rune_tables is None:
            rune_tables = build_rune_tables(q_t, qlens)
        _check_tables(rune_tables, nq, words, q_t.device)
    tier_b = words > _TIER_A_WORDS
    # tier B takes the candidates by length, so those of a warp end together
    order = torch.argsort(clens.view(-1)).to(torch.int32) if tier_b else None
    seg = (tier_b_plan(words, nq, nc, torch.cuda.get_device_properties(q_t.device)
                       .multi_processor_count) if tier_b else 0)
    lib = cuda_build.load()
    with torch.cuda.device(q_t.device):
        stream = torch.cuda.current_stream(q_t.device).cuda_stream
        tail = (words, qlens.data_ptr(), nq, cands_t.data_ptr(), clens.data_ptr(),
                None if order is None else order.data_ptr(), seg, cand_len, nc,
                out.data_ptr(), stream)
        if alphabet is None:
            keys, key_offs, peq = rune_tables
            name = "sz_myers_runes"
            err = lib.sz_myers_runes(keys.data_ptr(), key_offs.data_ptr(),
                                     peq.data_ptr(), *tail)
        else:
            peq = _peq(q_t, qlens, words)
            name = "sz_myers"
            err = lib.sz_myers(peq.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    tier = "myers_tier_b" if tier_b else "myers_tier_a"
    KERNEL_LAUNCHES[tier if alphabet is not None else tier + "_runes"] += 1
    return out
