"""Myers bit-parallel unit-cost Levenshtein over byte strings.

Counterpart of ``stringzilla_tpu/ops/myers_pallas.py``, with the same
layouts at the public function, so the two are compared like with like:

    myers(q_t, qlens, cands_t, clens) -> (n_queries, n_cands) int32

* ``q_t``      ``(rows, n_queries)`` int32 query chars, padded with -1;
  ``rows`` is a multiple of 32 and at most 4096;
* ``qlens``    ``(n_queries, 1)`` int32;
* ``cands_t``  ``(cand_len, n_cands)`` int32 candidate chars;
* ``clens``    ``(1, n_cands)`` int32.

Chars are bytes: a value outside ``[0, 256)`` matches nothing (the JAX
kernel's ``alphabet=256`` contract). Each query of length m occupies
``W = ceil(rows / 64)`` 64-bit words; its match table ``peq[c][w]`` (bit i
set iff query char ``64 w + i == c``, the reference's 256-entry PEQ,
``serial.hpp:2189``) is built here with torch ops and read by both versions.
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

import torch

from ..utils import cuda_build

__all__ = ["myers", "myers_reference", "KERNEL_LAUNCHES", "MAX_ROWS"]

MAX_ROWS = 4096  # longer queries wait for the wavefront tier
_TIER_A_WORDS = 4  # csrc/myers.cu keeps up to 4 words per thread in registers

# Launches of each CUDA kernel, counted where the wrapper launches it.
KERNEL_LAUNCHES = {"myers_tier_a": 0, "myers_tier_b": 0}

_INT64_MIN = -(1 << 63)
# Bit k as an int64 value (bit 63 is INT64_MIN), and the masks of bits [0, k).
_BIT = [1 << k for k in range(63)] + [_INT64_MIN]
_LOW = [(1 << k) - 1 for k in range(64)] + [-1]


def words_of(rows: int) -> int:
    """64-bit words a query block of ``rows`` chars occupies."""
    return max(1, -(-rows // 64))


def _check(q_t, qlens, cands_t, clens):
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


def myers_reference(q_t, qlens, cands_t, clens) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same recurrence over an
    ``(n_queries, n_cands, W)`` int64 state, one candidate char per step,
    with lanes frozen past their own candidate's end."""
    _check(q_t, qlens, cands_t, clens)
    rows, nq = q_t.shape
    cand_len, nc = cands_t.shape
    dev = q_t.device
    words = words_of(rows)
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
        c = cands_t[j].long()
        c = torch.where((c >= 0) & (c < 256), c, 256)
        eq = peq[:, c, :]
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


def myers(q_t, qlens, cands_t, clens) -> torch.Tensor:
    """All-pairs unit-cost edit distances ``(n_queries, n_cands) int32``:
    the Hopper kernel for CUDA tensors, the plain version for CPU ones."""
    _check(q_t, qlens, cands_t, clens)
    if q_t.device.type == "cpu":
        return myers_reference(q_t, qlens, cands_t, clens)
    if q_t.device.type != "cuda":
        raise ValueError(f"myers runs on CUDA or CPU tensors, not {q_t.device}")
    rows, nq = q_t.shape
    cand_len, nc = cands_t.shape
    out = torch.empty((nq, nc), dtype=torch.int32, device=q_t.device)
    if nq == 0 or nc == 0:
        return out
    words = words_of(rows)
    peq = _peq(q_t, qlens, words)
    lib = cuda_build.load()
    with torch.cuda.device(q_t.device):
        stream = torch.cuda.current_stream(q_t.device).cuda_stream
        err = lib.sz_myers(peq.data_ptr(), words, qlens.data_ptr(), nq,
                           cands_t.data_ptr(), clens.data_ptr(), cand_len, nc,
                           out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sz_myers launch failed: "
                           f"{lib.sz_cuda_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES["myers_tier_a" if words <= _TIER_A_WORDS
                    else "myers_tier_b"] += 1
    return out
