"""Compare domain: equality and 3-way lexicographic order, single and batch.

Counterpart of ``stringzilla_tpu/ops/compare.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax). The
reference's ``compare`` domain (``sz_equal`` reference ``compare.h:53``,
``sz_order`` ``compare.h:88``) is a bounded memcmp. The batch forms compare
whole collections at once through the sorter's big-endian key words
(``ops.sort.pgram_keys_bounds``): a comparison is a lexicographic compare
of key vectors, vectorised in numpy.
"""

from __future__ import annotations

import numpy as np

from .sort import pgram_keys_bounds

__all__ = ["equal", "order", "batch_equal", "batch_order"]


def _as_bytes(x) -> bytes:
    if isinstance(x, str):
        return x.encode("utf-8")
    return bytes(x)


def equal(a, b) -> bool:
    """Bounded equality (``sz_equal``, reference ``compare.h:53``)."""
    return _as_bytes(a) == _as_bytes(b)


def order(a, b) -> int:
    """3-way lexicographic order: -1/0/+1 (``sz_order``, ``compare.h:88``)."""
    a, b = _as_bytes(a), _as_bytes(b)
    return -1 if a < b else (0 if a == b else 1)


def _keys_for(items: list[bytes], words: int) -> np.ndarray:
    lens = np.fromiter(map(len, items), dtype=np.int64, count=len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = np.frombuffer(b"".join(items), dtype=np.uint8)
    return pgram_keys_bounds(data, offsets[:-1], offsets[1:], words)


def _pair_keys(first, second):
    """Key matrices of both collections, of one width (the longer string's
    words, at least two, then the length)."""
    a = [_as_bytes(x) for x in first]
    b = [_as_bytes(x) for x in second]
    if len(a) != len(b):
        raise ValueError("collections must have equal length")
    maxlen = max((len(s) for s in a + b), default=0)
    words = max(-(-maxlen // 4), 2)
    return _keys_for(a, words), _keys_for(b, words)


def batch_equal(first, second) -> np.ndarray:
    """Pairwise ``first[i] == second[i]`` over two equally-long collections."""
    ka, kb = _pair_keys(first, second)
    return (ka == kb).all(axis=1)


def batch_order(first, second) -> np.ndarray:
    """Pairwise 3-way order verdicts (-1/0/+1) as ``int8[n]``."""
    ka, kb = _pair_keys(first, second)
    lt = np.zeros(len(ka), dtype=bool)
    gt = np.zeros(len(ka), dtype=bool)
    undecided = np.ones(len(ka), dtype=bool)
    for c in range(ka.shape[1]):
        col_lt = undecided & (ka[:, c] < kb[:, c])
        col_gt = undecided & (ka[:, c] > kb[:, c])
        lt |= col_lt
        gt |= col_gt
        undecided &= ~(col_lt | col_gt)
    return gt.astype(np.int8) - lt.astype(np.int8)
