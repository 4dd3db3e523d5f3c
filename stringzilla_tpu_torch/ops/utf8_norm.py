"""Own UAX-15 normalization machinery — NFC/NFD/NFKC/NFKD over generated
UCD tables (reference: ``include/stringzilla/utf8_norm.h:46-60`` + its
generated ``utf8_norm/tables.h``; the reference's quick-check short-circuit
is described in ``README.md:899-903``).

Counterpart of ``stringzilla_tpu/ops/utf8_norm.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax). Pipeline
(D-forms): full-decomposition gather → canonical reordering; C-forms add
the canonical pairwise recomposition (UAX-15 D117). The decomposition and
reordering stages are vectorized numpy (single gather + one stable
``lexsort``); composition is the textbook starter-walk. A packed
quick-check table (derived per UAX-15 §9) short-circuits already-normalized
text — the overwhelmingly common case — to a single vectorized scan.

The tables are ``ops.ucd``'s text group, which the standard library builds
(``ucd.text_available()``); the JAX module needs ``regex`` for them and
otherwise takes the ``unicodedata`` fallbacks kept here for the same test.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "normalize_runes", "utf8_norm", "utf8_is_normalized",
    "utf8_find_denormalized",
]

_FORMS = ("NFC", "NFD", "NFKC", "NFKD")
_QC_SHIFT = {"NFC": 0, "NFD": 2, "NFKC": 4, "NFKD": 6}

_pairs_dict: dict[int, int] | None = None


def _encode(runes: np.ndarray) -> bytes:
    """u32 scalar runes → UTF-8 (the native encoder when available)."""
    from ..utils import native

    arr = np.asarray(runes, dtype=np.uint32)
    if native.available():
        out = native.utf8_encode(arr)
        if out is not None:
            return bytes(out)
    return arr.astype("<u4").tobytes().decode("utf-32-le").encode("utf-8")


def _pairs() -> dict[int, int]:
    global _pairs_dict
    if _pairs_dict is None:
        from . import ucd

        keys, vals = ucd.comp_pairs()
        _pairs_dict = {int(k): int(v) for k, v in zip(keys, vals)}
    return _pairs_dict


def _decompose(runes: np.ndarray, compat: bool) -> np.ndarray:
    """Full recursive decomposition as one gather + repeat-expansion."""
    from . import ucd

    idx, vals, offs = ucd.decomp_tables(compat)
    di = idx[runes]
    has = di >= 0
    if not has.any():
        return runes
    lens = np.ones(len(runes), dtype=np.int64)
    lens[has] = offs[di[has] + 1] - offs[di[has]]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    total = int(lens.sum())
    src = np.repeat(np.arange(len(runes)), lens)
    within = np.arange(total) - starts[src]
    exp = has[src]
    gather = offs[np.maximum(di[src], 0)] + within
    return np.where(exp, vals[np.where(exp, gather, 0)],
                    runes[src]).astype(np.uint32)


def _reorder(runes: np.ndarray, c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonical ordering: stable sort of each nonzero-ccc run (UAX-15 D108).
    One ``lexsort`` — segment id (starters open segments), then ccc, then
    original position for stability."""
    seg = np.cumsum(c == 0)
    order = np.lexsort((np.arange(len(runes)), c, seg))
    return runes[order], c[order]


def _compose(runes: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Canonical pairwise composition (UAX-15 D117 starter walk)."""
    pairs = _pairs()
    out: list[int] = []
    starter_pos = -1
    last_cc = 0
    for r, cc in zip(runes.tolist(), c.tolist()):
        cc = int(cc)
        if starter_pos >= 0 and (last_cc < cc or last_cc == 0):
            comp = pairs.get((out[starter_pos] << 21) | int(r))
            if comp is not None:
                out[starter_pos] = comp
                continue
        out.append(int(r))
        if cc == 0:
            starter_pos = len(out) - 1
            last_cc = 0
        else:
            last_cc = cc
    return np.asarray(out, dtype=np.uint32)


def normalize_runes(runes: np.ndarray, form: str) -> np.ndarray:
    """Normalize a u32 rune array to the given form (own machinery)."""
    from . import ucd

    if form not in _FORMS:
        raise ValueError(f"form must be one of {_FORMS}")
    if len(runes) == 0:
        return np.asarray(runes, dtype=np.uint32)
    runes = np.asarray(runes, dtype=np.uint32)
    dec = _decompose(runes, compat=form in ("NFKC", "NFKD"))
    c = ucd.ccc()[dec]
    dec, c = _reorder(dec, c)
    if form in ("NFC", "NFKC"):
        dec = _compose(dec, c)
    return dec


def _suspects(runes: np.ndarray, form: str) -> np.ndarray:
    """Indices where quick-check is not Yes or canonical order is violated."""
    from . import ucd

    qc = (ucd.qc_classes()[runes] >> _QC_SHIFT[form]) & 0x3
    c = ucd.ccc()[runes]
    bad = qc != 0
    if len(runes) > 1:
        viol = np.zeros(len(runes), dtype=bool)
        viol[1:] = (c[1:] != 0) & (c[1:] < c[:-1])
        bad |= viol
    return np.nonzero(bad)[0]


def _seq_bounds(c: np.ndarray, i: int) -> tuple[int, int]:
    """[start, end) of the combining sequence containing rune index i."""
    start = i
    while start > 0 and c[start] != 0:
        start -= 1
    end = i + 1
    n = len(c)
    while end < n and c[end] != 0:
        end += 1
    return start, end


def _first_divergent(runes: np.ndarray, form: str) -> int:
    """Rune index of the start of the first combining sequence that is not
    in normal form, or -1. Quick-check Maybe hits are verified by
    normalizing just their combining sequence."""
    from . import ucd

    sus = _suspects(runes, form)
    if len(sus) == 0:
        return -1
    c = ucd.ccc()[runes]
    checked_until = -1
    for i in sus.tolist():
        if i < checked_until:
            continue
        start, end = _seq_bounds(c, i)
        # A starter suspect (e.g. Hangul V/T jamo, QC=Maybe) composes with
        # the PRECEDING starter — pull it into the window; combining-mark
        # suspects already rewound onto their starter.
        if start == i and c[i] == 0 and start > 0:
            start -= 1
        window = runes[start:end]
        norm = normalize_runes(window, form)
        if not np.array_equal(norm, window):
            # first rune the normalization actually rewrites
            k = min(len(norm), len(window))
            same = np.nonzero(norm[:k] != window[:k])[0]
            return start + (int(same[0]) if len(same) else k)
        checked_until = end
    return -1


def _dispatch(data, form: str):
    """Common entry. ONE batched scan decides which islands are suspect:
    the pure non-ASCII runs are concatenated (space-separated — islands
    contain no ASCII), decoded natively in one call, and quick-check/ccc
    gathered vectorized. Only suspect islands — a Maybe/No rune or an
    ordering violation — are decoded individually afterwards.

    Returns ``(buf, [(w0, w1, runes) for each SUSPECT island])`` where w0
    includes the one-ASCII-char backward extension (recomposition reach).
    """
    from .utf8 import _as_bytes, utf8_decode
    from . import ucd

    buf = _as_bytes(data)
    arr = np.frombuffer(buf, dtype=np.uint8)
    if form not in _FORMS:
        raise ValueError(f"form must be one of {_FORMS}")
    # Vectorized island enumeration (the per-island Python loop was the
    # clean-corpus bottleneck): maximal non-ASCII runs via nonzero+diff,
    # their concatenation is just arr[hi], separators inserted at the
    # cumulative run lengths.  Windowing per island is EXACT: ASCII is
    # stable under every normal form (no decompositions, ccc 0, QC Yes)
    # and never pair-composes, so normalization can only rewrite bytes
    # inside a maximal non-ASCII run plus — through recomposition — the
    # single character immediately before it (e + ◌́ → é); nothing
    # interacts across a window boundary.
    hi = np.nonzero(arr >= 0x80)[0]
    if hi.size == 0:
        return buf, []
    gaps = np.nonzero(np.diff(hi) > 1)[0]
    starts = np.concatenate([[hi[0]], hi[gaps + 1]])
    ends = np.concatenate([hi[gaps] + 1, [hi[-1] + 1]])
    w0s = np.maximum(starts - 1, 0)  # one-ASCII-char recomposition reach
    cat = np.insert(arr[hi], np.cumsum(ends - starts), 32).tobytes()
    try:
        from .segment import decode_runes

        runes, _offs = decode_runes(cat)
    except Exception:  # pragma: no cover — native decoder unavailable
        runes = utf8_decode(cat)
    runes = np.asarray(runes, dtype=np.int64)
    sep_mask = runes == 32
    island_id = np.concatenate([[0], np.cumsum(sep_mask)[:-1]])
    qc = (ucd.qc_classes()[runes] >> _QC_SHIFT[form]) & 0x3
    c = ucd.ccc()[runes]
    bad = qc != 0
    if len(runes) > 1:
        viol = np.zeros(len(runes), dtype=bool)
        viol[1:] = (c[1:] != 0) & (c[1:] < c[:-1])
        bad |= viol
    bad &= ~sep_mask
    suspect_ids = np.unique(island_id[bad])
    out = []
    for i in suspect_ids.tolist():
        w0, w1 = int(w0s[i]), int(ends[i])
        out.append((w0, w1, utf8_decode(buf[w0:w1])))
    return buf, out


def _renorm_island(raw: bytes, form: str) -> bytes:
    """Re-encode a denormalized island, keeping invalid-UTF-8 byte runs
    verbatim: only maximal *valid* rune spans are normalized and re-encoded,
    so normalization never rewrites bytes it did not need to touch (clean
    invalid islands already pass through byte-identical)."""
    from .segment import decode_runes

    runes, offs = decode_runes(raw)
    runes = np.asarray(runes, dtype=np.int64)
    offs = np.asarray(offs, dtype=np.int64)
    # A decoded U+FFFD is a *source* replacement iff its source bytes are not
    # the literal EF BF BD encoding.
    bad = np.zeros(len(runes), dtype=bool)
    for j in np.nonzero(runes == 0xFFFD)[0]:
        if raw[offs[j]:offs[j + 1]] != b"\xef\xbf\xbd":
            bad[j] = True
    if not bad.any():
        return _encode(normalize_runes(runes, form))
    out, j, n = [], 0, len(runes)
    while j < n:
        if bad[j]:
            k = j
            while k < n and bad[k]:
                k += 1
            out.append(raw[offs[j]:offs[k]])
        else:
            k = j
            while k < n and not bad[k]:
                k += 1
            out.append(_encode(normalize_runes(runes[j:k], form)))
        j = k
    return b"".join(out)


def utf8_norm(data, form: str = "NFC") -> bytes:
    """UAX-15 normalization of a UTF-8 buffer (``sz_utf8_norm``, reference
    ``utf8_norm.h:46``). The ASCII bulk is passed through untouched at
    memory speed (the reference's quick-check short-circuit,
    ``README.md:899-903``); only non-ASCII islands are decoded, checked,
    and — when actually denormalized — rewritten and spliced back."""
    from . import ucd

    if not ucd.text_available():  # tables unavailable → stdlib fallback
        from .utf8 import _as_bytes

        import unicodedata

        buf = _as_bytes(data)
        if form not in _FORMS:
            raise ValueError(f"form must be one of {_FORMS}")
        return unicodedata.normalize(
            form, buf.decode("utf-8", "replace")).encode("utf-8")
    buf, wins = _dispatch(data, form)
    dirty = []
    for w0, w1, runes in wins:
        if _first_divergent(runes, form) >= 0:
            dirty.append((w0, w1, _renorm_island(bytes(buf[w0:w1]), form)))
    if not dirty:
        return bytes(buf)
    parts, pos = [], 0
    for w0, w1, rep in dirty:
        parts.append(buf[pos:w0])
        parts.append(rep)
        pos = w1
    parts.append(buf[pos:])
    return b"".join(parts)


def utf8_is_normalized(data, form: str = "NFC") -> bool:
    from . import ucd

    if not ucd.text_available():
        from .utf8 import _as_bytes

        import unicodedata

        return unicodedata.is_normalized(
            form, _as_bytes(data).decode("utf-8", "replace"))
    _, wins = _dispatch(data, form)
    return all(_first_divergent(runes, form) < 0 for _, _, runes in wins)


def utf8_find_denormalized(data, form: str = "NFC") -> int:
    """Byte offset of the first combining sequence that is not in normal
    form, or -1 (``sz_utf8_find_denormalized``, reference ``utf8_norm.h:60``)."""
    from . import ucd

    if not ucd.text_available():
        from .utf8 import _as_bytes

        import unicodedata

        s = _as_bytes(data).decode("utf-8", "replace")
        if unicodedata.is_normalized(form, s):
            return -1
        t = unicodedata.normalize(form, s)
        p = 0
        while p < len(s) and p < len(t) and s[p] == t[p]:
            p += 1
        seq_start = min(p, len(s) - 1)
        while seq_start > 0 and unicodedata.combining(s[seq_start]):
            seq_start -= 1
        return len(s[:seq_start].encode("utf-8"))
    _, wins = _dispatch(data, form)
    for w0, _w1, runes in wins:
        i = _first_divergent(runes, form)
        if i >= 0:
            return w0 + int(len(_encode(runes[:i])))
    return -1
