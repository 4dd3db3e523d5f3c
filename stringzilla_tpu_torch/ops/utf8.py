"""UTF-8 layer: rune decode/count/seek, case folding, normalization, uncased
search, token boundaries, grapheme clusters.

Counterpart of ``stringzilla_tpu/ops/utf8.py``, copied rather than imported
(importing any ``stringzilla_tpu`` module imports jax). Re-creates the
behavior of the reference's ``utf8_*`` domains (reference
``include/stringzilla/utf8_runes.h:34-96``, ``utf8_uncased_fold.h:55``,
``utf8_norm.h:46-60``, ``utf8_uncased.h:746-957``, ``utf8_tokens.h:53-139``,
``utf8_graphemes.h:37``). Invalid input resynchronizes with U+FFFD per
maximal subpart (``README.md:888-893``) — exactly Python's
``errors="replace"`` policy, which is the host-exact engine here. The hot
paths run in the native host runtime (``utils/native.py``) over the
generated UCD tables of ``ops.ucd``; each keeps a Python fallback for when
the library cannot be built.

Case-insensitive search of a buffer of 1 MiB or more has a device tier,
``_uncased_find_device``: the byte-LUT kernel folds the buffer's ASCII on
the card, the streaming-search kernel finds the folded needle and the next
non-ASCII byte, and the native scanner patches the windows around each
non-ASCII run. On a card it has no Python fallback: without the native
library it raises.

Grapheme clustering implements UAX-29 GB1-GB13: exactly over the segment
tables where ``ops.ucd.available()``, else with properties derived from
``unicodedata`` (Extended_Pictographic approximated by the emoji blocks).
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache

import numpy as np

__all__ = [
    "utf8_count",
    "utf8_decode",
    "utf8_seek",
    "utf8_fold",
    "utf8_norm",
    "utf8_is_normalized",
    "utf8_find_denormalized",
    "utf8_uncased_find",
    "utf8_uncased_order",
    "utf8_newlines",
    "utf8_whitespaces",
    "utf8_delimiters",
    "utf8_graphemes",
]

_REPLACEMENT = 0xFFFD

# Unicode newline sequences (UAX-14 mandatory breaks; reference
# ``utf8_tokens.h:53``). CRLF counts as one token.
_NEWLINE_RUNES = (0x0A, 0x0B, 0x0C, 0x0D, 0x85, 0x2028, 0x2029)


def _as_bytes(data) -> bytes:
    if isinstance(data, str):
        return data.encode("utf-8")
    return bytes(data)


def _as_u8(data) -> np.ndarray:
    """``data`` as a ``uint8`` array, without a copy for an array or a
    bytes-like object."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if isinstance(data, str):
        data = data.encode("utf-8")
    return np.frombuffer(data, dtype=np.uint8)


def _decode(data) -> str:
    return _as_bytes(data).decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Runes
# ---------------------------------------------------------------------------


def utf8_count(data) -> int:
    """Number of runes incl. U+FFFD replacements (``sz_utf8_count``,
    reference ``utf8_runes.h:34``)."""
    buf = _as_bytes(data)
    arr = np.frombuffer(buf, dtype=np.uint8)
    lead_count = int(((arr & 0xC0) != 0x80).sum())
    # Fast path: valid UTF-8 has one rune per lead byte. Validate cheaply; on
    # failure fall back to the exact replacement-aware decode.
    try:
        buf.decode("utf-8")
        return lead_count
    except UnicodeDecodeError:
        return len(_decode(buf))


def utf8_decode(data) -> np.ndarray:
    """Decode to ``uint32`` runes (``sz_utf8_decode``, ``utf8_runes.h:96``)."""
    s = _decode(data)
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def utf8_seek(data, rune_index: int) -> int:
    """Byte offset of rune ``rune_index`` (``sz_utf8_seek``,
    ``utf8_runes.h:58``). Clamps to the end like the reference."""
    buf = _as_bytes(data)
    try:
        buf.decode("utf-8")
        arr = np.frombuffer(buf, dtype=np.uint8)
        leads = np.nonzero((arr & 0xC0) != 0x80)[0]
        if rune_index >= len(leads):
            return len(buf)
        return int(leads[rune_index])
    except UnicodeDecodeError:
        # Exact path: walk maximal subparts.
        count = 0
        dec = _incremental_runes(buf)
        for off, _length, _r in dec:
            if count == rune_index:
                return off
            count += 1
        return len(buf)


def _incremental_runes(buf: bytes):
    """Yield (byte_offset, byte_length, rune) with U+FFFD maximal-subpart
    resync — the reference's fill-and-drain decode contract."""
    i, n = 0, len(buf)
    while i < n:
        b = buf[i]
        if b < 0x80:
            yield (i, 1, b)
            i += 1
            continue
        # sequence length from the lead byte
        if b >> 5 == 0b110:
            L = 2
        elif b >> 4 == 0b1110:
            L = 3
        elif b >> 3 == 0b11110:
            L = 4
        else:
            L = 0
        if L and i + L <= n:
            try:
                ch = buf[i : i + L].decode("utf-8")
                yield (i, L, ord(ch))
                i += L
                continue
            except UnicodeDecodeError:
                pass
        # invalid: consume the maximal subpart (the longest prefix Python's
        # 'replace' policy turns into a single U+FFFD)
        j = i + 1
        while j < n and j - i < 4:
            if buf[i : j + 1].decode("utf-8", "replace") != "�":
                break
            j += 1
        yield (i, j - i, _REPLACEMENT)
        i = j


# ---------------------------------------------------------------------------
# Case folding / normalization
# ---------------------------------------------------------------------------


def utf8_fold(data) -> bytes:
    """Full Unicode case folding incl. multi-char expansions — ß→ss, ﬃ→ffi
    (``sz_utf8_uncased_fold``, reference ``utf8_uncased_fold.h:55``). The
    hot path is the native fused decode→fold→encode over generated
    CaseFolding tables (``tapecraft.cpp::tc_utf8_fold_bytes``); fallback is
    ``str.casefold`` (same C+F full folding)."""
    buf = _as_bytes(data)
    out = _native_fold_bytes(buf)
    if out is not None:
        return out
    return _decode(buf).casefold().encode("utf-8")


def _fold_tables():
    from . import ucd

    if not ucd.text_available():
        return None
    t = ucd._load_text()
    return (t["fold1"], t["fold_multi_keys"], t["fold_multi_offs"],
            t["fold_multi_vals"])


def _native_fold_bytes(buf: bytes) -> bytes | None:
    from ..utils import native

    if not native.available():
        return None
    tabs = _fold_tables()
    if tabs is None:
        return None
    out = native.utf8_fold_bytes(np.frombuffer(buf, dtype=np.uint8), *tabs)
    return bytes(out) if out is not None else None


# UAX-15 normalization lives in utf8_norm.py — own decompose/reorder/compose
# machinery over generated UCD tables with a quick-check fast path
# (re-exported here to keep the one-module-per-domain surface flat).
from .utf8_norm import (  # noqa: E402
    utf8_find_denormalized,
    utf8_is_normalized,
    utf8_norm,
)


# ---------------------------------------------------------------------------
# Case-insensitive search (fold on the fly, original offsets)
# ---------------------------------------------------------------------------


def _fold_with_offsets(buf: bytes):
    """Folded rune list + per-folded-rune (byte_offset, byte_len) into the
    original buffer; expansions share their source rune's span."""
    folded: list[int] = []
    spans: list[tuple[int, int]] = []
    for off, length, r in _incremental_runes(buf):
        f = chr(r).casefold()
        for ch in f:
            folded.append(ord(ch))
            spans.append((off, length))
    return folded, spans


def _folded_with_spans(buf: bytes):
    """(folded_runes int64[m], start_off int64[m], end_off int64[m]) — the
    native decode+fold pipeline with per-folded-rune source byte spans;
    Python fallback."""
    from ..utils import native

    tabs = _fold_tables()
    if native.available() and tabs is not None:
        dec = native.utf8_decode(np.frombuffer(buf, dtype=np.uint8))
        runes, offs = dec
        fr = native.fold_runes(runes, *tabs)
        folded, src = fr
        starts = offs[:-1].astype(np.int64)[src]
        ends = offs[1:].astype(np.int64)[src]
        return folded.astype(np.int64), starts, ends
    h_folded, h_spans = _fold_with_offsets(buf)
    starts = np.asarray([s for s, _l in h_spans], dtype=np.int64)
    ends = starts + np.asarray([l for _s, l in h_spans], dtype=np.int64)
    return np.asarray(h_folded, dtype=np.int64), starts, ends


_UNCASED_DEVICE_MIN = 1 << 20


def _uncased_find_device(hb, nd_f: np.ndarray, device, hay, folded,
                         min_bytes: int | None = None):
    """Device tier for case-insensitive search over big, ASCII-dominant
    buffers: fold ASCII on the card with the byte-LUT kernel (ASCII case
    folding is 1:1 byte-level), find the folded needle and the next byte
    >= 0x80 with the streaming-search kernel, and patch every window that
    can touch a non-ASCII run with the exact native scanner. Byte-fold
    matches are genuine (a byte >= 0x80 can never equal an ASCII needle
    byte, so any reported window is all-ASCII); the patches only add the
    matches that *involve* non-ASCII folding (K -> k, ß -> ss, ...).

    ``hb`` is the buffer (a ``uint8`` array or bytes-like), ``device`` where
    its mirrors live, and ``hay`` and ``folded`` zero-argument callables
    that give the flat mirror (``hb`` in ``hay()[:n]``) and its ASCII-folded
    copy; they are called only once the search qualifies. Every search is
    bounded by ``n``, since a folded needle can hold ``\\x00``. Returns
    ``(off, len)`` / ``(-1, 0)``, or None when the shape doesn't qualify (an
    empty needle, a buffer under ``min_bytes``, a needle with a folded byte
    >= 0x80, or more than 64 non-ASCII runs before the answer): the caller
    then runs the whole-buffer native scan. On a CPU device the tier also
    declines when the native library or the fold tables are missing; on a
    card it raises then, so the search never moves to the host unnoticed.

    Unlike the JAX function, any needle length qualifies (the search is
    exact for any length), and a needle hit is kept across rounds: the
    first hit from a lower start is also the first from any start up to it,
    so the needle search runs again only when the patches have passed it.
    """
    import torch

    from ..utils import native

    k = int(len(nd_f))
    n = len(hb)
    if k == 0 or n < (_UNCASED_DEVICE_MIN if min_bytes is None else min_bytes):
        return None
    if (np.asarray(nd_f) >= 0x80).any():
        return None
    tabs = _fold_tables()
    if torch.device(device).type == "cpu":
        if not native.available() or tabs is None:
            return None
    else:
        native.load()
        if tabs is None:
            raise RuntimeError("the case-folding tables are unavailable")
    from .find import byteset_mask
    from .find_kernel import search_positions

    arr = _as_u8(hb)
    hay, folded = hay(), folded()
    hi_ws = byteset_mask(bytes(range(128, 256)))
    needle = np.asarray(nd_f, dtype=np.uint8)
    margin = 4 * k + 8  # max source-byte span of a k-folded-rune window
    pos = 0
    p_a = None
    for _ in range(64):  # too many unicode islands → whole-buffer native
        if p_a is None or 0 <= p_a < pos:
            p_a = int(search_positions(folded, n, "first", needle=needle, lo=pos))
        p_hi = int(search_positions(hay, n, "first", byteset_words=hi_ws, lo=pos))
        if p_hi < 0:
            return (p_a, k) if p_a >= 0 else (-1, 0)
        if p_a >= 0 and p_a + k <= p_hi:
            return (p_a, k)
        # Exact native patch around the non-ASCII run: covers every window
        # that can overlap it; all-ASCII windows before/after stay with the
        # device scan.
        w0 = max(pos, p_hi - margin)
        run_end = p_hi
        while run_end < n and arr[run_end] >= 0x80:
            run_end += 1
        w1 = min(n, run_end + margin)
        res = native.utf8_uncased_find(arr[w0:w1], np.asarray(nd_f, np.uint32),
                                       0, *tabs)
        # Only starts BEFORE run_end are this patch's to decide: a window
        # starting at or after run_end cannot touch this run (windows only
        # extend forward), so the device scan / a later patch owns it — and
        # the patch buffer is truncated at w1, which could otherwise hide an
        # earlier crossing match while reporting a later in-buffer one.
        if res is not None and 0 <= res[0] < run_end - w0:
            return (w0 + res[0], res[1])
        pos = run_end
        if pos >= n:
            return (-1, 0)
    return None  # dense non-ASCII: caller falls through to the native scan


def ascii_fold_lut() -> np.ndarray:
    """The byte LUT of ASCII case folding: A-Z → a-z, every other byte kept
    (exactly ``tolower`` on ASCII; bytes >= 0x80 are left to the patches)."""
    lut = np.arange(256, dtype=np.uint8)
    lut[65:91] += 32
    return lut


def utf8_uncased_find(haystack, needle, start_rune: int = 0):
    """Case-insensitive substring search; returns ``(byte_offset, byte_len)``
    in the ORIGINAL haystack bytes or ``(-1, 0)`` (``sz_utf8_uncased_search``,
    reference ``utf8_uncased.h:957``). Hot path: the fused native scan that
    folds on the fly — no folded-haystack materialization, SWAR-skipped
    ASCII runs, candidate positions verified incrementally (the reference's
    own architecture). Fallback: decode+fold to rune arrays with source
    spans, then a dense shifted-compare."""
    nb = _as_bytes(needle)
    from ..utils import native

    tabs = _fold_tables()
    if native.available() and tabs is not None:
        nd_f, _, _ = _folded_with_spans(nb)
        res = native.utf8_uncased_find(
            _as_u8(haystack), nd_f.astype(np.uint32), start_rune, *tabs)
        if res is not None:
            return res
    h, starts, ends = _folded_with_spans(_as_bytes(haystack))
    nd, _, _ = _folded_with_spans(nb)
    k = len(nd)
    if k == 0:
        return (0, 0)
    if len(h) < k:
        return (-1, 0)
    mask = np.ones(len(h) - k + 1, dtype=bool)
    for a in range(k):
        mask &= h[a : len(h) - k + 1 + a] == nd[a]
    idx = np.nonzero(mask)[0]
    idx = idx[idx >= start_rune]
    if idx.size == 0:
        return (-1, 0)
    i = int(idx[0])
    return (int(starts[i]), int(ends[i + k - 1] - starts[i]))


def _folded_runes(buf: bytes) -> np.ndarray:
    """Folded rune array without source spans (cheaper: no src allocation)."""
    from ..utils import native

    tabs = _fold_tables()
    if native.available() and tabs is not None:
        runes, _offs = native.utf8_decode(np.frombuffer(buf, dtype=np.uint8))
        folded, _ = native.fold_runes(runes, *tabs, with_src=False)
        return folded.astype(np.int64)
    return _folded_with_spans(buf)[0]


def utf8_uncased_order(a, b) -> int:
    """Uncased 3-way collation (``sz_utf8_uncased_order``,
    ``utf8_uncased.h:746``) — rune-wise order of the folded streams."""
    fa, fb = _folded_runes(_as_bytes(a)), _folded_runes(_as_bytes(b))
    n = min(len(fa), len(fb))
    neq = np.nonzero(fa[:n] != fb[:n])[0]
    if neq.size:
        i = neq[0]
        return -1 if fa[i] < fb[i] else 1
    return -1 if len(fa) < len(fb) else (0 if len(fa) == len(fb) else 1)


def utf8_find_cased(data) -> int:
    """Byte offset of the first rune that changes under folding, or -1
    (``sz_utf8_find_cased``, ``utf8_uncased.h:800``) — one table gather
    over the decoded runes."""
    buf = _as_bytes(data)
    tabs = _fold_tables()
    if tabs is not None:
        from .segment import decode_runes

        runes, offs = decode_runes(buf)
        if runes.size == 0:
            return -1
        changed = tabs[0][runes.astype(np.int64)] != runes
        idx = np.nonzero(changed)[0]
        return int(offs[idx[0]]) if idx.size else -1
    for off, _length, r in _incremental_runes(buf):
        if chr(r).casefold() != chr(r):
            return off
    return -1


# ---------------------------------------------------------------------------
# Token boundaries (``sz_utf8_newlines/whitespaces/delimiters``)
# ---------------------------------------------------------------------------


def _match_spans(buf: bytes, pred):
    """(offset, byte_len) spans of single runes satisfying ``pred``."""
    out = []
    for off, length, r in _incremental_runes(buf):
        if pred(r):
            out.append((off, length))
    return out


def utf8_newlines(data) -> list[tuple[int, int]]:
    """Newline boundary spans; CRLF coalesces into one 2-byte token
    (``sz_utf8_newlines``, reference ``utf8_tokens.h:53``)."""
    buf = _as_bytes(data)
    spans = _match_spans(buf, lambda r: r in _NEWLINE_RUNES)
    merged = []
    skip = False
    for i, (off, length) in enumerate(spans):
        if skip:
            skip = False
            continue
        if (buf[off] == 0x0D and i + 1 < len(spans)
                and spans[i + 1][0] == off + 1 and buf[off + 1] == 0x0A):
            merged.append((off, length + spans[i + 1][1]))
            skip = True
        else:
            merged.append((off, length))
    return merged


def utf8_whitespaces(data) -> list[tuple[int, int]]:
    """Unicode whitespace runes (``sz_utf8_whitespaces``, ``utf8_tokens.h:117``)."""
    return _match_spans(_as_bytes(data),
                        lambda r: chr(r).isspace() or r == 0x200B)


def utf8_delimiters(data) -> list[tuple[int, int]]:
    """Punctuation/symbol delimiters (``sz_utf8_delimiters``,
    ``utf8_tokens.h:139``): category P* or S*, or whitespace."""

    def pred(r):
        c = chr(r)
        return c.isspace() or unicodedata.category(c)[0] in ("P", "S")

    return _match_spans(_as_bytes(data), pred)


# ---------------------------------------------------------------------------
# Grapheme clusters (UAX-29 GB1-GB13)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _gcb_class(r: int) -> str:
    if r == 0x0D:
        return "CR"
    if r == 0x0A:
        return "LF"
    cat = unicodedata.category(chr(r))
    if cat in ("Cc", "Cf", "Zl", "Zp") and r not in (0x200D,):
        return "Control"
    if 0x1F1E6 <= r <= 0x1F1FF:
        return "RI"
    if r == 0x200D:
        return "ZWJ"
    if cat in ("Mn", "Me") or unicodedata.combining(chr(r)) or r in (0xFF9E, 0xFF9F):
        return "Extend"
    if cat == "Mc":
        return "SpacingMark"
    # Hangul syllable types
    if 0x1100 <= r <= 0x115F or 0xA960 <= r <= 0xA97C:
        return "L"
    if 0x1160 <= r <= 0x11A7 or 0xD7B0 <= r <= 0xD7C6:
        return "V"
    if 0x11A8 <= r <= 0x11FF or 0xD7CB <= r <= 0xD7FB:
        return "T"
    if 0xAC00 <= r <= 0xD7A3:
        return "LVT" if (r - 0xAC00) % 28 else "LV"
    # Extended_Pictographic approximation: emoji & symbol blocks
    if (0x1F000 <= r <= 0x1FAFF or 0x2600 <= r <= 0x27BF
            or r in (0x2764, 0x2B50, 0x203C, 0x2049)):
        return "ExtPict"
    return "Other"


def _gb_break(prev_cls: str, cls: str, ri_parity: int, after_pict_zwj: bool) -> bool:
    if prev_cls == "CR" and cls == "LF":
        return False  # GB3
    if prev_cls in ("CR", "LF", "Control"):
        return True  # GB4
    if cls in ("CR", "LF", "Control"):
        return True  # GB5
    if prev_cls == "L" and cls in ("L", "V", "LV", "LVT"):
        return False  # GB6
    if prev_cls in ("LV", "V") and cls in ("V", "T"):
        return False  # GB7
    if prev_cls in ("LVT", "T") and cls == "T":
        return False  # GB8
    if cls in ("Extend", "ZWJ"):
        return False  # GB9
    if cls == "SpacingMark":
        return False  # GB9a
    if prev_cls == "ZWJ" and cls == "ExtPict" and after_pict_zwj:
        return False  # GB11
    if prev_cls == "RI" and cls == "RI" and ri_parity == 1:
        return False  # GB12/13
    return True  # GB999


def utf8_graphemes(data) -> list[tuple[int, int]]:
    """Grapheme-cluster spans ``(byte_offset, byte_len)`` (``sz_utf8_graphemes``,
    reference ``utf8_graphemes.h:37``). Exact GB1-GB13 via the vectorized
    table tier (``ops.segment``); the hand-derived per-rune engine below is
    the fallback when the UCD table source is unavailable."""
    buf = _as_bytes(data)
    from . import ucd

    if ucd.available():
        from .segment import grapheme_breaks

        if not buf:
            return []
        br = grapheme_breaks(buf)
        bounds = [0] + [int(b) for b in br] + [len(buf)]
        return [(a, b - a) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    runes = list(_incremental_runes(buf))
    if not runes:
        return []
    out = []
    start = runes[0][0]
    prev_cls = _gcb_class(runes[0][2])
    ri_run = 1 if prev_cls == "RI" else 0
    # GB11 state: have we seen ExtPict (Extend*) ZWJ just before?
    pict_state = prev_cls == "ExtPict"
    for off, length, r in runes[1:]:
        cls = _gcb_class(r)
        if _gb_break(prev_cls, cls, ri_run % 2, pict_state):
            out.append((start, off - start))
            start = off
        if cls == "RI":
            ri_run = ri_run + 1 if prev_cls == "RI" else 1
        else:
            ri_run = 0
        if cls == "ExtPict":
            pict_state = True
        elif cls not in ("Extend", "ZWJ"):
            pict_state = False
        prev_cls = cls
    end = runes[-1][0] + runes[-1][1]
    out.append((start, end - start))
    return out
