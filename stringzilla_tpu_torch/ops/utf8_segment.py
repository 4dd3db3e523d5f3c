"""UAX-29 word/sentence segmentation and UAX-14 line-break opportunities.

Counterpart of ``stringzilla_tpu/ops/utf8_segment.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax). Both tiers
are kept: the exact table tier (``ops.segment``) where ``ops.ucd``'s
segment group can be built (``ucd.available()``: the ``regex`` package is
installed), and the ``unicodedata``-derived tier below where it cannot.

Counterparts of the reference's ``sz_utf8_wordbreaks`` (reference
``utf8_wordbreaks.h:37``), ``sz_utf8_sentences`` (``utf8_sentences.h:37``) and
``sz_utf8_linebreaks`` (``utf8_linebreaks.h:41``). The reference ships
generated UCD property tables (~1.9-6 KLoC each); here the properties are
derived from CPython's ``unicodedata`` (same UCD) with documented
approximations:

* WordBreak: ALetter/Numeric/Katakana/Extend/Format/MidLetter/MidNum/
  MidNumLet/ExtendNumLet/WSegSpace/RI classified from general categories +
  known code points; Hebrew-letter special rules (WB7a-c) treat HL as ALetter.
* SentenceBreak: ATerm/STerm/Close/Sp/Sep/Lower/Upper from categories; rules
  SB1-SB11 with the lower-case-continuation suppression (SB8).
* LineBreak: the mandatory classes (BK/CR/LF), SP-driven opportunities, and
  the common prohibitions (no break before closing punctuation / after
  opening punctuation, numbers kept whole) — the high-traffic subset of
  UAX-14's class table.

All functions return ``(byte_offset, byte_len)`` spans of the segments
(words/sentences) or sorted break offsets (linebreaks), over the original
bytes, with U+FFFD resync for invalid input.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache

from .utf8 import _as_bytes, _incremental_runes

__all__ = ["utf8_words", "utf8_wordbreaks", "utf8_sentences", "utf8_linebreaks"]


# ---------------------------------------------------------------------------
# Word boundaries (UAX-29 §4)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _wb_class(r: int) -> str:
    c = chr(r)
    if r == 0x0D:
        return "CR"
    if r == 0x0A:
        return "LF"
    if r in (0x0B, 0x0C, 0x85, 0x2028, 0x2029):
        return "Newline"
    if r == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= r <= 0x1F1FF:
        return "RI"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Mc", "Me") or r in (0xFF9E, 0xFF9F, 0x200C):
        return "Extend"
    if cat == "Cf":
        return "Format"
    if 0x30A0 <= r <= 0x30FF or 0x31F0 <= r <= 0x31FF or r in (0x3031, 0x3032, 0x3033, 0x3034, 0x3035):
        return "Katakana"
    if r == 0x27:  # U+0027 is Single_Quote in UAX-29; without a separate
        return "MidNumLet"  # Hebrew_Letter class its WB6/7 behavior matches MidNumLet
    if r == 0x2019:  # RIGHT SINGLE QUOTATION MARK
        return "MidNumLet"  # MidNumLet per WordBreakProperty.txt
    if r in (0x3A, 0xB7, 0x387, 0x05F4, 0x2027, 0xFE13, 0xFE55, 0xFF1A):
        return "MidLetter"
    if r in (0x2C, 0x3B, 0x37E, 0x589, 0x60C, 0x60D, 0x66C, 0x7F8, 0xFE10,
             0xFE14, 0xFE50, 0xFE54, 0xFF0C, 0xFF1B):
        return "MidNum"
    if r in (0x2E, 0x2018, 0x2024, 0xFE52, 0xFF07, 0xFF0E):
        return "MidNumLet"
    if cat == "Nd" or r == 0x066B:
        return "Numeric"
    if cat == "Pc" or r in (0x202F,):
        return "ExtendNumLet"
    if cat == "Zs" and r != 0x00A0 and r not in (0x2007, 0x202F):
        return "WSegSpace"
    # Hiragana / ideographs do NOT form words under UAX-29 (each is Other)
    if cat.startswith("L") and not (0x3040 <= r <= 0x309F) and not _is_ideograph(r):
        return "ALetter"
    return "Other"


def _is_ideograph(r: int) -> bool:
    return (0x4E00 <= r <= 0x9FFF or 0x3400 <= r <= 0x4DBF
            or 0xF900 <= r <= 0xFAFF or 0x20000 <= r <= 0x2FA1F)


_AHL = ("ALetter",)
_MID_LETTER = ("MidLetter", "MidNumLet")
_MID_NUM = ("MidNum", "MidNumLet")


def _word_break_between(classes: list[str], i: int) -> bool:
    """True if a boundary exists between rune i-1 and i (post-Extend/Format
    collapse, so ``classes`` excludes Extend/Format/ZWJ)."""
    prev, cur = classes[i - 1], classes[i]
    # WB3 CR x LF
    if prev == "CR" and cur == "LF":
        return False
    # WB3a/3b: break around newlines
    if prev in ("CR", "LF", "Newline") or cur in ("CR", "LF", "Newline"):
        return True
    # WB3d keep WSegSpace runs together
    if prev == "WSegSpace" and cur == "WSegSpace":
        return False
    # WB5 ALetter x ALetter
    if prev in _AHL and cur in _AHL:
        return False
    # WB6/WB7 ALetter x Mid x ALetter
    if prev in _AHL and cur in _MID_LETTER and i + 1 < len(classes) and classes[i + 1] in _AHL:
        return False
    if prev in _MID_LETTER and cur in _AHL and i >= 2 and classes[i - 2] in _AHL:
        return False
    # WB8/9/10 Numeric|ALetter adjacency
    if prev == "Numeric" and cur == "Numeric":
        return False
    if prev in _AHL and cur == "Numeric":
        return False
    if prev == "Numeric" and cur in _AHL:
        return False
    # WB11/12 Numeric x MidNum x Numeric
    if prev in _MID_NUM and cur == "Numeric" and i >= 2 and classes[i - 2] == "Numeric":
        return False
    if prev == "Numeric" and cur in _MID_NUM and i + 1 < len(classes) and classes[i + 1] == "Numeric":
        return False
    # WB13 Katakana x Katakana
    if prev == "Katakana" and cur == "Katakana":
        return False
    # WB13a/b ExtendNumLet glue
    if prev in ("ALetter", "Numeric", "Katakana", "ExtendNumLet") and cur == "ExtendNumLet":
        return False
    if prev == "ExtendNumLet" and cur in ("ALetter", "Numeric", "Katakana"):
        return False
    # WB15/16 RI pairs (handled by parity in caller via class rewrite)
    return True  # WB999


def utf8_wordbreaks(data) -> list[int]:
    """Sorted byte offsets of word boundaries (between-position offsets,
    excluding 0 and len) — the raw boundary stream of ``sz_utf8_wordbreaks``.
    Exact WB1-WB999 via the vectorized table tier when UCD tables are
    available; the hand-derived engine below is the fallback."""
    buf = _as_bytes(data)
    from . import ucd

    if ucd.available():
        from .segment import word_breaks

        return [int(b) for b in word_breaks(buf)]
    runes = list(_incremental_runes(buf))
    if not runes:
        return []
    # collapse Extend/Format/ZWJ onto the previous base (WB4)
    bases = []  # (offset, class)
    for off, length, r in runes:
        cls = _wb_class(r)
        if cls in ("Extend", "Format", "ZWJ") and bases and bases[-1][1] not in ("CR", "LF", "Newline", "WSegSpace"):
            continue
        bases.append((off, cls))
    classes = [c for _, c in bases]
    out = []
    ri_run = 0
    for i in range(1, len(bases)):
        prev, cur = classes[i - 1], classes[i]
        ri_run = ri_run + 1 if prev == "RI" else 0
        # WB15/16: regional indicators bind in pairs
        if prev == "RI" and cur == "RI" and ri_run % 2 == 1:
            continue
        if _word_break_between(classes, i):
            out.append(bases[i][0])
    return out


def utf8_words(data) -> list[tuple[int, int]]:
    """Word-token spans: maximal segments between boundaries whose content
    contains at least one letter/number/katakana rune (the conventional
    "words only" view of the boundary stream)."""
    buf = _as_bytes(data)
    from . import ucd

    if ucd.available():
        from .segment import words as _words

        return _words(buf)
    breaks = [0] + utf8_wordbreaks(buf) + [len(buf)]
    out = []
    for a, b in zip(breaks[:-1], breaks[1:]):
        if a == b:
            continue
        seg = buf[a:b]
        if any(_wb_class(r) in ("ALetter", "Numeric", "Katakana", "ExtendNumLet")
               for _, _, r in _incremental_runes(seg)):
            out.append((a, b - a))
    return out


# ---------------------------------------------------------------------------
# Sentence boundaries (UAX-29 §5, simplified SB1-SB11)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _sb_class(r: int) -> str:
    c = chr(r)
    if r == 0x0D:
        return "CR"
    if r == 0x0A:
        return "LF"
    if r in (0x85, 0x2028, 0x2029):
        return "Sep"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me", "Mc", "Cf"):
        return "Extend"
    if r in (0x2E, 0x2024, 0xFE52, 0xFF0E):
        return "ATerm"
    if r in (0x21, 0x3F, 0x203C, 0x2047, 0x2048, 0x2049, 0x3002, 0xFE56,
             0xFE57, 0xFF01, 0xFF1F, 0xFF61, 0x61F, 0x6D4, 0x700, 0x701, 0x702):
        return "STerm"
    if cat in ("Po",) and r in (0x2C, 0x3A, 0x3B):
        return "SContinue"
    if cat in ("Ps", "Pe", "Pi", "Pf") or r in (0x22, 0x27):
        return "Close"
    if cat == "Zs" or r == 0x09:
        return "Sp"
    if cat == "Ll":
        return "Lower"
    if cat in ("Lu", "Lt"):
        return "Upper"
    if cat == "Nd":
        return "Numeric"
    return "Other"


def utf8_sentences(data) -> list[tuple[int, int]]:
    """Sentence spans ``(byte_offset, byte_len)`` (``sz_utf8_sentences``).
    Exact SB1-SB11 via the table tier when available."""
    buf = _as_bytes(data)
    from . import ucd

    if ucd.available():
        from .segment import sentences as _sentences

        return _sentences(buf)
    runes = [(off, ln, r) for off, ln, r in _incremental_runes(buf)]
    if not runes:
        return []
    classes = [_sb_class(r) for _, _, r in runes]
    n = len(runes)
    breaks = []  # indices where a new sentence starts
    i = 0
    while i < n:
        cls = classes[i]
        if cls in ("ATerm", "STerm"):
            j = i + 1
            # trailing Close* Sp* (SB9/SB10)
            while j < n and classes[j] == "Close":
                j += 1
            while j < n and classes[j] == "Sp":
                j += 1
            if j < n and classes[j] in ("CR", "LF", "Sep"):
                j += 1
                if j < n and classes[j - 1] == "CR" and classes[j] == "LF":
                    j += 1
            # SB8: ATerm followed (eventually) by lowercase → not a boundary
            if cls == "ATerm" and j < n and classes[j] in ("Lower", "Numeric", "SContinue"):
                i += 1
                continue
            # SB7: Upper ATerm Upper (abbreviation like "U.S. Government")
            if (cls == "ATerm" and i >= 1 and classes[i - 1] == "Upper"
                    and j < n and classes[j] == "Upper"):
                i += 1
                continue
            if j < n:
                breaks.append(j)
            i = j if j > i else i + 1
        elif cls in ("CR", "LF", "Sep"):
            j = i + 1
            if cls == "CR" and j < n and classes[j] == "LF":
                j += 1
            if j < n:
                breaks.append(j)
            i = j
        else:
            i += 1
    starts = [0] + breaks
    offs = [runes[s][0] for s in starts] + [len(buf)]
    return [(a, b - a) for a, b in zip(offs[:-1], offs[1:]) if b > a]


# ---------------------------------------------------------------------------
# Line-break opportunities (UAX-14, common subset)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _lb_class(r: int) -> str:
    c = chr(r)
    if r == 0x0A:
        return "LF"
    if r == 0x0D:
        return "CR"
    if r in (0x0B, 0x0C, 0x85, 0x2028, 0x2029):
        return "BK"
    if r == 0x20:
        return "SP"
    if r == 0x200B:
        return "ZW"
    if r in (0xA0, 0x202F, 0x2007, 0x2060, 0xFEFF):
        return "GL"  # glue: no break around
    if r == 0x2D:
        return "HY"
    if r in (0x2013, 0x2014):
        return "BA"  # break after dashes
    cat = unicodedata.category(c)
    if cat in ("Ps", "Pi") or r in (0x22, 0x27):
        return "OP"
    if cat in ("Pe", "Pf") or r in (0x2C, 0x2E, 0x3B, 0x3A, 0x21, 0x3F, 0x25):
        return "CL"
    if cat in ("Mn", "Mc", "Me", "Cf"):
        return "CM"
    if cat == "Nd":
        return "NU"
    if _is_ideograph(r) or 0x3040 <= r <= 0x30FF:
        return "ID"  # ideographic: break between any two
    return "AL"


def utf8_linebreaks(data) -> list[int]:
    """Sorted byte offsets of line-break opportunities (positions where a
    line may be wrapped), including mandatory breaks after BK/CR/LF
    (``sz_utf8_linebreaks``, reference ``utf8_linebreaks.h:41``).
    UAX-14 core rule cascade via the table tier when available."""
    buf = _as_bytes(data)
    from . import ucd

    if ucd.available():
        from .segment import line_breaks

        return [int(b) for b in line_breaks(buf)[0]]
    runes = list(_incremental_runes(buf))
    if not runes:
        return []
    # combining marks attach to their base (LB9)
    bases = []
    for off, ln, r in runes:
        cls = _lb_class(r)
        if cls == "CM" and bases:
            continue
        bases.append((off, ln, cls))
    out = []
    n = len(bases)
    for i in range(1, n):
        off, _ln, cls = bases[i]
        p_off, p_ln, prev = bases[i - 1]
        if prev == "CR" and cls == "LF":
            continue
        if prev in ("BK", "CR", "LF"):  # mandatory break after
            out.append(off)
            continue
        if prev == "ZW":
            out.append(off)
            continue
        if prev == "GL" or cls == "GL":
            continue
        if cls in ("BK", "CR", "LF"):
            continue
        if cls == "SP":  # never break before a space
            continue
        if prev == "SP":
            out.append(off)
            continue
        if cls == "CL":  # no break before closers
            continue
        if prev == "OP":  # no break after openers
            continue
        if prev in ("HY", "BA") and cls != "NU":
            out.append(off)
            continue
        if prev == "ID" or cls == "ID":
            out.append(off)
            continue
        # AL/NU runs hold together
    return out
