"""Exact UAX-29 / UAX-14 segmentation over generated UCD tables.

Counterpart of ``stringzilla_tpu/ops/segment.py``, copied rather than
imported (importing any ``stringzilla_tpu`` module imports jax). It needs
``ops.ucd``'s segment group, which only the ``regex`` package builds:
``ops.utf8_segment`` calls it when ``ucd.available()``.

The reference implements these as per-ISA scalar/SIMD automata over ~40K LoC
of generated tables (reference ``include/stringzilla/utf8_wordbreaks/``,
``utf8_graphemes.h:37``, ``utf8_sentences.h``, ``utf8_linebreaks.h:41``).
This design splits the work differently:

* the native runtime decodes UTF-8 to rune + offset arrays
  (``tapecraft.cpp::tc_utf8_decode``);
* property classification is one ``np.take`` per axis over the packed
  tables from ``ops.ucd`` (exact UCD data, not hand-derived classes);
* grapheme (GB1-GB13 incl. GB9a/9b/11/12/13) and word (WB1-WB999 incl.
  Hebrew_Letter / Single_Quote / Double_Quote rules) boundaries are
  evaluated **vectorized** — every rule is a boolean expression over
  shifted class arrays, with run-parity tricks for the Regional_Indicator
  pair rules;
* sentence (SB1-SB11) and line-break (UAX-14 core LB2-LB31) boundaries run
  a small per-element automaton on the collapsed class arrays (loops are
  over *elements*, not bytes, and both axes are cold paths next to
  search/hash/DP).

All outputs are byte offsets into the original buffer.
"""

from __future__ import annotations

import numpy as np

from . import ucd
from .utf8 import _as_bytes, _incremental_runes

__all__ = [
    "decode_runes",
    "grapheme_breaks",
    "word_breaks",
    "sentence_breaks",
    "line_breaks",
]

_WB = {name: np.uint8(i) for i, name in enumerate(ucd.WB_VALUES)}
_GCB = {name: np.uint8(i) for i, name in enumerate(ucd.GCB_VALUES)}
_SB = {name: np.uint8(i) for i, name in enumerate(ucd.SB_VALUES)}
_LB = {name: np.uint8(i) for i, name in enumerate(ucd.LB_VALUES)}


def decode_runes(buf: bytes):
    """(runes u32[k], offsets i32[k+1]) — native decoder with a pure-Python
    fallback; U+FFFD per maximal subpart either way."""
    from ..utils import native

    arr = np.frombuffer(buf, dtype=np.uint8)
    out = native.utf8_decode(arr)
    if out is not None:
        return out
    offs, runes = [], []
    for off, _ln, r in _incremental_runes(buf):
        offs.append(off)
        runes.append(r)
    offs.append(len(buf))
    return (np.asarray(runes, dtype=np.uint32),
            np.asarray(offs, dtype=np.int32))



def _member(c: np.ndarray, vals) -> np.ndarray:
    """Membership of u8 class ids via a 256-entry boolean LUT (drop-in for
    ``np.isin``, which sorts per call and dominated the profile)."""
    lut = np.zeros(256, dtype=bool)
    lut[np.asarray(vals, dtype=np.int64)] = True
    return lut[c]

def _last_index_where(mask: np.ndarray) -> np.ndarray:
    """per position i: the largest j <= i with mask[j], else -1."""
    n = mask.shape[0]
    return np.maximum.accumulate(np.where(mask, np.arange(n), -1))


def _ri_pair_nobreak(is_ri: np.ndarray) -> np.ndarray:
    """nb[i]: position i is an RI preceded by an ODD run of RIs (the second
    of a flag pair binds to the first — GB12/13, WB15/16)."""
    n = is_ri.shape[0]
    if n == 0:
        return is_ri
    prev_ri = np.concatenate([[False], is_ri[:-1]])
    run_start = is_ri & ~prev_ri
    start_idx = _last_index_where(run_start)
    run_len_before = np.arange(n) - start_idx  # count of RIs before i in run
    return is_ri & prev_ri & (run_len_before % 2 == 1)


# ---------------------------------------------------------------------------
# Graphemes — UAX-29 §3, fully vectorized
# ---------------------------------------------------------------------------


def grapheme_breaks(buf: bytes, count_only: bool = False):
    """Byte offsets of extended-grapheme-cluster starts (excluding 0),
    i.e. the boundary set of GB1-GB13/GB999. Production tier: the native
    streaming automaton (``tapecraft.cpp::tc_gb_breaks``); this vectorized
    scan is the differential oracle and fallback."""
    from ..utils import native

    buf = _as_bytes(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    out = native.gb_breaks(arr, ucd.gcb_classes(), ucd.gcb_ext_pict(),
                           count_only=count_only)
    if out is not None:
        return out
    res = _grapheme_breaks_py(buf)
    return len(res) if count_only else res


def _grapheme_breaks_py(buf: bytes) -> np.ndarray:
    runes, offs = decode_runes(_as_bytes(buf))
    n = runes.shape[0]
    if n <= 1:
        return np.zeros(0, dtype=np.int64)
    idx = runes.astype(np.int64)
    c = ucd.gcb_classes()[idx]
    ep = ucd.gcb_ext_pict()[idx].astype(bool)
    G = _GCB
    prev, cur = c[:-1], c[1:]  # boundary i is between rune i and i+1

    nb = np.zeros(n - 1, dtype=bool)
    # GB3 CR x LF
    nb |= (prev == G["CR"]) & (cur == G["LF"])
    gb3 = nb.copy()
    # GB6-8 Hangul
    nb |= (prev == G["L"]) & _member(cur, [G["L"], G["V"], G["LV"], G["LVT"]])
    nb |= _member(prev, [G["LV"], G["V"]]) & _member(cur, [G["V"], G["T"]])
    nb |= _member(prev, [G["LVT"], G["T"]]) & (cur == G["T"])
    # GB9 / GB9a / GB9b
    nb |= _member(cur, [G["Extend"], G["ZWJ"]])
    nb |= cur == G["SpacingMark"]
    nb |= prev == G["Prepend"]
    # GB11: ExtPict Extend* ZWJ x ExtPict
    is_ext = c == G["Extend"]
    last_non_ext = _last_index_where(~is_ext)  # nearest non-Extend at or before
    # for boundary between i and i+1 with c[i]==ZWJ: the element before the
    # ZWJ (skipping Extend) must be Extended_Pictographic
    before_zwj = np.full(n, -1)
    before_zwj[1:] = last_non_ext[:-1]
    pre_ok = np.zeros(n, dtype=bool)
    valid = before_zwj >= 0
    pre_ok[valid] = ep[before_zwj[valid]]
    nb |= (prev == G["ZWJ"]) & ep[1:] & pre_ok[:-1]
    # GB12/13 RI pairs
    nb |= _ri_pair_nobreak(c == G["Regional_Indicator"])[1:]
    # GB4/5 force breaks around controls (after GB3)
    ctl = [G["Control"], G["CR"], G["LF"]]
    force = _member(prev, ctl) | _member(cur, ctl)
    brk = np.where(gb3, False, np.where(force, True, ~nb))
    return offs[1:-1][brk].astype(np.int64)


# ---------------------------------------------------------------------------
# Words — UAX-29 §4, fully vectorized
# ---------------------------------------------------------------------------


def word_breaks(buf: bytes, count_only: bool = False):
    """Byte offsets of word boundaries (excluding 0 and len), per WB1-WB999
    with the full class set (Hebrew_Letter, Single/Double_Quote, WSegSpace).
    Production tier: the native streaming automaton
    (``tapecraft.cpp::tc_wb_breaks``); this vectorized scan is the
    differential oracle and fallback."""
    from ..utils import native

    buf = _as_bytes(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    out = native.wb_breaks(arr, ucd.wb_classes(), ucd.gcb_ext_pict(),
                           count_only=count_only)
    if out is not None:
        return out
    res = _word_breaks_py(buf)
    return len(res) if count_only else res


def _word_breaks_py(buf: bytes) -> np.ndarray:
    buf = _as_bytes(buf)
    runes, offs = decode_runes(buf)
    n = runes.shape[0]
    if n <= 1:
        return np.zeros(0, dtype=np.int64)
    idx = runes.astype(np.int64)
    c = ucd.wb_classes()[idx]
    ep = ucd.gcb_ext_pict()[idx].astype(bool)
    W = _WB

    # WB4: Extend/Format/ZWJ attach to the preceding element unless it is
    # sot / CR / LF / Newline. A standalone E/F/Z (after sot) becomes a base
    # itself, so chained E/F/Z always attach when the previous *rune* is not
    # a separator (separators are never E/F/Z).
    efz = _member(c, [W["Extend"], W["Format"], W["ZWJ"]])
    seps = [W["CR"], W["LF"], W["Newline"]]
    attach = efz.copy()
    attach[0] = False
    attach[1:] &= ~_member(c[:-1], seps)

    # collapsed element sequence
    el_idx = np.nonzero(~attach)[0]  # rune index of each element start
    C = c[el_idx]
    m = C.shape[0]
    if m <= 1:
        return np.zeros(0, dtype=np.int64)
    prev, cur = C[:-1], C[1:]
    prev2 = np.concatenate([[np.uint8(255)], C[:-2]])  # class of element k-2
    nxt = np.concatenate([C[2:], [np.uint8(255)]])  # class of element k+1

    AHL = [W["ALetter"], W["Hebrew_Letter"]]
    MIDL = [W["MidLetter"], W["MidNumLet"], W["Single_Quote"]]
    MIDN = [W["MidNum"], W["MidNumLet"], W["Single_Quote"]]

    nb = np.zeros(m - 1, dtype=bool)
    # WB3 CR x LF
    wb3 = (prev == W["CR"]) & (cur == W["LF"])
    # WB3c ZWJ x ExtPict — raw adjacency: the rune just before this element
    raw_prev_zwj = c[el_idx[1:] - 1] == W["ZWJ"]
    nb |= raw_prev_zwj & ep[el_idx[1:]]
    # WB3d WSegSpace x WSegSpace
    nb |= (prev == W["WSegSpace"]) & (cur == W["WSegSpace"])
    # WB5
    nb |= _member(prev, AHL) & _member(cur, AHL)
    # WB6 / WB7
    nb |= _member(prev, AHL) & _member(cur, MIDL) & _member(nxt, AHL)
    nb |= _member(prev2, AHL) & _member(prev, MIDL) & _member(cur, AHL)
    # WB7a / WB7b / WB7c (Hebrew quotes)
    nb |= (prev == W["Hebrew_Letter"]) & (cur == W["Single_Quote"])
    nb |= ((prev == W["Hebrew_Letter"]) & (cur == W["Double_Quote"])
           & (nxt == W["Hebrew_Letter"]))
    nb |= ((prev2 == W["Hebrew_Letter"]) & (prev == W["Double_Quote"])
           & (cur == W["Hebrew_Letter"]))
    # WB8 / WB9 / WB10
    nb |= (prev == W["Numeric"]) & (cur == W["Numeric"])
    nb |= _member(prev, AHL) & (cur == W["Numeric"])
    nb |= (prev == W["Numeric"]) & _member(cur, AHL)
    # WB11 / WB12
    nb |= (prev2 == W["Numeric"]) & _member(prev, MIDN) & (cur == W["Numeric"])
    nb |= (prev == W["Numeric"]) & _member(cur, MIDN) & (nxt == W["Numeric"])
    # WB13 / WB13a / WB13b
    nb |= (prev == W["Katakana"]) & (cur == W["Katakana"])
    glue = AHL + [W["Numeric"], W["Katakana"], W["ExtendNumLet"]]
    nb |= _member(prev, glue) & (cur == W["ExtendNumLet"])
    nb |= (prev == W["ExtendNumLet"]) & _member(cur, glue[:-1])
    # WB15/16 RI pairs (on collapsed elements)
    nb |= _ri_pair_nobreak(C == W["Regional_Indicator"])[1:]
    # WB3a / WB3b force breaks around newlines (after WB3)
    force = _member(prev, seps) | _member(cur, seps)
    brk = np.where(wb3, False, np.where(force, True, ~nb))
    return offs[el_idx[1:][brk]].astype(np.int64)


def words(buf: bytes) -> list[tuple[int, int]]:
    """Word-token spans: segments containing at least one letter / numeric /
    katakana rune (the conventional "words only" view)."""
    buf = _as_bytes(buf)
    runes, offs = decode_runes(buf)
    breaks = word_breaks(buf)
    bounds = np.concatenate([[0], breaks, [len(buf)]])
    idx = runes.astype(np.int64)
    c = ucd.wb_classes()[idx]
    W = _WB
    wordy = _member(c, [W["ALetter"], W["Hebrew_Letter"], W["Numeric"],
                        W["Katakana"], W["ExtendNumLet"]])
    # rune offset -> cumulative wordy count, so each span is one range query
    cum = np.concatenate([[0], np.cumsum(wordy)])
    starts = np.searchsorted(offs[:-1], bounds[:-1], side="left")
    ends = np.searchsorted(offs[:-1], bounds[1:], side="left")
    out = []
    for a, b, ra, rb in zip(bounds[:-1], bounds[1:], starts, ends):
        if b > a and cum[rb] > cum[ra]:
            out.append((int(a), int(b - a)))
    return out


# ---------------------------------------------------------------------------
# Sentences — UAX-29 §5, exact SB1-SB11 on collapsed elements
# ---------------------------------------------------------------------------


def sentence_breaks(buf: bytes, count_only: bool = False):
    """Byte offsets where a new sentence starts (excluding 0). Production
    tier: the native automaton (``tapecraft.cpp::tc_sb_breaks``); this
    Python element scan remains the differential oracle and fallback."""
    from ..utils import native

    buf = _as_bytes(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    out = native.sb_breaks(arr, ucd.sb_classes(), count_only=count_only)
    if out is not None:
        return out
    res = _sentence_breaks_py(buf)
    return len(res) if count_only else res


def _sentence_breaks_py(buf: bytes) -> np.ndarray:
    buf = _as_bytes(buf)
    runes, offs = decode_runes(buf)
    n = runes.shape[0]
    if n <= 1:
        return np.zeros(0, dtype=np.int64)
    idx = runes.astype(np.int64)
    c = ucd.sb_classes()[idx]
    S = _SB
    para = (S["Sep"], S["CR"], S["LF"])

    # SB5 collapse: Extend/Format attach unless after sot/ParaSep
    ef = _member(c, [S["Extend"], S["Format"]])
    attach = ef.copy()
    attach[0] = False
    attach[1:] &= ~_member(c[:-1], list(para))
    el_idx = np.nonzero(~attach)[0]
    C = c[el_idx]
    m = C.shape[0]
    if m <= 1:
        return np.zeros(0, dtype=np.int64)

    # SB8 lookahead: first "significant" class at or after element k
    sig = _member(C, [S["OLetter"], S["Upper"], S["Lower"], S["Sep"],
                      S["CR"], S["LF"], S["ATerm"], S["STerm"]])
    nxt_sig = np.full(m, 255, dtype=np.uint8)
    last = np.uint8(255)
    for k in range(m - 1, -1, -1):
        nxt_sig[k] = last
        if sig[k]:
            last = C[k]

    breaks = []
    # terminator-run state: kind (ATerm/STerm id or 0), seen_sp, prev2 class
    term = 0
    seen_sp = False
    for k in range(1, m):
        pc, cc = C[k - 1], C[k]
        # SB3
        if pc == S["CR"] and cc == S["LF"]:
            term, seen_sp = 0, False
            continue
        # SB4
        if pc in para:
            breaks.append(k)
            term, seen_sp = 0, False
        elif term:
            if cc == S["Close"] and not seen_sp:
                pass  # SB9
            elif cc == S["Sp"]:
                seen_sp = True  # SB9/SB10
            elif cc in para:
                pass  # SB9/SB10 (break lands after it via SB4)
            elif cc in (S["SContinue"], S["ATerm"], S["STerm"]):
                pass  # SB8a
            elif term == S["ATerm"] and nxt_sig[k] == S["Lower"] and not sig[k]:
                pass  # SB8 (cur itself in the skip set, eventual Lower)
            elif term == S["ATerm"] and cc == S["Lower"]:
                pass  # SB8 degenerate: cur IS the Lower
            elif (term == S["ATerm"] and cc == S["Upper"] and not seen_sp
                  and C[k - 1] == S["ATerm"] and k >= 2
                  and C[k - 2] in (S["Upper"], S["Lower"])):
                pass  # SB7
            elif term == S["ATerm"] and cc == S["Numeric"] and C[k - 1] == S["ATerm"]:
                pass  # SB6
            else:
                breaks.append(k)  # SB11
                term, seen_sp = 0, False
        if cc in (S["ATerm"], S["STerm"]):
            term, seen_sp = int(cc), False
        elif term and not (cc == S["Close"] and not seen_sp) and cc != S["Sp"] \
                and cc not in para:
            term, seen_sp = 0, False
    return offs[el_idx[np.asarray(breaks, dtype=np.int64)]].astype(np.int64) \
        if breaks else np.zeros(0, dtype=np.int64)


def sentences(buf: bytes) -> list[tuple[int, int]]:
    buf = _as_bytes(buf)
    br = sentence_breaks(buf)
    bounds = np.concatenate([[0], br, [len(buf)]])
    return [(int(a), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:])
            if b > a]


# ---------------------------------------------------------------------------
# Line breaks — UAX-14 core rule cascade (LB2-LB31)
# ---------------------------------------------------------------------------


def line_breaks(buf: bytes, count_only: bool = False):
    """(offsets, mandatory) — byte offsets of break opportunities; the
    parallel bool array marks mandatory breaks (after BK/CR/LF/NL).
    Production tier: ``tapecraft.cpp::tc_lb_breaks``; this Python scan is
    the oracle and fallback."""
    from ..utils import native

    buf = _as_bytes(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    out = native.lb_breaks(arr, ucd.lb_classes(), count_only=count_only)
    if out is not None:
        return out
    res = _line_breaks_py(buf)
    return len(res[0]) if count_only else res


def _line_breaks_py(buf: bytes) -> tuple[np.ndarray, np.ndarray]:
    buf = _as_bytes(buf)
    runes, offs = decode_runes(buf)
    n = runes.shape[0]
    if n <= 1:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    idx = runes.astype(np.int64)
    c = ucd.lb_classes()[idx].copy()
    L = _LB

    # LB1 resolution
    c[_member(c, [L["AI"], L["SG"], L["XX"]])] = L["AL"]
    c[c == L["CJ"]] = L["NS"]
    c[c == L["SA"]] = L["AL"]  # (CM/AL split by category is a tailoring)

    # LB9/LB10: attach CM/ZWJ to base (not after BK/CR/LF/NL/SP/ZW/sot);
    # a standalone CM is rewritten to AL (LB10) and later CMs attach to it
    cmz = _member(c, [L["CM"], L["ZWJ"]])
    hard = [L["BK"], L["CR"], L["LF"], L["NL"], L["SP"], L["ZW"]]
    attach = cmz.copy()
    attach[0] = False
    attach[1:] &= ~_member(c[:-1], hard)
    c[cmz & ~attach] = L["AL"]  # LB10
    zwj_raw = c == L["ZWJ"]  # before collapse (LB8a uses raw adjacency)
    el_idx = np.nonzero(~attach)[0]
    C = c[el_idx]
    m = C.shape[0]

    out_off, out_mand = [], []
    # state across the element scan
    sp_before = 0  # class before a run of spaces (for LB14-16/LB21a context)
    ri_run = 0
    for k in range(1, m):
        pc, cc = C[k - 1], C[k]
        prev_el_rune = el_idx[k] - 1  # raw rune just before this element
        prior = C[k - 2] if k >= 2 else np.uint8(255)
        # track the class that opened a space run
        if pc != L["SP"]:
            sp_before = int(pc)
        ri_run = ri_run + 1 if pc == L["RI"] else 0

        def emit(mand=False):
            out_off.append(int(offs[el_idx[k]]))
            out_mand.append(mand)

        # LB4/LB5 mandatory
        if pc == L["CR"] and cc == L["LF"]:
            continue
        if pc in (L["BK"], L["CR"], L["LF"], L["NL"]):
            emit(True)
            continue
        if cc in (L["BK"], L["CR"], L["LF"], L["NL"]):
            continue  # LB6
        if cc in (L["SP"], L["ZW"]):
            continue  # LB7
        if pc == L["ZW"] or (pc == L["SP"] and sp_before == L["ZW"]):
            emit()  # LB8
            continue
        if zwj_raw[prev_el_rune]:
            continue  # LB8a ZWJ x
        if pc == L["WJ"] or cc == L["WJ"]:
            continue  # LB11
        if pc == L["GL"]:
            continue  # LB12
        if cc == L["GL"] and pc not in (L["SP"], L["BA"], L["HY"]):
            continue  # LB12a
        if cc in (L["CL"], L["CP"], L["EX"], L["IS"], L["SY"]):
            continue  # LB13
        if sp_before == L["OP"] and (pc == L["OP"] or pc == L["SP"]):
            continue  # LB14 OP SP* x
        if pc == L["QU"] and cc == L["OP"]:
            continue  # LB15 (simplified)
        if (sp_before in (L["CL"], L["CP"]) and cc == L["NS"]
                and (pc in (L["CL"], L["CP"], L["SP"]))):
            continue  # LB16
        if sp_before == L["B2"] and cc == L["B2"] and pc in (L["B2"], L["SP"]):
            continue  # LB17
        if pc == L["SP"]:
            emit()  # LB18
            continue
        if pc == L["QU"] or cc == L["QU"]:
            continue  # LB19
        if pc == L["CB"] or cc == L["CB"]:
            emit()  # LB20
            continue
        if cc in (L["BA"], L["HY"], L["NS"]) or pc == L["BB"]:
            continue  # LB21
        if k >= 2 and prior == L["HL"] and pc in (L["HY"], L["BA"]):
            continue  # LB21a
        if pc == L["SY"] and cc == L["HL"]:
            continue  # LB21b
        if cc == L["IN"]:
            continue  # LB22
        if (pc in (L["AL"], L["HL"]) and cc == L["NU"]) or \
                (pc == L["NU"] and cc in (L["AL"], L["HL"])):
            continue  # LB23
        if (pc == L["PR"] and cc in (L["ID"], L["EB"], L["EM"])) or \
                (pc in (L["ID"], L["EB"], L["EM"]) and cc == L["PO"]):
            continue  # LB23a
        if (pc in (L["PR"], L["PO"]) and cc in (L["AL"], L["HL"])) or \
                (pc in (L["AL"], L["HL"]) and cc in (L["PR"], L["PO"])):
            continue  # LB24
        if (pc in (L["CL"], L["CP"], L["NU"]) and cc in (L["PO"], L["PR"])) or \
                (pc in (L["PO"], L["PR"]) and cc in (L["OP"], L["NU"])) or \
                (pc in (L["HY"], L["IS"], L["NU"], L["SY"]) and cc == L["NU"]):
            continue  # LB25 (regex approximated pairwise)
        if pc == L["JL"] and cc in (L["JL"], L["JV"], L["H2"], L["H3"]):
            continue  # LB26
        if pc in (L["JV"], L["H2"]) and cc in (L["JV"], L["JT"]):
            continue
        if pc in (L["JT"], L["H3"]) and cc == L["JT"]:
            continue
        if pc in (L["JL"], L["JV"], L["JT"], L["H2"], L["H3"]) and cc == L["PO"]:
            continue  # LB27
        if pc == L["PR"] and cc in (L["JL"], L["JV"], L["JT"], L["H2"], L["H3"]):
            continue
        if pc in (L["AL"], L["HL"]) and cc in (L["AL"], L["HL"]):
            continue  # LB28
        if pc == L["IS"] and cc in (L["AL"], L["HL"]):
            continue  # LB29
        if (pc in (L["AL"], L["HL"], L["NU"]) and cc == L["OP"]) or \
                (pc == L["CP"] and cc in (L["AL"], L["HL"], L["NU"])):
            continue  # LB30
        if pc == L["RI"] and cc == L["RI"] and ri_run % 2 == 1:
            continue  # LB30a
        if pc == L["EB"] and cc == L["EM"]:
            continue  # LB30b
        emit()  # LB31
    return (np.asarray(out_off, dtype=np.int64),
            np.asarray(out_mand, dtype=bool))
