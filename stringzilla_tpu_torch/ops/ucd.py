"""Generated Unicode property tables — the data layer of the UTF-8 tier.

Counterpart of ``stringzilla_tpu/ops/ucd.py``, copied rather than imported
(importing any ``stringzilla_tpu`` module imports jax). The reference ships
~40K LoC of generated UCD tables (reference
``include/stringzilla/utf8_wordbreaks/tables.h`` and siblings); here the
same information is generated at first use, packed into dense numpy arrays
and cached on disk. The tables come in two groups, each with its own
availability test, so that each caller asks for the group it needs:

* **text** (``text_available()``): full case folding (``fold1``, the
  multi-rune ``fold_multi_*``) from ``str.casefold``, and the UAX-15
  normalization tables (``ccc``, ``nfd_*``, ``nfkd_*``, ``comp_*``, ``qc``)
  from ``unicodedata``. The standard library alone builds them;
* **segment** (``available()``): ``wb``, ``gcb``, ``sb``, ``lb`` and
  ``ext_pict``, the UAX-29/14 classes, scanned with the ``regex`` package's
  UCD property engine, which is present only where it is installed.

The JAX module builds all of them only when ``regex`` imports, so without it
its fold and normalization callers take their ``str.casefold`` and
``unicodedata`` fallbacks; here those callers use the tables wherever
Python runs. The values are the same. Each group is cached as an ``.npz``
under ``build/stringzilla_tpu_torch/`` beside the package, keyed by
``unicodedata.unidata_version`` (and ``regex``'s version for the segment
group); a lock file lets one process build while the others wait for it.

Class-id 0 is always the axis's "Other"/default class.
"""

from __future__ import annotations

import fcntl
import os
import threading

import numpy as np

__all__ = [
    "WB_VALUES", "GCB_VALUES", "SB_VALUES", "LB_VALUES",
    "available", "text_available",
    "wb_classes", "gcb_classes", "sb_classes", "lb_classes",
    "gcb_ext_pict", "fold1", "fold_multi", "ucd_version",
    "ccc", "decomp_tables", "comp_pairs", "qc_classes",
]

_MAX_CP = 0x110000
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "stringzilla_tpu_torch")

# UAX-29 / UAX-14 property value enumerations; index = class id, 0 = default.
WB_VALUES = (
    "Other", "CR", "LF", "Newline", "Extend", "ZWJ", "Regional_Indicator",
    "Format", "Katakana", "Hebrew_Letter", "ALetter", "Single_Quote",
    "Double_Quote", "MidNumLet", "MidLetter", "MidNum", "Numeric",
    "ExtendNumLet", "WSegSpace",
)
GCB_VALUES = (
    "Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator",
    "Prepend", "SpacingMark", "L", "V", "T", "LV", "LVT",
)
SB_VALUES = (
    "Other", "CR", "LF", "Extend", "Sep", "Format", "Sp", "Lower", "Upper",
    "OLetter", "Numeric", "ATerm", "SContinue", "STerm", "Close",
)
LB_VALUES = (
    "XX", "BK", "CR", "LF", "CM", "NL", "SG", "WJ", "ZW", "GL", "SP", "ZWJ",
    "B2", "BA", "BB", "HY", "CB", "CL", "CP", "EX", "IN", "NS", "OP", "QU",
    "IS", "NU", "PO", "PR", "SY", "AI", "AL", "CJ", "EB", "EM", "H2", "H3",
    "HL", "ID", "JL", "JT", "JV", "RI", "SA", "AK", "AP", "AS", "VF", "VI",
)

_lock = threading.Lock()
_text: dict[str, np.ndarray] = {}
_segment: dict[str, np.ndarray] = {}


def _has_regex() -> bool:
    try:
        import regex  # noqa: F401

        return True
    except ImportError:
        return False


def available() -> bool:
    """Whether the segment group (``wb``, ``gcb``, ``sb``, ``lb``,
    ``ext_pict``) can be built: its source, the ``regex`` package's UCD
    property engine, imports. The segmenters keep a ``unicodedata``-derived
    tier for when it does not."""
    return _has_regex()


def text_available() -> bool:
    """Whether the text group (case folding and normalization) can be built:
    always, since ``str.casefold`` and ``unicodedata`` are its source. Its
    callers keep the JAX package's fallbacks for when it is False."""
    return True


def ucd_version() -> str:
    import unicodedata

    return unicodedata.unidata_version


def _all_codepoints_string() -> str:
    """One string containing every scalar codepoint (surrogates excluded),
    so a single compiled-regex scan classifies the whole plane set."""
    return "".join(
        chr(c) for c in range(_MAX_CP) if not (0xD800 <= c <= 0xDFFF))


def _scan_property(pattern: str, haystack: str, cp_index: np.ndarray,
                   out: np.ndarray, value: int) -> None:
    import regex

    rx = regex.compile(pattern, regex.V1)
    for m in rx.finditer(haystack):
        out[cp_index[m.start() : m.end()]] = value


def _build_axis(prop: str, values: tuple[str, ...], haystack: str,
                cp_index: np.ndarray) -> np.ndarray:
    out = np.zeros(_MAX_CP, dtype=np.uint8)
    for vid, vname in enumerate(values):
        if vid == 0:
            continue  # default class
        _scan_property(rf"\p{{{prop}={vname}}}", haystack, cp_index, out, vid)
    return out


def _build_segment_tables() -> dict[str, np.ndarray]:
    import regex  # noqa: F401 — the segment group's source

    haystack = _all_codepoints_string()
    # position in haystack -> codepoint
    cp_index = np.fromiter((ord(c) for c in haystack), dtype=np.int64,
                           count=len(haystack))
    tables = {
        "wb": _build_axis("Word_Break", WB_VALUES, haystack, cp_index),
        "gcb": _build_axis("Grapheme_Cluster_Break", GCB_VALUES, haystack, cp_index),
        "sb": _build_axis("Sentence_Break", SB_VALUES, haystack, cp_index),
        "lb": _build_axis("Line_Break", LB_VALUES, haystack, cp_index),
    }
    ep = np.zeros(_MAX_CP, dtype=np.uint8)
    _scan_property(r"\p{Extended_Pictographic}", haystack, cp_index, ep, 1)
    tables["ext_pict"] = ep
    return tables


def _build_text_tables() -> dict[str, np.ndarray]:
    """The fold tables, then the normalization tables."""
    # Full case folding (C+F status): CPython's str.casefold implements the
    # UCD CaseFolding.txt full mapping; sample it per codepoint once.
    fold = np.arange(_MAX_CP, dtype=np.uint32)
    multi_keys, multi_vals, multi_offs = [], [], [0]
    for c in range(_MAX_CP):
        if 0xD800 <= c <= 0xDFFF:
            continue
        f = chr(c).casefold()
        if len(f) == 1:
            fc = ord(f)
            if fc != c:
                fold[c] = fc
        else:
            multi_keys.append(c)
            multi_vals.extend(ord(ch) for ch in f)
            multi_offs.append(len(multi_vals))
            fold[c] = 0xFFFFFFFF  # sentinel: expansion in fold_multi
    tables = {
        "fold1": fold,
        "fold_multi_keys": np.asarray(multi_keys, dtype=np.uint32),
        "fold_multi_vals": np.asarray(multi_vals, dtype=np.uint32),
        "fold_multi_offs": np.asarray(multi_offs, dtype=np.int64),
    }
    tables.update(_build_norm_tables())
    return tables


def _build_norm_tables() -> dict[str, np.ndarray]:
    """UAX-15 normalization data, derived from CPython's own UCD:

    * ``ccc`` — Canonical_Combining_Class, u8 per codepoint;
    * full (recursive) NFD / NFKD expansions — ``unicodedata.normalize`` of
      each single codepoint already applies the recursion and the Hangul
      algorithm, so the runtime is a flat gather (reference analog:
      ``utf8_norm/tables.h``, generated from UnicodeData.txt);
    * primary composition pairs — a canonical 2-char decomposition whose NFC
      round-trips back is, by definition, a primary composite: this exactly
      reproduces CompositionExclusions.txt + singleton/non-starter rules
      without shipping the file;
    * derived quick-check classes (UAX-15 §9): NFx_QC=No where the codepoint
      itself normalizes away, Maybe where it can fuse with a preceding
      character (second element of a primary pair, incl. Hangul V/T jamo).
    """
    import unicodedata as ud

    ccc_t = np.zeros(_MAX_CP, dtype=np.uint8)
    # decomposition expansions: idx<0 → none; else vals[offs[idx]:offs[idx+1]]
    nfd_idx = np.full(_MAX_CP, -1, dtype=np.int32)
    nfkd_idx = np.full(_MAX_CP, -1, dtype=np.int32)
    nfd_vals, nfd_offs = [], [0]
    nfkd_vals, nfkd_offs = [], [0]
    pair_keys, pair_vals = [], []
    # qc: 0 = Yes, 1 = Maybe, 2 = No; one axis per form
    qc = {f: np.zeros(_MAX_CP, dtype=np.uint8) for f in
          ("nfc", "nfd", "nfkc", "nfkd")}
    for c in range(_MAX_CP):
        if 0xD800 <= c <= 0xDFFF:
            continue
        ch = chr(c)
        ccc_t[c] = ud.combining(ch)
        nfd = ud.normalize("NFD", ch)
        nfkd = ud.normalize("NFKD", ch)
        if nfd != ch:
            nfd_idx[c] = len(nfd_offs) - 1
            nfd_vals.extend(ord(x) for x in nfd)
            nfd_offs.append(len(nfd_vals))
            qc["nfd"][c] = 2
            # Primary composite ⇔ the full decomposition recomposes back;
            # an excluded composite or singleton stays decomposed under NFC.
            if ud.normalize("NFC", nfd) != ch:
                qc["nfc"][c] = 2
            # Pairs come from the SINGLE-STEP canonical decomposition (the
            # raw UnicodeData.txt field): full NFD of e.g. an LVT Hangul
            # syllable or ǻ is longer than 2 but the char still composes
            # pairwise. Hangul's algorithmic step is synthesized below.
            raw = ud.decomposition(ch)
            if raw and not raw.startswith("<") and qc["nfc"][c] == 0:
                parts = [int(h, 16) for h in raw.split()]
                if len(parts) == 2:
                    pair_keys.append((parts[0] << 21) | parts[1])
                    pair_vals.append(c)
        if nfkd != ch:
            nfkd_idx[c] = len(nfkd_offs) - 1
            nfkd_vals.extend(ord(x) for x in nfkd)
            nfkd_offs.append(len(nfkd_vals))
            qc["nfkd"][c] = 2
            if ud.normalize("NFKC", ch) != ch:
                qc["nfkc"][c] = 2
    # Hangul algorithmic composition pairs (UAX-15 §3.12): (L,V)→LV, (LV,T)→LVT.
    s_base, l_base, v_base, t_base = 0xAC00, 0x1100, 0x1161, 0x11A7
    v_count, t_count = 21, 28
    for s in range(s_base, s_base + 11172):
        s_index = s - s_base
        if s_index % t_count == 0:  # LV syllable
            l = l_base + s_index // (v_count * t_count)
            v = v_base + (s_index % (v_count * t_count)) // t_count
            pair_keys.append((l << 21) | v)
        else:  # LVT: composed from the LV syllable + trailing jamo
            lv = s_base + (s_index // t_count) * t_count
            t = t_base + s_index % t_count
            pair_keys.append((lv << 21) | t)
        pair_vals.append(s)
    # Maybe: second element of any primary pair can fuse into the previous
    # starter, so a string containing it needs verification.
    order = np.argsort(np.asarray(pair_keys, dtype=np.uint64), kind="stable")
    keys = np.asarray(pair_keys, dtype=np.uint64)[order]
    vals = np.asarray(pair_vals, dtype=np.uint32)[order]
    for second in set(int(k) & 0x1FFFFF for k in keys):
        if qc["nfc"][second] == 0:
            qc["nfc"][second] = 1
        if qc["nfkc"][second] == 0:
            qc["nfkc"][second] = 1
    qc_packed = (qc["nfc"] | (qc["nfd"] << 2) | (qc["nfkc"] << 4)
                 | (qc["nfkd"] << 6)).astype(np.uint8)
    return {
        "ccc": ccc_t,
        "nfd_idx": nfd_idx,
        "nfd_vals": np.asarray(nfd_vals, dtype=np.uint32),
        "nfd_offs": np.asarray(nfd_offs, dtype=np.int64),
        "nfkd_idx": nfkd_idx,
        "nfkd_vals": np.asarray(nfkd_vals, dtype=np.uint32),
        "nfkd_offs": np.asarray(nfkd_offs, dtype=np.int64),
        "comp_keys": keys,
        "comp_vals": vals,
        "qc": qc_packed,
    }


def _cached(cache: dict, name: str, build) -> dict[str, np.ndarray]:
    """``cache`` filled from ``build/.../{name}.npz``, or from ``build()``,
    which is then saved there (atomically, under a lock file that makes the
    other processes wait for the one that builds)."""
    if cache:
        return cache
    with _lock:
        if cache:
            return cache
        path = os.path.join(_BUILD_DIR, f"{name}.npz")
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(path):
                try:
                    with np.load(path) as z:
                        cache.update({k: z[k] for k in z.files})
                    return cache
                except Exception:
                    pass  # a corrupt cache is built again
            tables = build()
            tmp = f"{path}.tmp{os.getpid()}.npz"
            try:
                np.savez_compressed(tmp, **tables)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        cache.update(tables)
        return cache


def _load_text() -> dict[str, np.ndarray]:
    return _cached(_text, f"ucd-text-{ucd_version()}", _build_text_tables)


def _load_segment() -> dict[str, np.ndarray]:
    import regex

    tag = f"{ucd_version()}-rx{getattr(regex, '__version__', '0')}"
    return _cached(_segment, f"ucd-segment-{tag}", _build_segment_tables)


def wb_classes() -> np.ndarray:
    """Word_Break class ids, u8[0x110000] (UAX-29 table 3)."""
    return _load_segment()["wb"]


def gcb_classes() -> np.ndarray:
    """Grapheme_Cluster_Break class ids (UAX-29 table 2)."""
    return _load_segment()["gcb"]


def gcb_ext_pict() -> np.ndarray:
    """Extended_Pictographic membership, u8[0x110000] (emoji-data.txt)."""
    return _load_segment()["ext_pict"]


def sb_classes() -> np.ndarray:
    """Sentence_Break class ids (UAX-29 table 4)."""
    return _load_segment()["sb"]


def lb_classes() -> np.ndarray:
    """Line_Break class ids (UAX-14)."""
    return _load_segment()["lb"]


def fold1() -> np.ndarray:
    """1:1 full case folding, u32[0x110000]; 0xFFFFFFFF marks multi-rune
    expansions (look up in ``fold_multi``)."""
    return _load_text()["fold1"]


def fold_multi() -> dict[int, tuple[int, ...]]:
    """Multi-rune full-fold expansions (e.g. ß → s s)."""
    t = _load_text()
    keys, vals, offs = t["fold_multi_keys"], t["fold_multi_vals"], t["fold_multi_offs"]
    return {int(k): tuple(int(v) for v in vals[offs[i] : offs[i + 1]])
            for i, k in enumerate(keys)}


def ccc() -> np.ndarray:
    """Canonical_Combining_Class, u8[0x110000] (UnicodeData.txt field 3)."""
    return _load_text()["ccc"]


def decomp_tables(compat: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full recursive canonical (or compatibility) decomposition:
    ``(idx i32[0x110000] — −1 = none, vals u32[], offs i64[])``; the
    expansion of codepoint c is ``vals[offs[idx[c]] : offs[idx[c]+1]]``."""
    t = _load_text()
    p = "nfkd" if compat else "nfd"
    return t[f"{p}_idx"], t[f"{p}_vals"], t[f"{p}_offs"]


def comp_pairs() -> tuple[np.ndarray, np.ndarray]:
    """Primary composition pairs: sorted u64 keys ``(first << 21) | second``
    and u32 composed codepoints (UAX-15 D117, incl. Hangul algorithmic
    pairs, excl. CompositionExclusions)."""
    t = _load_text()
    return t["comp_keys"], t["comp_vals"]


def qc_classes() -> np.ndarray:
    """Packed quick-check classes, u8[0x110000]: two bits per form —
    bits 0-1 NFC, 2-3 NFD, 4-5 NFKC, 6-7 NFKD; 0 = Yes, 1 = Maybe, 2 = No
    (UAX-15 §9 derived properties)."""
    return _load_text()["qc"]
