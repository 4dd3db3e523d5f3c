"""UTF-8 runes on the host: count and decode.

Counterpart of the host part of ``stringzilla_tpu/ops/utf8.py`` that the
buffer tier calls, copied rather than imported (importing any
``stringzilla_tpu`` module imports jax): ``utf8_count`` and
``utf8_decode`` (reference ``include/stringzilla/utf8_runes.h:34-96``).
Invalid input resynchronizes with U+FFFD per maximal subpart (reference
``README.md:888-893``), exactly Python's ``errors="replace"`` policy, which
is the host-exact engine here. Case folding, normalization, uncased search
and the segmenters come with the rest of that module.
"""

from __future__ import annotations

import numpy as np

__all__ = ["utf8_count", "utf8_decode"]


def _as_bytes(data) -> bytes:
    if isinstance(data, str):
        return data.encode("utf-8")
    return bytes(data)


def _decode(data) -> str:
    return _as_bytes(data).decode("utf-8", errors="replace")


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
