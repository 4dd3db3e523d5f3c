"""``Str`` / ``Strs`` / ``File`` — the single-string public API.

Counterpart of ``stringzilla_tpu/models/str_api.py``. Mirrors the
reference's Python binding surface (``python/stringzilla.c``: ``Str``
zero-copy string, memory-mapped ``File``, ``Strs`` collection; module-level
find/count/split/translate/hash functions,
``python/stringzilla.c:9531-9612``):

* a ``Str`` owns one host buffer and lazily mirrors it to the device as a
  flat ``uint8`` tensor with a zero tail of at least 16 bytes (the layout
  ``ops.find_kernel`` and ``ops.utf8_device`` consume), built once and
  cached; a zero-copy slice is a ``Str`` of its own with its own mirror;
* search ops dispatch on size, as in the JAX package: buffers of at least
  1 MiB run the hand-written streaming kernels on the device (find, rfind,
  overlapping count, the byteset family on ``csrc/find.cu``; ``translate``
  on the byte LUT; ``utf8_count``/``utf8_valid`` on ``csrc/utf8.cu``),
  smaller ones run on the host;
* the device is the module-level ``default_device_scope()``'s: ``cuda:0``,
  which raises without a card. Point it at ``DeviceScope(device="cpu")`` to
  run the kernels' plain versions on the CPU;
* ``split``/``splitlines`` return ``Strs`` views backed by (data, offsets)
  tapes — zero copies of the underlying bytes, like the reference's
  ``sz_string_view_t`` splits.

``Strs.hashes`` of 2^14 strings or more runs the hash kernels
(``csrc/hash.cu``) over the parent ``Str``'s mirror, gathering every span
where it lies; ``Strs.order``/``sort``/``sorted`` sort on the host, as in
the JAX package. Methods whose modules are not ported yet raise
``NotImplementedError`` naming them: Arrow import and export, case folding,
normalization, uncased search and the segmenters (the host UTF-8 modules).
"""

from __future__ import annotations

import mmap as _mmap
from typing import Iterable

import numpy as np
import torch

from ..ops import find as _find_ops
from ..ops import hash as _hash_ops
from ..ops.find_kernel import search_positions
from ..ops.hash_kernel import hash_bounds_device
from ..ops.sha256 import Sha256
from ..ops.sort import argsort_bounds
from ..ops.tape import Tape, round_up
from .device_scope import default_device_scope

__all__ = ["Str", "Strs", "File", "FindSplits", "Utf8Wordbreaks",
           "Utf8Newlines", "Utf8Whitespaces", "Utf8Delimiters",
           "Utf8SplitNewlines", "Utf8SplitWhitespaces", "Utf8SplitDelimiters"]

_DEVICE_MIN_BYTES = 1 << 20
_DEVICE_MIN_HASHES = 1 << 14  # Strs.hashes takes the device from this many strings
_MIRROR_TAIL = 16  # zero bytes past the end of a device mirror, at least
_STAGING_BYTES = 64 << 20  # host staging chunk of a mirror's copy to a card

_HOST_UTF8 = ("the host UTF-8 modules: ops/utf8.py folding, normalization and "
              "uncased search, ops/utf8_segment.py (ROADMAP.md, queue 1 item 5)")
_ARROW = "Arrow import and export: models/arrow.py (ROADMAP.md, queue 1 item 5)"


def _not_ported(what: str):
    raise NotImplementedError(f"not ported to stringzilla_tpu_torch yet; waits for {what}")


def _mirror_of(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """``buf`` as a flat ``uint8`` tensor on ``device``, padded with zeros to
    a multiple of 16 bytes plus at least ``_MIRROR_TAIL``. The host buffer
    may be read-only (``bytes``, a ``File``'s mmap): it is copied through a
    pinned staging tensor in chunks, never handed to ``torch.from_numpy``."""
    n = int(buf.shape[0])
    mirror = torch.empty(round_up(n, 16) + _MIRROR_TAIL, dtype=torch.uint8, device=device)
    mirror[n:].zero_()
    if device.type == "cpu":
        mirror[:n].numpy()[:] = buf
        return mirror
    stage = torch.empty(min(n, _STAGING_BYTES), dtype=torch.uint8, pin_memory=True)
    for lo in range(0, n, _STAGING_BYTES):
        hi = min(lo + _STAGING_BYTES, n)
        stage[: hi - lo].numpy()[:] = buf[lo:hi]
        mirror[lo:hi].copy_(stage[: hi - lo])  # synchronous: the stage is reused
    return mirror


def _to_bytes_like(data) -> np.ndarray:
    """View input as a uint8 numpy array without copying when possible."""
    if isinstance(data, Str):
        return data._buf
    if isinstance(data, str):
        return np.frombuffer(data.encode("utf-8"), dtype=np.uint8)
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, dtype=np.uint8)
    if isinstance(data, (memoryview, _mmap.mmap)):
        return np.frombuffer(data, dtype=np.uint8)
    if isinstance(data, np.ndarray):
        return data.view(np.uint8) if data.dtype != np.uint8 else data
    raise TypeError(f"can't wrap {type(data)!r} as Str")


def _needle_bytes(needle) -> bytes:
    if isinstance(needle, Str):
        return bytes(needle)
    if isinstance(needle, str):
        return needle.encode("utf-8")
    return bytes(needle)


class Str:
    """Zero-copy byte string with device-accelerated search (reference type
    ``Str``, ``python/stringzilla.c``; C++ ``sz::string_view``)."""

    __slots__ = ("_buf", "_mirror", "_bytes_cache")

    def __init__(self, data=b""):
        self._buf = _to_bytes_like(data)
        self._mirror = None
        self._bytes_cache = None

    # -- container protocol -------------------------------------------------

    def __len__(self) -> int:
        return int(self._buf.shape[0])

    def __bytes__(self) -> bytes:
        return self._buf.tobytes()

    def __str__(self) -> str:
        return self._buf.tobytes().decode("utf-8", errors="replace")

    def __repr__(self) -> str:
        head = bytes(self._buf[:40])
        return f"Str({head!r}{'...' if len(self) > 40 else ''}, len={len(self)})"

    def __getitem__(self, key):
        if isinstance(key, slice):
            return Str(self._buf[key])  # numpy slice = zero-copy view
        return int(self._buf[key])

    def __eq__(self, other) -> bool:
        try:
            ob = _to_bytes_like(other if not isinstance(other, str) else other)
        except TypeError:
            return NotImplemented
        if isinstance(other, str):
            ob = np.frombuffer(other.encode(), dtype=np.uint8)
        return self._buf.shape == ob.shape and bool((self._buf == ob).all())

    def __lt__(self, other) -> bool:
        return bytes(self) < _needle_bytes(other)

    def __le__(self, other) -> bool:
        return bytes(self) <= _needle_bytes(other)

    def __hash__(self) -> int:
        return self.hash()

    def __contains__(self, needle) -> bool:
        return self.find(needle) >= 0

    # -- buffer introspection (reference ``Str.address``/``Str.nbytes``,
    # ``python/stringzilla.c:2115-2116``) -----------------------------------

    @property
    def address(self) -> int:
        """Host address of the first byte — zero-copy views into a parent
        buffer report an address inside the parent, as the reference does.
        Empty strings/views still report their real buffer pointer (numpy
        views carry a valid pointer at length 0), matching the reference's
        pointer-identity semantics."""
        return int(self._buf.ctypes.data)

    @property
    def nbytes(self) -> int:
        return len(self)

    # -- device mirror -------------------------------------------------------

    def _device(self) -> torch.Tensor:
        """The device mirror on the default scope's device, built on first
        use and cached (rebuilt if the scope's device changes)."""
        device = default_device_scope().device
        if self._mirror is None or self._mirror.device != device:
            self._mirror = _mirror_of(self._buf, device)
        return self._mirror

    def _use_device(self) -> bool:
        return len(self) >= _DEVICE_MIN_BYTES

    # -- search --------------------------------------------------------------

    def find(self, needle, start: int = 0, end: int | None = None) -> int:
        """First occurrence (``sz_find``; Python ``Str.find``). Positions are
        absolute, bounded to ``[start, end)`` like ``bytes.find``."""
        nd = _needle_bytes(needle)
        n = len(self)
        end = n if end is None else min(end, n)
        if start < 0 or end < 0:  # normalize negative bounds like Python
            start, end, _ = slice(start, end).indices(n)
        if self._use_device():
            if len(nd) == 0:
                return start if start <= end else -1
            # exact for any needle length, bounds and all: no host re-search
            return int(search_positions(
                self._device(), n, "first", needle=np.frombuffer(nd, dtype=np.uint8),
                lo=start, hi=end - len(nd)))
        return bytes(self).find(nd, start, end)

    def rfind(self, needle, start: int = 0, end: int | None = None) -> int:
        nd = _needle_bytes(needle)
        n = len(self)
        end = n if end is None else min(end, n)
        if start < 0 or end < 0:
            start, end, _ = slice(start, end).indices(n)
        if self._use_device():
            if len(nd) == 0:
                return end
            return int(search_positions(
                self._device(), n, "last", needle=np.frombuffer(nd, dtype=np.uint8),
                lo=start, hi=end - len(nd)))
        return bytes(self).rfind(nd, start, end)

    def index(self, needle) -> int:
        r = self.find(needle)
        if r < 0:
            raise ValueError("substring not found")
        return r

    def rindex(self, needle) -> int:
        r = self.rfind(needle)
        if r < 0:
            raise ValueError("substring not found")
        return r

    def count(self, needle, allowoverlap: bool = False) -> int:
        """Occurrence count; ``allowoverlap`` extends Python semantics the way
        the reference binding does (``Str.count(needle, allowoverlap=True)``)."""
        nd = _needle_bytes(needle)
        n = len(self)
        if len(nd) == 0:
            return n + 1
        if not allowoverlap:
            return bytes(self).count(nd)
        if self._use_device():
            # exact for any needle length (the JAX tier stops at 16 bytes)
            return int(search_positions(self._device(), n, "count",
                                        needle=np.frombuffer(nd, dtype=np.uint8)))
        return _find_ops.count(bytes(self), nd, allowoverlap=True, device="cpu")

    def contains(self, needle) -> bool:
        """Binding alias of ``in`` (reference ``Str.contains``)."""
        return self.find(needle) >= 0

    def equal(self, other) -> bool:
        """Binding alias of ``==`` (``sz_equal``)."""
        return self == other

    def decode(self, encoding: str = "utf-8", errors: str = "strict") -> str:
        return bytes(self).decode(encoding, errors)

    def count_byteset(self, charset) -> int:
        """Occurrences of ANY byte of the set (binding ``Str.count_byteset``)."""
        if self._use_device():
            ws = _find_ops.byteset_mask(_needle_bytes(charset))
            return int(search_positions(self._device(), len(self), "count",
                                        byteset_words=ws))
        lut = np.zeros(256, dtype=bool)
        for bb in _needle_bytes(charset):
            lut[bb] = True
        return int(lut[self._buf].sum())

    # -- strip family (zero-copy views) --------------------------------------

    _WHITESPACE = b" \t\n\r\x0b\x0c"

    def _strip_bounds(self, charset, left: bool, right: bool):
        chars = _needle_bytes(charset) if charset is not None else self._WHITESPACE
        lut = np.zeros(256, dtype=bool)
        for bb in chars:
            lut[bb] = True
        keep = np.nonzero(~lut[self._buf])[0]
        if keep.size == 0:
            return 0, 0
        lo = int(keep[0]) if left else 0
        hi = int(keep[-1]) + 1 if right else len(self)
        return lo, hi

    def lstrip(self, charset=None) -> "Str":
        lo, hi = self._strip_bounds(charset, True, False)
        return Str(self._buf[lo:hi])

    def rstrip(self, charset=None) -> "Str":
        lo, hi = self._strip_bounds(charset, False, True)
        return Str(self._buf[lo:hi])

    def strip(self, charset=None) -> "Str":
        lo, hi = self._strip_bounds(charset, True, True)
        return Str(self._buf[lo:hi])

    def offset_within(self, larger: "Str") -> int:
        """Byte offset of this zero-copy view inside ``larger`` (pointer
        arithmetic, like the reference — no search)."""
        lb = larger._buf if isinstance(larger, Str) else _to_bytes_like(larger)
        my_ptr = self._buf.__array_interface__["data"][0]
        their_ptr = lb.__array_interface__["data"][0]
        off = my_ptr - their_ptr
        if off < 0 or off + len(self) > lb.shape[0]:
            raise ValueError("not a view into the given string")
        return int(off)

    def write_to(self, filename: str) -> None:
        with open(filename, "wb") as f:
            f.write(bytes(self))

    def startswith(self, prefix) -> bool:
        return bytes(self).startswith(_needle_bytes(prefix))

    def endswith(self, suffix) -> bool:
        return bytes(self).endswith(_needle_bytes(suffix))

    # -- byteset search (``sz_find_byteset`` family, find.h:272-290) ---------

    def find_first_of(self, charset) -> int:
        return self._byteset_search(charset, "first", invert=False)

    def find_last_of(self, charset) -> int:
        return self._byteset_search(charset, "last", invert=False)

    def find_first_not_of(self, charset) -> int:
        return self._byteset_search(charset, "first", invert=True)

    def find_last_not_of(self, charset) -> int:
        return self._byteset_search(charset, "last", invert=True)

    def _byteset_search(self, charset, mode: str, invert: bool) -> int:
        words = _find_ops.byteset_mask(_needle_bytes(charset))
        if invert:
            words = ~words
        if self._use_device():
            return int(search_positions(self._device(), len(self), mode,
                                        byteset_words=words))
        lut = np.zeros(256, dtype=bool)
        for w in range(8):
            for b in range(32):
                lut[w * 32 + b] = bool((int(words[w]) >> b) & 1)
        hits = lut[self._buf]
        idx = np.nonzero(hits)[0]
        if idx.size == 0:
            return -1
        return int(idx[0] if mode == "first" else idx[-1])

    # -- splitting (zero-copy ``Strs`` views) --------------------------------

    def split(self, separator=b" ", maxsplit: int = -1, keepseparator: bool = False) -> "Strs":
        """Split on an exact separator (binding ``Str.split``,
        ``python/stringzilla.c``). Returns zero-copy views."""
        sep = _needle_bytes(separator)
        data = bytes(self)
        parts = data.split(sep) if maxsplit < 0 else data.split(sep, maxsplit)
        pos = 0
        bounds = []
        for i, p in enumerate(parts):
            startp = pos
            endp = pos + len(p)
            if keepseparator and i < len(parts) - 1:
                endp += len(sep)
            bounds.append((startp, endp))
            pos += len(p) + len(sep)
        return Strs._from_views(self, bounds)

    def rsplit(self, separator=b" ", maxsplit: int = -1, keepseparator: bool = False) -> "Strs":
        sep = _needle_bytes(separator)
        data = bytes(self)
        parts = data.rsplit(sep) if maxsplit < 0 else data.rsplit(sep, maxsplit)
        bounds = []
        pos = 0
        for i, p in enumerate(parts):
            startp = pos
            endp = pos + len(p)
            if keepseparator and i < len(parts) - 1:
                endp += len(sep)
            bounds.append((startp, endp))
            pos += len(p) + len(sep)
        return Strs._from_views(self, bounds)

    def split_byteset(self, charset, maxsplit: int = -1) -> "Strs":
        """Split on ANY byte of the set (binding ``Str.split_byteset``)."""
        lut = np.zeros(256, dtype=bool)
        for b in _needle_bytes(charset):
            lut[b] = True
        hits = np.nonzero(lut[self._buf])[0]
        if maxsplit >= 0:
            hits = hits[:maxsplit]
        bounds = []
        start = 0
        for h in hits:
            bounds.append((start, int(h)))
            start = int(h) + 1
        bounds.append((start, len(self)))
        return Strs._from_views(self, bounds)

    def rsplit_byteset(self, charset, maxsplit: int = -1) -> "Strs":
        """Like ``split_byteset`` but the maxsplit budget spends from the
        right (binding ``Str.rsplit_byteset``)."""
        lut = np.zeros(256, dtype=bool)
        for bb in _needle_bytes(charset):
            lut[bb] = True
        hits = np.nonzero(lut[self._buf])[0]
        if maxsplit >= 0:
            hits = hits[max(len(hits) - maxsplit, 0):] if maxsplit else hits[:0]
        bounds = []
        start = 0
        for h in hits:
            bounds.append((start, int(h)))
            start = int(h) + 1
        bounds.append((start, len(self)))
        return Strs._from_views(self, bounds)

    def split_byteset_iter(self, charset):
        """Lazy byteset split (binding ``Str.split_byteset_iter``)."""
        for part in self.split_byteset(charset):
            yield part

    def rsplit_byteset_iter(self, charset):
        for part in reversed(list(self.rsplit_byteset(charset))):
            yield part

    def splitlines(self, keeplinebreaks: bool = False) -> "Strs":
        data = bytes(self)
        parts = data.splitlines(True)
        bounds = []
        pos = 0
        for p in parts:
            stripped = p.splitlines()[0] if p else p
            endp = pos + (len(p) if keeplinebreaks else len(stripped))
            bounds.append((pos, endp))
            pos += len(p)
        return Strs._from_views(self, bounds)

    # -- lazy iterator ranges (C++ sugar analogs) -----------------------------
    # Reference: allocation-free ``find_matches_view`` / ``rfind_matches_view``
    # / ``find_splits_view`` / ``rfind_splits_view``
    # (``include/stringzilla/stringzilla.hpp:543-875``) and the Python
    # binding's ``split_iter`` / ``rsplit_iter`` (``python/stringzilla.c``).
    # The incremental scans run on the HOST over one cached bytes view: a
    # lazy iterator makes O(matches) tiny dependent scans, and paying a
    # device dispatch per ``next()`` is pathological (one round-trip per
    # line when iterating a big log). One-shot find/rfind still dispatch.

    def _host_bytes(self) -> bytes:
        if self._bytes_cache is None:
            self._bytes_cache = bytes(self)
        return self._bytes_cache

    def find_all(self, needle, allowoverlap: bool = False):
        """Lazy iterator of match offsets, left to right
        (``find_matches_view``, reference ``stringzilla.hpp:543``)."""
        nd = _needle_bytes(needle)
        if not nd:
            return
        data = self._host_bytes()
        pos = 0
        while True:
            i = data.find(nd, pos)
            if i < 0:
                return
            yield i
            pos = i + (1 if allowoverlap else len(nd))

    def rfind_all(self, needle, allowoverlap: bool = False):
        """Lazy iterator of match offsets, right to left
        (``rfind_matches_view``, reference ``stringzilla.hpp:634``)."""
        nd = _needle_bytes(needle)
        if not nd:
            return
        data = self._host_bytes()
        end = len(self)
        while end >= len(nd):
            i = data.rfind(nd, 0, end)
            if i < 0:
                return
            yield i
            end = i + (len(nd) - 1 if allowoverlap else 0)

    def split_iter(self, separator=b" ", keepseparator: bool = False):
        """Lazy split on an exact separator, yielding zero-copy ``Str`` views
        (binding ``Str.split_iter``; ``find_splits_view``,
        reference ``stringzilla.hpp:742``). Returns the typed lazy iterator
        ``FindSplits`` (reference module type, ``python/stringzilla.c:6548``)."""
        return FindSplits(self._split_iter_gen(separator, keepseparator))

    def _split_iter_gen(self, separator, keepseparator):
        sep = _needle_bytes(separator)
        if not sep:
            yield self[:]
            return
        data = self._host_bytes()
        start = 0
        while True:
            i = data.find(sep, start)
            if i < 0:
                yield self[start:]
                return
            yield self[start : i + (len(sep) if keepseparator else 0)]
            start = i + len(sep)

    def rsplit_iter(self, separator=b" ", keepseparator: bool = False):
        """Lazy split from the right (binding ``Str.rsplit_iter``;
        ``rfind_splits_view``, reference ``stringzilla.hpp:875``). Parts come
        right to left; with ``keepseparator`` each non-rightmost part keeps
        its trailing separator (same convention as ``rsplit``). Returns the
        typed lazy iterator ``FindSplits``."""
        return FindSplits(self._rsplit_iter_gen(separator, keepseparator))

    def _rsplit_iter_gen(self, separator, keepseparator):
        sep = _needle_bytes(separator)
        if not sep:
            yield self[:]
            return
        data = self._host_bytes()
        end_body = len(self)  # body end (excl.) of the upcoming part
        extra = 0  # trailing separator bytes (0 only for the rightmost part)
        while True:
            i = data.rfind(sep, 0, end_body)
            if i < 0:
                yield self[0 : end_body + extra]
                return
            yield self[i + len(sep) : end_body + extra]
            end_body = i
            extra = len(sep) if keepseparator else 0

    def partition(self, separator):
        sep = _needle_bytes(separator)
        i = self.find(sep)
        if i < 0:
            return (self, Str(b""), Str(b""))
        return (self[:i], Str(sep), self[i + len(sep):])

    def rpartition(self, separator):
        sep = _needle_bytes(separator)
        i = self.rfind(sep)
        if i < 0:
            return (Str(b""), Str(b""), self)
        return (self[:i], Str(sep), self[i + len(sep):])

    # -- transforms & hashes --------------------------------------------------

    def translate(self, table) -> "Str":
        """256-byte LUT transform (``sz_lookup``, reference ``memory.h:153``;
        binding ``Str.translate``). Device path for big buffers."""
        lut = np.frombuffer(_needle_bytes(table), dtype=np.uint8)
        if lut.shape[0] != 256:
            raise ValueError("translate table must be exactly 256 bytes")
        if self._use_device():
            from ..ops.memory import lookup_transform

            out = lookup_transform(self._device()[: len(self)], lut)
            return Str(out.cpu().numpy())
        return Str(lut[self._buf])

    def hash(self, seed: int = 0) -> int:
        """Seeded 64-bit StringZilla hash, bit-identical to the reference."""
        return _hash_ops.sz_hash(bytes(self), seed)

    def bytesum(self) -> int:
        return _hash_ops.bytesum(bytes(self))

    def sha256(self) -> bytes:
        return Sha256(bytes(self)).digest()

    # -- UTF-8 conveniences (full layer in ops.utf8 / ops.utf8_segment) -------

    def utf8_count(self) -> int:
        """Rune count. Big buffers run the fused device validation+count
        pass (one streaming sweep over the cached mirror); invalid UTF-8
        falls back to the host's exact U+FFFD maximal-subpart semantics."""
        if self._use_device():
            from ..ops.utf8_device import validate_count_device

            valid, count = validate_count_device(self._device(), len(self))
            if valid:
                return count
        from ..ops.utf8 import utf8_count

        return utf8_count(bytes(self))

    def utf8_valid(self) -> bool:
        from ..ops.utf8_device import utf8_valid

        return utf8_valid(self)

    def utf8_fold(self) -> "Str":
        _not_ported(_HOST_UTF8)

    def utf8_norm(self, form: str = "NFC") -> "Str":
        _not_ported(_HOST_UTF8)

    def utf8_uncased_find(self, needle):
        """Case-insensitive search; its host tier and its device tier (an
        ASCII-folded mirror through the byte LUT, then the streaming search)
        come with the host UTF-8 modules."""
        _not_ported(_HOST_UTF8)

    def utf8_codepoints(self):
        """Iterator of code points, U+FFFD for ill-formed input (binding
        ``utf8_codepoints``)."""
        from ..ops.utf8 import utf8_decode

        return iter(int(r) for r in utf8_decode(bytes(self)))

    def utf8_wordbreaks(self) -> "Utf8Wordbreaks":
        _not_ported(_HOST_UTF8)

    def utf8_graphemes(self) -> "Strs":
        _not_ported(_HOST_UTF8)

    def utf8_sentences(self) -> "Strs":
        _not_ported(_HOST_UTF8)

    def utf8_linebreaks(self) -> "Strs":
        _not_ported(_HOST_UTF8)

    def utf8_whitespaces(self) -> "Utf8Whitespaces":
        _not_ported(_HOST_UTF8)

    def utf8_newlines(self) -> "Utf8Newlines":
        _not_ported(_HOST_UTF8)

    def utf8_delimiters(self) -> "Utf8Delimiters":
        _not_ported(_HOST_UTF8)

    def utf8_split_whitespaces(self) -> "Utf8SplitWhitespaces":
        _not_ported(_HOST_UTF8)

    def utf8_split_newlines(self) -> "Utf8SplitNewlines":
        _not_ported(_HOST_UTF8)

    def utf8_split_delimiters(self) -> "Utf8SplitDelimiters":
        _not_ported(_HOST_UTF8)

    def utf8_uncased_fold(self) -> "Str":
        _not_ported(_HOST_UTF8)

    def utf8_uncased_search(self, needle, start_rune: int = 0):
        _not_ported(_HOST_UTF8)

    def utf8_uncased_matches(self, needle, include_overlapping: bool = False):
        _not_ported(_HOST_UTF8)

    # -- order ----------------------------------------------------------------

    def order(self, other) -> int:
        """3-way lexicographic compare (``sz_order``, reference
        ``compare.h:88``): -1 / 0 / +1."""
        a, b = bytes(self), _needle_bytes(other)
        return -1 if a < b else (0 if a == b else 1)


class Strs:
    """A collection of ``Str`` views (reference type ``Strs``,
    ``python/stringzilla.c``) backed by a tape: parent buffer + bounds."""

    __slots__ = ("_parent", "_starts", "_ends")

    def __init__(self, items: Iterable | None = None):
        if items is None:
            buf = np.zeros(0, dtype=np.uint8)
            self._parent = Str(buf)
            self._starts = np.zeros(0, dtype=np.int64)
            self._ends = np.zeros(0, dtype=np.int64)
            return
        if isinstance(items, Tape):
            tape = items
        elif hasattr(items, "__arrow_c_array__"):
            # Any Arrow producer; the reference constructor consumes its
            # capsules (``python/stringzilla.c:8537``).
            _not_ported(_ARROW)
        else:
            tape = Tape.from_strings(list(items))
        self._parent = Str(np.asarray(tape.data))
        self._starts = np.asarray(tape.offsets[:-1], dtype=np.int64)
        self._ends = np.asarray(tape.offsets[1:], dtype=np.int64)

    def __arrow_c_array__(self, requested_schema=None):
        """Arrow PyCapsule export (binding ``Strs.__arrow_c_array__``)."""
        _not_ported(_ARROW)

    @classmethod
    def _from_views(cls, parent: Str, bounds) -> "Strs":
        out = cls.__new__(cls)
        out._parent = parent
        if bounds:
            arr = np.asarray(bounds, dtype=np.int64)
            out._starts, out._ends = arr[:, 0], arr[:, 1]
        else:
            out._starts = np.zeros(0, dtype=np.int64)
            out._ends = np.zeros(0, dtype=np.int64)
        return out

    def __len__(self) -> int:
        return int(self._starts.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            idx = np.arange(len(self))[i]
            return self._take(idx)
        if i < 0:
            i += len(self)
        return self._parent[int(self._starts[i]) : int(self._ends[i])]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other) -> bool:
        try:
            if len(self) != len(other):
                return False
        except TypeError:
            return NotImplemented
        return all(bytes(a) == _needle_bytes(b) for a, b in zip(self, other))

    def _take(self, idx: np.ndarray) -> "Strs":
        out = Strs.__new__(Strs)
        out._parent = self._parent
        out._starts = self._starts[idx]
        out._ends = self._ends[idx]
        return out

    def to_list(self) -> list[bytes]:
        return [bytes(s) for s in self]

    def to_tape(self) -> Tape:
        return Tape.from_strings(self.to_list())

    @property
    def lengths(self) -> np.ndarray:
        return (self._ends - self._starts).astype(np.int64)

    # -- tape-layout introspection (reference ``Strs.tape_address`` /
    # ``offsets_address`` / ``offsets_are_large`` / ``__layout__`` getters,
    # ``python/stringzilla.c:8525-8530``). Our tape is always a parent
    # buffer plus int64 start/end bounds, so offsets are always "large". ---

    @property
    def tape_address(self) -> int:
        return self._parent.address

    @property
    def tape_nbytes(self) -> int:
        return len(self._parent)

    @property
    def offsets_address(self) -> int:
        """Address of the end-offsets array (one int64 per view). The
        reference exposes its count+1 offsets array the same way; callers
        pair this with ``tape_address`` for zero-copy FFI hand-off."""
        return int(self._ends.ctypes.data) if len(self) else 0

    @property
    def offsets_nbytes(self) -> int:
        return int(self._ends.nbytes)

    @property
    def offsets_are_large(self) -> bool:
        """Always True: bounds are int64 (the reference's U64_TAPE case)."""
        return True

    @property
    def __layout__(self) -> str:
        contiguous = len(self) > 0 and bool(
            (self._ends[:-1] == self._starts[1:]).all()) \
            and int(self._starts[0]) == 0 \
            and int(self._ends[-1]) == len(self._parent)
        kind = "U64_TAPE_VIEW" if not contiguous else "U64_TAPE"
        return (f"Strs[layout={kind}, count={len(self)}, "
                f"data=0x{self.tape_address:x}, "
                f"offsets=0x{self.offsets_address:x}]")

    def order(self, reverse: bool = False, uncased: bool = False,
              top_count: int | None = None) -> np.ndarray:
        """Stable argsort permutation (``sz_sequence_argsort``, reference
        ``sort.h:87``; binding ``Strs.order``). Zero-copy: the sort keys are
        exported straight from the parent buffer."""
        return argsort_bounds(self._parent._buf, self._starts, self._ends,
                              reverse=reverse, uncased=uncased, top_count=top_count)

    def sort(self, reverse: bool = False) -> "Strs":
        """Sorted copy of the collection (binding ``Strs.sort``)."""
        return self._take(self.order(reverse=reverse))

    def append(self, item) -> "Strs":
        """Append one string (binding ``Strs.append``). Rebuilds the backing
        tape — O(total bytes), amortize with ``extend`` for bulk adds."""
        return self.extend([item])

    def extend(self, items) -> "Strs":
        """Append many strings (binding ``Strs.extend``), in place."""
        new = Tape.from_strings(self.to_list() + [
            _needle_bytes(x) for x in items])
        self._parent = Str(np.asarray(new.data))
        self._starts = np.asarray(new.offsets[:-1], dtype=np.int64)
        self._ends = np.asarray(new.offsets[1:], dtype=np.int64)
        return self

    def hashes(self, seed: int = 0) -> np.ndarray:
        """Per-string 64-bit StringZilla hashes, bit-identical to ``sz_hash``.
        From 2^14 strings on, the hash kernels run over the parent buffer's
        mirror on ``default_device_scope()``'s device (the plain versions on a
        CPU scope), each span gathered where it lies; a second call copies
        no byte of the buffer again. Smaller collections hash on the host."""
        if len(self) >= _DEVICE_MIN_HASHES:
            return hash_bounds_device(self._parent._device(), self._starts, self._ends, seed)
        return _hash_ops.hash_batch(self.to_list(), seed)

    def to_pylist(self) -> list[bytes]:
        """Binding alias of ``to_list``."""
        return self.to_list()

    @property
    def tape(self) -> Tape:
        """The underlying Arrow-style (data, offsets) container (the
        reference exposes tape_address/tape_nbytes; here the object itself)."""
        return self.to_tape()

    def sorted(self, reverse: bool = False) -> "Strs":
        """A NEW sorted collection (binding ``Strs.sorted``)."""
        return self._take(self.order(reverse=reverse))

    def shuffled(self, seed: int | None = None) -> "Strs":
        """Binding alias of ``shuffle`` (returns a new permuted view)."""
        return self.shuffle(seed)

    def sample(self, count: int, seed: int | None = None) -> "Strs":
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(self), size=count)
        return self._take(idx)

    def shuffle(self, seed: int | None = None) -> "Strs":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self))
        return self._take(idx)


class FindSplits:
    """Typed lazy iterator of zero-copy ``Str`` views returned by
    ``Str.split_iter``/``Str.rsplit_iter`` (reference module type
    ``stringzilla.FindSplits``, ``python/stringzilla.c:6548``: exported so
    callers can ``isinstance``-check; iteration is its whole contract)."""

    __slots__ = ("_it",)

    def __init__(self, it):
        self._it = iter(it)

    def __iter__(self):
        return self

    def __next__(self) -> Str:
        return next(self._it)


# Typed view collections mirroring the reference binding's module-level
# iterator types (python/stringzilla.c:9744+). The reference exports pure
# iterators; these subclass ``Strs`` so iteration yields the same zero-copy
# ``Str`` views while indexing/len stay available (a strict superset).
class Utf8Wordbreaks(Strs):
    """TR29 word segments (reference type ``stringzilla.Utf8Wordbreaks``)."""


class Utf8Newlines(Strs):
    """Newline tokens (reference type ``stringzilla.Utf8Newlines``)."""


class Utf8Whitespaces(Strs):
    """Whitespace runs (reference type ``stringzilla.Utf8Whitespaces``)."""


class Utf8Delimiters(Strs):
    """Delimiter tokens (reference type ``stringzilla.Utf8Delimiters``)."""


class Utf8SplitNewlines(Strs):
    """Segments between newlines (ref type ``stringzilla.Utf8SplitNewlines``)."""


class Utf8SplitWhitespaces(Strs):
    """Segments between whitespace runs (ref ``stringzilla.Utf8SplitWhitespaces``)."""


class Utf8SplitDelimiters(Strs):
    """Segments between delimiters (ref ``stringzilla.Utf8SplitDelimiters``)."""


class File(Str):
    """Memory-mapped read-only file (reference type ``File``,
    ``python/stringzilla.c``): zero-copy `Str` over the page cache."""

    __slots__ = ("_mmap", "_file")

    def __init__(self, path: str):
        f = open(path, "rb")
        try:
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except ValueError:  # empty file can't be mmapped
            f.close()
            super().__init__(b"")
            self._mmap = None
            self._file = None
            return
        self._file = f
        self._mmap = mm
        super().__init__(np.frombuffer(mm, dtype=np.uint8))

    def close(self):
        if self._mmap is not None:
            # Drop the numpy view first — mmap refuses to close while
            # exported buffer pointers exist.
            self._buf = np.zeros(0, dtype=np.uint8)
            self._mirror = None
            self._bytes_cache = None
            self._mmap.close()
            self._file.close()
            self._mmap = None
