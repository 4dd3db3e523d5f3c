"""stringzilla_tpu_torch — the PyTorch/CUDA port of stringzilla_tpu.

Batch string engines in PyTorch, with every kernel on the engines' path
hand-written in CUDA C++ for NVIDIA Hopper (``csrc/``, built with ``nvcc``
for ``sm_90a`` on first use) and a plain PyTorch version beside each kernel
for the CPU. Imports torch and numpy, never jax.

Layout mirrors ``stringzilla_tpu`` so each module has a counterpart:

* ``stringzilla_tpu_torch.ops``    — kernels' wrappers and plain versions,
  tapes and on-device packing
* ``stringzilla_tpu_torch.models`` — engine classes and ``DeviceScope``
* ``stringzilla_tpu_torch.parallel`` — work split over a scope's devices
* ``stringzilla_tpu_torch.utils``  — device resolution, the CUDA kernel build
* ``stringzilla_tpu_torch.serve``  — the engine server on a Unix socket

Ported so far: ``LevenshteinDistances`` with any costs
(unit costs on the Myers kernel, others on the column DP),
``NeedlemanWunschScores`` and ``SmithWatermanScores`` (the column DP, with
the byte-LUT kernel mapping bytes to cost classes), pairs with a string
over 4096 chars on the wavefront kernels, ``LevenshteinDistancesUTF8``
(the same engines over runes, the Myers kernel's rune route for unit
costs) and ``Fingerprints`` (the MinHash kernel); the buffer tier
(``Str``, ``File``, ``Strs`` and the module-level find, count, split,
translate and UTF-8 functions), whose buffers of at least 1 MiB run the
streaming-search, UTF-8 validation and byte-LUT kernels on the card;
hashing and set operations: ``Strs.hashes`` and ``intersect`` on the AES
hash kernels of ``csrc/hash.cu``, SHA-256, sort and compare; and the host
UTF-8 layer: case folding, normalization, uncased search and order (a
buffer of at least 1 MiB searched on the card through the byte-LUT and
streaming-search kernels first), the token views and the UAX-29/14
segmenters, over a native host runtime (``native/tapecraft.cpp``, built
with ``g++`` on first use) and generated UCD tables; Arrow import and
export of ``Strs`` and ``Tape``; ``reset_capabilities``. Every name of the
JAX package's ``__all__`` is here. A ``DeviceScope`` spans every visible
card (or a list of devices): the engines split their candidates and
``Fingerprints`` its documents over it (``parallel/cross.py``), a pair past
one device's wavefront runs on the ring tier with its rows cut over the
scope's devices (``parallel/ring.py``, the ``ring_tile`` kernel), and
``serve.py`` answers engine requests from other processes. Not ported:
scopes over several hosts, and the native host tiers for packing,
hashing, SHA-256 and sort keys.
"""

from .models.device_scope import DeviceScope
from .models.fingerprints import Fingerprints
from .models.str_api import (
    File,
    FindSplits,
    Str,
    Strs,
    Utf8Delimiters,
    Utf8Newlines,
    Utf8SplitDelimiters,
    Utf8SplitNewlines,
    Utf8SplitWhitespaces,
    Utf8Whitespaces,
    Utf8Wordbreaks,
)
from .models.similarities import (
    LevenshteinDistances,
    LevenshteinDistancesUTF8,
    NeedlemanWunsch,
    NeedlemanWunschScores,
    SmithWaterman,
    SmithWatermanScores,
)
from .ops import utf8 as _u
from .ops import utf8_segment as _useg
from .ops.compare import batch_equal, batch_order, equal
from .ops.compare import order as compare_order
from .ops.hash import Hasher, bytesum, fill_random, hash_multiseed, random, sz_hash
from .ops.intersect import intersect
from .ops.sha256 import Sha256, hmac_sha256, sha256
from .ops.sort import argsort_strings
from .ops.tape import Tape
from .utils import platform

# Module-level function surface mirroring the reference binding
# (``python/stringzilla.c:9531-9612``), as the JAX package routes it:
# find/rfind/count/byteset search/split/translate go through ``Str``, so big
# buffers take the same kernels as ``Str.find``.


def _as_str(text) -> Str:
    return text if isinstance(text, Str) else Str(text)


def find(haystack, needle) -> int:
    """Offset of the first occurrence, -1 if absent (``sz_find``)."""
    return _as_str(haystack).find(needle)


def rfind(haystack, needle) -> int:
    """Offset of the last occurrence (``sz_rfind``)."""
    return _as_str(haystack).rfind(needle)


def count(haystack, needle, allowoverlap: bool = False) -> int:
    """Occurrence count (non-overlapping by default, matching ``Str.count``
    and the reference binding's ``sz.count``)."""
    return _as_str(haystack).count(needle, allowoverlap=allowoverlap)


def split(text, separator=b" ", maxsplit: int = -1, keepseparator: bool = False):
    """Split into a zero-copy ``Strs`` view (binding ``Str.split``)."""
    return _as_str(text).split(separator, maxsplit=maxsplit, keepseparator=keepseparator)


def split_iter(text, separator=b" ", keepseparator: bool = False):
    """Lazy split iterator (binding ``Str.split_iter``; ``find_splits_view``,
    reference ``stringzilla.hpp:742``)."""
    return _as_str(text).split_iter(separator, keepseparator=keepseparator)


def splitlines(text, keeplinebreaks: bool = False):
    return _as_str(text).splitlines(keeplinebreaks=keeplinebreaks)


def translate(text, lut) -> bytes:
    """256-byte LUT transform (``sz_lookup``; binding ``Str.translate``)."""
    return bytes(_as_str(text).translate(lut))


def count_byteset(text, charset) -> int:
    """Module-level form of ``Str.count_byteset`` (reference binding)."""
    return _as_str(text).count_byteset(charset)


def utf8_valid(data) -> bool:
    """Well-formed UTF-8 check (device pass for ``Str`` buffers of 1 MiB
    and more)."""
    from .ops.utf8_device import utf8_valid as _uv

    return _uv(data)


def find_byteset(text, charset) -> int:
    """First byte ∈ set (``sz_find_byteset``), through ``Str`` as find is."""
    return _as_str(text)._byteset_search(charset, "first", invert=False)


def rfind_byteset(text, charset) -> int:
    """Last byte ∈ set (``sz_rfind_byteset``)."""
    return _as_str(text)._byteset_search(charset, "last", invert=False)


def reset_capabilities(*caps) -> None:
    """Restrict or restore the backend tier (binding
    ``sz.reset_capabilities``, reference ``README.md:954-962``):
    ``reset_capabilities('serial')`` (or ``'interpret'``) makes the default
    scope, and every entry point given no device, run the plain versions on
    the CPU; ``reset_capabilities()`` (or ``'all'``) and ``'cuda'``,
    ``'gpu'``, ``'tpu'`` or ``'pallas'`` give them the card again."""
    if "serial" in caps or "interpret" in caps:
        platform.force_backend(cpu=True)
    elif not caps or caps == ("all",) or any(c in caps for c in ("cuda", "gpu", "tpu", "pallas")):
        platform.force_backend(cpu=False)
    else:
        raise ValueError(f"unknown capability set {caps!r}")


def _via_str(name):
    def fn(text, *args, **kwargs):
        return getattr(_as_str(text), name)(*args, **kwargs)

    fn.__name__ = name
    fn.__doc__ = f"Module-level form of ``Str.{name}`` (reference binding)."
    return fn


hash = sz_hash  # noqa: A001 - intentional API parity with the reference
order = compare_order  # the reference binding's name
argsort = argsort_strings
lookup = translate
utf8_count = _u.utf8_count
utf8_decode = _u.utf8_decode
utf8_seek = _u.utf8_seek
utf8_fold = _u.utf8_fold
utf8_norm = _u.utf8_norm
utf8_is_normalized = _u.utf8_is_normalized
utf8_find_denormalized = _u.utf8_find_denormalized
utf8_find_cased = _u.utf8_find_cased
utf8_uncased_find = _u.utf8_uncased_find
utf8_uncased_order = _u.utf8_uncased_order
utf8_words = _useg.utf8_words
utf8_codepoints = _via_str("utf8_codepoints")
utf8_split_whitespaces = _via_str("utf8_split_whitespaces")
utf8_split_newlines = _via_str("utf8_split_newlines")
utf8_split_delimiters = _via_str("utf8_split_delimiters")
utf8_uncased_fold = _via_str("utf8_uncased_fold")
utf8_uncased_search = _via_str("utf8_uncased_search")
utf8_uncased_matches = _via_str("utf8_uncased_matches")
# The reference binding's module-level segmenters yield Str views
# (python/stringzilla.c); the offset- and span-returning functions stay at
# ops.utf8 and ops.utf8_segment.
utf8_newlines = _via_str("utf8_newlines")
utf8_whitespaces = _via_str("utf8_whitespaces")
utf8_delimiters = _via_str("utf8_delimiters")
utf8_graphemes = _via_str("utf8_graphemes")
utf8_wordbreaks = _via_str("utf8_wordbreaks")
utf8_sentences = _via_str("utf8_sentences")
utf8_linebreaks = _via_str("utf8_linebreaks")

__version__ = "0.1.0"


def __capabilities__():
    return platform.capabilities()


__all__ = [
    "DeviceScope",
    "File",
    "FindSplits",
    "Fingerprints",
    "Hasher",
    "LevenshteinDistances",
    "LevenshteinDistancesUTF8",
    "NeedlemanWunsch",
    "NeedlemanWunschScores",
    "Sha256",
    "SmithWaterman",
    "SmithWatermanScores",
    "Str",
    "Strs",
    "Tape",
    "Utf8Delimiters",
    "Utf8Newlines",
    "Utf8SplitDelimiters",
    "Utf8SplitNewlines",
    "Utf8SplitWhitespaces",
    "Utf8Whitespaces",
    "Utf8Wordbreaks",
    "__capabilities__",
    "argsort",
    "argsort_strings",
    "batch_equal",
    "batch_order",
    "bytesum",
    "compare_order",
    "count",
    "count_byteset",
    "equal",
    "fill_random",
    "find",
    "find_byteset",
    "hash",
    "hash_multiseed",
    "hmac_sha256",
    "intersect",
    "lookup",
    "order",
    "random",
    "rfind",
    "rfind_byteset",
    "sha256",
    "split",
    "split_iter",
    "splitlines",
    "sz_hash",
    "translate",
    "reset_capabilities",
    "utf8_codepoints",
    "utf8_count",
    "utf8_decode",
    "utf8_delimiters",
    "utf8_find_cased",
    "utf8_find_denormalized",
    "utf8_fold",
    "utf8_graphemes",
    "utf8_is_normalized",
    "utf8_linebreaks",
    "utf8_newlines",
    "utf8_norm",
    "utf8_seek",
    "utf8_sentences",
    "utf8_split_delimiters",
    "utf8_split_newlines",
    "utf8_split_whitespaces",
    "utf8_uncased_find",
    "utf8_uncased_fold",
    "utf8_uncased_matches",
    "utf8_uncased_order",
    "utf8_uncased_search",
    "utf8_valid",
    "utf8_whitespaces",
    "utf8_wordbreaks",
    "utf8_words",
]
