"""The port's host UTF-8 layer against the JAX package's on the CPU: case
folding, normalization in all four forms, rune seek, uncased search and
order, the token boundaries, graphemes and the UAX-29/14 segmenters, each
``Str`` method and module-level name, and uncased sorting of non-ASCII
strings. The same numpy-seeded fuzz strings (runes drawn by index from a
pool of letters, marks, joiners, separators, Hangul, emoji and characters
whose case folding expands or maps outside ASCII, some with invalid bytes)
go through both packages; results must be exactly equal. Both take the same
tier here: the native host runtime and the UCD tables (``regex`` is
installed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu.ops import utf8 as JU  # noqa: E402
from stringzilla_tpu.ops import utf8_segment as JS  # noqa: E402
from stringzilla_tpu_torch.ops import utf8 as TU  # noqa: E402
from stringzilla_tpu_torch.ops import utf8_segment as TS  # noqa: E402
from stringzilla_tpu_torch.utils import platform  # noqa: E402

POOL = [
    0x41, 0x61, 0x4B, 0x6B, 0x53, 0x73, 0x27, 0x2019, 0x22, 0x05D0,  # letters, quotes
    0x31, 0x2C, 0x2E, 0x3A, 0x5F, 0x20, 0xA0, 0x21, 0x3F, 0x28, 0x29,  # digits, punctuation
    0x0A, 0x0D, 0x0B, 0x85, 0x2028, 0x200D, 0x200C, 0x200B, 0xAD,  # separators, joiners
    0x0301, 0x0308, 0x0327, 0x0903, 0x1100, 0x1161, 0x11A8, 0xAC00, 0xAC01,  # marks, Hangul
    0x1F1E6, 0x1F1E7, 0x1F600, 0x2764, 0xFE0F, 0x1F3FB,  # flags, emoji
    0x30A2, 0x4E00, 0x3042, 0x0E01, 0x0644, 0x0928,  # scripts
    0xDF, 0x1E9E, 0x212A, 0x130, 0x3A3, 0x3C2, 0xFB01, 0x149, 0xC9, 0xE9, 0x1C5,  # folding
    0x2126, 0x212B, 0x1E0A, 0x323, 0x1E69, 0x3D3, 0xF900,  # normalization
]
FORMS = ["NFC", "NFD", "NFKC", "NFKD"]


def _strings(salt: int, count: int = 60, longest: int = 24):
    """``count`` fuzz strings of 0..longest runes from POOL; every fifth
    with invalid bytes inside or at the end."""
    rng = np.random.default_rng(180 + salt)
    out = []
    for i in range(count):
        runes = rng.integers(0, len(POOL), int(rng.integers(0, longest + 1)))
        s = "".join(chr(POOL[int(r)]) for r in runes).encode()
        if i % 5 == 4:
            cut = int(rng.integers(0, len(s) + 1))
            s = s[:cut] + [b"\xff", b"\xc3", b"\xe2\x82", b"\xed\xa0\x80"][i % 4] + s[cut:]
        out.append(s)
    return out


def _norm(x):
    """Results of either package as comparable Python values."""
    if isinstance(x, (jsz.Str, tsz.Str)):
        return bytes(x)
    if isinstance(x, (jsz.Strs, tsz.Strs)):
        return [bytes(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], (jsz.Str, tsz.Str)):
        return [bytes(v) for v in x]
    return x


HOST = {
    "utf8_fold": lambda U, s: U.utf8_fold(s),
    "utf8_seek": lambda U, s: [U.utf8_seek(s, i) for i in (0, 1, 3, 7, 100)],
    "utf8_find_cased": lambda U, s: U.utf8_find_cased(s),
    "utf8_newlines": lambda U, s: U.utf8_newlines(s),
    "utf8_whitespaces": lambda U, s: U.utf8_whitespaces(s),
    "utf8_delimiters": lambda U, s: U.utf8_delimiters(s),
    "utf8_graphemes": lambda U, s: U.utf8_graphemes(s),
    "utf8_uncased_find": lambda U, s: [U.utf8_uncased_find(s, s[a:b])
                                       for a, b in ((0, 1), (2, 7), (5, 9))],
    "utf8_uncased_find ss": lambda U, s: [U.utf8_uncased_find(s, n, r) for n, r in
                                          ((b"ss", 0), ("K".encode(), 1), (b"kS", 2))],
    "utf8_uncased_order": lambda U, s: [U.utf8_uncased_order(s, t) for t in
                                        (b"", s.upper(), s[:3], s.lower() + b"a")],
}


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_function_matches_jax(name):
    fn = HOST[name]
    for s in _strings(sum(map(ord, name))):
        assert _norm(fn(TU, s)) == _norm(fn(JU, s)), (name, s)


@pytest.mark.parametrize("form", FORMS)
def test_norm_forms_match_jax(form):
    for s in _strings(len(form)) + [b"e\xcc\x81", "Ḍ̇".encode(), b"abc"]:
        assert TU.utf8_norm(s, form) == JU.utf8_norm(s, form), (form, s)
        assert TU.utf8_is_normalized(s, form) == JU.utf8_is_normalized(s, form), (form, s)
        assert TU.utf8_find_denormalized(s, form) == JU.utf8_find_denormalized(s, form), (form, s)


def test_norm_rejects_unknown_form():
    with pytest.raises(ValueError):
        TU.utf8_norm(b"abc", "NFX")


SEGMENTERS = ["utf8_words", "utf8_wordbreaks", "utf8_sentences", "utf8_linebreaks"]


@pytest.mark.parametrize("name", SEGMENTERS)
def test_segmenter_matches_jax(name):
    text = (b"Mr. Smith's 3.14 items -- \"quoted\" text. Next one!\r\n"
            + "Ça va? Ünïcode wörds: naïve café.  日本語のテキスト。".encode())
    for s in _strings(len(name), count=40) + [text]:
        assert getattr(TS, name)(s) == getattr(JS, name)(s), (name, s)


STR_METHODS = {
    "utf8_fold": lambda s: s.utf8_fold(), "utf8_norm": lambda s: s.utf8_norm(),
    "utf8_norm NFKD": lambda s: s.utf8_norm("NFKD"),
    "utf8_uncased_find": lambda s: s.utf8_uncased_find(b"ss"),
    "utf8_codepoints": lambda s: list(s.utf8_codepoints()),
    "utf8_wordbreaks": lambda s: s.utf8_wordbreaks(), "utf8_graphemes": lambda s: s.utf8_graphemes(),
    "utf8_sentences": lambda s: s.utf8_sentences(), "utf8_linebreaks": lambda s: s.utf8_linebreaks(),
    "utf8_whitespaces": lambda s: s.utf8_whitespaces(), "utf8_newlines": lambda s: s.utf8_newlines(),
    "utf8_delimiters": lambda s: s.utf8_delimiters(),
    "utf8_split_whitespaces": lambda s: s.utf8_split_whitespaces(),
    "utf8_split_newlines": lambda s: s.utf8_split_newlines(),
    "utf8_split_delimiters": lambda s: s.utf8_split_delimiters(),
    "utf8_uncased_fold": lambda s: s.utf8_uncased_fold(),
    "utf8_uncased_search": lambda s: s.utf8_uncased_search("K".encode()),
    "utf8_uncased_search start": lambda s: s.utf8_uncased_search(b"a", start_rune=2),
    "utf8_uncased_matches": lambda s: list(s.utf8_uncased_matches(b"ss")),
    "utf8_uncased_matches overlapping": lambda s: list(
        s.utf8_uncased_matches(b"a", include_overlapping=True)),
}


@pytest.mark.parametrize("name", sorted(STR_METHODS))
def test_str_method_matches_jax(name):
    fn = STR_METHODS[name]
    for s in _strings(len(name), count=25) + [b"STRASSE stra\xc3\x9fe Stra\xe1\xba\x9ee aaa"]:
        got, want = fn(tsz.Str(s)), fn(jsz.Str(s))
        assert type(got).__name__ == type(want).__name__, name
        assert _norm(got) == _norm(want), (name, s)


NEW_NAMES = sorted(n for n in jsz.__all__ if n.startswith("utf8_")
                   and n not in ("utf8_count", "utf8_decode", "utf8_valid"))


@pytest.mark.parametrize("name", NEW_NAMES)
def test_module_level_name_matches_jax(name):
    extra = {"utf8_seek": (2,), "utf8_uncased_find": (b"ss",), "utf8_uncased_order": (b"STRASSE",),
             "utf8_uncased_search": (b"ss",), "utf8_uncased_matches": (b"ss",),
             "utf8_norm": ("NFKC",)}.get(name, ())
    for s in _strings(len(name), count=15) + [b"Stra\xc3\x9fe STRASSE"]:
        got, want = getattr(tsz, name)(s, *extra), getattr(jsz, name)(s, *extra)
        if name in ("utf8_uncased_matches", "utf8_codepoints"):
            got, want = list(got), list(want)
        assert _norm(got) == _norm(want), (name, s)


def test_exports_hold_every_jax_name():
    assert set(jsz.__all__) <= set(tsz.__all__)
    for name in tsz.__all__:
        assert hasattr(tsz, name), name


def test_reset_capabilities_moves_the_default_scope(monkeypatch):
    from stringzilla_tpu_torch.models.device_scope import default_device_scope

    monkeypatch.setattr(platform, "_CPU_FORCED", False)
    tsz.reset_capabilities("serial")
    assert default_device_scope().device == torch.device("cpu")
    assert platform.resolve_device(None) == torch.device("cpu")
    tsz.reset_capabilities("interpret")
    assert default_device_scope().device == torch.device("cpu")
    tsz.reset_capabilities("gpu")
    assert platform._CPU_FORCED is False
    tsz.reset_capabilities("serial")
    tsz.reset_capabilities()
    assert platform._CPU_FORCED is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_device_scope()
    tsz.reset_capabilities("serial")
    tsz.reset_capabilities("all")
    assert platform._CPU_FORCED is False
    with pytest.raises(ValueError):
        tsz.reset_capabilities("avx512")


def test_serial_capabilities_run_str_device_branch_on_cpu(monkeypatch):
    """After ``reset_capabilities('serial')`` a buffer of 1 MiB takes its
    device branch on the CPU (the plain versions), as JAX's takes its host
    tier under the interpreter; the results agree."""
    monkeypatch.setattr(platform, "_CPU_FORCED", False)
    data = (b"abc Stra\xc3\x9fe " * 90000)[: (1 << 20) + 7]
    tsz.reset_capabilities("serial")
    try:
        s = tsz.Str(data)
        assert s.find(b"Stra") == data.find(b"Stra")
        assert s.utf8_uncased_find(b"STRASSE") == jsz.Str(data).utf8_uncased_find(b"STRASSE")
        assert s._mirror.device == torch.device("cpu")
    finally:
        tsz.reset_capabilities()


UNCASED_ITEMS = [b"Stra\xc3\x9fe", b"STRASSE", b"\xc3\xa9cole", b"Ecole", b"\xc3\x89COLE", b"abc",
                 b"ABD", b"\xc7\x85", b"\xc7\x86", b"", b"k", b"\xe2\x84\xaa", b"K", b"\xff", b"ss"]


@pytest.mark.parametrize("kwargs", [{}, {"reverse": True}, {"top_count": 3}],
                         ids=["plain", "reverse", "top 3"])
def test_uncased_argsort_of_non_ascii_matches_jax(kwargs):
    rng = np.random.default_rng(181)
    items = UNCASED_ITEMS + [UNCASED_ITEMS[int(i)] + UNCASED_ITEMS[int(j)]
                             for i, j in rng.integers(0, len(UNCASED_ITEMS), (40, 2))]
    got = tsz.argsort_strings(items, uncased=True, **kwargs)
    np.testing.assert_array_equal(got, jsz.argsort_strings(items, uncased=True, **kwargs))
    order = tsz.Strs(items).order(uncased=True, **kwargs)
    np.testing.assert_array_equal(order, jsz.Strs(items).order(uncased=True, **kwargs))
