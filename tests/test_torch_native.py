"""The port's native host runtime (its own copy of ``tapecraft.cpp``, built
into ``build/stringzilla_tpu_torch/``) against the JAX package's library on
the same inputs, for every function the port wires; the port's native
segmentation automata against its vectorized numpy tier; the functions with
no native library in either package against each other; and the build's
failure modes: ``lib()`` None, ``load()`` raising with ``g++``'s message.
Exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu.ops import ucd as jucd  # noqa: E402
from stringzilla_tpu.ops import utf8 as JU  # noqa: E402
from stringzilla_tpu.ops import utf8_segment as JS  # noqa: E402
from stringzilla_tpu.utils import native as jnative  # noqa: E402
from stringzilla_tpu_torch.ops import segment as S  # noqa: E402
from stringzilla_tpu_torch.ops import sort as tsort  # noqa: E402
from stringzilla_tpu_torch.ops import ucd  # noqa: E402
from stringzilla_tpu_torch.ops import utf8 as TU  # noqa: E402
from stringzilla_tpu_torch.ops import utf8_segment as TS  # noqa: E402
from stringzilla_tpu_torch.utils import native  # noqa: E402

# tests/test_segmentation.py's samples: letters, quotes, digits, separators,
# joiners, marks, Hangul, flags, emoji and scripts, plus folding specials
SAMPLES = [
    0x0041, 0x0061, 0x0027, 0x2019, 0x0022, 0x05D0, 0x05F4, 0x0031, 0x002C, 0x002E, 0x003A,
    0x005F, 0x0020, 0x00A0, 0x000A, 0x000D, 0x0085, 0x2028, 0x200D, 0x200C, 0x00AD, 0x0301,
    0x0308, 0x0903, 0x1100, 0x1160, 0x11A8, 0xAC00, 0xAC01, 0x1F1E6, 0x1F1E7, 0x1F600, 0x2764,
    0xFE0F, 0x261D, 0x1F3FB, 0x30A2, 0x4E00, 0x3042, 0x0E01, 0x0644, 0x0928, 0x093C, 0x094D,
    0x00DF, 0x1E9E, 0x212A, 0x0130, 0xFB01, 0x0149, 0x03A3,
]


def _fuzz(salt, count=50, longest=48):
    rng = np.random.default_rng(183 + salt)
    out = []
    for i in range(count):
        runes = rng.choice(np.asarray(SAMPLES), int(rng.integers(1, longest)))
        s = "".join(chr(int(c)) for c in runes).encode()
        if i % 4 == 3:
            s = s[: len(s) // 2] + b"\xf0\x9f" + s[len(s) // 2:] + b"\xc3"
        out.append(np.frombuffer(s, np.uint8))
    return out


def _fold_tabs(u):
    t = u._fold_tables()
    assert t is not None
    return t


def test_native_builds_into_the_build_directory():
    L = native.load()
    assert L is native.lib() and native.available()
    assert L._name.startswith(native._BUILD_DIR) and "libtapecraft-" in L._name


def test_decode_encode_match_jax():
    for arr in _fuzz(0):
        got, want = native.utf8_decode(arr), jnative.utf8_decode(arr)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(native.utf8_encode(got[0]), jnative.utf8_encode(want[0]))


def test_fold_runes_and_bytes_match_jax():
    tabs, jtabs = _fold_tabs(TU), _fold_tabs(JU)
    for arr in _fuzz(1):
        runes = jnative.utf8_decode(arr)[0]
        for with_src in (True, False):
            got = native.fold_runes(runes, *tabs, with_src=with_src)
            want = jnative.fold_runes(runes, *jtabs, with_src=with_src)
            np.testing.assert_array_equal(got[0], want[0])
            if with_src:
                np.testing.assert_array_equal(got[1], want[1])
        assert bytes(native.utf8_fold_bytes(arr, *tabs)) == bytes(
            jnative.utf8_fold_bytes(arr, *jtabs))


def test_uncased_find_matches_jax():
    tabs, jtabs = _fold_tabs(TU), _fold_tabs(JU)
    for i, arr in enumerate(_fuzz(2)):
        hay = arr.tobytes()
        for needle in (hay[1:4], b"ss", "K".encode(), hay[-3:]):
            nd = TU._folded_with_spans(needle)[0].astype(np.uint32)
            for start in (0, 1, 5):
                assert native.utf8_uncased_find(arr, nd, start, *tabs) == \
                    jnative.utf8_uncased_find(arr, nd, start, *jtabs), (hay, needle, start)


@pytest.mark.parametrize("axis", ["wb", "gb", "sb", "lb"])
def test_break_automata_match_jax(axis):
    tables = {"wb": (ucd.wb_classes(), ucd.gcb_ext_pict()), "gb": (ucd.gcb_classes(),
              ucd.gcb_ext_pict()), "sb": (ucd.sb_classes(),), "lb": (ucd.lb_classes(),)}[axis]
    jtables = {"wb": (jucd.wb_classes(), jucd.gcb_ext_pict()), "gb": (jucd.gcb_classes(),
               jucd.gcb_ext_pict()), "sb": (jucd.sb_classes(),), "lb": (jucd.lb_classes(),)}[axis]
    fn, jfn = getattr(native, f"{axis}_breaks"), getattr(jnative, f"{axis}_breaks")
    text = np.frombuffer(b"Word boundaries; 3.14 can't stop -- \"quoted\" text.\n" * 40, np.uint8)
    for arr in _fuzz(3) + [text]:
        got, want = fn(arr, *tables), jfn(arr, *jtables)
        for a, b in (zip(got, want) if axis == "lb" else [(got, want)]):
            np.testing.assert_array_equal(a, b)
        assert fn(arr, *tables, count_only=True) == jfn(arr, *jtables, count_only=True)


def test_pgram_keys_unicode_match_jax():
    tabs, jtabs = _fold_tabs(TU), _fold_tabs(JU)
    items = [a.tobytes() for a in _fuzz(4, count=30, longest=12)]
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in items])]).astype(np.int64)
    data = np.frombuffer(b"".join(items), np.uint8)
    for reverse in (False, True):
        np.testing.assert_array_equal(
            native.pgram_keys_unicode(data, offsets[:-1], offsets[1:], 9, reverse, *tabs),
            jnative.pgram_keys_unicode(data, offsets[:-1], offsets[1:], 9, reverse, *jtabs))


def test_native_vs_vectorized_segmentation():
    """The native streaming automata against the vectorized numpy tier on
    mixed-script fuzz and plain text, as tests/test_segmentation.py holds
    the JAX package's."""
    for arr in _fuzz(5) + [np.frombuffer(b"Word boundaries; 3.14 can't stop -- \"quoted\" "
                                         b"text.\n" * 40, np.uint8)]:
        buf = arr.tobytes()
        assert list(S.word_breaks(buf)) == list(S._word_breaks_py(buf)), buf
        assert list(S.grapheme_breaks(buf)) == list(S._grapheme_breaks_py(buf)), buf
        assert list(S.sentence_breaks(buf)) == list(S._sentence_breaks_py(buf)), buf
        got, want = S.line_breaks(buf), S._line_breaks_py(buf)
        assert list(got[0]) == list(want[0]) and list(got[1]) == list(want[1]), buf


CALLS = {
    "utf8_fold": lambda U, s: U.utf8_fold(s),
    "utf8_norm NFC": lambda U, s: U.utf8_norm(s, "NFC"),
    "utf8_norm NFKD": lambda U, s: U.utf8_norm(s, "NFKD"),
    "utf8_uncased_find": lambda U, s: U.utf8_uncased_find(s, b"Ss"),
    "utf8_uncased_order": lambda U, s: U.utf8_uncased_order(s, s.lower()),
    "utf8_find_cased": lambda U, s: U.utf8_find_cased(s),
    "utf8_graphemes": lambda U, s: U.utf8_graphemes(s),
    "utf8_words": lambda U, s: (TS if U is TU else JS).utf8_words(s),
    "utf8_sentences": lambda U, s: (TS if U is TU else JS).utf8_sentences(s),
    "utf8_linebreaks": lambda U, s: (TS if U is TU else JS).utf8_linebreaks(s),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_without_native_matches_jax_without_native(monkeypatch, name):
    """Both packages' Python and numpy paths, with neither library."""
    monkeypatch.setattr(native, "lib", lambda: None)
    monkeypatch.setattr(jnative, "lib", lambda: None)
    for arr in _fuzz(6, count=15, longest=20):
        s = arr.tobytes()
        assert CALLS[name](TU, s) == CALLS[name](JU, s), (name, s)


def test_uncased_sort_without_native_matches_jax(monkeypatch):
    monkeypatch.setattr(native, "lib", lambda: None)
    monkeypatch.setattr(jnative, "lib", lambda: None)
    from stringzilla_tpu.ops import sort as jsort

    items = [a.tobytes() for a in _fuzz(7, count=30, longest=8)]
    np.testing.assert_array_equal(tsort.argsort_strings(items, uncased=True),
                                  jsort.argsort_strings(items, uncased=True))


def test_failed_build_gives_none_and_load_raises(monkeypatch, tmp_path):
    bad = tmp_path / "tapecraft.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.lib() is None and not native.available()
    assert native.utf8_decode(np.zeros(3, np.uint8)) is None
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*broken"):
        native.load()
    # the Python paths give the same results with no library
    assert TU.utf8_fold("STRAẞE".encode()) == b"strasse"
    assert TU.utf8_uncased_find(b"xx STRASSE", "straße".encode()) == (3, 7)
