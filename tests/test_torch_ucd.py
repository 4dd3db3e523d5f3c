"""The port's UCD tables against the JAX package's, array by array (the
tables play the part of weights here), and the tiers that run without them:
the fold and normalization tables must build and agree with ``regex``
reported missing; with the segment tables reported missing in both
packages, the segmenters' ``unicodedata`` tier must agree; with the text
tables reported missing, the port's fold and normalization fallbacks must
agree with the JAX package's (its tables need ``regex``). Exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu.ops import ucd as jucd  # noqa: E402
from stringzilla_tpu.ops import utf8 as JU  # noqa: E402
from stringzilla_tpu.ops import utf8_segment as JS  # noqa: E402
from stringzilla_tpu_torch.ops import ucd  # noqa: E402
from stringzilla_tpu_torch.ops import utf8 as TU  # noqa: E402
from stringzilla_tpu_torch.ops import utf8_segment as TS  # noqa: E402

TEXT = ["fold1", "fold_multi_keys", "fold_multi_vals", "fold_multi_offs", "ccc", "nfd_idx",
        "nfd_vals", "nfd_offs", "nfkd_idx", "nfkd_vals", "nfkd_offs", "comp_keys", "comp_vals",
        "qc"]
SEGMENT = ["wb", "gcb", "sb", "lb", "ext_pict"]

SAMPLES = [
    b"", b"abc", b"Mr. Smith's 3.14 items -- \"quoted\" text. Next one!\r\nNew line",
    "Ça va? Ünïcode wörds: naïve café.  日本語のテキスト。".encode(),
    "👩‍🚀🇺🇸🇫🇷 é 각 x‍y".encode(), b"bad \xff\xc3 bytes\xe2\x82",
    "ﬁle STRAẞE Ǆ ΣΑΣ K Å".encode(), "שָׁלוֹם \"ab\" a'b 1,000.5".encode(),
]


@pytest.mark.parametrize("name", TEXT)
def test_text_table_matches_jax(name):
    got, want = ucd._load_text()[name], jucd._load()[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SEGMENT)
def test_segment_table_matches_jax(name):
    got, want = ucd._load_segment()[name], jucd._load()[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_accessors_match_jax():
    for fn in ("wb_classes", "gcb_classes", "sb_classes", "lb_classes", "gcb_ext_pict", "fold1",
               "ccc", "qc_classes"):
        np.testing.assert_array_equal(getattr(ucd, fn)(), getattr(jucd, fn)())
    assert ucd.fold_multi() == jucd.fold_multi()
    for compat in (False, True):
        for a, b in zip(ucd.decomp_tables(compat), jucd.decomp_tables(compat)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ucd.comp_pairs(), jucd.comp_pairs()):
        np.testing.assert_array_equal(a, b)
    assert ucd.ucd_version() == jucd.ucd_version()
    assert (ucd.WB_VALUES, ucd.GCB_VALUES, ucd.SB_VALUES, ucd.LB_VALUES) == (
        jucd.WB_VALUES, jucd.GCB_VALUES, jucd.SB_VALUES, jucd.LB_VALUES)


def test_text_tables_build_without_regex(monkeypatch, tmp_path):
    """With ``regex`` reported missing, the text group still builds, into a
    fresh cache, equal to the JAX tables, while the segment group is
    reported unavailable."""
    monkeypatch.setattr(ucd, "_has_regex", lambda: False)
    monkeypatch.setattr(ucd, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(ucd, "_text", {})
    assert not ucd.available() and ucd.text_available()
    tables = ucd._load_text()
    assert sorted(tables) == sorted(TEXT)
    for name in TEXT:
        np.testing.assert_array_equal(tables[name], jucd._load()[name])
    assert [p.name for p in tmp_path.glob("*.npz")] == [f"ucd-text-{ucd.ucd_version()}.npz"]
    monkeypatch.setattr(ucd, "_text", {})  # a second load reads the cache
    np.testing.assert_array_equal(ucd.fold1(), jucd.fold1())
    assert TU.utf8_fold("STRAẞE".encode()) == b"strasse"


@pytest.mark.parametrize("fn", ["utf8_words", "utf8_wordbreaks", "utf8_sentences",
                                "utf8_linebreaks", "utf8_graphemes"])
def test_segmenter_fallback_tier_matches_jax(monkeypatch, fn):
    """The ``unicodedata``-derived tier (what runs where ``regex`` is not
    installed) against the JAX package's, both forced onto it."""
    monkeypatch.setattr(ucd, "available", lambda: False)
    monkeypatch.setattr(jucd, "available", lambda: False)
    port, jax_ = (TU, JU) if fn == "utf8_graphemes" else (TS, JS)
    rng = np.random.default_rng(182)
    pool = "aZ1 .,:'\"!?\n\r ́‍é一あア\U0001F600\U0001F1E6-—("
    fuzz = ["".join(pool[int(i)] for i in rng.integers(0, len(pool), int(rng.integers(0, 30))))
            .encode() for _ in range(40)]
    for s in SAMPLES + fuzz:
        assert getattr(port, fn)(s) == getattr(jax_, fn)(s), (fn, s)


@pytest.mark.parametrize("form", ["NFC", "NFD", "NFKC", "NFKD"])
def test_text_fallbacks_match_jax(monkeypatch, form):
    """With the text tables reported missing, folding, normalization and
    the uncased functions take the ``str.casefold`` / ``unicodedata``
    fallbacks, as the JAX package's do without ``regex``."""
    monkeypatch.setattr(ucd, "text_available", lambda: False)
    monkeypatch.setattr(jucd, "available", lambda: False)
    for s in SAMPLES:
        assert TU.utf8_norm(s, form) == JU.utf8_norm(s, form), s
        assert TU.utf8_is_normalized(s, form) == JU.utf8_is_normalized(s, form), s
        assert TU.utf8_find_denormalized(s, form) == JU.utf8_find_denormalized(s, form), s
        assert TU.utf8_fold(s) == JU.utf8_fold(s), s
        assert TU.utf8_find_cased(s) == JU.utf8_find_cased(s), s
        assert TU.utf8_uncased_find(s, b"SS") == JU.utf8_uncased_find(s, b"SS"), s
        assert TU.utf8_uncased_order(s, b"abc") == JU.utf8_uncased_order(s, b"abc"), s
