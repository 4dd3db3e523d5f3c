"""The device tier of case-insensitive search (``ops.utf8.
_uncased_find_device``) on a CPU device, where it runs the plain versions
of the byte-LUT and streaming-search kernels, against the JAX package's
``utf8_uncased_find`` (its native whole-buffer scan) and, on small cases,
the JAX tier itself in the Pallas interpreter. Cases: those of
tests/test_segmentation.py, a buffer with more non-ASCII runs than the
tier's 64 rounds (it gives up and the caller scans), matches that cross a
patch's edges, needles over 16 bytes, a folded needle ending in U+0000 at
the buffer's end, and ``Str.utf8_uncased_find`` on buffers of 1 MiB inside
``DeviceScope(device="cpu")`` with the LUT and search calls counted; on a
card-like device with no native library or fold tables, the tier raises
before any mirror is made. Exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu.ops import utf8 as JU  # noqa: E402
from stringzilla_tpu_torch.models import str_api  # noqa: E402
from stringzilla_tpu_torch.ops import find_kernel, memory  # noqa: E402
from stringzilla_tpu_torch.ops import utf8 as TU  # noqa: E402
from stringzilla_tpu_torch.utils import native  # noqa: E402


def _words_with_islands():
    """tests/test_segmentation.py's corpus: 400 ASCII words with three
    non-ASCII ones."""
    rng = np.random.default_rng(184)
    ascii_words = [b"alpha", b"BETA", b"Gamma", b"delta", b"epsilon"]
    parts = [ascii_words[int(i)] for i in rng.integers(0, 5, 400)]
    for slot, w in zip((50, 170, 290), ["ß".encode(), "École".encode(), b"Kelvin\xe2\x84\xaa"]):
        parts[slot] = w
    return b" ".join(parts)


BASE = _words_with_islands()
CASES = {
    "beta": (BASE, "beta"), "GAMMA d": (BASE, "GAMMA d"), "ss via patch": (BASE, "ss"),
    "kelvink": (BASE, "kelvink"), "absent": (BASE, "zzznope"), "all ascii": (b"x" * 3000, "xXx"),
    "after an island": (b"x" * 3000 + "préfixe".encode() + b"NEEDLE one", "needle"),
    # a match starting in the ASCII before a run and ending inside it
    "into a run": (b"q" * 200 + b"abcSTRA\xc3\x9fE" + b"z" * 200, "abcstrasse"),
    # two runs a few bytes apart: the first patch's window holds a match
    # that starts after its run; the second round's patch owns it
    "owned by the next patch": (b"q" * 300 + "ß".encode() + b"ab" + "K".encode() + b"q" * 300,
                                "abk"),
    "across two runs": (b"q" * 300 + "ßaß".encode() + b"q" * 300, "ssass"),
    # an ASCII hit right before a run, and one right after it
    "ascii before a run": (b"q" * 100 + b"NEEDLE" + "é".encode() + b"q" * 100, "needle"),
    "ascii after a run": (b"q" * 100 + "é".encode() + b"NEEDLE" + b"q" * 100, "needle"),
    "needle of 24": (BASE + b" the QUICK brown fox jumps!", "the quick brown fox jumps"),
    "needle of 40 over a run": (b"q" * 500 + "Die STRAßE hinunter und dann links abbiegen".encode()
                                + b"q" * 500, "die strasse hinunter und dann links abbi"),
    "needle of 17 absent": (BASE, "alpha beta gammaX"),
    "run at the end": (b"q" * 500 + "ß".encode(), "qss"),
    "run at the start": ("ß".encode() + b"q" * 500, "ssq"),
}


CPU = torch.device("cpu")


def _tier(hay: bytes, nd_f, **kw):
    """The tier on a CPU device, over the ``Str`` mirror of ``hay`` and its
    folded copy, made as ``Str`` makes them."""
    mirror = str_api._mirror_of(np.frombuffer(hay, np.uint8), CPU)
    return TU._uncased_find_device(
        hay, nd_f, CPU, lambda: mirror,
        lambda: memory.lookup_transform(mirror, TU.ascii_fold_lut()), **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_tier_matches_jax(case):
    hay, nd = CASES[case]
    nd_f, _, _ = TU._folded_with_spans(nd.encode())
    got = _tier(hay, nd_f, min_bytes=0)
    assert got is not None
    assert got == JU.utf8_uncased_find(hay, nd) == TU.utf8_uncased_find(hay, nd)


@pytest.mark.parametrize("case", ["beta", "ss via patch"])
def test_device_tier_matches_jax_tier_interpreted(case):
    hay, nd = CASES[case]
    got = _tier(hay, TU._folded_with_spans(nd.encode())[0], min_bytes=0)
    want = JU._uncased_find_device(hay, JU._folded_with_spans(nd.encode())[0], min_bytes=0,
                                   allow_interpret=True)
    assert got == want


def test_device_tier_gives_up_after_64_runs():
    hay = b"".join(b"word%03d caf\xc3\xa9 " % i for i in range(80)) + b"the END"
    nd_f = TU._folded_with_spans(b"the end")[0]
    assert _tier(hay, nd_f, min_bytes=0) is None
    assert TU.utf8_uncased_find(hay, b"the end") == JU.utf8_uncased_find(hay, b"the end")
    # 63 runs before the hit still fit in 64 rounds
    hay = b"".join(b"word%03d caf\xc3\xa9 " % i for i in range(63)) + b"the END"
    assert _tier(hay, nd_f, min_bytes=0) == \
        JU.utf8_uncased_find(hay, b"the end")


def test_device_tier_declines_what_it_cannot_do():
    hay = BASE
    assert _tier(hay, np.zeros(0, np.int64), min_bytes=0) is None
    assert _tier(hay, TU._folded_with_spans("é".encode())[0], min_bytes=0) is None
    assert _tier(hay, TU._folded_with_spans(b"beta")[0]) is None


def _unbuilt():
    raise AssertionError("a mirror was made for a search that does not run on the device")


def test_device_tier_declines_before_making_mirrors(monkeypatch):
    """What the tier declines, it declines before its mirrors are made; on a
    CPU device that includes a missing native library or fold tables."""
    nd_f = TU._folded_with_spans(b"beta")[0]
    for dev in (CPU, torch.device("cuda", 0)):
        assert TU._uncased_find_device(BASE, nd_f[:0], dev, _unbuilt, _unbuilt, min_bytes=0) is None
        assert TU._uncased_find_device(BASE, TU._folded_with_spans("é".encode())[0], dev,
                                       _unbuilt, _unbuilt, min_bytes=0) is None
    monkeypatch.setattr(native, "lib", lambda: None)
    assert TU._uncased_find_device(BASE, nd_f, CPU, _unbuilt, _unbuilt, min_bytes=0) is None


@pytest.mark.parametrize("missing", ["native library", "fold tables"])
def test_device_tier_on_a_card_raises_without_its_host_parts(monkeypatch, missing):
    """On a card the tier never hands the search to the host: with no native
    library or no fold tables it raises, before any mirror is made, through
    ``Str.utf8_uncased_find`` as well."""
    from types import SimpleNamespace

    if missing == "native library":
        monkeypatch.setattr(native, "lib", lambda: None)
    else:
        monkeypatch.setattr(TU, "_fold_tables", lambda: None)
    nd_f = TU._folded_with_spans(b"beta")[0]
    with pytest.raises(RuntimeError, match="native host runtime|case-folding tables"):
        TU._uncased_find_device(BASE, nd_f, torch.device("cuda", 0), _unbuilt, _unbuilt,
                                min_bytes=0)
    monkeypatch.setattr(str_api, "default_device_scope",
                        lambda: SimpleNamespace(device=torch.device("cuda", 0)))
    s = tsz.Str(b"beta " * ((1 << 20) // 5 + 1))
    with pytest.raises(RuntimeError, match="native host runtime|case-folding tables"):
        s.utf8_uncased_find(b"BETA")
    assert s._mirror is None and s._folded is None


def test_device_tier_bounds_every_search_by_n():
    """A folded needle may hold U+0000: the mirror's zero tail must not
    complete a match past the end."""
    hay = b"q" * 100 + b"abC"
    nd_f = TU._folded_with_spans(b"abc\x00")[0]
    assert _tier(hay, nd_f, min_bytes=0) == (-1, 0)
    assert JU.utf8_uncased_find(hay, b"abc\x00") == (-1, 0)
    hay = b"q" * 100 + b"abC\x00"
    assert _tier(hay, nd_f, min_bytes=0) == (100, 4)


@pytest.fixture
def counted(monkeypatch):
    """CPU scope for ``Str``; counts the tier's LUT and search calls (the
    plain versions run on the CPU, where the launch counters stay still)."""
    monkeypatch.setattr(str_api, "default_device_scope", lambda: tsz.DeviceScope(device="cpu"))
    calls = {"lut": 0, "search": 0}
    lut, search = memory.lookup_transform, find_kernel.search_positions

    def counting_lut(*a, **k):
        calls["lut"] += 1
        return lut(*a, **k)

    def counting_search(*a, **k):
        calls["search"] += 1
        return search(*a, **k)

    monkeypatch.setattr(memory, "lookup_transform", counting_lut)
    monkeypatch.setattr(find_kernel, "search_positions", counting_search)
    return calls


def _big_text(islands: int):
    """Just over 1 MiB of ASCII words with ``islands`` non-ASCII words
    spread evenly; returns the bytes and each non-ASCII run's (start, end)."""
    rng = np.random.default_rng(185)
    words = [b"alpha", b"BETA", b"Gamma", b"delta", b"epsilon", b"zeta"]
    parts = [words[int(i)] for i in rng.integers(0, len(words), 190000)]
    specials = ["STRAßE".encode(), "École".encode(), b"\xe2\x84\xaaelvin", "naïve".encode()]
    for j, slot in enumerate(np.linspace(1000, 180000, islands).astype(int)):
        parts[slot] = specials[j % len(specials)]
    data = b" ".join(parts)
    arr = np.frombuffer(data, np.uint8)
    hi = np.flatnonzero(arr >= 0x80)
    cut = np.flatnonzero(np.diff(hi) > 1)
    starts, ends = hi[np.concatenate([[0], cut + 1])], hi[np.concatenate([cut, [-1]])] + 1
    return data, [(int(a), int(b)) for a, b in zip(starts, ends)]


def _rounds(data, runs, got):
    """The tier's rounds to reach ``got``: a match that holds a non-ASCII
    byte is found by the patch of the first run it touches; any other
    answer comes one round after the last run that starts before its end
    (for no match, the buffer's end)."""
    off, length = got
    if off >= 0 and max(data[off: off + length]) >= 0x80:
        return sum(end <= off for _, end in runs) + 1
    end = off + length if off >= 0 else len(data)
    return sum(start < end for start, _ in runs) + 1


def test_str_big_buffer_runs_the_tier_with_counted_calls(counted):
    data, runs = _big_text(6)
    assert len(data) >= 1 << 20
    s, j = tsz.Str(data), jsz.Str(data)
    needles = {"strasse": b"STRASSE", "absent": b"nowhere", "early ascii": b"BETA gamma",
               "24 bytes": data[-30:-6].upper()}
    for name, nd in needles.items():
        before = counted["search"]
        got = s.utf8_uncased_find(nd)
        assert got == j.utf8_uncased_find(nd) == JU.utf8_uncased_find(data, nd), name
        # one needle search, kept across rounds, and one byteset search a round
        assert counted["search"] - before == 1 + _rounds(data, runs, got), name
    assert counted["lut"] == 1  # the folded mirror is made once and cached
    assert s._device_folded() is s._device_folded()


def test_str_big_buffer_dense_runs_fall_back(counted):
    data, runs = _big_text(100)
    assert len(runs) == 100
    s = tsz.Str(data)
    got = s.utf8_uncased_find(b"ZETA nowhere")
    assert got == JU.utf8_uncased_find(data, b"ZETA nowhere")
    assert counted["search"] == 1 + 64 and counted["lut"] == 1
