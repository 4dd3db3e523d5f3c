"""The port's ``Str`` / ``File`` / ``Strs`` against the JAX package's on the
CPU, on the same numpy-seeded bytes, with Python's ``bytes`` methods as the
oracle beside both. Below 1 MiB both packages run their host tier. From
1 MiB on, the port's device branch runs on a CPU scope (its kernels' plain
versions); the JAX ``Str`` runs its host tier there, because it takes the
device only outside the Pallas interpreter. Tolerance: exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.models import str_api  # noqa: E402
from stringzilla_tpu_torch.ops import find_kernel, memory, utf8_device  # noqa: E402

BIG = (1 << 20) + 4099  # over the device threshold, not a multiple of 16


def _rng(salt=0):
    """A generator of this file's own: the tests draw the same data in any
    order and leave the session ``rng``, which other files share, as it is."""
    return np.random.default_rng(42 + salt)


@pytest.fixture
def cpu_scope(monkeypatch):
    monkeypatch.setattr(str_api, "default_device_scope",
                        lambda: tsz.DeviceScope(device="cpu"))


@pytest.fixture(scope="module")
def big():
    """BIG random lowercase bytes with needles planted near both ends and
    across the kernel's chunk edges."""
    buf = _rng().integers(97, 123, BIG).astype(np.uint8)
    for at in (0, 65536 - 3, 131072, BIG - 300, BIG - 5):
        buf[at: at + 5] = np.frombuffer(b"XqZwV", np.uint8)
    long = _rng(1).integers(97, 123, 130).astype(np.uint8)
    buf[500000: 500130] = long
    buf[900000: 900130] = long
    return buf.tobytes(), long.tobytes()


def _pair(data):
    return tsz.Str(data), jsz.Str(data)


def _same(fn, t, j):
    got, want = fn(t), fn(j)
    if isinstance(want, (jsz.Str, jsz.Strs)):
        got, want = bytes(got) if isinstance(want, jsz.Str) else got.to_list(), (
            bytes(want) if isinstance(want, jsz.Str) else want.to_list())
    assert got == want
    return got


SMALL_CALLS = [
    lambda s: s.find(b"hello"), lambda s: s.rfind(b"hello"),
    lambda s: s.find(b"hello", 1), lambda s: s.find(b"o", -5), lambda s: s.rfind(b"o", 0, -3),
    lambda s: s.find(b""), lambda s: s.rfind(b""), lambda s: s.find(b"", 30),
    lambda s: s.count(b"l"), lambda s: s.count(b"ll", allowoverlap=True), lambda s: s.count(b""),
    lambda s: s.count_byteset(b"lo"), lambda s: b"world" in s, lambda s: s.contains(b"mars"),
    lambda s: s.find_first_of(b" owd"), lambda s: s.find_last_of(b"lo"),
    lambda s: s.find_first_not_of(b"hel"), lambda s: s.find_last_not_of(b"ld"),
    lambda s: s.split(b","), lambda s: s.split(b",", maxsplit=1),
    lambda s: s.rsplit(b",", maxsplit=1), lambda s: s.split(b",", keepseparator=True),
    lambda s: s.split_byteset(b" ,"), lambda s: s.rsplit_byteset(b" ,", maxsplit=1),
    lambda s: s.splitlines(), lambda s: s.splitlines(keeplinebreaks=True),
    lambda s: [bytes(x) for x in s.split_iter(b",")],
    lambda s: [bytes(x) for x in s.rsplit_iter(b",", keepseparator=True)],
    lambda s: list(s.find_all(b"l", allowoverlap=True)), lambda s: list(s.rfind_all(b"ll")),
    lambda s: s.strip(b"h\n"), lambda s: s.lstrip(), lambda s: s.rstrip(b"\n"),
    lambda s: [bytes(p) for p in s.partition(b", ")], lambda s: [bytes(p) for p in s.rpartition(b"l")],
    lambda s: s.translate(bytes(range(256)).upper()), lambda s: s.hash(), lambda s: s.hash(7),
    lambda s: hash(s), lambda s: s.bytesum(), lambda s: s.utf8_count(), lambda s: s.utf8_valid(),
    lambda s: list(s.utf8_codepoints()), lambda s: s.order(b"hello"), lambda s: len(s),
    lambda s: s[3], lambda s: s[2:9], lambda s: s.startswith(b"hel"), lambda s: s.endswith(b"\n"),
    lambda s: s.decode(), lambda s: str(s), lambda s: s == b"x", lambda s: s < b"z",
]


@pytest.mark.parametrize("call", range(len(SMALL_CALLS)))
def test_small_str_matches_jax(call):
    t, j = _pair("hello world, héllo wörld, hello TPU\nline two,\r\n,end\n")
    _same(SMALL_CALLS[call], t, j)


def test_small_str_needs_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = tsz.Str(b"abc" * 1000)
    assert s.find(b"cab") == 2 and s.count(b"ab", allowoverlap=True) == 1000
    assert s.utf8_count() == 3000 and s.find_first_of(b"c") == 2


BIG_CALLS = {
    "find": lambda s: s.find(b"XqZwV"), "rfind": lambda s: s.rfind(b"XqZwV"),
    "find-1": lambda s: s.find(b"q"), "find-miss": lambda s: s.find(b"XqZwVV"),
    "find-start": lambda s: s.find(b"XqZwV", 1), "find-window": lambda s: s.find(b"XqZwV", 65000, 131077),
    "find-window-short": lambda s: s.find(b"XqZwV", 65000, 131076),
    "find-negative": lambda s: s.find(b"XqZwV", -400), "rfind-negative": lambda s: s.rfind(b"XqZwV", 0, -6),
    "rfind-window": lambda s: s.rfind(b"XqZwV", 10, 131076), "find-past-end": lambda s: s.find(b"a", BIG + 5),
    "find-empty": lambda s: s.find(b"", 77), "find-empty-past": lambda s: s.find(b"", 10, 5),
    "rfind-empty": lambda s: s.rfind(b"", 0, 99), "count-empty": lambda s: s.count(b""),
    "count": lambda s: s.count(b"ab"), "count-overlap": lambda s: s.count(b"ab", allowoverlap=True),
    "count-overlap-16": lambda s: s.count(b"XqZwV" * 3 + b"a", allowoverlap=True),
    "count_byteset": lambda s: s.count_byteset(b"XZ\x00"),
    "first_of": lambda s: s.find_first_of(b"\n\r"), "last_of": lambda s: s.find_last_of(b"XZ"),
    "first_not_of": lambda s: s.find_first_not_of(bytes(range(97, 123))),
    "last_not_of": lambda s: s.find_last_not_of(b"Vwxyz"),
    "contains": lambda s: b"qZw" in s, "index": lambda s: s.rindex(b"XqZ"),
    "partition": lambda s: [len(p) for p in s.partition(b"XqZwV")],
    "translate": lambda s: s.translate(bytes(range(256)).swapcase()),
    "utf8_count": lambda s: s.utf8_count(), "utf8_valid": lambda s: s.utf8_valid(),
    "slice": lambda s: s[7:].find(b"XqZwV"),
}


@pytest.mark.parametrize("name", sorted(BIG_CALLS))
def test_big_str_matches_jax_and_bytes(cpu_scope, big, name):
    data, _ = big
    t, j = _pair(data)
    got = _same(BIG_CALLS[name], t, j)
    if name.split("-")[0] in ("find", "rfind", "count") and "overlap" not in name:
        assert got == BIG_CALLS[name](data)


def test_big_str_long_needles_and_launch_free_cpu(cpu_scope, big):
    data, long = big
    t, j = _pair(data)
    before = (dict(find_kernel.KERNEL_LAUNCHES), dict(utf8_device.KERNEL_LAUNCHES),
              dict(memory.KERNEL_LAUNCHES))
    for needle in (long, long[:17], long[:-1] + b"!"):
        assert t.find(needle) == j.find(needle) == data.find(needle)
        assert t.rfind(needle) == j.rfind(needle) == data.rfind(needle)
        assert t.find(needle, 500001) == j.find(needle, 500001) == data.find(needle, 500001)
        assert t.rfind(needle, 0, 900129) == j.rfind(needle, 0, 900129) == data.rfind(needle, 0, 900129)
        assert t.count(needle, allowoverlap=True) == j.count(needle, allowoverlap=True)
    assert (dict(find_kernel.KERNEL_LAUNCHES), dict(utf8_device.KERNEL_LAUNCHES),
            dict(memory.KERNEL_LAUNCHES)) == before


def test_big_module_byteset_search_goes_through_str(cpu_scope, big):
    data, _ = big
    for charset in (b"XZ", b"\n", bytes(range(97, 123))):
        assert tsz.find_byteset(data, charset) == jsz.find_byteset(data, charset)
        assert tsz.rfind_byteset(data, charset) == jsz.rfind_byteset(data, charset)


def test_big_utf8_invalid_falls_back_to_the_host(cpu_scope):
    text = "".join(_rng(2).choice(list("abж€🎉 "), 600000)).encode()
    assert len(text) >= 1 << 20
    bad = bytearray(text)
    for at in (5, 70000, len(bad) - 2):
        bad[at] = 0xFF
    for data in (text, bytes(bad), text + b"\xE2\x82"):
        t, j = _pair(data)
        assert t.utf8_count() == j.utf8_count() == len(data.decode("utf-8", "replace"))
        assert t.utf8_valid() == j.utf8_valid() == tsz.utf8_valid(t) == (data is text)


def test_mirror_is_cached_padded_and_per_slice(cpu_scope, big):
    data, _ = big
    s = tsz.Str(data)
    m = s._device()
    assert m is s._device() and m.dtype == torch.uint8 and m.dim() == 1
    assert m.numel() % 16 == 0 and m.numel() - len(data) >= 16
    assert not m[len(data):].any() and bytes(m[: len(data)].numpy()) == data
    view = s[16:]
    assert view._device() is not m and view.find(b"XqZwV") == data.find(b"XqZwV", 16) - 16


def test_file_matches_jax(cpu_scope, big, tmp_path):
    data, _ = big
    path = tmp_path / "log.txt"
    path.write_bytes(data)
    t, j = tsz.File(str(path)), jsz.File(str(path))
    for call in (lambda s: s.find(b"XqZwV"), lambda s: s.rfind(b"XqZwV"),
                 lambda s: s.count(b"q", allowoverlap=True), lambda s: s.utf8_count(),
                 lambda s: s.find_first_of(b"XZ"), lambda s: len(s.split(b"XqZwV"))):
        assert call(t) == call(j)
    assert t._mirror is not None
    t.close()
    j.close()
    assert t._mirror is None and len(t) == 0
    empty = tmp_path / "empty.txt"
    empty.write_bytes(b"")
    assert len(tsz.File(str(empty))) == 0


def test_big_find_needs_a_card_or_a_cpu_scope(monkeypatch, big):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = tsz.Str(big[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.find(b"XqZwV")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.utf8_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsz.find_byteset(big[0], b"c")
    assert tsz.find_byteset(b"abc", b"c") == 2  # a small buffer stays on the host


def test_strs_matches_jax():
    rng = _rng(3)
    items = [rng.integers(97, 100, int(m)).astype(np.uint8).tobytes()
             for m in rng.integers(0, 9, 40)]
    t, j = tsz.Strs(items), jsz.Strs(items)
    assert t.to_list() == j.to_list() == items
    assert list(t.lengths) == list(j.lengths)
    assert t[3:17:2].to_list() == j[3:17:2].to_list() and bytes(t[-1]) == bytes(j[-1])
    assert t.sample(7, seed=1).to_list() == j.sample(7, seed=1).to_list()
    assert t.shuffle(seed=2).to_list() == j.shuffled(seed=2).to_list()
    assert t == items and t.to_tape().to_list() == items and t.tape.to_list() == items
    t.append(b"x").extend(["y", b"z"])
    j.append(b"x").extend(["y", b"z"])
    assert t.to_pylist() == j.to_pylist()
    assert tsz.Strs().to_list() == [] and len(tsz.Strs(tsz.Tape.from_strings(items))) == 40
    assert t.offsets_are_large and t.tape_nbytes == j.tape_nbytes
    parts = tsz.Str(b"a b  c").split(b" ")
    assert isinstance(parts, tsz.Strs) and parts.to_list() == [b"a", b"b", b"", b"c"]
    assert isinstance(tsz.Str(b"a,b").split_iter(b","), tsz.FindSplits)
    for cls in ("Utf8Wordbreaks", "Utf8Newlines", "Utf8Whitespaces", "Utf8Delimiters",
                "Utf8SplitNewlines", "Utf8SplitWhitespaces", "Utf8SplitDelimiters"):
        assert issubclass(getattr(tsz, cls), tsz.Strs)


def test_module_functions_match_jax():
    hay = b"one two  three\nfour two"
    for name, args in [("find", (hay, b"two")), ("rfind", (hay, b"two")),
                       ("count", (hay, b"o")), ("count_byteset", (hay, b"o ")),
                       ("utf8_count", ("héllo",)), ("utf8_valid", (b"\xff",)),
                       ("hash", (hay,)), ("sz_hash", (hay, 3)), ("bytesum", (hay,)),
                       ("fill_random", (40, 7)), ("random", (12, 3))]:
        assert getattr(tsz, name)(*args) == getattr(jsz, name)(*args), name
    assert tsz.count(hay, b"o", allowoverlap=True) == jsz.count(hay, b"o", allowoverlap=True)
    assert tsz.translate(hay, bytes(range(256)).upper()) == jsz.translate(hay, bytes(range(256)).upper())
    assert tsz.lookup is tsz.translate
    assert [bytes(p) for p in tsz.split(hay)] == [bytes(p) for p in jsz.split(hay)]
    assert [bytes(p) for p in tsz.split_iter(hay, b"o")] == [bytes(p) for p in jsz.split_iter(hay, b"o")]
    assert tsz.splitlines(hay).to_list() == jsz.splitlines(hay).to_list()
    np.testing.assert_array_equal(tsz.utf8_decode("añ🎉\xff".encode("utf-8", "surrogatepass")),
                                  jsz.utf8_decode("añ🎉\xff".encode("utf-8", "surrogatepass")))
    np.testing.assert_array_equal(tsz.hash_multiseed(hay, [0, 5]), jsz.hash_multiseed(hay, [0, 5]))
    h1, h2 = tsz.Hasher(9), jsz.Hasher(9)
    assert h1.update(hay[:5]).update(hay[5:]).digest() == h2.update(hay).digest()
    assert tsz.find_byteset(hay, b"fh") == jsz.find_byteset(hay, b"fh")
    assert tsz.rfind_byteset(hay, b"fh") == jsz.rfind_byteset(hay, b"fh")


@pytest.mark.parametrize("call,what", [
    (lambda s: jsz.Strs(s.split(b" ")).to_list(), "Arrow export"),  # the JAX Strs imports
    (lambda s: tsz.Strs(jsz.Strs(bytes(s).split(b" "))).to_list(), "Arrow import"),
    (lambda s: s.utf8_fold(), "item 5"), (lambda s: s.utf8_norm(), "item 5"),
    (lambda s: s.utf8_uncased_find(b"a"), "item 5"), (lambda s: s.utf8_wordbreaks(), "item 5"),
    (lambda s: s.utf8_graphemes(), "item 5"), (lambda s: s.utf8_sentences(), "item 5"),
    (lambda s: s.utf8_linebreaks(), "item 5"), (lambda s: s.utf8_whitespaces(), "item 5"),
    (lambda s: s.utf8_newlines(), "item 5"), (lambda s: s.utf8_delimiters(), "item 5"),
    (lambda s: s.utf8_split_whitespaces(), "item 5"), (lambda s: s.utf8_split_newlines(), "item 5"),
    (lambda s: s.utf8_split_delimiters(), "item 5"), (lambda s: s.utf8_uncased_fold(), "item 5"),
    (lambda s: s.utf8_uncased_search(b"a"), "item 5"),
    (lambda s: list(s.utf8_uncased_matches(b"a")), "item 5"),
])
def test_unported_methods_name_their_item(call, what):
    """The methods that waited for the host UTF-8 modules and Arrow (ROADMAP
    queue 1 item 5) now run, and agree with the JAX package's."""
    text = "ABC Stra\u00dfe a\u0301 x.\n".encode()
    if what.startswith("Arrow"):
        assert call(tsz.Str(text)) == text.split(b" ")
        return
    got, want = call(tsz.Str(text)), call(jsz.Str(text))
    norm = lambda x: (bytes(x) if isinstance(x, (tsz.Str, jsz.Str)) else
                      [bytes(v) for v in x] if isinstance(x, (tsz.Strs, jsz.Strs)) else x)
    assert norm(got) == norm(want)
