"""The port's set operations, sort, compare and SHA-256 (``intersect``,
``ops.sort``, ``ops.compare``, ``ops.sha256``, ``Str.sha256``,
``Strs.hashes``/``order``/``sort``/``sorted``) against the JAX package's on
the CPU, on the same numpy-seeded strings, with Python's sets, ``sorted``,
``hashlib`` and ``hmac`` beside both. The port's device paths run their
plain versions on ``device="cpu"`` (or a CPU scope for ``Strs``).
Tolerance: exact equality."""

import hashlib
import hmac

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu.ops import compare as jax_compare  # noqa: E402
from stringzilla_tpu.ops import intersect as jax_intersect  # noqa: E402
from stringzilla_tpu.ops import sha256 as jax_sha256  # noqa: E402
from stringzilla_tpu.ops import sort as jax_sort  # noqa: E402
from stringzilla_tpu_torch.models import str_api  # noqa: E402
from stringzilla_tpu_torch.ops import compare, intersect, sha256, sort  # noqa: E402
from stringzilla_tpu_torch.ops.tape import Tape  # noqa: E402


def _rng(salt=0):
    return np.random.default_rng(42 + salt)


def _words(salt, count, lo=0, hi=12, alphabet=b"abc"):
    """``count`` strings of ``lo``-``hi`` bytes over a small alphabet, so
    prefixes, duplicates and empty strings are common."""
    rng = _rng(salt)
    pool = np.frombuffer(alphabet, np.uint8)
    return [pool[rng.integers(0, len(pool), int(n))].tobytes()
            for n in rng.integers(lo, hi + 1, count)]


@pytest.fixture
def cpu_scope(monkeypatch):
    monkeypatch.setattr(str_api, "default_device_scope", lambda: tsz.DeviceScope(device="cpu"))


def _common(first, second, got):
    """The pairs of ``intersect``'s answer as strings, and the set they must be."""
    a, b = list(first), list(second)
    as_b = lambda x: x.encode() if isinstance(x, str) else bytes(x)  # noqa: E731
    pairs = {as_b(a[i]) for i, j in zip(*got) if as_b(a[i]) == as_b(b[j])}
    assert len(pairs) == len(got[0])
    return pairs, {as_b(x) for x in a} & {as_b(x) for x in b}


INTERSECT_CASES = {
    "duplicates": (_words(1, 200, 0, 3), _words(2, 150, 0, 3)),
    "empty first": ([], [b"a"]),
    "empty second": ([b"a", b"b"], []),
    "no overlap": ([b"x", b"y"], [b"a", b"b"]),
    "str and bytes": (["café", "a", "b", "a"], [b"b", "café".encode(), b"z"]),
    "long strings": (_words(3, 40, 60, 200), _words(3, 40, 60, 200)[::-1] + [b"q" * 100]),
}


@pytest.mark.parametrize("name", sorted(INTERSECT_CASES))
def test_intersect_matches_jax(name):
    first, second = INTERSECT_CASES[name]
    got = tsz.intersect(first, second, seed=3, device="cpu")
    want = jsz.intersect(first, second, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    pairs, oracle = _common(first, second, got)
    assert pairs == oracle


def test_intersect_of_tapes_and_strs():
    first, second = _words(4, 300), _words(5, 300)
    want = jsz.intersect(first, second)
    for a, b in ((Tape.from_strings(first), Tape.from_strings(second)),
                 (tsz.Strs(first), tsz.Strs(second))):
        for g, w in zip(tsz.intersect(a, b, device="cpu"), want):
            np.testing.assert_array_equal(g, w)


def test_intersect_across_the_device_threshold():
    """2^15 distinct strings or more in all hash with ``hash_batch_device``,
    and 2^15 keys a side sort on the device (here the plain versions)."""
    rng = _rng(6)
    pool = [rng.integers(97, 123, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(4, 13, 60000)]
    first = pool[:40000] + pool[:100]
    second = [pool[int(i)] for i in rng.permutation(np.arange(20000, 60000))] + pool[-5:]
    got = tsz.intersect(first, second, seed=7, device="cpu")
    want = jsz.intersect(first, second, seed=7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pairs, oracle = _common(first, second, got)
    assert pairs == oracle


def test_intersect_resolves_forced_collisions(monkeypatch):
    """A constant hasher makes every pair collide: the exact byte check must
    keep only the true matches, in both packages."""
    zeros = lambda items, seed=0, **kw: np.zeros(len(items), np.uint64)  # noqa: E731
    monkeypatch.setattr(jax_intersect, "hash_batch", zeros)
    monkeypatch.setattr(intersect, "hash_batch", zeros)
    monkeypatch.setattr(intersect, "hash_batch_device", zeros)
    first, second = _words(7, 60, 1, 4), _words(8, 50, 1, 4)
    got = tsz.intersect(first, second, device="cpu")
    want = jax_intersect.intersect(first, second)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pairs, oracle = _common(first, second, got)
    assert pairs == oracle and len(pairs) > 3


def test_device_argsort_orders_u64_unsigned():
    keys = np.array([2**64 - 1, 0, 2**63, 2**63 - 1, 5, 2**63, 1], dtype=np.uint64)
    order = intersect._device_argsort_u64(keys, torch.device("cpu"))
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))


SORT_ITEMS = {
    "prefixes and empties": _words(9, 500, 0, 9),
    "mixed case": _words(10, 400, 0, 6, alphabet=b"aAbBzZ_"),
    "high bytes": _words(11, 300, 0, 5, alphabet=bytes([0, 1, 0x7F, 0x80, 0xFF])),
}
SORT_KWARGS = {
    "plain": {}, "reverse": {"reverse": True}, "top 7": {"top_count": 7},
    "top 7 reverse": {"top_count": 7, "reverse": True}, "uncased": {"uncased": True},
}


@pytest.mark.parametrize("items", sorted(SORT_ITEMS))
@pytest.mark.parametrize("kwargs", sorted(SORT_KWARGS))
def test_argsort_strings_matches_jax(items, kwargs):
    data, kw = SORT_ITEMS[items], SORT_KWARGS[kwargs]
    if kw.get("uncased") and items == "high bytes":
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            tsz.argsort_strings(data, **kw)
        return
    got = tsz.argsort_strings(data, **kw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jsz.argsort_strings(data, **kw))
    if not kw:
        assert [data[i] for i in got] == sorted(data)


@pytest.mark.parametrize("reverse", [False, True])
def test_argsort_on_the_device_path(reverse):
    """``prefer_device`` at 2^14 rows or more: dyadic padding with
    0xFFFFFFFF rows, stable passes over packed key columns."""
    data = _words(12, (1 << 14) + 3, 0, 11, alphabet=b"ab\xff")
    got = sort.argsort_strings(data, reverse=reverse, prefer_device=True, device="cpu")
    np.testing.assert_array_equal(got, jax_sort.argsort_strings(data, reverse=reverse,
                                                                prefer_device=True))
    assert [data[i] for i in got] == sorted(data, reverse=reverse)


def test_pack_pgram_keys_matches_jax():
    data = _words(13, 50, 0, 17, alphabet=b"aZ\x00\xff")
    for kw in ({}, {"reverse": True}, {"uncased": True}):
        np.testing.assert_array_equal(sort.pack_pgram_keys(data, **kw),
                                      jax_sort.pack_pgram_keys(data, **kw))


def test_strs_order_sort_sorted_match_jax():
    data = _words(14, 300, 0, 8, alphabet=b"abcAB")
    t, j = tsz.Strs(data), jsz.Strs(data)
    for kw in ({}, {"reverse": True}, {"uncased": True}, {"top_count": 5}):
        np.testing.assert_array_equal(t.order(**kw), j.order(**kw))
    for reverse in (False, True):
        assert t.sort(reverse=reverse).to_list() == j.sort(reverse=reverse).to_list()
        assert t.sorted(reverse=reverse).to_list() == sorted(data, reverse=reverse)
    view = tsz.Str(b"delta alpha charlie bravo alpha").split(b" ")
    assert view.sorted().to_list() == sorted(bytes(view[i]) for i in range(len(view)))


def test_compare_matches_jax():
    rng = _rng(15)
    a = _words(16, 200, 0, 9, alphabet=b"ab\x00")
    b = [s if rng.random() < 0.3 else t for s, t in zip(a, _words(17, 200, 0, 9, b"ab\x00"))]
    np.testing.assert_array_equal(tsz.batch_equal(a, b), jax_compare.batch_equal(a, b))
    np.testing.assert_array_equal(tsz.batch_order(a, b), jax_compare.batch_order(a, b))
    assert tsz.batch_order(a, b).dtype == np.int8
    np.testing.assert_array_equal(tsz.batch_order(a, b),
                                  [(x > y) - (x < y) for x, y in zip(a, b)])
    for x, y in [(b"a", b"b"), ("b", "a"), (b"ab", b"ab"), (b"", b"\x00"), ("é", b"e")]:
        assert tsz.order(x, y) == jsz.order(x, y) == tsz.compare_order(x, y)
        assert tsz.equal(x, y) == jsz.equal(x, y)
    assert tsz.batch_equal([], []).shape == (0,)
    with pytest.raises(ValueError, match="equal length"):
        compare.batch_order([b"a"], [])


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 65, 119, 120, 1000])
def test_sha256_matches_jax_and_hashlib(length):
    data = _rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    want = hashlib.sha256(data).digest()
    assert tsz.sha256(data) == jsz.sha256(data) == want
    h = tsz.Sha256(data[:length // 3])
    assert h.copy().update(data[length // 3:]).hexdigest() == want.hex()
    assert h.reset().digest() == hashlib.sha256(b"").digest()
    key = data[:70] or b"k"
    assert tsz.hmac_sha256(key, data) == jsz.hmac_sha256(key, data) == \
        hmac.new(key, data, "sha256").digest()


def test_sha256_batch_matches_jax_and_hashlib():
    rng = _rng(18)
    items = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in list(range(0, 130)) + [600, 1000]]
    got = sha256.sha256_batch(items, device="cpu")
    assert got.shape == (len(items), 32) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_sha256.sha256_batch(items))
    assert [bytes(d) for d in got] == [hashlib.sha256(s).digest() for s in items]
    picked = sha256.sha256_tape(Tape.from_strings(items), indices=[5, 130], device="cpu")
    np.testing.assert_array_equal(picked, got[[5, 130]])
    assert sha256.sha256_batch([], device="cpu").shape == (0, 32)


def test_str_sha256_and_strs_hashes_match_jax(cpu_scope):
    data = b"".join(_words(19, 2000, 0, 90, alphabet=b"ab \n"))
    assert tsz.Str(data).sha256() == jsz.Str(data).sha256() == hashlib.sha256(data).digest()
    small_t, small_j = tsz.Str(data).split(b"\n"), jsz.Str(data).split(b"\n")
    np.testing.assert_array_equal(small_t.hashes(5), small_j.hashes(5))
    # 2^14 strings or more: the hash kernels' plain versions over the mirror
    big = tsz.Str(data).split(b"a")
    assert len(big) >= str_api._DEVICE_MIN_HASHES
    want = jsz.Str(data).split(b"a").hashes(5)
    np.testing.assert_array_equal(big.hashes(5), want)
    assert big._parent._mirror is not None and big._parent._mirror.device.type == "cpu"
    np.testing.assert_array_equal(big.hashes(5), want)  # mirror reused


PORTED = {
    "Str.sha256": lambda: tsz.Str(b"abc").sha256(),
    "Strs.hashes": lambda: tsz.Strs([b"a"]).hashes(),
    "Strs.order": lambda: tsz.Strs([b"b", b"a"]).order(),
    "Strs.sort": lambda: tsz.Strs([b"b", b"a"]).sort(),
    "Strs.sorted": lambda: tsz.Strs([b"b", b"a"]).sorted(),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_hashing_and_sorting_methods_no_longer_raise(name):
    assert PORTED[name]() is not None


def test_exports_match_jax():
    for name in ("Sha256", "sha256", "hmac_sha256", "intersect", "argsort_strings", "argsort",
                 "equal", "compare_order", "order", "batch_equal", "batch_order"):
        assert name in tsz.__all__ and name in jsz.__all__, name
    assert len(set(tsz.__all__) & set(jsz.__all__)) == 52
    assert tsz.argsort is tsz.argsort_strings and tsz.order is tsz.compare_order
