"""Work split over a ``DeviceScope``'s devices (``stringzilla_tpu_torch/
parallel/cross.py`` and ``Fingerprints``' split route) on
CPU scopes that list the CPU 1, 3 or 8 times (``DeviceScope(devices=
["cpu"] * k)``: an even and an uneven split), held against the port's
one-device results, the JAX package's one-device engines, ``tests/
oracles.py``, and the JAX ``sharded_find``/``rfind``/``count`` and
``sharded_argsort`` on the conftest's 8-device CPU mesh, on the same
numpy-seeded inputs; and ``DeviceScope``'s arguments. The engines' split
route is held in ``test_torch_parallel_engines.py``. Tolerance: exact
equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import stringzilla_tpu as jsz  # noqa: E402
from stringzilla_tpu.ops.hash import hash_batch as jax_hash_batch  # noqa: E402
from stringzilla_tpu.parallel import cross as jcross  # noqa: E402

import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.models import device_scope  # noqa: E402
from stringzilla_tpu_torch.ops.hash_kernel import hash_tokens_raw  # noqa: E402
from stringzilla_tpu_torch.ops.myers import myers  # noqa: E402
from stringzilla_tpu_torch.ops.similarity_dp import similarity  # noqa: E402
from stringzilla_tpu_torch.ops.sort import _device_argsort  # noqa: E402
from stringzilla_tpu_torch.parallel import cross  # noqa: E402
from stringzilla_tpu_torch.utils import platform  # noqa: E402

CPU = tsz.DeviceScope(device="cpu")
SPLITS = [1, 3, 8]


def _scope(k: int):
    return tsz.DeviceScope(devices=["cpu"] * k)


def _strings(rng, lengths, alphabet=b"acgt"):
    return [bytes(rng.choice(list(alphabet), int(n)).astype(np.uint8)) for n in lengths]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()), axis_names=("data",))


# -- DeviceScope ------------------------------------------------------------------


def test_scope_spans_every_card(monkeypatch):
    """``DeviceScope()`` spans every visible card, as the JAX scope spans
    ``jax.devices()``; ``cpu_cores`` the first of them; an index one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    every = tsz.DeviceScope()
    assert every.devices == tuple(cards) and every.device == cards[0]
    assert every.device_count == 4 and not every.is_single_device
    for cores, want in ((2, 2), (9, 4), (0, 4), (None, 4)):
        assert tsz.DeviceScope(cpu_cores=cores).devices == tuple(cards[:want])
    assert tsz.DeviceScope(device_index=2).devices == (cards[2],)
    assert tsz.DeviceScope(gpu_device=3).device == cards[3]
    assert tsz.DeviceScope(gpu_device=3).is_single_device
    assert tsz.DeviceScope(device="cuda").device == cards[0]
    assert tsz.DeviceScope(devices=["cuda:1", "cuda:1"]).devices == (cards[1], cards[1])
    with pytest.raises(ValueError, match="does not exist"):
        tsz.DeviceScope(device_index=4)
    with pytest.raises(ValueError, match="one type"):
        tsz.DeviceScope(devices=["cpu", "cuda:0"])
    # the JAX scope over the conftest's 8 CPU devices counts alike
    assert jsz.DeviceScope(cpu_cores=3).device_count == 3
    assert jsz.DeviceScope().device_count == 8
    assert jsz.DeviceScope(device_index=2).is_single_device


def test_scope_of_listed_devices():
    """``devices=`` may repeat one device: the port's counterpart of the
    JAX tests' virtual 8-device CPU mesh."""
    scope = tsz.DeviceScope(devices=["cpu"] * 8)
    assert scope.device_count == 8 and not scope.is_single_device
    assert scope.device == torch.device("cpu")
    assert scope.devices == (torch.device("cpu"),) * 8
    assert "scope-devices:8" in scope.get_capabilities()
    one = tsz.DeviceScope(devices=[torch.device("cpu")])
    assert one.is_single_device and one.device_count == CPU.device_count == 1
    with pytest.raises(ValueError, match="at least one"):
        tsz.DeviceScope(devices=[])


def test_cuda_scope_needs_a_card(monkeypatch):
    """Without a card every CUDA scope raises ``RuntimeError``; nothing
    falls back to the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"cpu_cores": 2}, {"device_index": 0}, {"gpu_device": 1},
                   {"device": "cuda"}, {"devices": ["cuda:0", "cuda:0"]}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsz.DeviceScope(**kwargs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_scope.default_device_scope()
    platform.force_backend(cpu=True)
    try:
        assert device_scope.default_device_scope().devices == (torch.device("cpu"),)
    finally:
        platform.force_backend(cpu=False)


def test_split_bounds():
    for n in range(0, 20):
        for parts in range(1, 10):
            cuts = cross.split_bounds(n, parts)
            sizes = np.diff(cuts)
            assert cuts[0] == 0 and cuts[-1] == n and len(sizes) == parts
            assert sizes.max() - sizes.min() <= 1 and (np.diff(sizes) <= 0).all()
            assert [len(p) for p in np.array_split(np.arange(n), parts)] == sizes.tolist()


# -- Fingerprints -----------------------------------------------------------------


@pytest.fixture(scope="module")
def fingerprint_case():
    rng = np.random.default_rng(3)
    docs = [bytes(rng.integers(32, 127, int(n)).astype(np.uint8))
            for n in rng.integers(0, 120, 11)]
    engine = tsz.Fingerprints(ndim=32, window_widths=(3, 5), seed=9)
    want_jax = jsz.Fingerprints(ndim=32, window_widths=(3, 5), seed=9)(docs)
    return engine, docs, engine(docs, device=CPU), want_jax


@pytest.mark.parametrize("k", SPLITS + [20])
def test_split_fingerprints(fingerprint_case, k):
    engine, docs, (h, c), (jh, jc) = fingerprint_case
    gh, gc = engine(docs, device=_scope(k))
    for got, want in ((gh, h), (gc, c), (gh, np.asarray(jh)), (gc, np.asarray(jc))):
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    dh, dc = engine(docs, device=_scope(k), device_out=True)
    assert dh.device == torch.device("cpu") and dh.dtype == torch.int32
    np.testing.assert_array_equal(dh.numpy().view(np.uint32), h)
    np.testing.assert_array_equal(dc.numpy().view(np.uint32), c)


def test_split_fingerprints_edges(fingerprint_case):
    engine, docs, (h, _), _ = fingerprint_case
    eh, ec = engine([], device=_scope(3))
    assert eh.shape == ec.shape == (0, 32)
    out = (np.zeros((2, 32), np.uint32), np.zeros((2, 32), np.uint32))
    got = engine(docs[:2], device=_scope(8), out=out)
    assert got[0] is out[0]
    np.testing.assert_array_equal(out[0], h[:2])
    tape = tsz.Tape.from_strings(docs)
    np.testing.assert_array_equal(engine(tape, device=_scope(3))[0], h)


# -- cross.py directly ------------------------------------------------------------


def _myers_block(rng, nq, nc):
    rows, cand_len = 32, 20
    q_t = np.full((rows, nq), -1, np.int32)
    qlens = rng.integers(0, rows + 1, nq).astype(np.int32)
    for i, n in enumerate(qlens):
        q_t[:n, i] = rng.integers(0, 4, n)
    c_t = np.zeros((cand_len, nc), np.int32)
    clens = rng.integers(0, cand_len + 1, nc).astype(np.int32)
    for j, n in enumerate(clens):
        c_t[:n, j] = rng.integers(0, 4, n)
    return (torch.from_numpy(q_t), torch.from_numpy(qlens).view(-1, 1),
            torch.from_numpy(c_t), torch.from_numpy(clens).view(1, -1))


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("nc", [0, 2, 37])
def test_sharded_myers_and_similarity(k, nc):
    """Candidate columns cut into ``k`` parts (fewer columns than devices
    too), against the one-device kernels' plain versions."""
    rng = np.random.default_rng(nc + k)
    q_t, qlens, c_t, clens = _myers_block(rng, 6, nc)
    got = cross.sharded_myers(q_t, qlens, c_t, clens, _scope(k))
    assert got.shape == (6, nc) and got.dtype == torch.int32
    assert torch.equal(got, myers(q_t, qlens, c_t, clens))
    cfg = tsz.SmithWatermanScores(np.arange(256) % 4, np.eye(32, dtype=np.int32) * 3 - 1,
                                  open=-2, extend=-1).config
    table = torch.from_numpy(cfg.costs.table_np())
    q_ext = torch.zeros((40, 6), dtype=torch.int32)  # the +1-shifted layout, padding 0
    q_ext[1:33] = q_t.clamp(min=0)
    want = similarity(q_ext, qlens, c_t, clens, cfg, table)
    assert torch.equal(cross.sharded_similarity(q_ext, qlens, c_t, clens, cfg, _scope(k),
                                                table=table), want)


def _count(hay: bytes, needle: bytes) -> int:
    k = len(needle)
    return sum(hay[p:p + k] == needle for p in range(len(hay) - k + 1))


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_sharded_search_halo(data):
    """Haystacks of 0-300 bytes, needles of 1-12, 1-8 shards, a needle
    planted across each shard's end (the halo's case), as bytes and as a
    tensor: first, last and overlapping count equal Python's."""
    n = data.draw(st.integers(0, 300), "n")
    k = data.draw(st.integers(1, 12), "k")
    ndev = data.draw(st.integers(1, 8), "ndev")
    seed = data.draw(st.integers(0, 2**32 - 1), "seed")
    rng = np.random.default_rng(seed)
    hay = bytearray(rng.integers(97, 99, n).astype(np.uint8).tobytes())
    needle = bytes(rng.integers(97, 100, k).astype(np.uint8))
    shard = -(-n // ndev) if n else 1
    for edge in range(shard, n, shard):
        at = edge - int(rng.integers(1, k)) if k > 1 else edge - 1
        if 0 <= at and at + k <= n:
            hay[at: at + k] = needle
    hay = bytes(hay)
    scope = _scope(ndev)
    for h in (hay, torch.from_numpy(np.frombuffer(hay, np.uint8).copy())):
        assert cross.sharded_find(h, needle, scope) == hay.find(needle)
        assert cross.sharded_rfind(h, needle, scope) == hay.rfind(needle)
        assert cross.sharded_count(h, needle, scope) == _count(hay, needle)


SEARCH_CASES = [  # (haystack, needle)
    (b"abracadabra" * 7, b"abra"),
    (b"ab" * 10 + b"needle", b"needle"),  # a needle longer than a shard
    (b"abcab", b"ab"),  # a haystack shorter than the devices
    (b"abc", b"abcd"),  # n < k
    (b"xyzxyz", b""),  # the empty needle
]


@pytest.mark.parametrize("hay,needle", SEARCH_CASES)
def test_sharded_search_matches_jax(mesh, hay, needle):
    """The JAX sharded search on the 8-device mesh and the port's
    ``sharded_find``/``rfind``/``count`` on 1, 3 and 8 CPU devices, the
    empty-needle and ``n < k`` answers included. The JAX functions share
    one helper, ``_sharded_match_stats``, which compiles anew on every
    call: it runs once a case here, and its answers are read as
    ``sharded_find``/``rfind``/``count`` read them."""
    stats, n, k = jcross._sharded_match_stats(hay, needle, mesh)
    if k == 0:
        want = (0, n, n + 1)
    elif stats is None:
        want = (-1, -1, 0)
    else:
        want = tuple(int(v) for v in stats)
    assert want == (hay.find(needle), hay.rfind(needle),
                    _count(hay, needle) if needle else len(hay) + 1)
    if stats is None:  # nothing compiles: the public functions answer at once
        assert (jcross.sharded_find(hay, needle, mesh), jcross.sharded_rfind(hay, needle, mesh),
                jcross.sharded_count(hay, needle, mesh)) == want
    for k in SPLITS:
        got = (cross.sharded_find(hay, needle, _scope(k)),
               cross.sharded_rfind(hay, needle, _scope(k)),
               cross.sharded_count(hay, needle, _scope(k)))
        assert got == want


@pytest.fixture(scope="module")
def tokens():
    """Tokens over one blob, spans out of order and overlapping, of 0 to
    over ``WIDE_BYTES`` bytes (every hash route)."""
    rng = np.random.default_rng(17)
    blob = rng.integers(0, 256, 20000, dtype=np.uint8)
    lengths = np.concatenate([rng.integers(0, 80, 40), [0, 64, 65, 300, 16384, 16500]])
    starts = np.array([int(rng.integers(0, 20000 - n + 1)) for n in lengths], np.int64)
    return blob, starts, lengths.astype(np.int64)


@pytest.mark.parametrize("k", SPLITS)
def test_sharded_hashes(tokens, k):
    blob, starts, lengths = tokens
    one = hash_tokens_raw(torch.from_numpy(blob), torch.from_numpy(starts),
                          torch.from_numpy(lengths), 5)
    host = jax_hash_batch([blob[s: s + n].tobytes() for s, n in zip(starts, lengths)], seed=5)
    for b in (blob, torch.from_numpy(blob)):
        got = cross.sharded_hashes(b, starts, lengths, 5, _scope(k))
        assert got.dtype == torch.int64 and torch.equal(got, one)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), host)
    few = cross.sharded_hashes(blob, starts[:2], lengths[:2], 5, _scope(k))
    assert torch.equal(few, one[:2])
    assert cross.sharded_hashes(blob, starts[:0], lengths[:0], 5, _scope(k)).shape == (0,)


def _lexsort(keys):
    return np.lexsort(tuple(keys[:, c] for c in reversed(range(keys.shape[1]))))


@pytest.mark.parametrize("k", SPLITS)
def test_sharded_argsort_matches_jax(mesh, k):
    """Duplicate keys across every shard edge: the JAX ``sharded_argsort``
    on the 8-device mesh, ``np.lexsort`` and the port's one-device passes."""
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 3, (96, 3)).astype(np.uint32)
    keys[:, 2] = rng.choice([0, 0xFFFFFFFF, 0x80000000], 96)
    want = np.asarray(jcross.sharded_argsort(keys, mesh))
    np.testing.assert_array_equal(want, _lexsort(keys))
    got = cross.sharded_argsort(keys, _scope(k))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _device_argsort(keys, torch.device("cpu")))
    first = np.asarray(jcross.sharded_argsort(keys, mesh, num_keys=1))
    np.testing.assert_array_equal(cross.sharded_argsort(keys, _scope(k), num_keys=1).numpy(),
                                  first)


@pytest.mark.parametrize("k", SPLITS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint64, np.int8, np.uint16, np.bool_])
def test_sharded_argsort_dtypes(k, dtype):
    rng = np.random.default_rng(len(str(dtype)))
    keys = rng.integers(-4, 4, (61, 2))
    if dtype == np.uint64:
        keys = keys.astype(np.uint64) * np.uint64(1 << 61)
    keys = keys.astype(dtype)
    np.testing.assert_array_equal(cross.sharded_argsort(keys, _scope(k)).numpy(), _lexsort(keys))
    tiny = keys[:2]
    np.testing.assert_array_equal(cross.sharded_argsort(tiny, _scope(k)).numpy(), _lexsort(tiny))
    assert cross.sharded_argsort(keys[:0], _scope(k)).shape == (0,)
