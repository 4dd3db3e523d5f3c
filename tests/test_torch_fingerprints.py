"""The port's ``Fingerprints`` (plain PyTorch MinHash on a CPU scope) against
the JAX package's (its Pallas kernel in the interpreter), its parameters and
``band_keys``, the reference's golden vectors and the exact numpy oracle, on
the same numpy-seeded documents. Tolerance: exact equality of the uint32
hashes and counts."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
from stringzilla_tpu.ops import fingerprints as jfp  # noqa: E402

import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.ops import fingerprints as tfp  # noqa: E402
from stringzilla_tpu_torch.ops.fingerprints_kernel import (  # noqa: E402
    fingerprint_all, fingerprint_reference)

CPU = tsz.DeviceScope(device="cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fingerprint_vectors.json")


def _rng(seed=42):
    """A generator of this file's own: the tests draw the same data in any
    order and leave the session ``rng``, which other files share, as it is."""
    return np.random.default_rng(seed)


def _docs(rng, lengths, lo=0, hi=256):
    return [rng.integers(lo, hi, int(n), dtype=np.uint8).tobytes() for n in lengths]


def _tensors(docs, params):
    """``fingerprint_all``'s CPU inputs for ``docs``."""
    blob = np.frombuffer(b"".join(docs) + b"\0", np.uint8).copy()
    lens = np.array([len(d) for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return (torch.from_numpy(blob), torch.from_numpy(starts), torch.from_numpy(lens),
            {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})


@pytest.mark.parametrize("ndim,widths,seed", [
    (512, None, 0), (128, (4, 8), 1), (100, (1, 3, 31), 5), (10, None, 42),
    (64, (3, 5, 8, 16), 7), (192, (2, 7, 40), 123456789)])
def test_derive_params_matches_jax(ndim, widths, seed):
    got, want = tfp.derive_params(ndim, widths, seed), jfp.derive_params(ndim, widths, seed)
    assert got.keys() == want.keys() == set(tfp.PARAM_KEYS)
    for key in want:
        assert got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ws = widths or tfp.DEFAULT_WINDOW_WIDTHS
    np.testing.assert_array_equal(tfp.dim_window_widths(ndim, ws),
                                  jfp.dim_window_widths(ndim, ws))


def test_params_from_carries_the_jax_parameters():
    engine = jsz.Fingerprints(100, (1, 3, 31), seed=5)
    got = tfp.params_from(engine)
    for key in tfp.PARAM_KEYS:
        assert got[key].dtype == torch.int64
        np.testing.assert_array_equal(got[key].numpy(), engine._params[key])
    sliced = jfp.derive_params(128, (4, 8), 9)
    got = tfp.params_from(sliced, seed=9)
    np.testing.assert_array_equal(got["fused_disc"].numpy(), sliced["fused_disc"])
    with pytest.raises(ValueError, match="seed"):
        tfp.params_from(sliced)
    with pytest.raises(ValueError, match="differ"):
        tfp.params_from(sliced, seed=8)
    tampered = dict(sliced, mult=sliced["mult"] + 1)
    with pytest.raises(ValueError, match="mult"):
        tfp.params_from(tampered, seed=9)


@pytest.mark.parametrize("ndim,widths", [(16, (3, 5, 8, 16)), (64, None), (100, (1, 3, 31))])
def test_engine_matches_jax(ndim, widths):
    """Empty documents, documents shorter than every window and 129-256
    bytes (two of the JAX engine's buckets); exact equality, and the numpy
    oracle on a few."""
    rng = _rng()
    docs = _docs(rng, [0, 1, 2, 3, 4, 6, 7, 8]) + _docs(rng, rng.integers(129, 257, 40))
    docs[9] = b"ab" * 100  # a periodic doc: ties of the minimum
    got_h, got_c = tsz.Fingerprints(ndim, widths, seed=3)(docs, device=CPU)
    engine = jsz.Fingerprints(ndim, widths, seed=3)
    want_h, want_c = engine(docs)
    assert got_h.dtype == got_c.dtype == np.uint32
    assert got_h.shape == got_c.shape == (len(docs), ndim)
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_array_equal(got_c, want_c)
    assert (got_c[9] > 1).any() and (got_h[0] == 0xFFFFFFFF).all() and (got_c[0] == 0).all()
    for i in (1, 5, 9, 20):
        oh, oc = tfp.fingerprint_oracle(docs[i], engine._params)
        np.testing.assert_array_equal(got_h[i], oh)
        np.testing.assert_array_equal(got_c[i], oc)


def test_ndarray_items_are_their_raw_bytes():
    """A 1-D ndarray item of any dtype is hashed as its raw bytes, as the
    JAX engine's ``bytes(item)`` takes it (129-256 bytes: one JAX bucket)."""
    rng = _rng(7)
    docs = [rng.integers(0, 2**31, 40).astype(np.int32),
            rng.integers(0, 2**16, 100).astype(np.uint16),
            rng.integers(0, 256, 200, dtype=np.uint8).tobytes()]
    got_h, got_c = tsz.Fingerprints(64, seed=3)(docs, device=CPU)
    want_h, want_c = jsz.Fingerprints(64, seed=3)(docs)
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_array_equal(got_c, want_c)
    raw_h, raw_c = tsz.Fingerprints(64, seed=3)([d.tobytes() for d in docs[:2]], device=CPU)
    np.testing.assert_array_equal(got_h[:2], raw_h)
    np.testing.assert_array_equal(got_c[:2], raw_c)


def _golden_groups():
    groups = {}
    for case in json.load(open(GOLDEN)):
        groups.setdefault((case["seed"], case["nwidths"]), []).append(case)
    return sorted(groups.items())


@pytest.mark.parametrize("key,cases", _golden_groups(),
                         ids=[f"seed{s}-widths{n}" for (s, n), _ in _golden_groups()])
def test_golden_vectors(key, cases):
    """Every vector of the reference's compiled serial engine, one engine
    call per (seed, widths) over all its documents."""
    seed, nw = key
    engine = tsz.Fingerprints(64 * nw, tfp.DEFAULT_WINDOW_WIDTHS[:nw], seed=seed)
    h, c = engine([bytes(case["doc"]) for case in cases], device=CPU)
    for i, case in enumerate(cases):
        assert h[i].tolist() == case["hashes"], (seed, nw, len(case["doc"]))
        assert c[i].tolist() == case["counts"], (seed, nw, len(case["doc"]))


@pytest.mark.parametrize("widths", [(1,), (1, 2, 3), (5, 40), (2000, 3)])
def test_fingerprint_reference_matches_oracle(widths):
    """Widths of 1, wider than some documents and wider than the kernel's
    shared-memory halo; a document longer than its 4096-byte chunk."""
    rng = _rng(7)
    params = tfp.derive_params(2 * len(widths) + 1, widths, seed=11)
    docs = _docs(rng, [0, 1, 3, 39, 40, 41, 300, 2001]) + _docs(rng, [5000], 97, 100)
    h, c = fingerprint_reference(*_tensors(docs, params))
    assert h.dtype == c.dtype == torch.int32
    for i, doc in enumerate(docs):
        oh, oc = tfp.fingerprint_oracle(doc, params)
        np.testing.assert_array_equal(h[i].numpy().view(np.uint32), oh, err_msg=f"doc {i}")
        np.testing.assert_array_equal(c[i].numpy().view(np.uint32), oc, err_msg=f"doc {i}")


def test_fingerprint_all_takes_the_plain_version_on_the_cpu():
    params = tfp.derive_params(24, (3, 9), seed=2)
    args = _tensors(_docs(_rng(), [0, 10, 100]), params)
    got, want = fingerprint_all(*args), fingerprint_reference(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        fingerprint_all(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):
        fingerprint_all(args[0], args[1][:2], *args[2:])


@pytest.mark.parametrize("bands", [4, 16, 32])
def test_band_keys_match_jax(bands):
    """On numpy input and on the engine's ``device_out`` tensors."""
    docs = [bytes(_rng(bands).integers(97, 123, 60 + 7 * i).astype(np.uint8))
            for i in range(23)]
    docs.append(docs[0])  # a duplicate shares every band key
    h_dev, c_dev = tsz.Fingerprints(128)(docs, device=CPU, device_out=True)
    h_host, _ = tsz.Fingerprints(128)(docs, device=CPU)
    want = np.asarray(jfp.band_keys(h_host, bands=bands))
    got_np = tfp.band_keys(h_host, bands=bands)
    got_dev = tfp.band_keys(h_dev, bands=bands)
    assert got_np.dtype == np.uint32 and got_dev.dtype == torch.int32
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_dev.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want[0], want[-1])
    extremes = np.array([[0, 0xFFFFFFFF, 0x80000000, 1] * 8], np.uint32)
    np.testing.assert_array_equal(tfp.band_keys(extremes, 4),
                                  np.asarray(jfp.band_keys(extremes, bands=4)))
    with pytest.raises(ValueError, match="bands"):
        tfp.band_keys(h_host, bands=7)


def test_engine_out_tape_device_out_and_errors():
    docs = _docs(_rng(), [0, 5, 50, 150])
    engine = tsz.Fingerprints(40, (2, 5), seed=4)
    h, c = engine(docs, device=CPU)
    out = (np.zeros((4, 40), np.uint32), np.zeros((4, 40), np.uint32))
    res = engine(tsz.Tape.from_strings(docs), device=CPU, out=out)
    assert res[0] is out[0] and res[1] is out[1]
    np.testing.assert_array_equal(out[0], h)
    np.testing.assert_array_equal(out[1], c)
    dh, dc = engine(docs, device=CPU, device_out=True)
    assert dh.dtype == dc.dtype == torch.int32 and dh.device.type == "cpu"
    np.testing.assert_array_equal(dh.numpy().view(np.uint32), h)
    np.testing.assert_array_equal(dc[torch.tensor([3, 1])].numpy().view(np.uint32), c[[3, 1]])
    np.testing.assert_array_equal(engine(["héllo wörld"], device=CPU)[0],
                                  engine(["héllo wörld".encode()], device=CPU)[0])
    empty_h, empty_c = engine([], device=CPU)
    assert empty_h.shape == empty_c.shape == (0, 40)
    with pytest.raises(ValueError):
        tsz.Fingerprints(0)
    with pytest.raises(ValueError):
        tsz.Fingerprints(8, (3, 0))
    with pytest.raises(TypeError):
        engine([b"ab", 3], device=CPU)
    # a scope over several devices splits the documents, with the same bits
    split = engine(docs, device=tsz.DeviceScope(devices=["cpu"] * 3))
    np.testing.assert_array_equal(split[0], h)
    np.testing.assert_array_equal(split[1], c)


@pytest.mark.parametrize("window", [1, 4, 31])
def test_baseline_hashers_match_jax(window):
    doc = bytes(_rng(window).integers(0, 256, 120, dtype=np.uint8))
    for name in ("multiplying_rolling_hash", "rabin_karp_rolling_hash", "buz_rolling_hash"):
        np.testing.assert_array_equal(getattr(tfp, name)(doc, window),
                                      getattr(jfp, name)(doc, window), err_msg=name)
    assert len(tfp.rabin_karp_rolling_hash(doc[:window - 1], window)) == 0
