"""The port's ``LevenshteinDistances`` on a CPU scope against the JAX
package's engine (Pallas interpreter on the CPU) and Wagner-Fischer, on the
same numpy-seeded inputs. Tolerance: exact equality of the uint64 results."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402
import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.models import device_scope  # noqa: E402

from .oracles import levenshtein  # noqa: E402

CPU = tsz.DeviceScope(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _strings(rng, lengths, alphabet=b"abc"):
    return [bytes(rng.choice(list(alphabet), int(n)).astype(np.uint8)) for n in lengths]


def test_engine_matches_jax_across_buckets(rng):
    """Lengths 0-300 span the dyadic buckets 8 to 512, so queries reach
    both kernel tiers (<= 4 words per thread, more per warp on the card)."""
    qs = _strings(rng, [0, 5, 40, 100, 200, 300])
    cs = _strings(rng, [0, 3, 9, 17, 33, 70, 140, 290])
    cs[-1] = qs[-1][:250] + b"x" * 40
    got = tsz.LevenshteinDistances()(qs, cs, device=CPU)
    want = jsz.LevenshteinDistances()(qs, cs)
    assert got.dtype == np.uint64 and got.shape == (6, 8)
    np.testing.assert_array_equal(got, want)
    for i, j in [(0, 7), (3, 4), (5, 7), (4, 0)]:
        assert got[i, j] == levenshtein(qs[i], cs[j])


def test_dyadic_buckets_match_jax(rng):
    from stringzilla_tpu.models import similarities as jsim
    from stringzilla_tpu_torch.models import similarities as tsim

    lengths = np.concatenate([np.arange(0, 300), rng.integers(0, 5000, 200),
                              [4095, 4096, 4097, 2**20 + 1]])
    got, want = tsim._group_dyadic(lengths), jsim._group_dyadic(lengths)
    assert got.keys() == want.keys()
    for b in want:
        np.testing.assert_array_equal(got[b], want[b])


def test_engine_symmetric_call_matches_jax(rng):
    seqs = _strings(rng, rng.integers(0, 70, 7))
    got = tsz.LevenshteinDistances()(seqs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistances()(seqs))
    assert (got == got.T).all() and (np.diag(got) == 0).all()


def test_engine_tape_input_and_out(rng):
    qs = _strings(rng, rng.integers(0, 40, 4))
    cs = _strings(rng, rng.integers(0, 40, 5))
    out = np.full((4, 5), 99, dtype=np.uint64)
    res = tsz.LevenshteinDistances()(tsz.Tape.from_strings(qs),
                                     tsz.Tape.from_strings(cs), device=CPU, out=out)
    assert res is out
    np.testing.assert_array_equal(out, jsz.LevenshteinDistances()(
        jsz.Tape.from_strings(qs), jsz.Tape.from_strings(cs)))
    with pytest.raises(ValueError):
        tsz.LevenshteinDistances()(qs, cs, device=CPU, out=np.zeros((5, 4)))


def test_engine_int_array_input_takes_the_host_collection(rng):
    """Non-uint8 ndarrays are char values, packed on the host and scored on
    the scope's device."""
    qs = [rng.integers(97, 100, int(n)).astype(np.int64) for n in (0, 12, 33)]
    cs = [rng.integers(97, 100, int(n)).astype(np.int32) for n in (4, 20, 0, 70)]
    got = tsz.LevenshteinDistances()(qs, cs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistances()(qs, cs))
    mixed = tsz.LevenshteinDistances()([b"abc", qs[1]], [b"abd"], device=CPU)
    assert mixed[0, 0] == 1


def test_engine_str_input_dtype_and_errors():
    eng = tsz.LevenshteinDistances()
    out = eng(["kitten", "héllo", ""], ["sitting", "hello"], device=CPU)
    assert out.dtype == np.uint64
    assert out.tolist() == [[3, 6], [7, 2], [7, 5]]  # é is two bytes
    assert eng([], ["a"], device=CPU).shape == (0, 1)
    with pytest.raises(TypeError):
        eng([b"ab", 3], device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsz.LevenshteinDistances(mismatch=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsz.LevenshteinDistancesUTF8()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsz.NeedlemanWunsch()
    with pytest.raises(NotImplementedError, match="long-pair"):
        eng([b"a" * 5000], [b"ab"], device=CPU)
    with pytest.raises(ValueError):
        tsz.LevenshteinDistances(open=300)


def test_default_scope_needs_a_card(monkeypatch):
    """The default scope is cuda:0 and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsz.LevenshteinDistances()([b"a"], [b"b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsz.DeviceScope(device_index=0)
    assert CPU.device == torch.device("cpu")
    assert "devices:0" in tsz.__capabilities__()


def test_multi_device_scope_is_not_ported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="parallel/"):
        device_scope.DeviceScope()
    with pytest.raises(NotImplementedError, match="parallel/"):
        device_scope.DeviceScope(cpu_cores=2)
    assert device_scope.DeviceScope(gpu_device=3).device == torch.device("cuda", 3)


def test_port_imports_no_jax():
    code = ("import sys, stringzilla_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
