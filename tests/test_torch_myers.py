"""The port's Myers op (its plain PyTorch version, on the CPU) against the
JAX package's ``myers_pallas`` (Pallas interpreter on the CPU) and the
Wagner-Fischer oracle, on the same numpy-seeded inputs. Tolerance: exact
equality — both compute integer edit distances."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops.myers_pallas import myers_pallas  # noqa: E402
from stringzilla_tpu_torch.ops import myers as myers_mod  # noqa: E402
from stringzilla_tpu_torch.ops.myers import myers  # noqa: E402

from .oracles import levenshtein  # noqa: E402


def _pack(qs, cs, rows, cand_len):
    """numpy blocks in the shared layouts: queries padded with -1."""
    q_t = np.full((rows, len(qs)), -1, dtype=np.int32)
    qlens = np.zeros((len(qs), 1), np.int32)
    for i, s in enumerate(qs):
        q_t[: len(s), i] = np.frombuffer(s, np.uint8)
        qlens[i, 0] = len(s)
    c_t = np.zeros((cand_len, len(cs)), np.int32)
    clens = np.zeros((1, len(cs)), np.int32)
    for j, s in enumerate(cs):
        c_t[: len(s), j] = np.frombuffer(s, np.uint8)
        clens[0, j] = len(s)
    return q_t, qlens, c_t, clens


def _both(qs, cs, rows, cand_len):
    arrays = _pack(qs, cs, rows, cand_len)
    got = myers(*(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.asarray(myers_pallas(*(jnp.asarray(a) for a in arrays)))
    return got, want


def _strings(rng, lengths, lo=97, hi=101):
    return [bytes(rng.integers(lo, hi, int(n)).astype(np.uint8)) for n in lengths]


@pytest.mark.parametrize("rows,cand_len", [(32, 16), (64, 48), (128, 80)])
def test_myers_matches_jax_unrolled_route(rng, rows, cand_len):
    """rows <= 256: the JAX package's unrolled-words kernel."""
    qs = _strings(rng, rng.integers(0, rows + 1, 3))
    cs = _strings(rng, rng.integers(0, cand_len + 1, 128))
    got, want = _both(qs, cs, rows, cand_len)
    np.testing.assert_array_equal(got, want)
    for i, j in zip(rng.integers(0, 3, 24), rng.integers(0, 128, 24)):
        assert got[i, j] == levenshtein(qs[i], cs[j])


@pytest.mark.parametrize("rows", [512, 2048])
def test_myers_matches_jax_stacked_route(rng, rows):
    """rows > 256: the JAX package's stacked-words kernel (the port's
    warp-per-pair tier on the card)."""
    cand_len = 48
    qs = _strings(rng, [rows, rows - 33, rows - 64 - int(rng.integers(0, 17))], 97, 100)
    cs = _strings(rng, rng.integers(0, cand_len + 1, 127), 97, 100)
    cs.append(qs[0][:cand_len])  # near-identical candidate
    got, want = _both(qs, cs, rows, cand_len)
    np.testing.assert_array_equal(got, want)
    for i, j in [(0, 127), (1, 0), (2, 5)]:
        assert got[i, j] == levenshtein(qs[i], cs[j])


def test_myers_word_boundary_lengths(rng):
    """Lengths at 64-bit word edges exercise the cross-word carry and shift;
    empty strings give the other string's length."""
    lengths = [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257]
    qs = _strings(rng, lengths, 97, 99)
    cs = _strings(rng, [0, 1, 31, 32, 33, 47, 48], 97, 99)
    cs += [q[:48] for q in qs[2:]]
    got, want = _both(qs, cs, 288, 48)
    np.testing.assert_array_equal(got, want)
    for i, q in enumerate(qs):
        for j in (0, len(cs) - 1):
            assert got[i, j] == levenshtein(q, cs[j])
    assert (got[0] == [len(c) for c in cs]).all()  # m = 0 -> clen
    assert (got[:, 0] == lengths).all()  # clen = 0 -> m


def test_myers_longest_queries(rng):
    """4095- and 4096-char queries: the 64th word, the port's upper bound."""
    qs = _strings(rng, [4095, 4096], 97, 100)
    cs = _strings(rng, rng.integers(0, 41, 127), 97, 100) + [qs[1][-40:]]
    got, want = _both(qs, cs, 4096, 40)
    np.testing.assert_array_equal(got, want)
    assert got[1, -1] == levenshtein(qs[1], cs[-1]) == 4056


def test_myers_block_mixing_word_edges(rng):
    """One 4,096-row block whose queries sit at the word edges 4/5, 8/9,
    16/17, 32/33 and 63/64 (tier B gives each its own words, in segments of
    8, 16 or 32 lanes): every query against candidates of different
    lengths."""
    lengths = [64 * w + d for w in (4, 8, 16, 32, 63) for d in (0, 1)] + [4096]
    qs = _strings(rng, lengths, 97, 100)
    cs = _strings(rng, rng.integers(0, 49, 60), 97, 100) + [q[-48:] for q in qs[:3]]
    got, want = _both(qs, cs, 4096, 48)
    np.testing.assert_array_equal(got, want)
    for i in range(len(qs)):
        assert got[i, -1 - i % 3] == levenshtein(qs[i], cs[-1 - i % 3])


def test_myers_cpu_tensors_take_the_plain_version(rng):
    """On the CPU the wrapper runs the plain version and counts no launch;
    malformed inputs raise before any work."""
    arrays = [torch.from_numpy(a) for a in
              _pack([b"kitten", b"a"], [b"sitting", b""], 32, 8)]
    before = dict(myers_mod.KERNEL_LAUNCHES)
    assert myers(*arrays).tolist() == [[3, 6], [7, 1]]
    assert myers_mod.KERNEL_LAUNCHES == before
    q_t, qlens, c_t, clens = arrays
    with pytest.raises(TypeError):
        myers(q_t.long(), qlens, c_t, clens)
    with pytest.raises(ValueError):
        myers(q_t[:31], qlens, c_t, clens)  # rows not a multiple of 32
    with pytest.raises(ValueError):
        myers(q_t, qlens.view(1, -1), c_t, clens)
    with pytest.raises(ValueError):
        myers(q_t, qlens, c_t.T.contiguous().T, clens)  # non-contiguous
