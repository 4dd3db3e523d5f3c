"""The MinHash kernel's plan and its split-and-merge, on the CPU.

``ops.fingerprints_kernel.minhash_plan`` cuts documents longer than a unit
into byte ranges of window ends and hands the pieces to CTAs; the kernel
rolls each range from ``w - 1`` bytes before it and a merge combines the
ranges of a cut document. Here the plain versions of the two kernels
(``minhash_ranges`` and ``minhash_merge`` on CPU tensors:
``fingerprint_reference``'s roll on each piece with its warm-up, then the
merge) run every cut and are held against ``fingerprint_reference`` and the
JAX package's ``Fingerprints`` engine (its Pallas kernel in the
interpreter), and the plan is held to its guarantees: every window of every
document in exactly one piece, every CTA within its stated share, the same
plan for the same input. Also the argument that makes the kernel's f64 step
exact without a correction: the quotient from 1/m rounded up. Tolerance:
exact equality."""

from fractions import Fraction

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import stringzilla_tpu as jsz  # noqa: E402

from stringzilla_tpu_torch.ops import fingerprints as tfp  # noqa: E402
from stringzilla_tpu_torch.ops import fingerprints_kernel as fk  # noqa: E402

WIDTHS = {"w1": (1,), "w3-31": (3, 31), "default": tfp.DEFAULT_WINDOW_WIDTHS}
NDIM = 64
SEED = 3


def _units(widths):
    """The unit sizes each widths case is cut at: 1, w - 1, w, w + 1 of the
    widest window, and one drawn from a seed."""
    top = max(widths)
    drawn = int(np.random.default_rng(top).integers(2, 3 * top + 3))
    return sorted({1, max(top - 1, 1), top, top + 1, drawn})


def _docs(widths):
    """Documents of length 0, 1, w - 1 and w for every width, unit ± 1 for
    every unit, longer ones cut into several ranges, and ``b"ab" * n``
    (every window of a width ties with the minimum of its phase, so the
    counts add up across range edges); at most 64 bytes, four of the JAX
    engine's length buckets."""
    rng = np.random.default_rng(len(widths))
    lens = {0, 1}
    for w in widths:
        lens |= {w - 1, w}
    for u in _units(widths):
        lens |= {u - 1, u + 1}
    lens = sorted(n for n in lens if 0 <= n <= 64) + [45, 64]
    docs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    return docs + [b"ab" * 16, b"ab" * 31 + b"a"]


def _tensors(docs):
    blob = np.frombuffer(b"".join(docs) + b"\0", np.uint8).copy()
    lens = np.array([len(d) for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return torch.from_numpy(blob), starts, lens


def _params(widths, ndim=NDIM, seed=SEED):
    return {k: torch.from_numpy(v) for k, v in tfp.derive_params(ndim, widths, seed).items()}


def _split_and_merge(docs, params, unit):
    """The model: the plan's cut at ``unit``, each piece rolled by the
    plain range version, the cut documents merged by the plain merge."""
    blob, starts, lens = _tensors(docs)
    pa = fk.plan_arrays(fk.minhash_plan(lens, unit), starts, "cpu")
    hashes, counts, part_min, part_count = fk.minhash_ranges(blob, pa, params)
    return fk.minhash_merge(pa, part_min, part_count, hashes, counts)


@pytest.fixture(scope="module")
def expected():
    """Per widths case: its documents, ``fingerprint_reference`` on them,
    and the JAX engine's result (one call each: the result does not depend
    on the unit)."""
    out = {}
    for name, widths in WIDTHS.items():
        docs = _docs(widths)
        blob, starts, lens = _tensors(docs)
        ref = fk.fingerprint_reference(blob, torch.from_numpy(starts), torch.from_numpy(lens),
                                       _params(widths))
        out[name] = (docs, ref, jsz.Fingerprints(NDIM, widths, seed=SEED)(docs))
    return out


@pytest.mark.parametrize("name,unit", [(n, u) for n, ws in WIDTHS.items() for u in _units(ws)])
def test_split_and_merge_matches_reference_and_jax(expected, name, unit):
    docs, (ref_h, ref_c), (jax_h, jax_c) = expected[name]
    h, c = _split_and_merge(docs, _params(WIDTHS[name]), unit)
    assert torch.equal(h, ref_h) and torch.equal(c, ref_c)
    np.testing.assert_array_equal(h.numpy().view(np.uint32), jax_h)
    np.testing.assert_array_equal(c.numpy().view(np.uint32), jax_c)
    ab = len(docs) - 2
    assert (c[ab] > 1).any()  # the b"ab" ties were counted across the cut


def test_reference_agrees_with_jax_and_the_oracle(expected):
    for name, (docs, (ref_h, ref_c), (jax_h, jax_c)) in expected.items():
        np.testing.assert_array_equal(ref_h.numpy().view(np.uint32), jax_h, err_msg=name)
        np.testing.assert_array_equal(ref_c.numpy().view(np.uint32), jax_c, err_msg=name)
        params = tfp.derive_params(NDIM, WIDTHS[name], SEED)
        for i in (1, len(docs) - 1):
            oh, oc = tfp.fingerprint_oracle(docs[i], params)
            np.testing.assert_array_equal(jax_h[i], oh)
            np.testing.assert_array_equal(jax_c[i], oc)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(lengths=st.lists(st.integers(0, 80), min_size=1, max_size=8),
       unit=st.integers(1, 90), widths=st.sampled_from(sorted(WIDTHS)),
       seed=st.integers(0, 2**32 - 1))
def test_split_and_merge_property(lengths, unit, widths, seed):
    rng = np.random.default_rng(seed)
    # a small alphabet, so that windows tie across range edges
    docs = [rng.integers(97, 100, n, dtype=np.uint8).tobytes() for n in lengths]
    params = _params(WIDTHS[widths], ndim=16)
    blob, starts, lens = _tensors(docs)
    want = fk.fingerprint_reference(blob, torch.from_numpy(starts), torch.from_numpy(lens), params)
    got = _split_and_merge(docs, params, unit)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _check_plan(lengths, unit):
    plan = fk.minhash_plan(lengths, unit)
    doc, s, e = plan.doc, plan.s, plan.e
    assert plan.unit == unit and (e - s <= unit).all() and (s <= e).all()
    # every document's ranges, in order, tile [0, length): each window end
    # (so each window) in exactly one piece
    assert (np.diff(doc) >= 0).all() and np.array_equal(np.unique(doc), np.arange(len(lengths)))
    starts_at = np.r_[True, doc[1:] != doc[:-1]]
    ends_at = np.r_[doc[1:] != doc[:-1], True]
    assert (s[starts_at] == 0).all() and np.array_equal(e[ends_at], lengths)
    assert np.array_equal(s[~starts_at], e[~ends_at])
    # a document is cut iff it is longer than the unit, into ranges of
    # about equal size, each to a partial slot of its own
    pieces = np.bincount(doc, minlength=len(lengths))
    np.testing.assert_array_equal(pieces > 1, lengths > unit)
    for d in np.flatnonzero(pieces > 1):
        sizes = (e - s)[doc == d]
        assert sizes.max() - sizes.min() <= 1
    whole = pieces[doc] == 1
    np.testing.assert_array_equal(plan.out[whole], doc[whole])
    np.testing.assert_array_equal(-1 - plan.out[~whole], np.arange((~whole).sum()))
    np.testing.assert_array_equal(plan.cut_docs, np.flatnonzero(pieces > 1))
    np.testing.assert_array_equal(np.diff(plan.cut_first), pieces[pieces > 1])
    # CTAs take consecutive pieces, all of them, none empty
    assert plan.cta_first[0] == 0 and plan.cta_first[-1] == len(doc)
    assert (np.diff(plan.cta_first) > 0).all() or len(doc) == 0
    return plan


@pytest.mark.parametrize("seed", range(6))
def test_plan_covers_every_window_once(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 3000, int(rng.integers(1, 60)))
    lengths[rng.integers(0, len(lengths), 3)] = 0
    for unit in (1, 7, 30, 31, 32, int(rng.integers(1, 5000))):
        _check_plan(lengths, unit)


def test_plan_edges():
    assert len(fk.minhash_plan(np.zeros(0, np.int64), 5).cta_first) == 1
    plan = _check_plan(np.array([0, 0, 0]), 1)
    assert len(plan.cta_first) == 2 and len(plan.cut_docs) == 0
    plan = _check_plan(np.array([5, 6, 10]), 5)  # at the unit, one over, twice over
    np.testing.assert_array_equal(plan.cut_docs, [1, 2])
    np.testing.assert_array_equal(plan.s[plan.doc == 1], [0, 3])
    np.testing.assert_array_equal(plan.e[plan.doc == 1], [3, 6])
    for bad in (0, -1):
        with pytest.raises(ValueError, match="unit"):
            fk.minhash_plan(np.array([3]), bad)
    with pytest.raises(ValueError, match="lengths"):
        fk.minhash_plan(np.array([3, -1]), 4)


@pytest.mark.parametrize("workload", ["lines", "documents", "mixed"])
def test_plan_balances_the_ctas(workload):
    """On the card's SM count (132) and chip_smoke.py's phase 4d shapes:
    every CTA but the last rolls within one unit of its share of
    ``UNIT_SHARE`` units (its warm-up included, up to 30 bytes a cut range
    for the default widths), so within (UNIT_SHARE ± 1) / UNIT_SHARE of the
    mean; the last at most UNIT_SHARE + 1 units."""
    rng = np.random.default_rng(42)
    lengths = {"lines": lambda: rng.integers(60, 180, 32768),
               "documents": lambda: rng.integers(2048, 16385, 2048),
               "mixed": lambda: np.concatenate([rng.integers(0, 200, 3000),
                                                rng.integers(10_000, 300_000, 40)])}[workload]()
    unit = fk.minhash_unit(lengths, 132)
    plan = _check_plan(lengths, unit)
    doc, s, e = plan.doc, plan.s, plan.e
    per_cta = np.add.reduceat(e - s, plan.cta_first[:-1])  # window bytes a CTA
    share = fk.UNIT_SHARE * unit
    assert len(per_cta) > 100
    assert (per_cta[:-1] > share - unit).all() and (per_cta < share + unit).all()
    mean = per_cta.mean()
    assert per_cta[:-1].min() > (fk.UNIT_SHARE - 1) / fk.UNIT_SHARE * mean * 0.99
    assert per_cta.max() < (fk.UNIT_SHARE + 1) / fk.UNIT_SHARE * mean * 1.01
    # the warm-up (w - 1 <= 30 bytes a range that does not start its
    # document) adds at most 30 / UNIT_MIN to a CTA's steps
    warm = np.add.reduceat(np.minimum(s, 30), plan.cta_first[:-1])
    assert (warm <= 30 / fk.UNIT_MIN * per_cta + 30).all()
    again = fk.minhash_plan(lengths.copy(), fk.minhash_unit(lengths.copy(), 132))
    for a, b in zip(plan, again):
        np.testing.assert_array_equal(a, b)


def test_minhash_unit():
    assert fk.minhash_unit(np.zeros(0, np.int64), 132) == fk.UNIT_MIN
    assert fk.minhash_unit(np.array([100] * 10), 132) == fk.UNIT_MIN
    # the default widths' warm-up stays under UNIT_MIN; a wider window's
    # sets the unit, so a cut range warms up over at most 1 / WARMUP_SHARE
    assert fk.minhash_unit(np.array([100] * 10), 132, 31) == fk.UNIT_MIN
    assert fk.minhash_unit(np.array([100] * 10), 132, 513) == fk.WARMUP_SHARE * 512
    big = np.full(1000, 1 << 20)
    unit = fk.minhash_unit(big, 132)
    assert unit == -(-big.sum() // (fk.CTAS_PER_SM * 132 * fk.UNIT_SHARE))
    plan = fk.minhash_plan(big, unit)
    assert abs(len(plan.cta_first) - 1 - fk.CTAS_PER_SM * 132) <= 1


@pytest.mark.parametrize("ndim,widths,seed", [(256, None, 42), (100, (1, 3, 31), 5),
                                              (64, (3, 2000), 1)])
def test_kernel_params_quotient_is_exact(ndim, widths, seed):
    """``kernel_params``' 1/m is rounded up, and with it floor(x * inv_m)
    is floor(x / m) for every x below the step's bound, checked in exact
    rationals at the edges of every quotient the step can take (x = q m - 1,
    q m, q m + m - 1) and at the largest x a step can form; the
    dimensions are ordered by width."""
    params = _params(widths, ndim, seed)
    kp = fk.kernel_params(params, "cpu")
    ints, floats = kp["kernel"].ints, kp["kernel"].floats
    w = params["width"].numpy()
    order = np.argsort(w, kind="stable")
    np.testing.assert_array_equal(ints[0].numpy(), w[order])
    np.testing.assert_array_equal(ints[1].numpy(), order)
    np.testing.assert_array_equal(floats[1].numpy(), params["modulo"].numpy()[order])
    for k in range(ndim):
        m, inv, mult = int(floats[1, k]), float(floats[3, k]), int(floats[0, k])
        assert Fraction(inv) >= Fraction(1, m) > Fraction(inv) / (1 + Fraction(1, 2**52))
        top = (m - 1) * (mult + 256) + 256
        assert top < 2**52
        for q in (1, 2, 7, top // m):
            for x in (q * m - 1, q * m, q * m + m - 1, top, 2**52 - 1):
                if x < 2**52:
                    assert int(Fraction(x) * Fraction(inv)) == x // m


@pytest.mark.parametrize("widths,halo", [(None, 32), ((1,), 32), ((33,), 64), ((64,), 64),
                                         ((3, 512), 512), ((1000,), 1024), ((1024, 1025), 1024),
                                         ((2000,), 32), ((3, 2000), 32)])
def test_kernel_params_halo(widths, halo):
    """The bytes staged before a chunk: the widest width up to
    ``MAX_HALO``, rounded up to 32, at least 32; wider widths read global
    memory and take no halo."""
    kp = fk.kernel_params(_params(widths, ndim=16), "cpu")["kernel"]
    assert kp.halo == halo and kp.widest == max(widths or tfp.DEFAULT_WINDOW_WIDTHS)


def test_the_kernel_path_takes_only_kernel_params():
    """On a CUDA device the wrappers take ``kernel_params``' dict made for
    that device, and raise (naming ``kernel_params``) on the plain
    parameters or on arrays made for another device, before any work."""
    params = _params((3, 31))
    cuda = torch.device("cuda", 0)
    for plain_or_cpu in (params, fk.kernel_params(params, "cpu")):
        with pytest.raises(ValueError, match="kernel_params"):
            fk._kernel_arrays(plain_or_cpu, cuda)
    kp = fk.kernel_params(params, "cpu")
    assert fk._kernel_arrays(kp, torch.device("cpu")) is kp["kernel"]


def test_kernel_params_refuse_what_the_step_cannot_keep_exact():
    params = _params((3, 5), ndim=8)
    for key, value in (("width", 0), ("mult", -1), ("fused_disc", -1),
                       ("modulo", 1 << 45), ("mult", 4000)):
        bad = dict(params)
        bad[key] = params[key].clone()
        bad[key][3] = value
        with pytest.raises(ValueError, match="dimension 3"):
            fk.kernel_params(bad, "cpu")
    bad = dict(params, fused_disc=params["modulo"].clone())
    with pytest.raises(ValueError, match="dimension 0"):
        fk.kernel_params(bad, "cpu")


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """``minhash_ranges`` and ``minhash_merge`` on CPU tensors are their
    plain versions; ``fingerprint_all`` with ``kernel_params``' dict gives
    what it gives with the plain one, from host or device-side (here: CPU)
    starts and lengths."""
    docs = _docs((3, 31))
    params = _params((3, 31))
    blob, starts, lens = _tensors(docs)
    pa = fk.plan_arrays(fk.minhash_plan(lens, 7), starts, "cpu")
    got = fk.minhash_ranges(blob, pa, params)
    want = fk.ranges_reference(blob, pa, params)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert pa.n_slots > 0 and (got[3] > 0).any()
    merged = fk.minhash_merge(pa, got[2], got[3], got[0].clone(), got[1].clone())
    plain = fk.merge_reference(pa, got[2], got[3], got[0].clone(), got[1].clone())
    assert all(torch.equal(g, w) for g, w in zip(merged, plain))
    args = (blob, torch.from_numpy(starts), torch.from_numpy(lens))
    a = fk.fingerprint_all(*args, fk.kernel_params(params, "cpu"))
    b = fk.fingerprint_all(*args, params)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(a, merged))
