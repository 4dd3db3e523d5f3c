"""The port's UTF-8 route against the JAX package's on the same numpy-seeded
inputs: the device decode (``rune_count_validity``, ``decode_pack_device``),
the rune route of the Myers plain version (against ``myers_pallas(...,
alphabet=None)`` in the interpreter) and of its kernel's match tables, and
``LevenshteinDistancesUTF8`` on a CPU scope (against the JAX engine and
Wagner-Fischer over runes). Tolerance: exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import stringzilla_tpu as jsz  # noqa: E402
from stringzilla_tpu.ops import pack_device as jax_pack  # noqa: E402
from stringzilla_tpu.ops import utf8_pack_device as jax_utf8  # noqa: E402
from stringzilla_tpu.ops.myers_pallas import myers_pallas  # noqa: E402
from stringzilla_tpu.ops.tape import Tape as JaxTape  # noqa: E402

import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.ops import utf8_pack_device as tutf8  # noqa: E402
from stringzilla_tpu_torch.ops.myers import (_rune_eq, _rune_peq, myers,  # noqa: E402
                                             myers_reference, words_of)
from stringzilla_tpu_torch.ops.pack_device import device_tape  # noqa: E402
from stringzilla_tpu_torch.ops.tape import Tape, dyadic_bucket  # noqa: E402

CPU = tsz.DeviceScope(device="cpu")

# Scripts of one to four UTF-8 bytes a rune, U+0000 and emoji among them.
ALPHABET = list("abc xyz\u0000é") + list("абвгдежзий") + list("日本語中文字漢") + ["😀", "🎉", "𝄞"]
MALFORMED = [
    b"ab\x80cd",            # stray continuation
    b"x\xc3",               # truncated 2-byte lead
    b"x\xe2\x82",           # truncated 3-byte lead
    b"\xf0\x9f\x98",        # truncated 4-byte lead
    b"\xc0\xaf",            # 0xC0 lead (overlong)
    b"\xe0\x80\xafz",       # overlong 3-byte
    b"\xf0\x80\x80\xaf",    # overlong 4-byte
    b"\xed\xa0\x80",        # surrogate
    b"\xf4\x90\x80\x80",    # above U+10FFFF
    b"\xf5\x80\x80\x80",    # 0xF5 lead
    b"ok\xc3\xa9\xe2\x82",  # valid rune, then a truncated lead
]


def _rng(seed=42):
    """A generator of this file's own: the tests draw the same data in any
    order and leave the session ``rng``, which other files share, as it is."""
    return np.random.default_rng(seed)


def _text(rng, n, alphabet=ALPHABET):
    # by index: a numpy string array would drop the U+0000 entries
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), int(n)))


def _runes(s) -> list:
    return [ord(c) for c in s]


def _wagner_fischer(a, b) -> int:
    """Row-at-a-time unit-cost Wagner-Fischer over int sequences."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    j = np.arange(len(b) + 1, dtype=np.int64)
    prev = j.copy()
    for i in range(1, len(a) + 1):
        x = np.empty_like(prev)
        x[0] = i
        x[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(x - j) + j
    return int(prev[-1])


def _both_tapes(items):
    tape = Tape.from_strings(items)
    return device_tape(tape, torch.device("cpu")), jax_pack.DeviceTape(
        JaxTape(tape.data, tape.offsets))


def _valid_set(rng):
    return [_text(rng, n).encode() for n in [0, 1, 2, 5, 17, 40, 61]]


@pytest.mark.parametrize("kind", ["valid", "malformed", "mixed"])
def test_rune_count_validity_matches_jax(kind):
    """Counts and violation flags; the row is three bytes longer than the
    longest string, where the JAX function sees a lead cut off by the end
    (see the next test)."""
    valid = _valid_set(_rng())
    items = {"valid": valid, "malformed": MALFORMED, "mixed": valid + MALFORMED[::2]}[kind]
    dt, jdt = _both_tapes(items)
    idx = np.arange(len(items))
    row_len = dyadic_bucket(max(map(len, items)) + 3)
    got = tutf8.rune_count_validity(dt, idx, row_len)
    want = jax_utf8.rune_count_validity(jdt, idx, row_len)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1] > 0, [item not in valid for item in items])
    for item, count, bad in zip(items, *got):
        if not bad:
            assert count == len(item.decode())


def test_rune_count_validity_flags_a_lead_cut_off_at_the_row_end():
    """A string that fills its row and ends in a truncated lead: the port
    flags it, the JAX function (which reads only ``row_len`` bytes) does not
    (ROADMAP queue 3)."""
    items = [b"abcdef\xe2\x82", b"abcdefg\xc3", b"abcdefgh"]
    dt, jdt = _both_tapes(items)
    got = tutf8.rune_count_validity(dt, np.arange(3), 8)
    want = jax_utf8.rune_count_validity(jdt, np.arange(3), 8)
    assert got[1].tolist()[:2] != [0, 0] and got[1][2] == 0
    assert want[1].tolist() == [0, 0, 0]


@pytest.mark.parametrize("fill,transpose,shift", [
    (0, True, False), (-1, True, False), (0, False, False), (0, True, True), (7, False, True)])
def test_decode_pack_device_matches_jax(fill, transpose, shift):
    rng = _rng(3)
    items = _valid_set(rng) + [_text(rng, 90).encode()]
    dt, jdt = _both_tapes(items)
    idx = rng.permutation(len(items))[:6]
    byte_len = dyadic_bucket(max(len(items[i]) for i in idx))
    rune_len = 96
    got = tutf8.decode_pack_device(dt, idx, byte_len, rune_len, fill=fill,
                                   transpose=transpose, shift=shift)
    want = np.asarray(jax_utf8.decode_pack_device(jdt, idx, len(idx), byte_len, rune_len,
                                                  fill=fill, transpose=transpose, shift=shift))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    block = got.numpy() if not transpose else got.numpy().T
    for row, i in zip(block, idx):
        runes = _runes(items[i].decode())
        assert row[int(shift): int(shift) + len(runes)].tolist() == runes


def _rune_block(rng, q_lens, c_lens, rows, cand_len, alphabet):
    """Blocks in the ``myers`` layouts over ``alphabet`` (int runes); every
    third candidate a mutated copy of a query."""
    q_t = np.full((rows, len(q_lens)), -1, np.int32)
    for i, m in enumerate(q_lens):
        q_t[:m, i] = rng.choice(alphabet, m)
    c_t = np.zeros((cand_len, len(c_lens)), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = rng.choice(alphabet, n)
        if j % 3 == 0:
            src = q_t[: q_lens[j % len(q_lens)], j % len(q_lens)]
            k = min(n, len(src))
            c_t[:k, j] = np.where(rng.random(k) > 0.2, src[:k], c_t[:k, j])
    return (q_t, np.asarray(q_lens, np.int32).reshape(-1, 1), c_t,
            np.asarray(c_lens, np.int32).reshape(1, -1))


CJK = np.arange(0x4E00, 0x4E00 + 3000, dtype=np.int32)
WIDE = np.concatenate([[0, 0x1F600, 0x10FFFF, -5], np.arange(97, 123), CJK[:400]]).astype(np.int32)


@pytest.mark.parametrize("q_lens,c_lens,rows,cand_len,alphabet", [
    ([0, 1, 5, 32], [0, 1, 3, 31, 40], 32, 40, WIDE[:6]),
    ([64, 100, 128], [0, 1, 64, 127, 130], 128, 130, CJK),
    ([257, 300, 1], [0, 5, 290, 310], 320, 310, WIDE),
], ids=["w1-nul-emoji", "w2-cjk", "w5-over-256-distinct"])
def test_rune_myers_reference_matches_jax(q_lens, c_lens, rows, cand_len, alphabet):
    rng = _rng(len(q_lens) * rows)
    block = _rune_block(rng, q_lens, c_lens, rows, cand_len, alphabet)
    args = [torch.from_numpy(x) for x in block]
    got = myers(*args, alphabet=None)
    assert torch.equal(got, myers_reference(*args, alphabet=None))
    want = np.asarray(myers_pallas(*(jnp.asarray(x) for x in block), alphabet=None))
    np.testing.assert_array_equal(got.numpy(), want)
    q_t, ql, c_t, cl = block
    for i, j in [(0, 0), (len(q_lens) - 1, len(c_lens) - 1), (1, 2)]:
        assert got[i, j] == _wagner_fischer(q_t[: ql[i, 0], i], c_t[: cl[0, j], j])


@pytest.mark.parametrize("rows,alphabet", [(32, WIDE[:6]), (128, CJK), (320, WIDE)])
def test_rune_tables_give_the_direct_match_masks(rows, alphabet):
    """The kernel's route: each query's sorted distinct runes and one match
    row per rune, a candidate rune's row found by binary search (here
    ``np.searchsorted``), equal the plain version's direct comparison."""
    rng = _rng(rows)
    q_lens = [0, 1, rows // 2, rows]
    q_t, ql, c_t, _ = _rune_block(rng, q_lens, [rows] * 6, rows, rows, alphabet)
    c_t[:3, 0] = [-1, 0, 0x7FFFFFFF]  # the padding value and extremes
    words = words_of(rows)
    keys, offs, peq = (x.numpy() for x in _rune_peq(torch.from_numpy(q_t),
                                                     torch.from_numpy(ql), words))
    assert offs[0] == 0 and offs[-1] == len(keys)
    for q, m in enumerate(q_lens):
        k = keys[offs[q]:offs[q + 1]]
        np.testing.assert_array_equal(k, np.unique(q_t[:m, q]))
    for j in range(c_t.shape[0]):
        eq = _rune_eq(torch.from_numpy(q_t), torch.from_numpy(ql),
                      torch.from_numpy(c_t[j]), words).numpy()
        for q in range(len(q_lens)):
            k = keys[offs[q]:offs[q + 1]]
            at = np.minimum(np.searchsorted(k, c_t[j]), max(len(k) - 1, 0))
            found = (k[at] == c_t[j]) if len(k) else np.zeros(c_t.shape[1], bool)
            want = np.where(found[:, None], peq[offs[q] + at], 0)
            np.testing.assert_array_equal(eq[q], want, err_msg=f"step {j} query {q}")


def test_myers_rejects_another_alphabet():
    args = [torch.zeros(s, dtype=torch.int32) for s in ((32, 1), (1, 1), (4, 1), (1, 1))]
    with pytest.raises(ValueError, match="alphabet"):
        myers(*args, alphabet=512)


def _mixed(rng, lengths):
    return [_text(rng, n) for n in lengths]


def test_utf8_engine_matches_jax_mixed_scripts():
    """Rune lengths 0-300 over the dyadic rune buckets 8-512 (both tiers on
    the card); byte lengths up to four times that."""
    rng = _rng(5)
    qs = _mixed(rng, [0, 5, 70, 130, 260])
    cs = _mixed(rng, [2, 9, 100, 140, 300]) + [qs[3][:100] + "ж"]
    got = tsz.LevenshteinDistancesUTF8()(qs, cs, device=CPU)
    want = jsz.LevenshteinDistancesUTF8()(qs, cs)
    assert got.dtype == np.uint64 and got.shape == (5, 6)
    np.testing.assert_array_equal(got, want)
    for i, j in [(0, 5), (3, 5), (4, 4), (2, 2)]:
        assert got[i, j] == _wagner_fischer(_runes(qs[i]), _runes(cs[j]))


def test_utf8_engine_symmetric_tape_and_bytes_input():
    rng = _rng(6)
    seqs = _mixed(rng, rng.integers(0, 70, 7))
    got = tsz.LevenshteinDistancesUTF8()(seqs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistancesUTF8()(seqs))
    assert (got == got.T).all() and (np.diag(got) == 0).all()
    tape = tsz.Tape.from_strings([s.encode() for s in seqs])
    np.testing.assert_array_equal(tsz.LevenshteinDistancesUTF8()(tape, device=CPU), got)
    eng = tsz.LevenshteinDistancesUTF8()
    assert eng(["héllo", "😀a"], ["hello", "a"], device=CPU).tolist() == [[1, 5], [5, 1]]


def test_utf8_engine_malformed_input_takes_the_host_decode():
    """Any malformed string sends the collection to the host, which decodes
    each maximal invalid subpart to U+FFFD; a Tape too."""
    rng = _rng(8)
    qs = [b.decode("utf-8", "replace").encode() if i % 4 == 0 else b
          for i, b in enumerate(MALFORMED)] + [_text(rng, 12).encode()]
    cs = ["abcd", "x�", "oké�", _text(rng, 9)]
    got = tsz.LevenshteinDistancesUTF8()(qs, cs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistancesUTF8()(qs, cs))
    for i, q in enumerate(qs):
        for j, c in enumerate(cs):
            assert got[i, j] == _wagner_fischer(_runes(q.decode("utf-8", "replace")), _runes(c))
    tape_got = tsz.LevenshteinDistancesUTF8()(tsz.Tape.from_strings(qs), cs, device=CPU)
    np.testing.assert_array_equal(tape_got, got)
    # a lead cut off at the end of an 8-byte string is U+FFFD here too
    assert tsz.LevenshteinDistancesUTF8()([b"abcdef\xe2\x82"], ["abcdef�"],
                                          device=CPU).tolist() == [[0]]


def test_utf8_engine_int_array_input_keeps_its_values():
    qs = [np.array([70000, 0, -5, 3], np.int64), np.array([0, 3], np.int32)]
    cs = [np.array([70000, 3], np.int64), np.zeros(0, np.int32), np.array([0x10FFFF], np.int32)]
    got = tsz.LevenshteinDistancesUTF8()(qs, cs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistancesUTF8()(qs, cs))
    assert got.tolist() == [[2, 4, 4], [1, 2, 2]]


@pytest.mark.parametrize("costs", [dict(mismatch=2), dict(match=0, mismatch=3, open=2, extend=1)])
def test_utf8_engine_non_unit_costs_match_jax(costs):
    """Runes through the column DP: U+0161 must not alias its low byte
    0x61, "a"."""
    rng = _rng(9)
    qs = _mixed(rng, [0, 3, 20, 45]) + ["š", "a"]
    cs = _mixed(rng, [1, 8, 30, 60]) + ["a", "š"]
    got = tsz.LevenshteinDistancesUTF8(**costs)(qs, cs, device=CPU)
    np.testing.assert_array_equal(got, jsz.LevenshteinDistancesUTF8(**costs)(qs, cs))
    assert got[4, 4] == got[5, 5] == costs["mismatch"] and got[4, 5] == 0


def test_utf8_engine_long_pairs_match_wagner_fischer():
    """Two pairs with a string just over 4096 runes (the wavefront tier's
    band kernel, in runes): a near-duplicate and a short candidate."""
    rng = _rng(10)
    long_a = _text(rng, 4100)
    chars = list(long_a)
    for k in rng.integers(0, 4100, 30):
        chars[k] = "я"
    long_b = "".join(chars[:4050]) + "xyz"
    short = _text(rng, 60)
    got = tsz.LevenshteinDistancesUTF8()([long_a], [long_b, short], device=CPU)
    assert got.tolist() == [[_wagner_fischer(_runes(long_a), _runes(long_b)),
                             _wagner_fischer(_runes(long_a), _runes(short))]]
    assert len(long_a.encode()) > 2 * 4096
