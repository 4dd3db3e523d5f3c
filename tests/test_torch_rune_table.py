"""The rune route's lookup (``csrc/myers.cu``: each query's distinct runes in
an open-addressing hash table in shared memory, one probe for a candidate
rune's match row), on the CPU through its plain numpy version
``ops/myers.py`` ``rune_table``/``rune_probe`` (the same Fibonacci hash,
slot count and linear probe): every key found at its row and absent runes
missing for 0-4,096 keys (tier A's 256 and tier B's 4,096 at their edges),
the longest cluster of occupied slots bounded on CJK runs, multiples of the
slot count and random runes, the answer the same in any order of insertion
(the kernel's threads race), a plain emulation of the kernel (hash lookup,
then the recurrence) against the plain version ``myers_reference`` and the
JAX ``myers_pallas(alphabet=None)`` in the interpreter, and the engine's
tables built once a query block. Every check is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from stringzilla_tpu.ops.myers_pallas import myers_pallas  # noqa: E402

import stringzilla_tpu_torch as tsz  # noqa: E402
from stringzilla_tpu_torch.models import similarities as sim_mod  # noqa: E402
from stringzilla_tpu_torch.ops import myers as myers_mod  # noqa: E402
from stringzilla_tpu_torch.ops.myers import (  # noqa: E402
    _rune_eq, _rune_peq, build_rune_tables, myers_reference, rune_probe, rune_table,
    rune_table_bits, words_of)
from stringzilla_tpu_torch.ops.tape import dyadic_bucket  # noqa: E402
from stringzilla_tpu_torch.parallel import cross as cross_mod  # noqa: E402

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
EXTREMES = [-1, 0, INT32_MIN, INT32_MAX, 0x10FFFF]
KEY_COUNTS = [0, 1, 2, 255, 256, 257, 4095, 4096]
CJK = 0x4E00
# The longest run of occupied slots, the most any probe reads less one:
# runes with structure (a script's block, multiples of the slot count) and
# random ones, at the table's load of at most a half.
STRUCTURED_CLUSTER = 12
RANDOM_CLUSTER = 40


def _bits(count: int) -> int:
    """The table of a block whose queries could hold ``count`` runes."""
    return rune_table_bits(max(1, -(-count // 64)))


def _random_keys(rng, count: int, avoid=()) -> np.ndarray:
    keys = set()
    while len(keys) < count:
        keys.update(int(k) for k in rng.integers(INT32_MIN, INT32_MAX, count, endpoint=True))
        keys.difference_update(avoid)
    return np.array(sorted(keys)[:count], np.int64)


def _longest_cluster(slot_rows: np.ndarray) -> int:
    """The longest run of occupied slots, around the table's end too."""
    occupied = np.roll(slot_rows >= 0, -int(np.argmin(slot_rows >= 0)))
    edges = np.diff(np.concatenate([[0], occupied.astype(np.int8), [0]]))
    return int((np.nonzero(edges == -1)[0] - np.nonzero(edges == 1)[0]).max(initial=0))


@pytest.mark.parametrize("count", KEY_COUNTS)
def test_slots_are_a_power_of_two_at_least_twice_the_keys(count):
    slots = 1 << _bits(count)
    assert slots >= max(128, 2 * count) and slots & (slots - 1) == 0
    # tier A's blocks of <= 4 words take <= 512 slots (4 KB), tier B's <= 8,192 (64 KB)
    assert slots <= (512 if count <= 256 else 8192)


@pytest.mark.parametrize("count", KEY_COUNTS)
def test_every_key_is_found_at_its_row(count):
    keys = _random_keys(np.random.default_rng(count), count)
    table = rune_table(keys, _bits(count))
    rows, reads = rune_probe(table, keys)
    np.testing.assert_array_equal(rows, np.arange(count))
    assert (table[1] >= 0).sum() == count
    assert reads.max(initial=1) <= _longest_cluster(table[1]) + 1


@pytest.mark.parametrize("count", KEY_COUNTS)
def test_absent_runes_miss(count):
    """-1, U+0000, INT32_MIN, INT32_MAX, U+10FFFF and the neighbours of
    every key that are not keys themselves find no row."""
    keys = _random_keys(np.random.default_rng(count + 1), count, avoid=EXTREMES)
    table = rune_table(keys, _bits(count))
    around = np.concatenate([keys - 1, keys + 1])
    around = around[(around >= INT32_MIN) & (around <= INT32_MAX)]
    absent = np.setdiff1d(np.concatenate([EXTREMES, around]), keys)
    rows, _ = rune_probe(table, absent)
    assert (rows == -1).all()


@pytest.mark.parametrize("count", [1, 5, 256, 4096])
def test_extreme_runes_are_keys_like_any(count):
    """A rune of -1, U+0000, INT32_MIN or INT32_MAX is found at its row: no
    rune value marks an empty slot."""
    extremes = EXTREMES[:min(count, 4)]
    keys = np.unique(np.concatenate([extremes, _random_keys(np.random.default_rng(7),
                                                            count - len(extremes), EXTREMES)]))
    assert len(keys) == count
    table = rune_table(keys, _bits(count))
    np.testing.assert_array_equal(rune_probe(table, keys)[0], np.arange(count))


def _pattern(name: str, count: int) -> np.ndarray:
    slots = 1 << _bits(count)
    if name == "cjk run":
        return CJK + np.arange(count)
    if name == "slot multiples":
        return np.arange(count) * slots
    if name == "half-slot multiples":
        return np.arange(count) * (slots // 2)
    if name == "ascii and cjk":
        return np.concatenate([np.arange(32, 127), CJK + np.arange(count)])[:count]
    return _random_keys(np.random.default_rng(count + 2), count)


@pytest.mark.parametrize("count", [255, 256, 257, 4095, 4096])
@pytest.mark.parametrize("name", ["cjk run", "slot multiples", "half-slot multiples",
                                  "ascii and cjk", "random"])
def test_probe_length_is_bounded(name, count):
    """Runes that share their low bits or run consecutively spread over the
    table under the Fibonacci hash: the longest cluster stays within
    ``STRUCTURED_CLUSTER`` (``RANDOM_CLUSTER`` for random runes), so no
    probe reads more than that plus one slot; a key is found in at most 1.3
    reads on average (2 for random runes: Knuth's 1.5 at half load, with
    room for the draw)."""
    keys = np.unique(_pattern(name, count).astype(np.int64))
    table = rune_table(keys, _bits(count))
    longest = _longest_cluster(table[1])
    assert longest <= (RANDOM_CLUSTER if name == "random" else STRUCTURED_CLUSTER)
    _, hits = rune_probe(table, keys)
    misses = rune_probe(table, np.setdiff1d(keys + 1, keys))[1]
    assert hits.max() <= longest and misses.max(initial=1) <= longest + 1
    assert hits.mean() <= (2.0 if name == "random" else 1.3)


def test_colliding_runes_are_still_found():
    """Runes chosen to share one home slot make one long cluster: slower
    probes, the same answers."""
    bits = _bits(256)
    candidates = np.arange(0, 1 << 22, dtype=np.int64)
    same_home = candidates[myers_mod._home(candidates, bits) == 5][:256]
    table = rune_table(same_home, bits)
    assert _longest_cluster(table[1]) == 256
    rows, reads = rune_probe(table, same_home)
    np.testing.assert_array_equal(rows, np.arange(256))
    assert reads.max() == 256
    assert (rune_probe(table, np.setdiff1d(same_home + 1, same_home))[0] == -1).all()


@pytest.mark.parametrize("count", [256, 4096])
def test_any_insertion_order_gives_the_same_answers(count):
    """The kernel's threads insert in no set order: the occupied slots and
    every lookup's row are those of the sorted order."""
    rng = np.random.default_rng(count + 3)
    keys = np.unique(np.concatenate([CJK + np.arange(count // 2),
                                     _random_keys(rng, count - count // 2)]))
    bits = _bits(count)
    first = rune_table(keys, bits)
    raced = rune_table(keys, bits, order=rng.permutation(len(keys)))
    np.testing.assert_array_equal(first[1] >= 0, raced[1] >= 0)
    probe = np.concatenate([keys, keys + 1, EXTREMES])
    np.testing.assert_array_equal(rune_probe(first, probe)[0], rune_probe(raced, probe)[0])


def _rune_block(rng, q_lens, c_lens, rows, cand_len, alphabet):
    """Query chars padded with -1 and candidate chars padded with 0 over
    ``alphabet``; every third candidate a mutated copy of a query."""
    alphabet = np.asarray(alphabet, np.int32)
    q_t = np.full((rows, len(q_lens)), -1, np.int32)
    for i, m in enumerate(q_lens):
        q_t[:m, i] = alphabet[rng.integers(0, len(alphabet), m)]
    c_t = np.zeros((cand_len, len(c_lens)), np.int32)
    for j, n in enumerate(c_lens):
        c_t[:n, j] = alphabet[rng.integers(0, len(alphabet), n)]
        if j % 3 == 0:
            src = q_t[: q_lens[j % len(q_lens)], j % len(q_lens)]
            k = min(n, len(src))
            c_t[:k, j] = np.where(rng.random(k) > 0.2, src[:k], c_t[:k, j])
    return (q_t, np.asarray(q_lens, np.int32).reshape(-1, 1), c_t,
            np.asarray(c_lens, np.int32).reshape(1, -1))


def _emulate(q_t, ql, c_t, cl):
    """The kernel's rune route, plainly: each query's table from its
    ``_rune_peq`` keys, each candidate rune's row by ``rune_probe`` (no
    row: no match), that row's PEQ words as one integer, then the
    recurrence on the query's bits as one Python integer."""
    words = words_of(q_t.shape[0])
    keys, offs, peq = (x.numpy() for x in _rune_peq(torch.from_numpy(q_t),
                                                     torch.from_numpy(ql), words))
    peq = peq.view(np.uint64)
    out = np.zeros((q_t.shape[1], c_t.shape[1]), np.int64)
    for q in range(q_t.shape[1]):
        m = int(ql[q, 0])
        mask = (1 << m) - 1
        table = rune_table(keys[offs[q]:offs[q + 1]], rune_table_bits(words))
        row_eq = [sum(int(w) << (64 * i) for i, w in enumerate(peq[offs[q] + r]))
                  for r in range(offs[q + 1] - offs[q])]
        for j in range(c_t.shape[1]):
            n = int(cl[0, j])
            vp, vn = mask, 0
            for row in rune_probe(table, c_t[:n, j])[0].tolist():
                eq = row_eq[row] if row >= 0 else 0
                xv = eq | vn
                xh = ((((eq & vp) + vp) & mask) ^ vp) | eq
                ph = vn | (~(xh | vp) & mask)
                mh = vp & xh
                ph = ((ph << 1) | 1) & mask
                mh = (mh << 1) & mask
                vp = mh | (~(xv | ph) & mask)
                vn = ph & xv
            out[q, j] = n + bin(vp).count("1") - bin(vn).count("1")
    return out


_HOME_5 = np.arange(0, 1 << 20, dtype=np.int64)
_HOME_5 = _HOME_5[myers_mod._home(_HOME_5, rune_table_bits(1)) == 5][:40].astype(np.int32)


@pytest.mark.parametrize("q_lens,c_lens,rows,cand_len,alphabet", [
    ([0, 1, 17, 64], [0, 1, 2, 40, 64, 70], 64, 70,
     np.concatenate([EXTREMES[:4], CJK + np.arange(20)])),
    ([1, 64, 60], [0, 5, 33, 64, 64], 64, 64, _HOME_5),
    ([257, 300, 2], [0, 3, 290, 310], 320, 310, CJK + np.arange(400)),
], ids=["w1-extremes", "w1-colliding", "w5-cjk"])
def test_emulated_lookup_matches_plain_and_jax(q_lens, c_lens, rows, cand_len, alphabet):
    """Extreme runes (-1, U+0000, INT32_MIN, INT32_MAX) in queries and
    candidates, runes that all share one home slot, and a tier-B block of
    over 256 distinct CJK runes: the emulated kernel equals the plain
    version and the JAX kernel."""
    block = _rune_block(np.random.default_rng(rows + len(q_lens)), q_lens, c_lens, rows,
                        cand_len, alphabet)
    got = _emulate(*block)
    plain = myers_reference(*(torch.from_numpy(x) for x in block), alphabet=None).numpy()
    np.testing.assert_array_equal(got, plain)
    jax_out = np.asarray(myers_pallas(*(jnp.asarray(x) for x in block), alphabet=None))
    np.testing.assert_array_equal(got, jax_out)


@pytest.mark.parametrize("rows", [32, 256, 320])
def test_table_rows_give_the_direct_match_masks(rows):
    """A candidate rune's row by the hash probe, and that row of the
    ``_rune_peq`` table, equal the plain version's direct comparison with
    every query rune (U+0000, -1 and INT32_MAX among the candidates)."""
    rng = np.random.default_rng(rows + 11)
    alphabet = np.concatenate([[0, 0x1F600, 0x10FFFF, -5], CJK + np.arange(300)])
    q_lens = [0, 1, rows // 2, rows]
    q_t, ql, c_t, _ = _rune_block(rng, q_lens, [rows] * 5, rows, rows, alphabet)
    c_t[:3, 0] = [-1, 0, INT32_MAX]
    words = words_of(rows)
    keys, offs, peq = (x.numpy() for x in _rune_peq(torch.from_numpy(q_t),
                                                     torch.from_numpy(ql), words))
    tables = [rune_table(keys[offs[q]:offs[q + 1]], rune_table_bits(words))
              for q in range(len(q_lens))]
    for j in range(0, c_t.shape[0], 7):
        eq = _rune_eq(torch.from_numpy(q_t), torch.from_numpy(ql),
                      torch.from_numpy(c_t[j]), words).numpy()
        for q, table in enumerate(tables):
            row, _ = rune_probe(table, c_t[j])
            want = np.where((row >= 0)[:, None], peq[offs[q] + np.maximum(row, 0)], 0)
            np.testing.assert_array_equal(eq[q], want, err_msg=f"step {j} query {q}")


def test_build_rune_tables_builds_none_for_the_cpu():
    q_t = torch.tensor([[5], [-1]], dtype=torch.int32)
    assert build_rune_tables(q_t, torch.tensor([[1]], dtype=torch.int32)) is None


def test_engine_builds_each_query_blocks_tables_once(monkeypatch):
    """The engine's once-a-query-block path, with the build forced on the
    CPU: one build a query block, the same tables handed to every
    ``myers`` call on the block, equal to ``_rune_peq`` of it; the scores
    those of the plain version."""
    builds, calls = [], []

    def build(q_t, qlens):
        builds.append(_rune_peq(q_t, qlens, words_of(q_t.shape[0])))
        return builds[-1]

    def spy(q_t, qlens, cands_t, clens, alphabet=256, **kw):
        calls.append((q_t, qlens, alphabet, kw))
        return myers_reference(q_t, qlens, cands_t, clens, alphabet)

    monkeypatch.setattr(sim_mod, "build_rune_tables", build)
    monkeypatch.setattr(cross_mod, "myers", spy)  # the engine's blocks reach myers there
    rng = np.random.default_rng(12)
    pool = [chr(c) for c in np.concatenate([[0x61, 0x62, 0x436], CJK + np.arange(200)])]
    text = lambda n: "".join(pool[i] for i in rng.integers(0, len(pool), n))
    qs = [text(n) for n in (3, 7, 30, 60, 100, 130, 200)]
    cs = [text(n) for n in (0, 5, 20, 70, 150, 250)]
    got = tsz.LevenshteinDistancesUTF8()(qs, cs, device=tsz.DeviceScope(device="cpu"))
    q_blocks = {dyadic_bucket(len(q)) for q in qs}
    c_blocks = {dyadic_bucket(len(c)) for c in cs}
    assert len(builds) == len(q_blocks) and len(calls) == len(q_blocks) * len(c_blocks)
    for q_t, qlens, alphabet, kw in calls:
        assert alphabet is None
        tables = kw["rune_tables"]
        assert any(tables is b for b in builds)
        for have, want in zip(tables, _rune_peq(q_t, qlens, words_of(q_t.shape[0]))):
            assert torch.equal(have, want)
    for i, q in enumerate(qs):
        for j, c in enumerate(cs):
            a, b = [ord(x) for x in q], [ord(x) for x in c]
            prev = list(range(len(b) + 1))
            for x in range(1, len(a) + 1):
                cur = [x] + [0] * len(b)
                for y in range(1, len(b) + 1):
                    cur[y] = min(prev[y] + 1, cur[y - 1] + 1, prev[y - 1] + (a[x - 1] != b[y - 1]))
                prev = cur
            assert got[i, j] == prev[-1]
