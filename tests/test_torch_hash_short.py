"""``hash_short``'s design (``csrc/hash.cu``) on the CPU: a numpy model of
its table lookups and the order in which its warps take their strings,
and its route against the JAX package.

* The lookups: T0-T3, each replicated per bank (entry x of T0 for lane j
  at byte 256 x + 4 j, of T1 at 256 x + 128 + 4 j, T2 and T3 the same 64
  KiB on), each address one PRMT of a state byte and the lane's offset.
  The model's AESENC must equal ``aes_kernel.aes_round`` (the plain
  version) byte for byte, with every byte value in every position of the
  state, and every word a lane reads must lie in its own bank.
* The order: ``ops.hash_kernel.short_order`` (groups of 32 G strings, each
  hashed in rounds of 32 in order of block count), held against a numpy
  emulation of the kernel's ranking and against its definition; its
  absorb steps on a log's word mix; an emulated kernel that hashes round
  by round with the plain version.
* The route: ``hash_batch_device(..., device="cpu")`` against the JAX
  ``hash_pallas.hash_batch_device`` (its Pallas kernel in interpret mode),
  exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stringzilla_tpu.ops import hash_pallas as jax_hash_pallas  # noqa: E402
from stringzilla_tpu_torch.ops import aes_kernel, hash_kernel  # noqa: E402
from stringzilla_tpu_torch.ops.hash import SBOX  # noqa: E402

G = hash_kernel.SHORT_GEOMETRY[0]
U32 = np.uint64(0xFFFFFFFF)


# -- the lookups -----------------------------------------------------------------

def table_entries() -> np.ndarray:
    """``(4, 256)`` u32: table r's entry x, the MixColumns column of S-box(x)
    with coefficients (2, 1, 1, 3) in bytes 0-3, rotated left by 8 r bits."""
    s = SBOX.astype(np.uint64)
    d = ((s << np.uint64(1)) ^ ((s >> np.uint64(7)) * np.uint64(0x1B))) & np.uint64(0xFF)
    t0 = d | (s << np.uint64(8)) | (s << np.uint64(16)) | ((d ^ s) << np.uint64(24))
    return np.stack([rotl(t0.astype(np.uint32), 8 * r) if r else t0.astype(np.uint32)
                     for r in range(4)])


def short_table() -> np.ndarray:
    """The kernel's shared-memory table as ``build_short_table`` fills it:
    the stage holds entry ``256 r + x``, and 16-byte vector v (words 4 v to
    4 v + 3) takes table ``2 (v >> 12) + ((v >> 3) & 1)``'s entry
    ``(v >> 4) & 255``, four times."""
    stage = table_entries().reshape(-1)
    v = np.arange(4 * 256 * 32 // 4)
    vec = stage[256 * (2 * (v >> 12) + ((v >> 3) & 1)) + ((v >> 4) & 255)]
    return np.repeat(vec, 4).astype(np.uint32)


def rotl(x: np.ndarray, bits: int) -> np.ndarray:
    x = x.astype(np.uint64)
    return (((x << np.uint64(bits)) | (x >> np.uint64(32 - bits))) & U32).astype(np.uint32)


def byte_perm(x: np.ndarray, y: np.ndarray, selector: int) -> np.ndarray:
    """CUDA's ``__byte_perm``: result byte i is byte (selector nibble i) of
    the 8 bytes of x (0-3) and y (4-7)."""
    both = (x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32)))
    out = np.zeros_like(both)
    for i in range(4):
        nib = np.uint64((selector >> (4 * i)) & 7)
        out |= ((both >> (np.uint64(8) * nib)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def model_aesenc(state: np.ndarray, key: np.ndarray, lanes: np.ndarray):
    """One AESENC of ``(n, 4)`` u32 column words as lanes ``lanes`` run it
    (``short_aesenc``): ``(out, words)``, the result and the ``(n, 16)``
    table words each lane reads."""
    table = short_table()
    lo = (lanes.astype(np.uint32) << np.uint32(2))
    hi = lo | np.uint32(128)
    out = np.zeros_like(state)
    words = []
    for c in range(4):
        acc = key[:, c].copy()
        for r in range(4):
            address = byte_perm(state[:, (c + r) % 4], hi if r & 1 else lo, 0x5504 | (r << 4))
            word = (65536 * (r >> 1) + address.astype(np.int64)) // 4
            words.append(word)
            acc ^= table[word]
        out[:, c] = acc
    return out, np.stack(words, axis=1)


def _as_words(blocks: np.ndarray) -> np.ndarray:
    return blocks.reshape(-1, 16).view("<u4").astype(np.uint32)


def _plain(state_words: np.ndarray, key_words: np.ndarray) -> np.ndarray:
    state = torch.from_numpy(state_words.astype("<u4").view(np.uint8).reshape(-1, 16).copy())
    key = torch.from_numpy(key_words.astype("<u4").view(np.uint8).reshape(-1, 16).copy())
    return _as_words(aes_kernel.aes_round(state, key).numpy())


@pytest.mark.parametrize("position", range(16))
def test_model_aesenc_equals_the_plain_round_for_every_byte(position):
    """State byte ``position`` (column position // 4) takes all 256 values,
    the others and the keys random, each row on another lane."""
    rng = np.random.default_rng(100 + position)
    state = rng.integers(0, 256, (256, 16), dtype=np.uint8)
    state[:, position] = np.arange(256, dtype=np.uint8)
    key = rng.integers(0, 256, (256, 16), dtype=np.uint8)
    s, k = _as_words(state), _as_words(key)
    got, _ = model_aesenc(s, k, np.arange(256) % 32)
    np.testing.assert_array_equal(got, _plain(s, k))


def test_model_aesenc_on_seeded_states_and_chains():
    """Random states and keys, and a chain of 8 rounds (each round's output
    the next one's state), against the plain round."""
    rng = np.random.default_rng(7)
    s = _as_words(rng.integers(0, 256, (1024, 16), dtype=np.uint8))
    k = _as_words(rng.integers(0, 256, (1024, 16), dtype=np.uint8))
    lanes = rng.integers(0, 32, 1024)
    a, b = s, s
    for _ in range(8):
        a = model_aesenc(a, k, lanes)[0]
        b = _plain(b, k)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lane", range(32))
def test_every_word_a_lane_reads_lies_in_its_bank(lane):
    state = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 16, axis=1)  # every byte value
    s = _as_words(state)
    _, words = model_aesenc(s, s, np.full(256, lane))
    assert (words % 32 == lane).all()
    assert words.min() >= 0 and words.max() < 4 * 256 * 32  # inside the 128 KiB table


def test_the_table_build_writes_each_entry_where_the_lookups_read_it():
    """Entry x of table r for lane j at byte 65536 (r // 2) + 256 x +
    128 (r % 2) + 4 j: the layout the lookups' addresses assume."""
    table, entries = short_table(), table_entries()
    for r in range(4):
        for j in (0, 5, 31):
            at = (65536 * (r // 2) + 256 * np.arange(256) + 128 * (r % 2) + 4 * j) // 4
            np.testing.assert_array_equal(table[at], entries[r])


def test_a_warps_lookups_take_one_wavefront_where_the_old_tables_took_three():
    """A warp's 32 lanes on random states: in the replicated table each of
    an AESENC's 16 lookups puts one word in every bank; in the old
    ``T[4][256]`` (byte x of table r in bank x mod 32) the busiest bank
    held ~3.15 distinct words on average, the wavefronts a lookup took."""
    rng = np.random.default_rng(8)
    new_busiest, old_busiest = [], []
    for _ in range(2000):
        s = _as_words(rng.integers(0, 256, (32, 16), dtype=np.uint8))
        _, words = model_aesenc(s, s, np.arange(32))
        for w in words.T:
            new_busiest.append(np.bincount(w % 32, minlength=32).max())
        for c in range(4):
            for r in range(4):
                x = (s[:, (c + r) % 4] >> np.uint32(8 * r)) & np.uint32(0xFF)
                distinct = np.unique(x)
                old_busiest.append(np.bincount(distinct % 32, minlength=32).max())
    assert max(new_busiest) == 1
    assert 3.0 < np.mean(old_busiest) < 3.3


def model_extract(lo: np.ndarray, hi: np.ndarray, shift: int, count: int) -> np.ndarray:
    """``short_extract``: the 8 words of two 16-byte vectors, words
    shift // 4.. picked by two selects (8 bytes on if shift & 8, 4 if
    shift & 4), joined by funnel shifts of 8 (shift % 4) bits, masked to
    ``count`` bytes by ``__funnelshift_lc(~0, 0, max(8 count - 32 k, 0))``."""
    r = np.concatenate([lo, hi]).astype(np.uint64)
    a = [r[k + 2] if shift & 8 else r[k] for k in range(6)]
    b = [a[k + 1] if shift & 4 else a[k] for k in range(5)]
    sb = np.uint64(8 * (shift & 3))
    out = np.array([((b[k] | (b[k + 1] << np.uint64(32))) >> sb) & np.uint64(0xFFFFFFFF)
                    for k in range(4)], np.uint64)
    if count < 16:
        for k in range(4):
            bits = min(max(8 * count - 32 * k, 0), 32)
            out[k] &= np.uint64((1 << bits) - 1)
    return out.astype(np.uint32)


@pytest.mark.parametrize("shift", range(16))
def test_model_extract_takes_the_blocks_bytes(shift):
    """Bytes shift .. shift + count - 1 of 32 random bytes, zero past count,
    for every count 0-16 at every shift of the first byte in its vector."""
    rng = np.random.default_rng(300 + shift)
    for count in range(17):
        raw = rng.integers(0, 256, 32, dtype=np.uint8)
        want = np.zeros(16, np.uint8)
        want[:count] = raw[shift: shift + count]
        words = raw.view("<u4")
        got = model_extract(words[:4], words[4:], shift, count)
        np.testing.assert_array_equal(got.astype("<u4").view(np.uint8), want)


# -- the order -------------------------------------------------------------------

def kernel_order(lengths, group: int) -> tuple:
    """The kernel's ranking in numpy: in each group, lane l takes strings
    j = group l + k, k < group, and counts its own strings of each block
    count as it goes (a string's rank among the lane's own); a scan over
    the lanes adds the lanes below; a string's place is its count's start
    (the strings of fewer blocks), plus the lanes below, plus its rank."""
    blocks = hash_kernel.short_blocks(lengths)
    size = 32 * group
    order, bounds = [], [0]
    for base in range(0, len(blocks), size):
        idx = base + np.arange(size).reshape(32, group)  # [lane, k]
        nb = np.where(idx < len(blocks), blocks[np.minimum(idx, len(blocks) - 1)], 0)
        own = np.zeros((32, 5), np.int64)
        rank = np.zeros((32, group), np.int64)
        for k in range(group):
            rank[:, k] = own[np.arange(32), nb[:, k]]
            own[np.arange(32), nb[:, k]] += 1
        below = np.cumsum(own, axis=0) - own  # the exclusive scan over lanes
        total = own.sum(axis=0)
        start = np.concatenate([[0, 0], np.cumsum(total[1:])])  # start[b] for b = 1..4
        at = np.empty(int(total[1:].sum()), np.int64)
        for lane in range(32):
            for k in range(group):
                b = nb[lane, k]
                if b:
                    at[start[b] + below[lane, b] + rank[lane, k]] = idx[lane, k]
        order.append(at)
        bounds.append(bounds[-1] + len(at))
    return (np.concatenate(order) if order else np.zeros(0, np.int64)), np.array(bounds)


def _lengths(seed, count):
    """Lengths 0-64 with some over 64 and some negative."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 65, count)
    lengths[rng.random(count) < 0.1] = 100
    lengths[rng.random(count) < 0.03] = -1
    return lengths


COUNTS = [1, 31, 32, 33, 255, 256, 257, 1000, 2 * 512 + 77]


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("count", COUNTS)
def test_short_order_is_each_groups_strings_once_by_block_count(group, count):
    lengths = _lengths(count * 31 + group, count)
    blocks = hash_kernel.short_blocks(lengths)
    order, bounds = hash_kernel.short_order(lengths, group)
    size = 32 * group
    assert len(bounds) == -(-count // size) + 1 and bounds[0] == 0 and bounds[-1] == len(order)
    hashed = np.nonzero(blocks)[0]
    np.testing.assert_array_equal(np.sort(order), hashed)  # every hashed string once
    assert ((lengths[order] >= 0) & (lengths[order] <= 64)).all()
    for g in range(len(bounds) - 1):
        mine = order[bounds[g]: bounds[g + 1]]
        assert ((mine >= g * size) & (mine < (g + 1) * size)).all()
        nb = blocks[mine]
        assert (np.diff(nb) >= 0).all()
        for b in range(1, 5):
            assert (np.diff(mine[nb == b]) > 0).all()  # a count's strings in index order


@pytest.mark.parametrize("group", [1, 4, 8, 16])
@pytest.mark.parametrize("count", [33, 257, 2 * 512 + 77])
def test_short_order_is_what_the_kernels_ranking_computes(group, count):
    lengths = _lengths(count + 5 * group, count)
    want = kernel_order(lengths, group)
    got = hash_kernel.short_order(lengths, group)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def log_words(lines: int, seed: int = 0) -> np.ndarray:
    """A log's word lengths: 9 a line, 8 of one block and the word across
    the line break (``path=/api/v1/<p>\\n<timestamp>``) of three."""
    rng = np.random.default_rng(seed)
    one = rng.integers(1, 17, (lines, 8))
    three = rng.integers(33, 49, (lines, 1))
    return np.concatenate([one, three], axis=1).reshape(-1)


@pytest.mark.parametrize("group,most", [(G, 1.25), (8, 1.1), (16, 1.1)])
def test_log_word_mix_runs_about_its_own_blocks(group, most):
    """Grouped, the rounds run close to the words' own blocks: at the
    kernel's G = 4 a group's four rounds are three of 1-block words and one
    across the 1- and the 3-block words, which runs 3 steps for all, 1.23x
    the words' blocks; from G = 8 on within 1.1x. A thread a string in
    index order (every warp of 32 holding a 3-block word) takes 2.4x."""
    lengths = log_words(20_000)
    own = int(hash_kernel.short_blocks(lengths).sum())
    assert hash_kernel.short_steps(lengths, group) <= most * own
    assert hash_kernel.short_steps(lengths, None) >= 2.4 * own


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_short_steps_counts_each_rounds_longest_string(group):
    lengths = _lengths(300 + group, 1000)
    blocks = hash_kernel.short_blocks(lengths)
    order, bounds = hash_kernel.short_order(lengths, group)
    want = sum(32 * int(blocks[order[r: min(r + 32, hi)]].max())
               for lo, hi in zip(bounds[:-1], bounds[1:]) for r in range(lo, hi, 32))
    assert hash_kernel.short_steps(lengths, group) == want
    assert hash_kernel.short_steps(lengths, group) >= 32 * -(-int(blocks.sum()) // 128)


@pytest.mark.parametrize("group", [1, 4, 8, 16])
def test_an_emulated_kernel_round_by_round_equals_the_plain_version(group):
    """Each group's rounds of 32 strings in the kernel's order, each round
    hashed by the plain version into an ``out`` of -7s: the same digests as
    the plain version over all strings; the skipped entries keep -7."""
    lengths = _lengths(400 + group, 3 * 32 * group + 77)
    rng = np.random.default_rng(500 + group)
    starts = np.cumsum(rng.integers(0, 4, len(lengths))) + np.concatenate(
        [[0], np.cumsum(np.maximum(lengths, 0))[:-1]])
    blob = torch.from_numpy(rng.integers(0, 256, int(starts[-1]) + 200, dtype=np.uint8))
    st, ln = torch.from_numpy(starts), torch.from_numpy(lengths)
    want = hash_kernel.hash_short_reference(blob, st, ln, 9,
                                            torch.full((len(lengths),), -7, dtype=torch.int64))
    got = torch.full((len(lengths),), -7, dtype=torch.int64)
    order, bounds = hash_kernel.short_order(lengths, group)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for r in range(lo, hi, 32):
            idx = torch.from_numpy(order[r: min(r + 32, hi)])
            got[idx] = hash_kernel.hash_short_reference(blob, st[idx], ln[idx], 9)
    assert torch.equal(got, want)
    skipped = (lengths < 0) | (lengths > 64)
    assert (got.numpy()[skipped] == -7).all()


# -- the route against the JAX package --------------------------------------------

def words_like(count: int, seed: int = 11) -> list:
    """``count`` strings of 0-64 bytes, most of one block as words are, a
    few of 2-4: at odd offsets once packed."""
    rng = np.random.default_rng(seed)
    lengths = np.where(rng.random(count) < 0.8, rng.integers(0, 17, count),
                       rng.integers(17, 65, count))
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in lengths]


ROUTE_ITEMS = words_like(3 * 32 * G + 77)


@pytest.fixture(scope="module")
def jax_route():
    return jax_hash_pallas.hash_batch_device(ROUTE_ITEMS, 2**63 + 9)


@pytest.mark.parametrize("part", ["all", "group edges"])
def test_hash_batch_device_matches_jax_on_words_like_strings(jax_route, part):
    """Exact against the JAX package; ``group edges``: the strings around
    each group boundary of 32 G, hashed as a batch of their own that ends
    one past a boundary."""
    if part == "all":
        got = hash_kernel.hash_batch_device(ROUTE_ITEMS, 2**63 + 9, device="cpu")
        assert len(ROUTE_ITEMS) % (32 * G) != 0
        np.testing.assert_array_equal(got, jax_route)
    else:
        cut = 2 * 32 * G + 1
        got = hash_kernel.hash_batch_device(ROUTE_ITEMS[:cut], 2**63 + 9, device="cpu")
        np.testing.assert_array_equal(got, jax_route[:cut])
    assert hash_kernel.KERNEL_LAUNCHES["hash_short"] == 0
