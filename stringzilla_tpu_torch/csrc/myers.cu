// Myers/Hyyro bit-parallel unit-cost Levenshtein for every (query, candidate)
// pair of byte strings, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's two Pallas kernels:
//   * stringzilla_tpu/ops/myers_pallas.py::_kernel_unrolled (queries <= 256
//     chars)  -> myers_tier_a below;
//   * stringzilla_tpu/ops/myers_pallas.py::_kernel on bytes (queries of
//     257-4096 chars) -> myers_tier_b below.
// Both compute what the reference's levenshtein_distance_myers computes
// (serial.hpp:2163-2417): exact edit distances, 64 DP cells per word.
//
// What bounds it on this card. Per candidate char and per 64-bit word the
// recurrence is ~17 dependent 64-bit integer ops (an add with carry-out,
// ~12 logic ops, two shifts); the GPU issues each as two 32-bit ops, so a
// cell costs ~0.5 integer instruction and the kernel is bound by integer
// issue, not by memory: a pair reads one candidate char per step and the
// query's match table (PEQ) row of that char. So what counts is the work a
// step does that is no cell of the pair: words above the query's length,
// idle lanes, a warp's steps past a candidate's end, and the ballots that
// carry a word's bits to the next.
//
// What the design does about it. The TPU kernels packed 32 cells per int32
// lane and built each step's match mask with an MXU one-hot matmul; Hopper
// has native 64-bit registers and shared memory, so the match mask is one
// table read and every word holds 64 cells. Tier A keeps one pair per
// thread with its W <= 4 words in registers (fully unrolled, sequential
// carry); threads run across candidates, so the step's candidate reads
// coalesce and the query's PEQ (256 x W words, <= 8 KB) is loaded into
// shared memory once per block. Tier B runs each pair on the query's own
// words, W = ceil(m / 64), not the block's (carries and shifts only move
// upward, so the words above do nothing): a segment of S lanes a candidate,
// 32 / S candidates a warp, lane l holding the run of L = ceil(W / S)
// consecutive words lL .. lL + L - 1. A step ripples the add's carry and the
// one-bit shifts through a run in registers; across lanes, the runs'
// generate/propagate bits go by a ballot cut to the segment, resolved with
// one add, and the top bits of their last words by a second pair of
// ballots, so a step's four ballots serve L words. S is the host's pick
// (ops/myers.py tier_b_plan): 8, which wastes the fewest lanes and ballots,
// unless the launch would then leave the card short of warps (a block of
// few candidates), where 32 lanes, a warp a candidate, cut each lane's run
// to a quarter and give the card four times the warps. The candidates are taken in the order of their
// lengths (the host sorts them), so those of a warp end together; a lane
// past its own candidate's end keeps its state, and the steps below every
// candidate's end skip that select. The candidate chars come a chunk of S
// steps ahead (lane l of a segment loads char j0 + l, a step takes its char
// by one shuffle), and the PEQ words of the next step are read during this
// one, through L1 (a query's rows are read by its CTA's 8 warps; the chars
// a block uses are few rows of the table), so no step waits on a load
// chain. The kernel is built for the block's longest run (1, 2, 4 or 8
// words, from the host's words), so a block of short queries is not held to
// the registers of the longest.
//
// Runes (UTF-32, or any int32 values). The JAX kernel with alphabet=None
// builds each step's match mask by comparing the candidate rune with every
// query rune; a 2^21-row PEQ per query would not fit anywhere. Instead each
// query brings its K <= m distinct runes, sorted, and a PEQ of K x W words
// (the distinct-rune compression, built once a query block by the host:
// ops/myers.py rune_tables), and a candidate rune finds its row in one probe
// of a hash table of the query's runes in shared memory; a rune that is not
// there matches nothing. The recurrence is the byte route's; the kRunes =
// false instantiations are the byte route itself. Memory stays
// O(sum K_q * W_q), whatever the script.
//
// The rune table (ops/myers.py rune_table and rune_probe are its plain
// numpy version, the same hash, slot count and probe):
//   * layout: open addressing with linear probing, one 64-bit slot a rune,
//     its low word the rune's 32 bits and its high word its PEQ row. A
//     lookup is one 8-byte shared load and a compare where a binary search
//     over 256 (tier A) or 4,096 (tier B) sorted runes was up to 9 or 13
//     dependent loads, each behind a compare and two selects;
//   * slots: the power of two at least 128 * words (>= 2 K, since K <= m
//     <= 64 * words): the table is at most half full, and its size comes
//     from the block's words with no pull of K. Tier A holds <= 256 runes
//     in <= 512 slots (4 KB, static); tier B <= 4,096 in <= 8,192 (64 KB,
//     dynamic shared memory above 48 KB);
//   * hash: Fibonacci (multiplicative) on the rune's 32 bits, the top
//     log2(slots) bits of rune * 0x9E3779B9: runs of consecutive code points
//     (a script's block) and multiples of a power of two land spread out;
//   * empty slot: row -1 (all ones). Every int32 is a possible rune, so no
//     rune value can mark it; a rune -1 in an empty slot's low word still
//     misses, since the row says empty;
//   * build: each CTA's prologue, its threads inserting the query's sorted
//     runes with atomicCAS on the packed slot. Which rune of a cluster takes
//     which slot depends on the order, but the occupied slots and every
//     lookup's answer do not (linear probing with no deletions);
//   * probe bound: a lookup reads at most the length of its cluster (the
//     run of occupied slots it starts in) plus one slots. At half load with
//     keys that hash evenly the expected probe is ~1.5 slots for a rune that
//     is there and ~2.5 for one that is not (Knuth); runes chosen to share a
//     home slot make a cluster of up to K, a slower lookup and the same
//     answer (tests/test_torch_rune_table.py bounds the longest cluster on
//     CJK runs, multiples of the slot count and random runes).
// Tier A pipelines a pair's steps: step j runs the recurrence on char j's
// match words while it reads char j + 1's (its row found during step j - 1),
// probes for char j + 2's row and loads char j + 7 from memory, so no step
// waits on a load even where a block has too few pairs to hide latency by
// other warps (the engine's CJK blocks of 11-23 queries); a rune that is not
// there reads a zero row. Tier B looks each char up once, a chunk ahead:
// lane l of a segment probes for the char j0 + l it loads anyway, two chunks
// ahead, and a step takes its row by the one shuffle that carried the char.

// Exactness notes: all state is uint64_t (a signed >> would smear the
// cross-word top bit); a query char outside [0, 256) is never in the PEQ,
// and a candidate char outside it matches nothing; bits at or above the
// query length may hold garbage, which is harmless because carries and
// shifts only move upward and the final score masks them off:
//   D[m][n] = n + popcount(VP & mask) - popcount(VN & mask),  mask = [0, m).

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 256;
constexpr int kThreadsA = 256;  // tier A: one candidate per thread
constexpr int kWarpsB = 8;      // tier B: warps a CTA, fewer when the candidates are few
constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ uint64_t low_bits(int count) {  // count in [0, 64]
  return count >= 64 ? ~0ull : ((1ull << count) - 1ull);
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The rune table (see the header): log2 of the slots of a block of `words`
// words, the power of two at least 128 * words, and the slot that marks empty.
__host__ __device__ constexpr int table_bits(int words) {
  int bits = 7;
  while ((1 << bits) < 128 * words) ++bits;
  return bits;
}
constexpr unsigned long long kEmptySlot = ~0ull;  // row -1
constexpr uint32_t kFibonacci = 0x9E3779B9u;

__device__ __forceinline__ unsigned home_slot(int32_t c, int bits) {
  return (static_cast<uint32_t>(c) * kFibonacci) >> (32 - bits);
}

// Fills a table of 2^bits slots with the `count` runes keys[0 .. count),
// rune i on row i, by all the CTA's threads; ends with __syncthreads().
__device__ void build_table(unsigned long long* table, int bits, const int32_t* keys, int count) {
  const int slots = 1 << bits;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) table[i] = kEmptySlot;
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int32_t c = keys[i];
    const unsigned long long v =
        (static_cast<unsigned long long>(i) << 32) | static_cast<uint32_t>(c);
    unsigned h = home_slot(c, bits);
    while (atomicCAS(table + h, kEmptySlot, v) != kEmptySlot) h = (h + 1) & (slots - 1);
  }
  __syncthreads();
}

// The row of the slot s read at h for rune c, or -1 for a rune not in the
// table: s answers unless it holds another rune, then the probe goes on.
__device__ __forceinline__ int resolve_slot(const unsigned long long* table, int bits,
                                            int32_t c, unsigned h, unsigned long long s) {
  for (;;) {
    const int row = static_cast<int>(s >> 32);
    if (row < 0 || static_cast<uint32_t>(s) == static_cast<uint32_t>(c)) return row;
    h = (h + 1) & ((1u << bits) - 1u);
    s = table[h];
  }
}

__device__ __forceinline__ int find_row(const unsigned long long* table, int bits, int32_t c) {
  const unsigned h = home_slot(c, bits);
  return resolve_slot(table, bits, c, h, table[h]);
}

// One step of the recurrence on a pair's W words, eq_of(w) its char's match
// word w.
template <int W, typename Eq>
__device__ __forceinline__ void tier_a_step(uint64_t (&vp)[W], uint64_t (&vn)[W], Eq eq_of) {
  uint64_t carry = 0, ph_in = 1, mh_in = 0;  // word 0 takes D[0][j] = j
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t eq = eq_of(w);
    const uint64_t xv = eq | vn[w];
    const uint64_t t = eq & vp[w];
    const uint64_t s1 = t + vp[w];
    const uint64_t s = s1 + carry;
    carry = static_cast<uint64_t>((s1 < t) | (s < s1));
    const uint64_t xh = (s ^ vp[w]) | eq;
    const uint64_t ph = vn[w] | ~(xh | vp[w]);
    const uint64_t mh = vp[w] & xh;
    const uint64_t phs = (ph << 1) | ph_in;
    const uint64_t mhs = (mh << 1) | mh_in;
    ph_in = ph >> 63;
    mh_in = mh >> 63;
    vp[w] = mhs | ~(xv | phs);
    vn[w] = phs & xv;
  }
}

// One thread per (query, candidate); the query's W-word state in registers.
// Runes: keys/key_offs hold each query's sorted distinct runes (<= 256 here)
// and peq their rows; bytes: peq holds 256 rows per query.
template <int W, bool kRunes>
__global__ void __launch_bounds__(kThreadsA)
myers_tier_a(const int32_t* __restrict__ keys, const int32_t* __restrict__ key_offs,
             const uint64_t* __restrict__ peq, const int32_t* __restrict__ qlens,
             const int32_t* __restrict__ cands_t, const int32_t* __restrict__ clens,
             int cand_len, int nc, int cand_blocks, int32_t* __restrict__ out) {
  // runes: row kAlphabet stays zero, the row of a rune not in the query
  __shared__ uint64_t speq[(kAlphabet + (kRunes ? 1 : 0)) * W];
  constexpr int kBits = kRunes ? table_bits(W) : 0;
  __shared__ unsigned long long stable[kRunes ? 1 << kBits : 1];
  const int q = blockIdx.x / cand_blocks;
  const int cand = (blockIdx.x % cand_blocks) * kThreadsA + threadIdx.x;
  if constexpr (kRunes) {
    const int first = key_offs[q];
    // a query of <= 64 W chars has no more runes: the clamp keeps tables
    // that say otherwise inside speq and the table's half load (no endless probe)
    const int n_keys = clamp_int(key_offs[q + 1] - first, 0, 64 * W);
    const uint64_t* qpeq = peq + static_cast<size_t>(first) * W;
    for (int i = threadIdx.x; i < n_keys * W; i += kThreadsA) speq[i] = qpeq[i];
    if (threadIdx.x < W) speq[kAlphabet * W + threadIdx.x] = 0;
    build_table(stable, kBits, keys + first, n_keys);
  } else {
    const uint64_t* qpeq = peq + static_cast<size_t>(q) * kAlphabet * W;
    for (int i = threadIdx.x; i < kAlphabet * W; i += kThreadsA) speq[i] = qpeq[i];
    __syncthreads();
  }
  if (cand >= nc) return;

  const int m = clamp_int(qlens[q], 0, 64 * W);
  const int n = clamp_int(clens[cand], 0, cand_len);
  uint64_t vp[W], vn[W], mask[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    mask[w] = low_bits(clamp_int(m - 64 * w, 0, 64));
    vp[w] = mask[w];
    vn[w] = 0;
  }
  const int32_t* col = cands_t + cand;
  if constexpr (kRunes) {
    // A pipeline of four stages, so a step waits on no load: step j runs
    // the recurrence on char j's match words while it reads char j + 1's
    // (its row found a step before), probes for char j + 2's row, and loads
    // char j + 3 + kAhead from memory; a row of none is the zero row.
    constexpr int kAhead = 4;
    const auto char_at = [&](int j) { return j < n ? col[static_cast<size_t>(j) * nc] : 0; };
    const auto row_of = [](int r) { return static_cast<unsigned>(r < 0 ? kAlphabet : r); };
    int32_t ahead[kAhead];  // chars j + 3 .. j + 2 + kAhead
#pragma unroll
    for (int k = 0; k < kAhead; ++k) ahead[k] = char_at(3 + k);
    int32_t c2 = char_at(2);
    const unsigned row0 = row_of(find_row(stable, kBits, char_at(0)));
    unsigned row_next = row_of(find_row(stable, kBits, char_at(1)));
    uint64_t eq[W];
#pragma unroll
    for (int w = 0; w < W; ++w) eq[w] = speq[row0 * W + w];
    for (int j = 0; j < n; ++j) {
      uint64_t eq_next[W];
#pragma unroll
      for (int w = 0; w < W; ++w) eq_next[w] = speq[row_next * W + w];
      const unsigned h = home_slot(c2, kBits);
      const unsigned long long slot = stable[h];
      const int32_t far = char_at(j + 3 + kAhead);
      tier_a_step<W>(vp, vn, [&](int w) { return eq[w]; });
      row_next = row_of(resolve_slot(stable, kBits, c2, h, slot));
      c2 = ahead[0];
#pragma unroll
      for (int k = 0; k + 1 < kAhead; ++k) ahead[k] = ahead[k + 1];
      ahead[kAhead - 1] = far;
#pragma unroll
      for (int w = 0; w < W; ++w) eq[w] = eq_next[w];
    }
  } else {
    for (int j = 0; j < n; ++j) {
      // the match table's row of candidate char j, or an out-of-range row
      const unsigned c = static_cast<unsigned>(col[static_cast<size_t>(j) * nc]);
      tier_a_step<W>(vp, vn, [&](int w) { return c < kAlphabet ? speq[c * W + w] : 0ull; });
    }
  }
  int delta = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    delta += __popcll(vp[w] & mask[w]) - __popcll(vn[w] & mask[w]);
  out[static_cast<size_t>(q) * nc + cand] = n + delta;
}

// Tier B: each query's own W = ceil(m / 64) words in a segment of S lanes
// (8 or 32), lane l holding the run of L = ceil(W / S) consecutive words
// lL .. lL + L - 1; 32 / S candidates a warp, taken in the order `order`
// gives (by length, so that the candidates of a warp end together). A step
// ripples the add's carry and the one-bit shifts through a lane's run in
// registers; across lanes, the run's generate/propagate bits and its top
// word's top bits go by ballots cut to the segment.
template <int S, int L, bool kRunes>
__device__ void tier_b_run(const unsigned long long* table, int bits, int n_keys,
                           const uint64_t* __restrict__ qpeq,
                           int words, int m, int W, const int32_t* __restrict__ cands_t,
                           const int32_t* __restrict__ clens, const int32_t* __restrict__ order,
                           int cand_len, int nc, int slot0, int32_t* __restrict__ out) {
  constexpr unsigned kSegMask = S == 32 ? kFull : (1u << (S & 31)) - 1u;
  const int lane = threadIdx.x & 31;
  const int shift = lane & ~(S - 1);  // the segment's first lane
  const int sl = lane & (S - 1);       // this lane's place in it
  const int slot = slot0 + shift / S;
  const bool has = slot < nc;
  const int cand = has ? order[slot] : 0;
  const int n = has ? clamp_int(clens[cand], 0, cand_len) : 0;
  const int n_hi = __reduce_max_sync(kFull, n);
  const int n_lo = __reduce_min_sync(kFull, has ? n : n_hi);  // every candidate is live below it
  const int w0 = sl * L;
  uint64_t vp[L], vn[L], eq[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    vp[k] = low_bits(clamp_int(m - 64 * (w0 + k), 0, 64));
    vn[k] = 0;
  }
  // Candidate chars a chunk of S steps at a time, a chunk ahead: lane l
  // of a segment holds char j0 + l of its candidate; a step takes its char
  // by one shuffle, so the PEQ read never waits on a char load. Runes: the
  // lane holds the char's row instead, looked up once when the char arrives
  // (the chars come two chunks ahead, `far`), so a step shuffles a row; past
  // a candidate's end the char is 0 and its row U+0000's, which `live`
  // keeps from changing the state.
  const int32_t* col = cands_t + cand;
  const auto chars_at = [&](int j0) {
    const int j = j0 + sl;
    return j < n ? __ldg(col + static_cast<size_t>(j) * nc) : 0;
  };
  const auto row_of = [&](int c) {
    if constexpr (kRunes) return find_row(table, bits, c);
    else return c;
  };
  // The run's PEQ words of a row: a byte's, or a rune's (-1: a rune not in
  // the query matches nothing).
  const unsigned rows = kRunes ? static_cast<unsigned>(n_keys) : static_cast<unsigned>(kAlphabet);
  const auto load_eq = [&](int c, uint64_t* e) {
    const unsigned row = static_cast<unsigned>(c);
    const uint64_t* p = qpeq + static_cast<size_t>(row < rows ? row : 0) * words + w0;
#pragma unroll
    for (int k = 0; k < L; ++k) e[k] = row < rows && w0 + k < W ? __ldg(p + k) : 0ull;
  };
  int far = kRunes ? chars_at(2 * S) : 0;
  int cur = row_of(chars_at(0)), nxt = row_of(chars_at(S));
  load_eq(__shfl_sync(kFull, cur, shift), eq);

  // Step j with the match words eq; those of step j + 1 (char u + 1 of the
  // chunk) are read first. kTail: a candidate of the warp may have ended (j
  // >= n_lo), so each lane keeps its state past its own end.
  const auto step = [&](int u, int j, auto tail) {
    constexpr bool kTail = decltype(tail)::value;
    uint64_t next[L];
    load_eq(u + 1 < S ? __shfl_sync(kFull, cur, shift + u + 1) : __shfl_sync(kFull, nxt, shift),
            next);
    // The run's add (eq & vp) + vp with no carry in: each word's sum x, its
    // carry out g and whether it passes a carry on (p, the sum all ones);
    // the run generates (gen) or propagates (prop) a carry.
    uint64_t x[L];
    bool g[L], p[L];
    bool gen = false, prop = true;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t t = eq[k] & vp[k];
      x[k] = t + vp[k];
      g[k] = x[k] < t;
      p[k] = x[k] == ~0ull;
      gen = g[k] || (p[k] && gen);
      prop = prop && p[k];
    }
    // gen and prop are disjoint, so with a = gen | prop the sum a + gen has
    // exactly the runs' carries: bit l of cin is the carry into lane l's run
    // (the carry out of the top run is dropped).
    const unsigned gb = (__ballot_sync(kFull, gen) >> shift) & kSegMask;
    const unsigned pb = (__ballot_sync(kFull, prop) >> shift) & kSegMask;
    const unsigned a = gb | pb;
    bool carry = (((a + gb) ^ a ^ gb) >> sl) & 1u;
    uint64_t ph[L], mh[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t sum = x[k] + static_cast<uint64_t>(carry);
      carry = g[k] || (p[k] && carry);
      const uint64_t xh = (sum ^ vp[k]) | eq[k];
      ph[k] = vn[k] | ~(xh | vp[k]);
      mh[k] = vp[k] & xh;
    }
    // The one-bit shifts: in the run from word to word, into its first word
    // from the top word of the run below (word 0 takes D[0][j] = j).
    const unsigned pt = (__ballot_sync(kFull, ph[L - 1] >> 63) >> shift) & kSegMask;
    const unsigned mt = (__ballot_sync(kFull, mh[L - 1] >> 63) >> shift) & kSegMask;
    uint64_t ph_in = sl == 0 ? 1ull : (pt >> (sl - 1)) & 1u;
    uint64_t mh_in = sl == 0 ? 0ull : (mt >> (sl - 1)) & 1u;
    const bool live = !kTail || j < n;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint64_t xv = eq[k] | vn[k];
      const uint64_t phs = (ph[k] << 1) | ph_in;
      const uint64_t mhs = (mh[k] << 1) | mh_in;
      ph_in = ph[k] >> 63;
      mh_in = mh[k] >> 63;
      if (live) {
        vp[k] = mhs | ~(xv | phs);
        vn[k] = phs & xv;
      }
      eq[k] = next[k];
    }
  };
  for (int j0 = 0; j0 < n_hi; j0 += S) {
    if (j0 + S <= n_lo) {
#pragma unroll
      for (int u = 0; u < S; ++u) step(u, j0 + u, std::false_type{});
    } else {
#pragma unroll
      for (int u = 0; u < S; ++u)
        if (j0 + u < n_hi) step(u, j0 + u, std::true_type{});
    }
    cur = nxt;
    if constexpr (kRunes) {
      nxt = row_of(far);
      far = chars_at(j0 + 3 * S);
    } else {
      nxt = chars_at(j0 + 2 * S);
    }
  }
  int delta = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint64_t mask = low_bits(clamp_int(m - 64 * (w0 + k), 0, 64));
    delta += __popcll(vp[k] & mask) - __popcll(vn[k] & mask);
  }
#pragma unroll
  for (int offset = S / 2; offset > 0; offset >>= 1)
    delta += __shfl_xor_sync(kFull, delta, offset);
  if (sl == 0 && has) out[cand] = n + delta;
}

// A CTA of up to kWarpsB warps takes query q (blockIdx.x / cand_blocks)
// and 32 / S candidates a warp of those in `order`. kMaxRun is the longest
// run the block needs (the host's words / S, rounded up to 1, 2, 4 or 8), so
// that a block of short queries is not held to the registers of the longest
// run.
// Runes: the query's table in dynamic shared memory, 2^table_bits(words)
// slots (launch_b sizes it).
template <int S, int kMaxRun, bool kRunes>
__global__ void __launch_bounds__(32 * kWarpsB)
myers_tier_b(const int32_t* __restrict__ keys, const int32_t* __restrict__ key_offs,
             const uint64_t* __restrict__ peq, int words,
             const int32_t* __restrict__ qlens, const int32_t* __restrict__ cands_t,
             const int32_t* __restrict__ clens, const int32_t* __restrict__ order, int cand_len,
             int nc, int cand_blocks, int32_t* __restrict__ out) {
  extern __shared__ unsigned long long table[];
  const int q = blockIdx.x / cand_blocks;
  const int bits = kRunes ? table_bits(words) : 0;
  int n_keys = 0;
  const uint64_t* qpeq;
  if constexpr (kRunes) {
    const int first = key_offs[q];
    n_keys = clamp_int(key_offs[q + 1] - first, 0, 64 * words);  // as in tier A
    build_table(table, bits, keys + first, n_keys);  // ends in __syncthreads(), before any warp leaves
    qpeq = peq + static_cast<size_t>(first) * words;
  } else {
    qpeq = peq + static_cast<size_t>(q) * kAlphabet * words;
  }
  const int warps = blockDim.x >> 5;
  const int slot0 = ((blockIdx.x % cand_blocks) * warps + (threadIdx.x >> 5)) * (32 / S);
  if (slot0 >= nc) return;  // warp-uniform: the ballots below see full warps
  const int m = clamp_int(qlens[q], 0, 64 * words);
  const int W = max(1, (m + 63) / 64);  // the query's own words
  const int run = min((W + S - 1) / S, kMaxRun);
  int32_t* row = out + static_cast<size_t>(q) * nc;
#define SZ_TIER_B(L)                                                                             \
  tier_b_run<S, L, kRunes>(table, bits, n_keys, qpeq, words, m, W, cands_t, clens, order,        \
                           cand_len, nc, slot0, row)
  if constexpr (kMaxRun == 1) {
    SZ_TIER_B(1);
  } else if constexpr (kMaxRun == 2) {
    if (run == 1) SZ_TIER_B(1);
    else SZ_TIER_B(2);
  } else if constexpr (kMaxRun == 4) {
    switch (run) {
      case 1: SZ_TIER_B(1); break;
      case 2: SZ_TIER_B(2); break;
      case 3: SZ_TIER_B(3); break;
      default: SZ_TIER_B(4); break;
    }
  } else {
    switch (run) {
      case 1: SZ_TIER_B(1); break;
      case 2: SZ_TIER_B(2); break;
      case 3: SZ_TIER_B(3); break;
      case 4: SZ_TIER_B(4); break;
      case 5: SZ_TIER_B(5); break;
      case 6: SZ_TIER_B(6); break;
      case 7: SZ_TIER_B(7); break;
      default: SZ_TIER_B(8); break;
    }
  }
#undef SZ_TIER_B
}

// Tier B in segments of S lanes: CTAs of fewer warps where kWarpsB would
// leave SMs without a CTA (a block of few candidates), the kernel built for
// the block's longest run (S = 32 runs at most 2 words a lane).
template <int S, bool kRunes>
cudaError_t launch_b(const int32_t* keys, const int32_t* key_offs, const uint64_t* peq, int words,
                     const int32_t* qlens, int nq, const int32_t* cands_t, const int32_t* clens,
                     const int32_t* order, int cand_len, int nc, int32_t* out,
                     cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const auto ctas = [&](long long warps) {
    const long long per_cta = warps * (32 / S);
    return (nc + per_cta - 1) / per_cta * nq;
  };
  int warps = kWarpsB;
  while (warps > 1 && ctas(warps) < sms) warps /= 2;
  const long long cand_blocks = ctas(warps) / nq;
  const long long blocks = cand_blocks * nq;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const int cb = static_cast<int>(cand_blocks);
  const int max_run = (words + S - 1) / S;
  // runes: the table's 8-byte slots, past 48 KB only once allowed
  const int table_bytes = kRunes ? 8 << table_bits(words) : 0;
  const auto run_b = [&](auto kernel) {
    if (table_bytes > 48 * 1024) {
      const cudaError_t set = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, table_bytes);
      if (set != cudaSuccess) return set;
    }
    kernel<<<grid, 32 * warps, table_bytes, stream>>>(keys, key_offs, peq, words, qlens, cands_t,
                                                      clens, order, cand_len, nc, cb, out);
    return cudaGetLastError();
  };
  if (max_run <= 1) return run_b(myers_tier_b<S, 1, kRunes>);
  if constexpr (S == 32) {
    return run_b(myers_tier_b<S, 2, kRunes>);
  } else {
    if (max_run <= 2) return run_b(myers_tier_b<S, 2, kRunes>);
    if (max_run <= 4) return run_b(myers_tier_b<S, 4, kRunes>);
    return run_b(myers_tier_b<S, 8, kRunes>);
  }
}

template <bool kRunes>
cudaError_t launch(const int32_t* keys, const int32_t* key_offs, const uint64_t* peq, int words,
                   const int32_t* qlens, int nq, const int32_t* cands_t, const int32_t* clens,
                   const int32_t* order, int seg, int cand_len, int nc, int32_t* out,
                   cudaStream_t stream) {
  if (nq <= 0 || nc <= 0) return cudaSuccess;
  if (words < 1 || words > 64 || cand_len < 0) return cudaErrorInvalidValue;
  if (words <= 4) {
    const long long cand_blocks = (nc + kThreadsA - 1) / kThreadsA;
    const long long blocks = cand_blocks * nq;
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(blocks));
    const int cb = static_cast<int>(cand_blocks);
    switch (words) {
      case 1: myers_tier_a<1, kRunes><<<grid, kThreadsA, 0, stream>>>(keys, key_offs, peq, qlens, cands_t, clens, cand_len, nc, cb, out); break;
      case 2: myers_tier_a<2, kRunes><<<grid, kThreadsA, 0, stream>>>(keys, key_offs, peq, qlens, cands_t, clens, cand_len, nc, cb, out); break;
      case 3: myers_tier_a<3, kRunes><<<grid, kThreadsA, 0, stream>>>(keys, key_offs, peq, qlens, cands_t, clens, cand_len, nc, cb, out); break;
      default: myers_tier_a<4, kRunes><<<grid, kThreadsA, 0, stream>>>(keys, key_offs, peq, qlens, cands_t, clens, cand_len, nc, cb, out); break;
    }
    return cudaGetLastError();
  }
  if (order == nullptr) return cudaErrorInvalidValue;
  switch (seg) {
    case 8: return launch_b<8, kRunes>(keys, key_offs, peq, words, qlens, nq, cands_t, clens, order, cand_len, nc, out, stream);
    case 32: return launch_b<32, kRunes>(keys, key_offs, peq, words, qlens, nq, cands_t, clens, order, cand_len, nc, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All-pairs unit-cost edit distances of byte strings into out[nq][nc] (int32).
//   peq      [nq][256][words] uint64: bit i of word w of row c is set iff
//            query char 64 w + i equals c (built by the caller);
//   qlens    [nq] int32 query lengths (<= 64 * words);
//   cands_t  [cand_len][nc] int32 candidate chars, one candidate per column;
//   clens    [nc] int32 candidate lengths (<= cand_len);
//   order    [nc] int32, the candidates by length (tier B, words > 4, takes
//            them in this order, 32 / seg a warp; tier A reads nothing of it);
//   seg      tier B's lanes a candidate, 8 or 32 (ops/myers.py's
//            tier_b_plan; tier A reads nothing of it).
// Launches on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_myers(const uint64_t* peq, int words, const int32_t* qlens,
                                int nq, const int32_t* cands_t, const int32_t* clens,
                                const int32_t* order, int seg, int cand_len, int nc,
                                int32_t* out, cudaStream_t stream) {
  return launch<false>(nullptr, nullptr, peq, words, qlens, nq, cands_t, clens, order, seg,
                       cand_len, nc, out, stream);
}

// The same over runes (any int32 values):
//   keys      each query's distinct runes, ascending; query q's are
//             keys[key_offs[q] : key_offs[q + 1]], at most 64 * words of them;
//   key_offs  [nq + 1] int32;
//   peq       [key_offs[nq]][words] uint64: bit i of word w of row k is set iff
//             query char 64 w + i equals the rune keys[k];
// the rest as sz_myers.
extern "C" cudaError_t sz_myers_runes(const int32_t* keys, const int32_t* key_offs,
                                      const uint64_t* peq, int words, const int32_t* qlens,
                                      int nq, const int32_t* cands_t, const int32_t* clens,
                                      const int32_t* order, int seg, int cand_len, int nc,
                                      int32_t* out, cudaStream_t stream) {
  return launch<true>(keys, key_offs, peq, words, qlens, nq, cands_t, clens, order, seg, cand_len,
                      nc, out, stream);
}

extern "C" const char* sz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
