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
// issue, not by memory: a pair reads one candidate byte per step (int32,
// coalesced across threads) and W words of the query's match table (PEQ).
// The PEQ read is the one random access per step: tier A serves it from
// shared memory (256 x W words, <= 8 KB per query), tier B from L1/L2
// (up to 128 KB per query, read as W consecutive words per warp).
//
// What the design does about it. The TPU kernels packed 32 cells per int32
// lane and built each step's match mask with an MXU one-hot matmul; Hopper
// has native 64-bit registers and shared memory, so the match mask is one
// table read and every word holds 64 cells. Tier A keeps one pair per
// thread with its W <= 4 words in registers (fully unrolled, sequential
// carry); threads run across candidates, so the step's candidate reads
// coalesce and the query's PEQ is loaded once per block. Tier B keeps one
// pair per warp, lane l holding words l and l + 32: the add's carry crosses
// lanes as a 64-bit generate/propagate ballot resolved with one add, and the
// one-bit shift between words is a ballot of top bits.
//
// Runes (UTF-32, or any int32 values). The JAX kernel with alphabet=None
// builds each step's match mask by comparing the candidate rune with every
// query rune; a 2^21-row PEQ per query would not fit anywhere. Instead each
// query brings its K <= m distinct runes, sorted, and a PEQ of K x W words
// (the distinct-rune compression): a candidate rune finds its row by binary
// search over the query's runes in shared memory (<= 256 for tier A, <= 4096
// for tier B), and a rune that is not there matches nothing. The recurrence
// is the byte route's; the kRunes = false instantiations are the byte route
// itself. Memory stays O(sum K_q * W_q), whatever the script.
//
// Exactness notes: all state is uint64_t (a signed >> would smear the
// cross-word top bit); a query char outside [0, 256) is never in the PEQ,
// and a candidate char outside it matches nothing; bits at or above the
// query length may hold garbage, which is harmless because carries and
// shifts only move upward and the final score masks them off:
//   D[m][n] = n + popcount(VP & mask) - popcount(VN & mask),  mask = [0, m).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 256;
constexpr int kThreadsA = 256;  // tier A: one candidate per thread
constexpr int kWarpsB = 8;      // tier B: one candidate per warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRunesB = 64 * 64;  // tier B: a query's distinct runes, <= 4096

__device__ __forceinline__ uint64_t low_bits(int count) {  // count in [0, 64]
  return count >= 64 ? ~0ull : ((1ull << count) - 1ull);
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Row of rune c among a query's `count` sorted distinct runes, or -1.
__device__ __forceinline__ int find_rune(const int32_t* keys, int count, int32_t c) {
  int lo = 0;
  for (int n = count; n > 0;) {
    const int half = n >> 1;
    const bool right = keys[lo + half] < c;
    lo = right ? lo + half + 1 : lo;
    n = right ? n - half - 1 : half;
  }
  return (lo < count && keys[lo] == c) ? lo : -1;
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
  __shared__ uint64_t speq[kAlphabet * W];
  __shared__ int32_t skeys[kRunes ? kAlphabet : 1];
  const int q = blockIdx.x / cand_blocks;
  const int cand = (blockIdx.x % cand_blocks) * kThreadsA + threadIdx.x;
  int n_keys = 0;
  if constexpr (kRunes) {
    const int first = key_offs[q];
    n_keys = key_offs[q + 1] - first;
    const uint64_t* qpeq = peq + static_cast<size_t>(first) * W;
    for (int i = threadIdx.x; i < n_keys; i += kThreadsA) skeys[i] = keys[first + i];
    for (int i = threadIdx.x; i < n_keys * W; i += kThreadsA) speq[i] = qpeq[i];
  } else {
    const uint64_t* qpeq = peq + static_cast<size_t>(q) * kAlphabet * W;
    for (int i = threadIdx.x; i < kAlphabet * W; i += kThreadsA) speq[i] = qpeq[i];
  }
  __syncthreads();
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
  for (int j = 0; j < n; ++j) {
    // the match table's row of candidate char j, or an out-of-range row
    unsigned c;
    if constexpr (kRunes) {
      const int row = find_rune(skeys, n_keys, col[static_cast<size_t>(j) * nc]);
      c = row < 0 ? ~0u : static_cast<unsigned>(row);
    } else {
      c = static_cast<unsigned>(col[static_cast<size_t>(j) * nc]);
    }
    uint64_t carry = 0, ph_in = 1, mh_in = 0;  // word 0 takes D[0][j] = j
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t eq = c < kAlphabet ? speq[c * W + w] : 0ull;
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
  int delta = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    delta += __popcll(vp[w] & mask[w]) - __popcll(vn[w] & mask[w]);
  out[static_cast<size_t>(q) * nc + cand] = n + delta;
}

// One warp per (query, candidate); lane l holds words l + 32 k, k < K.
// Runes as in tier A, with the query's sorted runes (<= 4096) in shared
// memory and its K_q x words PEQ rows read from global memory.
template <int K, bool kRunes>
__global__ void __launch_bounds__(32 * kWarpsB)
myers_tier_b(const int32_t* __restrict__ keys, const int32_t* __restrict__ key_offs,
             const uint64_t* __restrict__ peq, int words,
             const int32_t* __restrict__ qlens, const int32_t* __restrict__ cands_t,
             const int32_t* __restrict__ clens, int cand_len, int nc,
             int cand_blocks, int32_t* __restrict__ out) {
  __shared__ int32_t skeys[kRunes ? kMaxRunesB : 1];
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x / cand_blocks;
  const int cand = (blockIdx.x % cand_blocks) * kWarpsB + (threadIdx.x >> 5);
  int n_keys = 0;
  const uint64_t* qpeq;
  if constexpr (kRunes) {
    const int first = key_offs[q];
    n_keys = key_offs[q + 1] - first;
    for (int i = threadIdx.x; i < n_keys; i += 32 * kWarpsB) skeys[i] = keys[first + i];
    __syncthreads();  // before any warp leaves
    qpeq = peq + static_cast<size_t>(first) * words;
  } else {
    qpeq = peq + static_cast<size_t>(q) * kAlphabet * words;
  }
  if (cand >= nc) return;  // warp-uniform: the ballots below see full warps

  const int m = clamp_int(qlens[q], 0, 64 * words);
  const int n = clamp_int(clens[cand], 0, cand_len);
  uint64_t vp[K], vn[K], mask[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    mask[k] = low_bits(clamp_int(m - 64 * (lane + 32 * k), 0, 64));
    vp[k] = mask[k];
    vn[k] = 0;
  }
  const int32_t* col = cands_t + cand;
  for (int j = 0; j < n; ++j) {
    // the match table's row of candidate char j, or an out-of-range row;
    // a rune's search is the same for every lane, so its reads broadcast
    unsigned c;
    if constexpr (kRunes) {
      const int row = find_rune(skeys, n_keys, col[static_cast<size_t>(j) * nc]);
      c = row < 0 ? ~0u : static_cast<unsigned>(row);
    } else {
      c = static_cast<unsigned>(col[static_cast<size_t>(j) * nc]);
    }
    uint64_t eq[K], s1[K];
    uint64_t gen = 0, prop = 0;  // bit w: word w generates / propagates a carry
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      eq[k] = ((kRunes ? c < static_cast<unsigned>(n_keys) : c < kAlphabet) && w < words)
                  ? qpeq[static_cast<size_t>(c) * words + w] : 0ull;
      const uint64_t t = eq[k] & vp[k];
      s1[k] = t + vp[k];
      gen |= static_cast<uint64_t>(__ballot_sync(kFull, s1[k] < t)) << (32 * k);
      prop |= static_cast<uint64_t>(__ballot_sync(kFull, s1[k] == ~0ull)) << (32 * k);
    }
    // gen and prop are disjoint, so with a = gen | prop the sum a + gen has
    // exactly the word carries of the multiword add: bit w of cin is the
    // carry into word w (the carry out of the top word is dropped).
    const uint64_t a = gen | prop;
    const uint64_t cin = (a + gen) ^ a ^ gen;
    uint64_t xv[K], ph[K], mh[K];
    uint64_t ph_top = 0, mh_top = 0;  // bit w: top bit of word w
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      const uint64_t s = s1[k] + ((cin >> w) & 1ull);
      xv[k] = eq[k] | vn[k];
      const uint64_t xh = (s ^ vp[k]) | eq[k];
      ph[k] = vn[k] | ~(xh | vp[k]);
      mh[k] = vp[k] & xh;
      ph_top |= static_cast<uint64_t>(__ballot_sync(kFull, ph[k] >> 63)) << (32 * k);
      mh_top |= static_cast<uint64_t>(__ballot_sync(kFull, mh[k] >> 63)) << (32 * k);
    }
    const uint64_t ph_in = (ph_top << 1) | 1ull;  // word 0 takes D[0][j] = j
    const uint64_t mh_in = mh_top << 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      const uint64_t phs = (ph[k] << 1) | ((ph_in >> w) & 1ull);
      const uint64_t mhs = (mh[k] << 1) | ((mh_in >> w) & 1ull);
      vp[k] = mhs | ~(xv[k] | phs);
      vn[k] = phs & xv[k];
    }
  }
  int delta = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    delta += __popcll(vp[k] & mask[k]) - __popcll(vn[k] & mask[k]);
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    delta += __shfl_xor_sync(kFull, delta, offset);
  if (lane == 0) out[static_cast<size_t>(q) * nc + cand] = n + delta;
}

template <bool kRunes>
cudaError_t launch(const int32_t* keys, const int32_t* key_offs, const uint64_t* peq, int words,
                   const int32_t* qlens, int nq, const int32_t* cands_t, const int32_t* clens,
                   int cand_len, int nc, int32_t* out, cudaStream_t stream) {
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
  } else {
    const long long cand_blocks = (nc + kWarpsB - 1) / kWarpsB;
    const long long blocks = cand_blocks * nq;
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(blocks));
    const int cb = static_cast<int>(cand_blocks);
    if (words <= 32)
      myers_tier_b<1, kRunes><<<grid, 32 * kWarpsB, 0, stream>>>(keys, key_offs, peq, words, qlens, cands_t, clens, cand_len, nc, cb, out);
    else
      myers_tier_b<2, kRunes><<<grid, 32 * kWarpsB, 0, stream>>>(keys, key_offs, peq, words, qlens, cands_t, clens, cand_len, nc, cb, out);
  }
  return cudaGetLastError();
}

}  // namespace

// All-pairs unit-cost edit distances of byte strings into out[nq][nc] (int32).
//   peq      [nq][256][words] uint64: bit i of word w of row c is set iff
//            query char 64 w + i equals c (built by the caller);
//   qlens    [nq] int32 query lengths (<= 64 * words);
//   cands_t  [cand_len][nc] int32 candidate chars, one candidate per column;
//   clens    [nc] int32 candidate lengths (<= cand_len).
// Launches on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_myers(const uint64_t* peq, int words, const int32_t* qlens,
                                int nq, const int32_t* cands_t, const int32_t* clens,
                                int cand_len, int nc, int32_t* out, cudaStream_t stream) {
  return launch<false>(nullptr, nullptr, peq, words, qlens, nq, cands_t, clens, cand_len, nc,
                       out, stream);
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
                                      int cand_len, int nc, int32_t* out, cudaStream_t stream) {
  return launch<true>(keys, key_offs, peq, words, qlens, nq, cands_t, clens, cand_len, nc, out,
                      stream);
}

extern "C" const char* sz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
