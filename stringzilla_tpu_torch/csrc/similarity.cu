// Column-DP similarity scores for every (query, candidate) pair, hand-written
// for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/similarity_pallas.py::_kernel_body: the exact int32
// score of the DP the reference's tile_scorer specialisations define
// (serial.hpp:853-1386), for all 16 combinations of objective (min/max),
// locality (global/local), gaps (linear/affine Gotoh) and substitution costs
// (uniform match/mismatch, or a 32x32 class table). The recurrence is
// transcribed from stringzilla_tpu/ops/similarity.py::_column_step_linear
// and ::_column_step_affine, row 0 and boundaries included:
//   boundary(k) = 0 (local), gap * k (linear), open + extend * (k - 1) for
//                 k > 0 (affine); gap_boundary(k) = boundary(k) + open + extend
//   column 0:     D[i] = boundary(i), I[i] = gap_boundary(i)
//   row 0:        D[0][j] = boundary(j) (linear),
//                 opt(boundary(j), gap_boundary(j)) (affine, j > 0)
//   linear cell:  a = opt(D[i][j-1] + gap, D[i-1][j-1] + sub) (opt 0 if local)
//                 D[i][j] = opt(a, D[i-1][j] + gap)
//   affine cell:  I = opt(D[i][j-1] + open, I[i][j-1] + extend)
//                 a = opt(D[i-1][j-1] + sub, I) (opt 0 if local)
//                 Dd = opt(D[i-1][j] + open, Dd[i-1][j] + extend), Dd[0][j] =
//                      gap_boundary(j)
//                 D[i][j] = opt(a, Dd)
// The JAX module writes the vertical chain as Dd[i] = opt(a[i-1] + open,
// Dd[i-1] + opt(open, extend)); with D[i-1] = opt(a[i-1], Dd[i-1]) and
// addition distributing over min and max the two are equal for every sign
// of the costs, so wrong-sign gaps give the JAX package's numbers.
// Global scores read D[qlen][clen]; local ones opt(0, D[i][j]) over rows
// 1..qlen and columns 1..clen. sub is match/mismatch on raw chars, or
// table[q class][c class] with 0 for a class outside [0, 32), as the JAX
// one-hot products give.
//
// What bounds it on this card. A cell is ~5 (linear) to ~12 (affine, local)
// dependent int32 adds, min/max and selects; nothing but the candidate char
// and the strip hand-off comes from memory. So it is bound by integer issue:
// 132 SMs x 64 int32 lanes a clock. The hand-off moves 8 or 16 bytes per
// pair per strip per column (2-4 bytes a cell over 32 rows), far below the
// 3.35 TB/s of HBM (the H100 SXM data sheet) at that issue rate.
//
// What the design does about it. The TPU kernel solved the in-column chain
// with a log-depth prefix scan and built class costs with MXU one-hot
// matmuls, because a TPU has no cheap scalar chain. Here one thread owns one
// pair and walks the chain as a running value: no scan, no matmul. Threads
// run across candidates, so a step's candidate loads coalesce and the
// threads of a warp share the query row, so class-table reads from shared
// memory broadcast or fall in distinct banks. A thread keeps a strip of
// kStrip query rows (D, and I when affine) and their query chars in
// registers, marches the strip across its candidate, and hands the strip's
// bottom row (D, and Dd when affine) to the next strip through a scratch
// row laid out [column][pair], so the hand-off coalesces too. A thread stops
// at its own clen, and strips past qlen are never run.
//
// Later work: DPX fused add-min/max (__viaddmin_s32) and the reference's
// tile-column march (cuda.cuh:708-749), which also fills the card when
// there are few pairs.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 32;    // query rows a thread keeps in registers
constexpr int kThreads = 64;  // candidates (threads) per block
constexpr int kBig = 1 << 28; // discard sentinel of the JAX module (BIG)
constexpr int kClasses = 32;
constexpr int kPad = kClasses + 1;  // class 32 stands for "outside [0, 32)"

struct Costs {
  int gap;       // linear: open_or_extend; affine: open
  int extend;    // affine only
  int match;     // uniform only
  int mismatch;  // uniform only
};

template <bool kMax>
__device__ __forceinline__ int opt(int a, int b) {
  return kMax ? max(a, b) : min(a, b);
}

template <bool kLocal, bool kAffine>
__device__ __forceinline__ int boundary(int k, const Costs& c) {
  if (kLocal) return 0;
  if (kAffine) return k > 0 ? c.gap + c.extend * (k - 1) : 0;
  return c.gap * k;
}

template <bool kLocal, bool kAffine>
__device__ __forceinline__ int gap_boundary(int k, const Costs& c) {
  return boundary<kLocal, kAffine>(k, c) + c.gap + c.extend;
}

// D[0][j]: the row above the first strip.
template <bool kMax, bool kLocal, bool kAffine>
__device__ __forceinline__ int row0(int j, const Costs& c) {
  const int b = boundary<kLocal, kAffine>(j, c);
  return (kAffine && j > 0) ? opt<kMax>(b, gap_boundary<kLocal, kAffine>(j, c)) : b;
}

__device__ __forceinline__ int class_of(int c) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(kClasses) ? c : kClasses;
}

// One thread per (query, candidate) pair of the launch's query and candidate
// ranges; pair = (q - q_begin) * c_count + (cand - c_begin).
template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__global__ void __launch_bounds__(kThreads)
similarity_dp(const int32_t* __restrict__ q_ext_t, int rows, const int32_t* __restrict__ qlens,
              int nq, const int32_t* __restrict__ cands_t, const int32_t* __restrict__ clens,
              int cand_len, int nc, int q_begin, int c_begin, int c_count, int cand_blocks,
              const int32_t* __restrict__ table, Costs costs, int32_t* __restrict__ scratch,
              int32_t* __restrict__ out) {
  // Transposed, padded table: tab[c_class * kPad + q_class]; row and column
  // kClasses are zeros. A warp shares q_class, so its reads hit distinct
  // banks (c_class + q_class) or broadcast.
  __shared__ int32_t tab[kClass ? kPad * kPad : 1];
  if (kClass) {
    for (int k = threadIdx.x; k < kPad * kPad; k += kThreads) {
      const int cc = k / kPad, qc = k % kPad;
      tab[k] = (cc < kClasses && qc < kClasses) ? table[qc * kClasses + cc] : 0;
    }
    __syncthreads();
  }
  const int lq = blockIdx.x / cand_blocks;
  const int lc = (blockIdx.x % cand_blocks) * kThreads + threadIdx.x;
  if (lc >= c_count) return;
  const int q = q_begin + lq;
  const int cand = c_begin + lc;
  const long long pairs = static_cast<long long>(gridDim.x / cand_blocks) * c_count;
  const long long pair = static_cast<long long>(lq) * c_count + lc;
  int32_t* result = out + static_cast<size_t>(q) * nc + cand;

  const int qlen = qlens[q];
  if (!kLocal && (qlen < 0 || qlen >= rows)) {  // no row qlen: the JAX masked reduce
    *result = kMax ? -kBig : kBig;
    return;
  }
  const int m = min(max(qlen, 0), rows - 1);
  const int n = min(max(clens[cand], 0), cand_len);
  const int32_t* col = cands_t + cand;  // char j (1-based) at col[(j - 1) * nc]
  const int32_t* query = q_ext_t + q;   // query row i at query[i * nq]
  int2* hand_off = reinterpret_cast<int2*>(scratch);  // affine: (D, Dd)
  int32_t* hand_off_d = scratch;                      // linear: D

  const int strips = (m + kStrip - 1) / kStrip;
  int best = 0;
  int score = row0<kMax, kLocal, kAffine>(n, costs);  // global score when m == 0
  for (int s = 0; s < strips; ++s) {
    const int top = 1 + s * kStrip;       // first query row of the strip
    const int valid = min(kStrip, m - top + 1);
    const bool first = s == 0, last = s == strips - 1;
    int qv[kStrip], D[kStrip], I[kStrip];
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const int ch = k < valid ? query[static_cast<size_t>(top + k) * nq] : 0;
      qv[k] = kClass ? class_of(ch) : ch;
      D[k] = boundary<kLocal, kAffine>(top + k, costs);
      if (kAffine) I[k] = gap_boundary<kLocal, kAffine>(top + k, costs);
    }
    // D of the row above the strip at the previous column (column 0 first).
    int up_prev = boundary<kLocal, kAffine>(top - 1, costs);
    // One-step prefetch of the candidate char and of the hand-off.
    int c_next = n > 0 ? col[0] : 0;
    int2 h_next = make_int2(0, 0);
    if (!first && n > 0) {
      if (kAffine) h_next = hand_off[pair];
      else h_next.x = hand_off_d[pair];
    }
    for (int j = 1; j <= n; ++j) {
      const int c = c_next;
      int up, dd;  // D and Dd of the row above the strip at column j
      if (first) {
        up = row0<kMax, kLocal, kAffine>(j, costs);
        dd = gap_boundary<kLocal, kAffine>(j, costs);
      } else {
        up = h_next.x;
        dd = h_next.y;
      }
      if (j < n) {
        c_next = col[static_cast<size_t>(j) * nc];
        if (!first) {
          const size_t at = static_cast<size_t>(j) * pairs + pair;
          if (kAffine) h_next = hand_off[at];
          else h_next.x = hand_off_d[at];
        }
      }
      const int32_t* tc = kClass ? tab + class_of(c) * kPad : nullptr;
      int diag = up_prev;
      up_prev = up;
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        const int sub = kClass ? tc[qv[k]] : (qv[k] == c ? costs.match : costs.mismatch);
        const int old = D[k];
        int a;
        if (kAffine) {
          I[k] = opt<kMax>(old + costs.gap, I[k] + costs.extend);
          a = opt<kMax>(diag + sub, I[k]);
        } else {
          a = opt<kMax>(old + costs.gap, diag + sub);
        }
        if (kLocal) a = opt<kMax>(a, 0);
        int d;
        if (kAffine) {
          dd = opt<kMax>(up + costs.gap, dd + costs.extend);
          d = opt<kMax>(a, dd);
        } else {
          d = opt<kMax>(a, up + costs.gap);
        }
        if (kLocal && k < valid) best = opt<kMax>(best, d);
        D[k] = d;
        diag = old;
        up = d;
      }
      if (!last) {
        const size_t at = static_cast<size_t>(j - 1) * pairs + pair;
        if (kAffine) hand_off[at] = make_int2(up, dd);
        else hand_off_d[at] = up;
      }
    }
    if (!kLocal && last) {
#pragma unroll
      for (int k = 0; k < kStrip; ++k)
        if (k == m - top) score = D[k];
    }
  }
  *result = kLocal ? opt<kMax>(best, 0) : score;
}

template <bool kMax, bool kLocal, bool kAffine, bool kClass>
void launch(dim3 grid, cudaStream_t stream, const int32_t* q_ext_t, int rows,
            const int32_t* qlens, int nq, const int32_t* cands_t, const int32_t* clens,
            int cand_len, int nc, int q_begin, int c_begin, int c_count, int cand_blocks,
            const int32_t* table, Costs costs, int32_t* scratch, int32_t* out) {
  similarity_dp<kMax, kLocal, kAffine, kClass><<<grid, kThreads, 0, stream>>>(
      q_ext_t, rows, qlens, nq, cands_t, clens, cand_len, nc, q_begin, c_begin, c_count,
      cand_blocks, table, costs, scratch, out);
}

using Launcher = void (*)(dim3, cudaStream_t, const int32_t*, int, const int32_t*, int,
                          const int32_t*, const int32_t*, int, int, int, int, int, int,
                          const int32_t*, Costs, int32_t*, int32_t*);

// Indexed by max * 8 + local * 4 + affine * 2 + classes.
constexpr Launcher kLaunchers[16] = {
    launch<false, false, false, false>, launch<false, false, false, true>,
    launch<false, false, true, false>,  launch<false, false, true, true>,
    launch<false, true, false, false>,  launch<false, true, false, true>,
    launch<false, true, true, false>,   launch<false, true, true, true>,
    launch<true, false, false, false>,  launch<true, false, false, true>,
    launch<true, false, true, false>,   launch<true, false, true, true>,
    launch<true, true, false, false>,   launch<true, true, false, true>,
    launch<true, true, true, false>,    launch<true, true, true, true>,
};

}  // namespace

// Scores of queries [q_begin, q_begin + q_count) against candidates
// [c_begin, c_begin + c_count) into out[nq][nc] (int32).
//   q_ext_t  [rows][nq] int32, row i holds query char i - 1 (row 0 unused);
//   qlens    [nq] int32; cands_t [cand_len][nc] int32; clens [nc] int32;
//   table    [32][32] int32 class costs (read only when classes != 0);
//   scratch  int32, (cand_len * q_count * c_count) words, twice that when
//            affine; read and written only when rows - 1 > 32.
// Launches on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_similarity(int objective_max, int local, int affine, int classes,
                                     int gap, int extend, int match, int mismatch,
                                     const int32_t* q_ext_t, int rows, const int32_t* qlens,
                                     int nq, const int32_t* cands_t, const int32_t* clens,
                                     int cand_len, int nc, int q_begin, int q_count,
                                     int c_begin, int c_count, const int32_t* table,
                                     int32_t* scratch, int32_t* out, cudaStream_t stream) {
  if (q_count <= 0 || c_count <= 0) return cudaSuccess;
  if (rows < 1 || cand_len < 0 || q_begin < 0 || c_begin < 0 || q_begin + q_count > nq ||
      c_begin + c_count > nc || (classes && table == nullptr))
    return cudaErrorInvalidValue;
  const long long cand_blocks = (c_count + kThreads - 1) / kThreads;
  const long long blocks = cand_blocks * q_count;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const Costs costs{gap, extend, match, mismatch};
  const int index = (objective_max ? 8 : 0) + (local ? 4 : 0) + (affine ? 2 : 0) +
                    (classes ? 1 : 0);
  kLaunchers[index](dim3(static_cast<unsigned>(blocks)), stream, q_ext_t, rows, qlens, nq,
                    cands_t, clens, cand_len, nc, q_begin, c_begin, c_count,
                    static_cast<int>(cand_blocks), table, costs, scratch, out);
  return cudaGetLastError();
}
