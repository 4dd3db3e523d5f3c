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
// What bounds it on this card. A cell is a chain of dependent int32 adds and
// min/max: 3 instructions (linear) to 6 (affine) with the DPX add-min/max
// __viaddmin_s32 / __viaddmax_s32 fusing an add into each min or max, plus
// the substitution and, when local, the clamp and the running best. Nothing
// but a candidate char and a strip hand-off comes from memory, so the
// kernel is bound by integer issue: 132 SMs x 64 int32 lanes a clock. That
// needs enough warps on every SM to cover each cell chain's latency.
//
// What the design does about it. The TPU kernel solved the in-column chain
// with a log-depth prefix scan and built class costs with MXU one-hot
// matmuls, because a TPU has no cheap scalar chain. Here a lane walks a
// strip of kStrip = 32 query rows down a column as a running value, the
// strip's D (and I when affine) in registers. Two routes place the strips;
// the host's plan (ops/similarity_dp.py dp_plan) picks one from the shapes
// and the SM count.
//
// * similarity_dp, a thread a pair: a thread marches each strip of its pair
//   across the candidate and hands the strip's bottom row (D, and Dd when
//   affine) to the next strip through a scratch row laid out [column][pair],
//   so the hand-off coalesces; threads run across candidates, so a step's
//   candidate loads coalesce and the class-table reads of a warp, which
//   shares the query row, broadcast or fall in distinct banks. In CTAs of
//   64 threads it fills the card only when there are many pairs (the
//   weighted lines: 262,144 pairs). The proteins' 8,192 pairs of ~1,000
//   chars make 2 warps an SM: each scheduler holds one warp or none, and
//   the cell chain's latency shows.
// * similarity_dp_warp, a warp a pair: lane l owns rows 32l + 1 .. 32l + 32
//   of a pass of 1,024 rows, and the lanes run one column apart: at step t
//   lane l computes column t - l + 1. The row above a lane's strip is lane
//   l - 1's bottom row of the step before, which arrives by __shfl_up_sync
//   (D, and Dd when affine); the diagonal is the one it received a step
//   earlier. Candidate chars go through a per-warp ring of 64 in shared
//   memory that the warp fills a chunk of 32 ahead (lane k loads char
//   t + k + 33), so lane l reads its char of step t at (t - l) mod 64 with
//   no bank conflict. A query of up to 1,024 chars takes one pass and no
//   hand-off; a longer one (rows up to 4,104) takes further passes, lane 31
//   handing its bottom row to the next pass's lane 0 through one scratch row
//   a pair, written and read in chunks of 32 through two more per-warp
//   rings, so no load sits on the chain. Occupancy: 16 warps a CTA, one
//   query and 16 candidates, at most 128 registers a thread, so one CTA (16
//   warps, 4 a scheduler) an SM; the 8,192 protein pairs are 512 CTAs.
//   Class costs: the lanes of a warp differ in query row and candidate
//   class, so tab[c * 33 + q] reads would conflict; instead the CTA builds
//   its query's profile P[lane][class][32 rows] (int32, a lane's slice
//   padded to 1,060 words) in shared memory once a pass, and a lane reads
//   its strip's 32 costs for the step's class as 8 16-byte loads. The pad
//   makes lane l's loads start in bank group (l + v) mod 8, so every
//   quarter-warp is conflict-free whatever the classes: 135,680 bytes for a
//   full pass plus 16 KiB of rings.
//
// Both routes stop a pair at its own clen, run no strip past qlen, and keep
// the JAX rule that a global pair whose qlen is not a row of the block
// scores the discard sentinel.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 32;    // query rows a lane keeps in registers
constexpr int kThreads = 64;  // candidates (threads) per block, thread route
constexpr int kLanes = 32;
constexpr int kPassRows = kLanes * kStrip;  // rows of one warp-route pass
constexpr int kWarps = 16;                  // candidates (warps) per block, warp route
constexpr int kRing = 64;                   // per-warp ring of candidate chars
constexpr int kBig = 1 << 28;               // discard sentinel of the JAX module (BIG)
constexpr int kClasses = 32;
constexpr int kPad = kClasses + 1;  // class 32 stands for "outside [0, 32)"
// A lane's slice of the warp route's query profile: [kPad classes][kStrip
// rows] and 4 words of pad, so lane l's 16-byte loads start in bank group
// (l + v) mod 8 (1060 / 4 = 265 = 1 mod 8).
constexpr int kProfileStride = kPad * kStrip + 4;
constexpr unsigned kFull = 0xffffffffu;

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

// opt(a + b, c) in one DPX instruction.
template <bool kMax>
__device__ __forceinline__ int add_opt(int a, int b, int c) {
  return kMax ? __viaddmax_s32(a, b, c) : __viaddmin_s32(a, b, c);
}

// opt(a + b, c), then opt with 0 when local (one instruction for max).
template <bool kMax, bool kLocal>
__device__ __forceinline__ int add_opt_cell(int a, int b, int c) {
  if (!kLocal) return add_opt<kMax>(a, b, c);
  return kMax ? __viaddmax_s32_relu(a, b, c) : min(__viaddmin_s32(a, b, c), 0);
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

// One cell of row k of a strip at column j: D and I hold the row's column
// j - 1 and receive column j; diag is D[k-1][j-1] (the row above's old D),
// up and dd are D[k-1][j] and Dd[k-1][j] on entry and this row's on exit.
template <bool kMax, bool kLocal, bool kAffine>
__device__ __forceinline__ void cell(int& D, int& I, int& diag, int& up, int& dd, int sub,
                                     const Costs& c) {
  const int old = D;
  int d;
  if (kAffine) {
    I = add_opt<kMax>(old, c.gap, I + c.extend);
    const int a = add_opt_cell<kMax, kLocal>(diag, sub, I);
    dd = add_opt<kMax>(up, c.gap, dd + c.extend);
    d = opt<kMax>(a, dd);
  } else {
    const int a = add_opt_cell<kMax, kLocal>(old, c.gap, diag + sub);
    d = add_opt<kMax>(up, c.gap, a);
  }
  D = d;
  diag = old;
  up = d;
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
        cell<kMax, kLocal, kAffine>(D[k], I[k], diag, up, dd, sub, costs);
        if (kLocal && k < valid) best = opt<kMax>(best, D[k]);
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

// One warp per (query, candidate) pair, a CTA per query and kWarps
// candidates: block b takes query q_begin + b / cand_blocks and candidates
// c_begin + (b % cand_blocks) * kWarps + warp. The scratch row of pair
// (q - q_begin) * c_count + (cand - c_begin) is scratch[pair * cand_len ..],
// (D, Dd) per column, read and written only when qlen > kPassRows.
template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__global__ void __launch_bounds__(kWarps * kLanes, 1)
similarity_dp_warp(const int32_t* __restrict__ q_ext_t, int rows,
                   const int32_t* __restrict__ qlens, int nq,
                   const int32_t* __restrict__ cands_t, const int32_t* __restrict__ clens,
                   int cand_len, int nc, int q_begin, int c_begin, int c_count, int cand_blocks,
                   int profile_lanes, const int32_t* __restrict__ table, Costs costs,
                   int2* __restrict__ scratch, int32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int profile_words = kClass ? profile_lanes * kProfileStride : 0;
  int32_t* profile = smem;  // [lane][class][row], kClass only
  int32_t* ring_c = smem + profile_words + warp * kRing;
  int2* ring_h = reinterpret_cast<int2*>(smem + profile_words + kWarps * kRing) + warp * kRing;
  int2* ring_o = reinterpret_cast<int2*>(smem + profile_words + 3 * kWarps * kRing) +
                 warp * kLanes;

  const int lq = blockIdx.x / cand_blocks;
  const int lc = (blockIdx.x % cand_blocks) * kWarps + warp;
  const bool live = lc < c_count;
  const int q = q_begin + lq;
  const int cand = c_begin + (live ? lc : 0);
  int32_t* result = out + static_cast<size_t>(q) * nc + cand;
  const int qlen = qlens[q];
  if (!kLocal && (qlen < 0 || qlen >= rows)) {  // the whole CTA: no barrier is skipped
    if (live && lane == 0) *result = kMax ? -kBig : kBig;
    return;
  }
  const int m = min(max(qlen, 0), rows - 1);
  const int n = live ? min(max(clens[cand], 0), cand_len) : 0;
  const int32_t* col = cands_t + cand;  // char j (1-based) at col[(j - 1) * nc]
  const int32_t* query = q_ext_t + q;   // query row i at query[i * nq]
  int2* hand = scratch + (static_cast<long long>(lq) * c_count + lc) * cand_len;

  // Candidate char j as the ring holds it: the class's offset in a lane's
  // profile slice, or the raw char.
  auto cand_char = [&](int j0) {  // 0-based
    if (j0 >= n) return 0;
    const int ch = col[static_cast<size_t>(j0) * nc];
    return kClass ? class_of(ch) * kStrip : ch;
  };

  const int passes = (m + kPassRows - 1) / kPassRows;
  int best = 0;
  bool holder = m == 0 && lane == 0;  // the lane that ends on D[m][n]
  int score = row0<kMax, kLocal, kAffine>(n, costs);
  for (int p = 0; p < passes; ++p) {
    const int base = p * kPassRows;  // rows above this pass
    const int lanes = min(kLanes, (m - base + kStrip - 1) / kStrip);
    const bool first = p == 0, last = p == passes - 1;
    if (kClass) {
      __syncthreads();  // the previous pass's reads of the profile are done
      for (int x = threadIdx.x; x < lanes * kProfileStride; x += blockDim.x) {
        const int l = x / kProfileStride, r = x % kProfileStride;
        const int cc = r / kStrip, row = base + l * kStrip + r % kStrip + 1;
        int v = 0;
        if (cc < kClasses && row <= m) {
          const int qc = query[static_cast<size_t>(row) * nq];
          if (static_cast<unsigned>(qc) < static_cast<unsigned>(kClasses))
            v = table[qc * kClasses + cc];
        }
        profile[x] = v;
      }
      __syncthreads();
    }
    if (!live) continue;

    const int top = base + lane * kStrip + 1;  // first query row of the lane's strip
    const int valid = max(0, min(kStrip, m - top + 1));
    int D[kStrip], I[kStrip], qv[kStrip];
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      if (!kClass) qv[k] = k < valid ? query[static_cast<size_t>(top + k) * nq] : 0;
      D[k] = boundary<kLocal, kAffine>(top + k, costs);
      if (kAffine) I[k] = gap_boundary<kLocal, kAffine>(top + k, costs);
    }
    const int32_t* lane_profile = profile + lane * kProfileStride;
    int up_prev = boundary<kLocal, kAffine>(top - 1, costs);
    int bot_d = 0, bot_dd = 0;  // this lane's bottom row (D, Dd) at its last column
    int c_pre = cand_char(lane);
    int2 h_pre = make_int2(0, 0);
    if (!first && lane < n) h_pre = hand[lane];

    const int steps = n + lanes - 1;
    for (int t = 0; t < steps; ++t) {
      if ((t & (kLanes - 1)) == 0) {  // chunk t / 32 into the rings, the next one loading
        ring_c[(t & (kRing - 1)) + lane] = c_pre;
        if (!first) ring_h[(t & (kRing - 1)) + lane] = h_pre;
        const int ahead = t + kLanes + lane;
        c_pre = cand_char(ahead);
        if (!first && ahead < n) h_pre = hand[ahead];
        __syncwarp();
      }
      const int up_s = __shfl_up_sync(kFull, bot_d, 1);
      const int dd_s = kAffine ? __shfl_up_sync(kFull, bot_dd, 1) : 0;
      const int j = t - lane + 1;
      if (j >= 1 && j <= n && lane < lanes) {
        const int at = (j - 1) & (kRing - 1);
        const int c = ring_c[at];
        int up = up_s, dd = dd_s;
        if (lane == 0) {
          if (first) {
            up = row0<kMax, kLocal, kAffine>(j, costs);
            dd = gap_boundary<kLocal, kAffine>(j, costs);
          } else {
            const int2 h = ring_h[at];
            up = h.x;
            dd = h.y;
          }
        }
        int diag = up_prev;
        up_prev = up;
        const int32_t* costs_of_c = lane_profile + c;
#pragma unroll
        for (int v = 0; v < kStrip / 4; ++v) {
          int4 s4 = make_int4(0, 0, 0, 0);
          if (kClass) s4 = *reinterpret_cast<const int4*>(costs_of_c + 4 * v);
          const int sub4[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 4 * v + i;
            const int sub = kClass ? sub4[i] : (qv[k] == c ? costs.match : costs.mismatch);
            cell<kMax, kLocal, kAffine>(D[k], I[k], diag, up, dd, sub, costs);
            if (kLocal && k < valid) best = opt<kMax>(best, D[k]);
          }
        }
        bot_d = up;
        bot_dd = dd;
        if (!last && lane == kLanes - 1) ring_o[(j - 1) & (kLanes - 1)] = make_int2(up, dd);
      }
      if (!last) {  // lane 31's column t - 30 ends a chunk: write it out
        const int j_out = t - (kLanes - 2);
        if (j_out >= 1 && j_out <= n && ((j_out & (kLanes - 1)) == 0 || j_out == n)) {
          __syncwarp();
          const int from = (j_out - 1) & ~(kLanes - 1);
          if (from + lane < j_out) hand[from + lane] = ring_o[lane];
          __syncwarp();
        }
      }
    }
    if (!kLocal && last && valid > 0 && top + valid - 1 == m) {
      holder = true;
#pragma unroll
      for (int k = 0; k < kStrip; ++k)
        if (k == valid - 1) score = D[k];
    }
  }
  if (!live) return;
  if (kLocal) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      best = opt<kMax>(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) *result = opt<kMax>(best, 0);
  } else if (holder) {
    *result = score;
  }
}

struct Launch {
  dim3 grid;
  cudaStream_t stream;
  const int32_t* q_ext_t;
  int rows;
  const int32_t* qlens;
  int nq;
  const int32_t* cands_t;
  const int32_t* clens;
  int cand_len, nc, q_begin, c_begin, c_count, cand_blocks;
  const int32_t* table;
  Costs costs;
  int32_t* scratch;
  int32_t* out;
};

template <bool kMax, bool kLocal, bool kAffine, bool kClass>
cudaError_t launch_thread(const Launch& a) {
  similarity_dp<kMax, kLocal, kAffine, kClass><<<a.grid, kThreads, 0, a.stream>>>(
      a.q_ext_t, a.rows, a.qlens, a.nq, a.cands_t, a.clens, a.cand_len, a.nc, a.q_begin,
      a.c_begin, a.c_count, a.cand_blocks, a.table, a.costs, a.scratch, a.out);
  return cudaGetLastError();
}

// Dynamic shared memory of the warp route: the profile of profile_lanes
// lanes (class costs only) and each warp's three rings.
size_t warp_smem_bytes(bool classes, int profile_lanes) {
  return sizeof(int32_t) * ((classes ? profile_lanes * kProfileStride : 0) +
                            kWarps * (kRing + 2 * kRing + 2 * kLanes));
}

template <bool kMax, bool kLocal, bool kAffine, bool kClass>
cudaError_t launch_warp(const Launch& a) {
  const int profile_lanes = std::min(kLanes, std::max(1, (a.rows - 1 + kStrip - 1) / kStrip));
  const size_t smem = warp_smem_bytes(kClass, profile_lanes);
  cudaError_t err = cudaFuncSetAttribute(similarity_dp_warp<kMax, kLocal, kAffine, kClass>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  similarity_dp_warp<kMax, kLocal, kAffine, kClass><<<a.grid, kWarps * kLanes, smem, a.stream>>>(
      a.q_ext_t, a.rows, a.qlens, a.nq, a.cands_t, a.clens, a.cand_len, a.nc, a.q_begin,
      a.c_begin, a.c_count, a.cand_blocks, profile_lanes, a.table, a.costs,
      reinterpret_cast<int2*>(a.scratch), a.out);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const Launch&);

// Indexed by max * 8 + local * 4 + affine * 2 + classes.
#define SZ_CONFIGS(fn)                                                                 \
  {fn<false, false, false, false>, fn<false, false, false, true>,                      \
   fn<false, false, true, false>,  fn<false, false, true, true>,                       \
   fn<false, true, false, false>,  fn<false, true, false, true>,                       \
   fn<false, true, true, false>,   fn<false, true, true, true>,                        \
   fn<true, false, false, false>,  fn<true, false, false, true>,                       \
   fn<true, false, true, false>,   fn<true, false, true, true>,                        \
   fn<true, true, false, false>,   fn<true, true, false, true>,                        \
   fn<true, true, true, false>,    fn<true, true, true, true>}
constexpr Launcher kThreadLaunchers[16] = SZ_CONFIGS(launch_thread);
constexpr Launcher kWarpLaunchers[16] = SZ_CONFIGS(launch_warp);
#undef SZ_CONFIGS

}  // namespace

// Scores of queries [q_begin, q_begin + q_count) against candidates
// [c_begin, c_begin + c_count) into out[nq][nc] (int32).
//   route    0: a thread a pair (similarity_dp), 1: a warp a pair
//            (similarity_dp_warp);
//   q_ext_t  [rows][nq] int32, row i holds query char i - 1 (row 0 unused);
//   qlens    [nq] int32; cands_t [cand_len][nc] int32; clens [nc] int32;
//   table    [32][32] int32 class costs (read only when classes != 0);
//   scratch  int32, (cand_len * q_count * c_count) words, twice that when
//            affine (the warp route: always twice); read and written only
//            when rows - 1 > 32 (thread route) or > 1024 (warp route).
// Launches on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_similarity(int route, int objective_max, int local, int affine,
                                     int classes, int gap, int extend, int match, int mismatch,
                                     const int32_t* q_ext_t, int rows, const int32_t* qlens,
                                     int nq, const int32_t* cands_t, const int32_t* clens,
                                     int cand_len, int nc, int q_begin, int q_count,
                                     int c_begin, int c_count, const int32_t* table,
                                     int32_t* scratch, int32_t* out, cudaStream_t stream) {
  if (q_count <= 0 || c_count <= 0) return cudaSuccess;
  if ((route != 0 && route != 1) || rows < 1 || cand_len < 0 || q_begin < 0 || c_begin < 0 ||
      q_begin + q_count > nq || c_begin + c_count > nc || (classes && table == nullptr))
    return cudaErrorInvalidValue;
  const int per_block = route ? kWarps : kThreads;
  const long long cand_blocks = (c_count + per_block - 1) / per_block;
  const long long blocks = cand_blocks * q_count;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const Launch a{dim3(static_cast<unsigned>(blocks)), stream, q_ext_t, rows, qlens, nq,
                 cands_t, clens, cand_len, nc, q_begin, c_begin, c_count,
                 static_cast<int>(cand_blocks), table, Costs{gap, extend, match, mismatch},
                 scratch, out};
  const int index = (objective_max ? 8 : 0) + (local ? 4 : 0) + (affine ? 2 : 0) +
                    (classes ? 1 : 0);
  return route ? kWarpLaunchers[index](a) : kThreadLaunchers[index](a);
}
