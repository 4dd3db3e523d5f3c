// One tile of the ring wavefront tier, hand-written for Hopper (sm_90a):
// ring_tile scores one entry's rows of one pair across one block of
// columns, for all 16 combinations of objective (min/max), locality
// (global/local), gaps (linear/affine) and substitution costs (uniform
// match/mismatch, or a 32x32 class table with ids clamped to [0, 31]).
//
// It replaces the tile function of stringzilla_tpu/parallel/ring.py
// (`tile`, a lax.scan over the block's columns, each column a log-step
// min/max scan over the chunk's rows), which no Pallas kernel stands
// behind. The recurrence is that function's, cell for cell, in int32:
//   E  = opt(E[i][j-1] + extend, D[i][j-1] + open)   (linear: D[i][j-1] + gap)
//   D0 = opt(D[i-1][j-1] + sub, E), then opt(D0, 0) when local
//   F  = opt(D0[i-1][j] + open, F[i-1][j] + extend)  (linear: D[i-1][j] + gap)
//   D  = opt(D0, F), then opt(D, 0) when local
// where the tile's first row takes the row above from the input (D and F
// handed on by the entry above, or the border for entry 0): its F is
// opt(top_D + open, top_F + extend). Inside the tile the F chain runs on
// D0, not on D: the JAX ring's chain, exact for Gotoh wherever reopening a
// gap never pays (min objective with open >= extend, max with open <=
// extend), and copied as it is elsewhere. For linear gaps F is the row
// above's D plus the gap, so a cell is the flat kernel's
// (wavefront.cu) with the row above and the column before given.
//
// Inputs and outputs of a launch, for a tile of `rows` rows and `w`
// columns starting at column col_base + 1 of the pair:
//   top_d, top_f   [w + 1] the row above: [0] the corner D[row_base][col_base],
//                  [c] column col_base + c;
//   left_d, left_e [rows] the column col_base (D and E); overwritten with the
//                  tile's last column, which the entry's next block reads;
//   bottom_d/_f    [w + 1] the tile's last row at [1..w], for the entry below;
//   best           max-objective local: raised to the tile's best cell
//                  (min-objective local scores 0, as the JAX ring gives).
// A global score is cell (m, n): the right column of the last block on the
// entry that holds row m.
//
// What bounds it on this card. As the flat kernel: 3 (linear) to 6
// (affine) int32 issue slots a cell with DPX fusing each add into its min
// or max, and a chain of rows + w anti-diagonals a tile, one after the
// other. A tile is one launch and waits on nothing outside it, so a block
// of w columns costs its entry rows + w chain steps: the host picks few,
// wide blocks (ops in parallel/ring.py).
//
// The design is the flat kernel's strips. The tile's rows are cut into
// strips of H = 32 R rows (R = 4 rows a lane), one warp marching a strip
// across the w columns: lane l holds rows r0 + l R + q and at step t
// computes the cell of row offset o = l R + q at column t - o + 1. The cell
// above comes from the lane above through __shfl_up_sync (D0 and F, and D
// for the diagonal, when affine), the cell to the left is the row's own.
// Strip 0 reads the row above from top_d/top_f, strip s > 0 from strip s -
// 1 through tagged 64-bit slots in device memory (value and the writer's
// strip + 1 in one relaxed store; two rows of slots by strip parity, and
// slot 0 holds the bottom row's column col_base, the first row's
// diagonal, written once the strip has its own first chunk). Each strip
// reads its rows' left column when it starts and writes their last column
// when it ends, so the column is rewritten in place with no strip reading
// what another wrote. A
// persistent grid of warps claims strips in order from a counter; a strip
// waits only on the strip above, claimed earlier by a running warp of the
// same launch, so the waits form no cycle and no launch ever waits on
// another launch, stream or device (several tiles may share one card). A
// wait backs off with __nanosleep and is bounded: past ~8 s it marks the
// caller's status 3, later waits give up, and the host raises.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "dp_cells.cuh"

namespace {

constexpr int kRingRows = 4;    // rows a lane R: a strip is a warp of 32 R rows
constexpr int kRingWarps = 4;   // warps a CTA
constexpr int kRingChunk = 16;  // steps a strip reads from the strip above at once
constexpr int kRingProfileBytes = kClasses * 32 * kRingRows;  // a warp's: 32 classes x 32 R rows

struct TileArgs {
  const int32_t* a;      // [rows] chars (class ids with classes) of the tile's rows
  const int32_t* b;      // [w] chars of the block's columns
  const int32_t* table;  // [32][32] class costs (classes only)
  const int32_t* top_d;  // [w + 1] D of the row above the tile; [0] the corner
  const int32_t* top_f;  // [w + 1] F of the row above (affine)
  int32_t* bottom_d;     // [w + 1] D of the tile's last row, written at [1..w]
  int32_t* bottom_f;     // [w + 1] its F (affine)
  int32_t* left_d;       // [rows] D of the column before the block, then of its last
  int32_t* left_e;       // [rows] E of it (affine)
  int32_t* best;         // the best cell (max-objective local)
  long long* slots;      // 2 parities x kArrays rows of (w + 1) hand-off slots
  int* counter;          // strips claimed
  int* status;           // 3 once a wait stalled
  Costs costs;
  int rows, w, strips;
};

// Strip s of the tile: rows r0 = 32 R s .. min(rows, r0 + 32 R) - 1 through
// the block's w columns. `prof` is the CTA's shared memory, `warp_base` the
// byte offset of this warp's class profile in it. False when a wait stalled.
template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__device__ bool ring_strip(const TileArgs& args, int s, unsigned char* prof, int warp_base) {
  constexpr int R = kRingRows, H = 32 * R, C = kRingChunk;
  // Rows of slots a strip hands on: D0, D and F when affine; D alone when
  // linear (F is the row above's D plus the gap, and D0 is not needed).
  constexpr int kArrays = kAffine ? 3 : 1;
  constexpr bool kBest = kLocal && kMax;
  const Costs c = args.costs;
  const int w = args.w;
  const int lane = threadIdx.x & 31;
  const int r0 = s * H;
  const int rows = min(H, args.rows - r0);
  const bool last = r0 + H >= args.rows;
  const int base = lane * R;   // this lane's first row offset
  const int rq = rows - base;  // its rows q < rq lie in the tile
  const long long stride = w + 1LL;
  long long* const up = args.slots + ((s + 1) & 1) * kArrays * stride;  // strip s - 1's rows
  long long* const down = args.slots + (s & 1) * kArrays * stride;
  // Row k of a parity's slots: 0 the value the row below chains on (D0, or
  // D when linear), 1 D (affine), 2 F (affine). Slot 0 of the D row holds
  // column col_base.
  constexpr int kD = kAffine ? 1 : 0;
  const unsigned tag_in = s, tag_out = s + 1;
  const signed char* const cost = reinterpret_cast<const signed char*>(prof);
  // The tile's last row: lane and row of this strip that hold it, if any.
  const int bottom_lane = last ? (args.rows - 1 - r0) / R : -1;
  const int bottom_q = (args.rows - 1 - r0) % R;

  const auto b_value = [&](int j, int l) {
    const int ch = j >= 0 && j < w ? __ldg(args.b + j) : kNoChar;
    return kClass ? warp_base + clamp_class(ch) * H + 4 * l : ch;
  };
  int bc[R], ac[kClass ? 1 : R], D1[R], D2[R];
  int I[kAffine ? R : 1], F[kAffine ? R : 1], U[kAffine ? R : 1];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = r0 + base + q;
    D1[q] = D2[q] = q < rq ? args.left_d[i] : 0;
    if constexpr (kAffine) {
      I[q] = q < rq ? args.left_e[i] : 0;
      F[q] = U[q] = 0;
    }
    if constexpr (!kClass) ac[q] = q < rq ? __ldg(args.a + i) : kNoChar;
    bc[q] = b_value(-(base + q), lane);
  }
  if constexpr (kClass)
    fill_profile<R>(prof, warp_base, args.a + r0 + base, rq, args.table, false);
  // The first row's diagonal at column 1: the row above's D at column
  // col_base (lanes l > 0: lane l - 1's last row; lane 0: from above, below).
  int x2 = __shfl_up_sync(kFull, D1[R - 1], 1);
  int best = 0;
  const bool sends = !last && lane == 31;  // the bottom row's lane

  // Lane x < C of the chunk at step tau holds, for step tau + x, the row
  // above at column tau + x + 1, and the char of b entering row r0 after
  // step tau + x; lane C of the first chunk holds the row above's D at
  // column 0 of the block.
  const bool reads = s > 0;
  long long wu = 0, wd = 0, wf = 0;  // slots from strip s - 1
  int tu = 0, tf = 0;                // the top row (strip 0)
  int b_next = 0;
  const auto load = [&](int tau) {
    const bool col0 = tau == 0 && lane == C;
    const int col = col0 ? 0 : tau + lane + 1;
    if ((lane >= C && !col0) || col > w) return;
    if (reads) {
      if (!kAffine || !col0) wu = ring_load(up + col);
      if constexpr (kAffine) {
        wd = ring_load(up + stride + col);
        if (!col0) wf = ring_load(up + 2 * stride + col);
      }
    } else {
      tu = __ldg(args.top_d + col);
      if constexpr (kAffine) tf = __ldg(args.top_f + col);
    }
  };
  const auto prefetch = [&](int tau) {
    if (lane < C) b_next = b_value(tau + lane + 1, 0);
    load(tau);
  };
  prefetch(0);
  const int steps = (w + rows - 1 + C - 1) / C * C;  // cell (r0 + rows - 1, w) is step w + rows - 2

  for (int tau = 0; tau < steps; tau += C) {
    int above_u, above_d, above_f = 0;
    if (reads) {
      const bool col0 = tau == 0 && lane == C;
      const bool need = (lane < C && tau + lane + 1 <= w) || col0;
      long long start = -1, looked = 0;
      unsigned nap = 0;
      const auto arrived = [&] {
        const auto tagged = [&](long long v) { return static_cast<unsigned>(v >> 32) == tag_in; };
        if (!kAffine) return tagged(wu);
        if (col0) return tagged(wd);
        return tagged(wu) && tagged(wd) && tagged(wf);
      };
      while (!__all_sync(kFull, !need || arrived())) {
        if (!flat_waiting(start, looked, nap, args.status)) return false;
        if (need) load(tau);
      }
      above_u = static_cast<int>(wu);
      above_d = static_cast<int>(kAffine ? wd : wu);
      above_f = static_cast<int>(wf);
    } else {
      above_u = above_d = tu;
      above_f = tf;
    }
    if (tau == 0) {
      const int corner = __shfl_sync(kFull, above_d, C);
      if (lane == 0) x2 = corner;
      // Slot 0 for the strip below: the bottom row's column col_base. Strip
      // s + 2 reuses these slots, so it writes only once it has the first
      // chunk from s + 1, which by then has read this parity's slot 0.
      if (sends) ring_store(down + kD * stride, flat_slot(tag_out, D1[R - 1]));
    }
    const int b_in = b_next;
    if (tau + C < steps) prefetch(tau + C);
    long long* const out = down + (tau - H + 2);  // the bottom row's column at step tau

    // kInside: every cell of the chunk lies in the tile (every row has
    // begun and none has passed column w), so none is masked.
    const auto chunk = [&](auto inside) {
      constexpr bool kInside = decltype(inside)::value;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int x_up = __shfl_sync(kFull, above_u, u);
        int x_lane;
        if constexpr (kAffine)
          x_lane = __shfl_up_sync(kFull, U[R - 1], 1);
        else
          x_lane = __shfl_up_sync(kFull, D1[R - 1], 1);
        const int x1 = lane == 0 ? x_up : x_lane;
        int xd = x1, y1 = 0;
        if constexpr (kAffine) {
          const int d_up = __shfl_sync(kFull, above_d, u);
          const int d_lane = __shfl_up_sync(kFull, D1[R - 1], 1);
          xd = lane == 0 ? d_up : d_lane;
          const int f_up = __shfl_sync(kFull, above_f, u);
          const int f_lane = __shfl_up_sync(kFull, F[R - 1], 1);
          y1 = lane == 0 ? f_up : f_lane;
        }
        const int tl = tau + u - base;  // step minus the lane's first row offset
#pragma unroll
        for (int q = R - 1; q >= 0; --q) {
          const int left = D1[q];
          const int diag = q > 0 ? D2[q - 1] : x2;
          int sub;
          if constexpr (kClass)
            sub = cost[bc[q] + (q / 4) * 128 + (q % 4)];
          else
            sub = ac[q] == bc[q] ? c.match : c.mismatch;
          int v, i_new = 0, f_new = 0, d0 = 0;
          if constexpr (kAffine) {
            const int upper = q > 0 ? U[q - 1] : x1;
            const int up_f = q > 0 ? F[q - 1] : y1;
            i_new = add_opt<kMax, false>(left, c.gap, I[q] + c.extend);
            f_new = add_opt<kMax, false>(upper, c.gap, up_f + c.extend);
            d0 = add_opt<kMax, kLocal>(diag, sub, i_new);
            v = opt<kMax>(d0, f_new);
          } else {
            const int upper = q > 0 ? D1[q - 1] : x1;
            v = add_opt<kMax, kLocal>(opt<kMax>(left, upper), c.gap, diag + sub);
          }
          const bool live =
              kInside || (q < rq && static_cast<unsigned>(tl - q) < static_cast<unsigned>(w));
          if (!kInside) {  // a row before column 1 or past column w keeps its value
            v = live ? v : left;
            if constexpr (kAffine) {
              i_new = live ? i_new : I[q];
              f_new = live ? f_new : F[q];
              d0 = live ? d0 : U[q];
            }
          }
          if (kBest && live) best = max(best, v);
          if (lane == bottom_lane && q == bottom_q && live) {  // the tile's last row
            args.bottom_d[tl - q + 1] = v;
            if constexpr (kAffine) args.bottom_f[tl - q + 1] = f_new;
          }
          D2[q] = left;
          D1[q] = v;
          if constexpr (kAffine) {
            I[q] = i_new;
            F[q] = f_new;
            U[q] = d0;
          }
        }
        x2 = xd;
        const int b_up = __shfl_sync(kFull, b_in, u);
        const int b_lane = __shfl_up_sync(kFull, bc[R - 1], 1);
#pragma unroll
        for (int q = R - 1; q > 0; --q) bc[q] = bc[q - 1];
        bc[0] = lane == 0 ? b_up : b_lane + (kClass ? 4 : 0);
        // the bottom row's cell of this step, column tau + u - H + 2
        const bool on =
            sends && (kInside || static_cast<unsigned>(tl - (R - 1)) < static_cast<unsigned>(w));
        if constexpr (kAffine) {
          ring_store(out + u, flat_slot(tag_out, U[R - 1]), on);
          ring_store(out + stride + u, flat_slot(tag_out, D1[R - 1]), on);
          ring_store(out + 2 * stride + u, flat_slot(tag_out, F[R - 1]), on);
        } else {
          ring_store(out + u, flat_slot(tag_out, D1[R - 1]), on);
        }
      }
    };
    if (rows == H && tau >= H - 1 && tau + C <= w)
      chunk(std::true_type{});
    else
      chunk(std::false_type{});
  }

  // The block's last column, in place of the column before it.
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (q < rq) {
      args.left_d[r0 + base + q] = D1[q];
      if constexpr (kAffine) args.left_e[r0 + base + q] = I[q];
    }
  }
  if (kBest) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) best = max(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) atomicMax(args.best, best);
  }
  return true;
}

template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__global__ void __launch_bounds__(kRingWarps * 32) ring_tile(TileArgs args) {
  extern __shared__ __align__(16) unsigned char ring_shared[];  // the warps' profiles (classes)
  const int warp_base = kClass ? (threadIdx.x >> 5) * kRingProfileBytes : 0;
  for (;;) {
    int k = 0;
    if ((threadIdx.x & 31) == 0) k = atomicAdd(args.counter, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= args.strips) return;
    if (!ring_strip<kMax, kLocal, kAffine, kClass>(args, k, ring_shared, warp_base)) return;
  }
}

#define SZ_RING(k)               \
  reinterpret_cast<const void*>( \
      ring_tile<((k) & 8) != 0, ((k) & 4) != 0, ((k) & 2) != 0, ((k) & 1) != 0>)

// The tile kernel of `config` (max * 8 + local * 4 + affine * 2 + classes),
// or null.
const void* ring_kernel(int config) {
  static const void* const kernels[16] = {
      SZ_RING(0),  SZ_RING(1),  SZ_RING(2),  SZ_RING(3),  SZ_RING(4),  SZ_RING(5),
      SZ_RING(6),  SZ_RING(7),  SZ_RING(8),  SZ_RING(9),  SZ_RING(10), SZ_RING(11),
      SZ_RING(12), SZ_RING(13), SZ_RING(14), SZ_RING(15)};
  return config >= 0 && config < 16 ? kernels[config] : nullptr;
}
#undef SZ_RING

}  // namespace

// ring_tile's geometry, which parallel/ring.py GEOMETRY mirrors: rows a
// lane (a strip is a warp of 32 of them a lane), warps a CTA, steps a strip
// reads from the strip above at once.
extern "C" void sz_ring_geometry(int* out) {
  out[0] = kRingRows;
  out[1] = kRingWarps;
  out[2] = kRingChunk;
}

// Bytes of scratch a tile of `rows` x `w` needs: the claim counter's 8 and,
// for two strips or more, two parities of w + 1 int64 slots of each row a
// strip hands on (D0, D and F when affine; D alone when linear).
extern "C" long long sz_ring_scratch_bytes(int rows, int w, int affine) {
  constexpr int H = 32 * kRingRows;
  const long long arrays = affine ? 3 : 1;
  return 8 + (rows > H ? 2 * arrays * (w + 1LL) * 8 : 0);
}

// One ring tile of `rows` rows and `w` columns in one launch of `ctas` CTAs
// of 4 warps, added to *launches.
//   config   max * 8 + local * 4 + affine * 2 + classes;
//   a, b     the tile's rows' and the block's int32 chars (class ids with
//            classes), rows, w >= 1;
//   table    [32][32] int32 class costs (read only with classes);
//   top_d/_f, bottom_d/_f, left_d/_e, best: as in the note at the head of
//            this file (the _f and _e arrays are read and written only when
//            affine, best only for max-objective local scores);
//   status   an int32 the caller zeroed: a stalled wait sets it to 3 and
//            every later wait that reads it gives up;
//   scratch  sz_ring_scratch_bytes of it, zeroed here.
// Launches on `stream` without synchronising.
extern "C" cudaError_t sz_ring_tile(int config, int gap, int extend, int match, int mismatch,
                                    const int32_t* a, int rows, const int32_t* b, int w,
                                    const int32_t* table, const int32_t* top_d,
                                    const int32_t* top_f, int32_t* bottom_d, int32_t* bottom_f,
                                    int32_t* left_d, int32_t* left_e, int32_t* best, int* status,
                                    void* scratch, long long scratch_bytes, int ctas,
                                    long long* launches, cudaStream_t stream) {
  const void* fn = ring_kernel(config);
  if (fn == nullptr || rows < 1 || w < 1 || w == INT_MAX || ctas < 1 ||
      ((config & 1) && table == nullptr))
    return cudaErrorInvalidValue;
  constexpr int H = 32 * kRingRows;
  const int strips = (rows + H - 1) / H;
  const long long needed = sz_ring_scratch_bytes(rows, w, (config & 2) != 0);
  if (scratch_bytes < needed) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(needed), stream);
  if (err != cudaSuccess) return err;
  char* base = static_cast<char*>(scratch);
  TileArgs args{a,        b,      table,  top_d,
                top_f,    bottom_d, bottom_f, left_d,
                left_e,   best,   reinterpret_cast<long long*>(base + 8),
                reinterpret_cast<int*>(base), status,
                Costs{gap, extend, match, mismatch}, rows, w, strips};
  void* params[] = {&args};
  const size_t shared = (config & 1) ? static_cast<size_t>(kRingWarps) * kRingProfileBytes : 0;
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(ctas)), dim3(kRingWarps * 32), params,
                         shared, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}
