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
// The design. The tile's rows are cut into strips of H = 32 R rows (R rows
// a lane), one warp marching a strip across the w columns: lane l holds
// rows r0 + l R + q and at step t computes the cell of row offset o = l R +
// q at column t - o + 1, so a step holds R independent cells a lane. The
// cell above comes from the lane above through __shfl_up_sync (D0 and F,
// and D for the diagonal, when affine), the cell to the left is the row's
// own. Lane 31's last row, the strip's bottom row, goes each step into the
// warp's ring in shared memory (one 16-byte store: D0, D, F), a column a
// slot; the strip below reads the row above there, one slot a step for
// all its lanes. A CTA of W warps claims W consecutive strips at once, so
// strip s + 1 of the same CTA waits on strip s through shared flags: the
// writer publishes the last column it wrote at each chunk's end, the
// reader the last column it took at each chunk's start, which bounds how
// far the writer may run ahead in its ring. Only the claim's last strip
// hands on through device memory: at each chunk's end its lanes write the
// chunk's columns, one a lane, as tagged 64-bit slots (value and the
// writer's strip + 1 in one relaxed store; two rows of slots by the
// claim's parity), or as the tile's bottom row when its strip is the
// last. The claim's first strip takes the slots a chunk ahead into
// registers (the top row for strip 0) and stages them in a ring of its
// own. Columns before the block: slot 0 holds the bottom row's column
// col_base (the first row's diagonal), which lane 31 holds before its
// last row starts. Rows past the tile in a ragged last strip copy the row
// above, so its lane 31 carries the tile's bottom row like any strip's.
// Each strip reads its rows' left column when it starts and writes their
// last column when it ends, so the column is rewritten in place with no
// strip reading what another wrote. The masked form of a chunk (rows not
// begun or past column w) runs only at a strip's ends.
//
// A persistent grid of CTAs claims in order from a counter; a claim waits
// only on the claim before it, made earlier by a running CTA of the same
// launch, so the waits form no cycle and no launch ever waits on another
// launch, stream or device (several tiles may share one card). A wait on
// device memory backs off with __nanosleep, and every wait is bounded:
// past ~8 s it marks the caller's status 3, later waits give up, and the
// host raises; a warp that gives up stops its CTA's waits on shared flags
// too.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "dp_cells.cuh"

namespace {

constexpr int kRingRows = 4;    // rows a lane R: a strip is a warp of 32 R rows
constexpr int kRingWarps = 4;   // warps a CTA; it claims as many consecutive strips at once
constexpr int kRingChunk = 16;  // steps a strip takes from the strip above at once
constexpr int kRingSpan = 256;  // columns of a warp's ring of bottom-row values
constexpr int kRingStripRows = 32 * kRingRows;
constexpr int kRingProfileBytes = kClasses * kRingStripRows;  // a warp's: 32 classes x 32 R rows
static_assert(kRingRows % 4 == 0, "a lane's class profile packs its rows four to a word");
static_assert(kRingChunk < 32 && kRingStripRows % kRingChunk == 0,
              "lane C of the first chunk takes the corner; strips start on a chunk");
static_assert((kRingSpan & (kRingSpan - 1)) == 0 && kRingSpan % kRingChunk == 0 &&
                  kRingSpan >= 2 * kRingChunk,
              "a ring holds whole chunks, a power of two of columns, two chunks at least");

// A column of a strip's bottom row as the strip below takes it: D0, D and F
// when affine (the fourth int pads it to one 16-byte access), D when linear.
template <bool kAffine>
using RingSlot = std::conditional_t<kAffine, int4, int>;

// The CTA's flags, at the head of its shared memory.
struct RingFlags {
  int group;              // the CTA's claim: strips group W .. group W + W - 1
  int gave_up;            // a warp's wait gave up: the CTA stops
  int done[kRingWarps];   // warp i's ring holds its bottom row through this column
  int used[kRingWarps];   // warp i + 1 has taken warp i's ring through this column
};
constexpr size_t kRingFlagBytes = (sizeof(RingFlags) + 15) / 16 * 16;

// Shared memory of a CTA: the flags, W + 1 rings (warp 0's staged row above,
// then each warp's bottom row) and, with classes, each warp's profile.
constexpr size_t ring_shared_bytes(bool affine, bool classes) {
  return kRingFlagBytes + (kRingWarps + 1) * kRingSpan * (affine ? sizeof(int4) : sizeof(int)) +
         (classes ? static_cast<size_t>(kRingWarps) * kRingProfileBytes : 0);
}

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
  int* counter;          // claims made
  int* status;           // 3 once a wait stalled
  Costs costs;
  int rows, w, strips;
};

// A slot's D0, D and F, and a slot made of them (linear: D alone).
__device__ __forceinline__ int slot_u(const int4& v) { return v.x; }
__device__ __forceinline__ int slot_d(const int4& v) { return v.y; }
__device__ __forceinline__ int slot_f(const int4& v) { return v.z; }
__device__ __forceinline__ int slot_u(int v) { return v; }
__device__ __forceinline__ int slot_d(int v) { return v; }
__device__ __forceinline__ int slot_f(int) { return 0; }
__device__ __forceinline__ void put_slot(int4& slot, int u, int d, int f) {
  slot = make_int4(u, d, f, 0);
}
__device__ __forceinline__ void put_slot(int& slot, int, int d, int) { slot = d; }

__device__ __forceinline__ int load_flag(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_flag(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// Waits until the shared flag reaches `need` (the last value read kept in
// `seen`, so a flag already past it costs nothing); false if a warp of the
// CTA gave up meanwhile, or past kFlatWaitCycles, which marks `status`
// stalled. Every lane reads the same word and the same clock.
__device__ __forceinline__ bool ring_wait(const int* flag, int need, int& seen,
                                          const int* gave_up, int* status) {
  if (seen >= need) return true;
  const long long start = clock64();
  for (;;) {
    seen = load_flag(flag);
    if (seen >= need) break;
    if (load_flag(gave_up)) return false;
    if (clock64() - start > kFlatWaitCycles) {
      atomicExch(status, kStalled);
      return false;
    }
    __nanosleep(32);
  }
  __threadfence_block();  // what the flag covers is read after it
  return true;
}

// Strip s of the tile, run by warp `warp` of its CTA: rows r0 = H s ..
// min(rows, r0 + H) - 1 through the block's w columns. False when a wait
// gave up.
template <bool kMax, bool kLocal, bool kAffine, bool kClass>
__device__ bool ring_strip(const TileArgs& args, const int s, const int warp, RingFlags& flags,
                           RingSlot<kAffine>* const rings, unsigned char* const prof) {
  using Slot = RingSlot<kAffine>;
  constexpr int R = kRingRows, H = kRingStripRows, C = kRingChunk, S = kRingSpan;
  // Rows of slots a claim hands on: D0, D and F when affine; D alone when
  // linear (F is the row above's D plus the gap, and D0 is not needed).
  constexpr int kArrays = kAffine ? 3 : 1;
  constexpr bool kBest = kLocal && kMax;
  const Costs c = args.costs;
  const int w = args.w;
  const int lane = threadIdx.x & 31;
  const int r0 = s * H;
  const int rows = min(H, args.rows - r0);
  const int base = lane * R;   // this lane's first row offset
  const int rq = rows - base;  // its rows q < rq lie in the tile; the others copy the row above
  const int warp_base = warp * kRingProfileBytes;
  const signed char* const cost = reinterpret_cast<const signed char*>(prof);

  // The row above: warp 0 stages it in rings[0..S) from the top row (strip
  // 0) or the slots of the claim before; warp i > 0 reads warp i - 1's
  // ring. The bottom row: this warp's ring, which the next warp reads
  // (hands_on) or this warp writes out a chunk at a time: the tile's
  // bottom row (last) or the slots of the claim after. Column c lies in a
  // ring's slot (c - 1) & (S - 1).
  const bool last = s == args.strips - 1;
  const bool hands_on = !last && warp < kRingWarps - 1;
  const bool from_top = s == 0;
  const Slot* const above = rings + warp * S;
  Slot* const below = rings + (warp + 1) * S;
  const long long stride = w + 1LL;
  const int group = s / kRingWarps;
  const long long* const up = args.slots + ((group + 1) & 1) * kArrays * stride;
  long long* const down = args.slots + (group & 1) * kArrays * stride;
  const unsigned tag_in = s, tag_out = s + 1;

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

  // Warp 0: lane x < C of the chunk at step tau holds, for step tau + x, the
  // row above at column tau + x + 1; lane C of the first chunk its D at
  // column 0 of the block. Every warp: lane x < C holds the char of b
  // entering row r0 after step tau + x.
  long long wu = 0, wd = 0, wf = 0;  // slots from the claim before
  int tu = 0, tf = 0;                // the top row (strip 0)
  int b_next = 0;
  const auto load = [&](int tau) {
    const bool col0 = tau == 0 && lane == C;
    const int col = col0 ? 0 : tau + lane + 1;
    if ((lane >= C && !col0) || col > w) return;
    if (from_top) {
      tu = __ldg(args.top_d + col);
      if constexpr (kAffine) tf = __ldg(args.top_f + col);
    } else {
      if (!kAffine || !col0) wu = ring_load(up + col);
      if constexpr (kAffine) {
        wd = ring_load(up + stride + col);
        if (!col0) wf = ring_load(up + 2 * stride + col);
      }
    }
  };
  // Warp 0 at the chunk of step tau: waits until the loaded slots carry the
  // claim before's tag, then stages the chunk in its ring.
  const auto stage = [&](int tau) {
    const bool col0 = tau == 0 && lane == C;
    const bool need = (lane < C && tau + lane + 1 <= w) || col0;
    if (!from_top) {
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
    }
    if (need) {
      const int col = col0 ? 0 : tau + lane + 1;
      const int d = static_cast<int>(kAffine ? wd : wu);  // linear: row 0 of the slots is D
      put_slot(rings[(col - 1) & (S - 1)], from_top ? tu : static_cast<int>(wu),
               from_top ? tu : d, from_top ? tf : static_cast<int>(wf));
    }
    __syncwarp();
    return true;
  };
  if (lane < C) b_next = b_value(lane + 1, 0);
  if (warp == 0) load(0);
  int seen_done = INT_MIN, seen_used = -1;
  const int steps = (w + H - 1 + C - 1) / C * C;  // lane 31's last row reaches column w at step w + H - 2

  for (int tau = 0; tau < steps; tau += C) {
    const int hi = tau + C - H + 1;  // the last column of the bottom row this chunk writes
    if (warp > 0) {  // columns tau + 1 .. tau + C of warp - 1's ring
      if (tau > 0) {
        __threadfence_block();  // the columns through tau were read before
        if (lane == 0) store_flag(&flags.used[warp - 1], tau);
      }
      if (!ring_wait(&flags.done[warp - 1], min(tau + C, w), seen_done, &flags.gave_up,
                     args.status))
        return false;
    } else if (!stage(tau)) {
      return false;
    }
    // this chunk's slots of the ring held columns hi - S and before
    if (hands_on &&
        !ring_wait(&flags.used[warp], hi - S, seen_used, &flags.gave_up, args.status))
      return false;
    const int b_in = b_next;
    if (tau + C < steps) {
      if (lane < C) b_next = b_value(tau + C + lane + 1, 0);
      if (warp == 0) load(tau + C);
    }
    if (tau == 0) {
      const int corner = slot_d(above[S - 1]);  // column 0
      if (lane == 0) x2 = corner;
    }
    const Slot* const row_above = above + (tau & (S - 1));  // [u]: column tau + u + 1
    // lane 31's last row at step tau + u is column tau + u - H + 2
    Slot* const out_lo = below + ((tau - H) & (S - 1)) + 1;  // steps u < C - 1
    Slot* const out_hi = below + ((tau - H + C) & (S - 1));  // step C - 1

    // kInside: every cell of the chunk lies in the tile (every row has
    // begun and none has passed column w), so none is masked.
    const auto chunk = [&](auto inside) {
      constexpr bool kInside = decltype(inside)::value;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const Slot ab = row_above[u];
        int x1, xd, y1 = 0;
        if constexpr (kAffine) {
          const int x_lane = __shfl_up_sync(kFull, U[R - 1], 1);
          const int d_lane = __shfl_up_sync(kFull, D1[R - 1], 1);
          const int f_lane = __shfl_up_sync(kFull, F[R - 1], 1);
          x1 = lane == 0 ? slot_u(ab) : x_lane;
          xd = lane == 0 ? slot_d(ab) : d_lane;
          y1 = lane == 0 ? slot_f(ab) : f_lane;
        } else {
          const int x_lane = __shfl_up_sync(kFull, D1[R - 1], 1);
          x1 = xd = lane == 0 ? slot_d(ab) : x_lane;
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
            if (!kInside) {
              // a row before column 1 or past column w keeps its value; a
              // row past the tile copies the row above
              const bool real = q < rq;
              const bool live = real && static_cast<unsigned>(tl - q) < static_cast<unsigned>(w);
              v = live ? v : real ? left : q > 0 ? D1[q - 1] : xd;
              f_new = live ? f_new : real ? F[q] : up_f;
              d0 = live ? d0 : real ? U[q] : upper;
              i_new = live ? i_new : I[q];
              if (kBest && live) best = max(best, v);
            }
          } else {
            const int upper = q > 0 ? D1[q - 1] : x1;
            v = add_opt<kMax, kLocal>(opt<kMax>(left, upper), c.gap, diag + sub);
            if (!kInside) {
              const bool real = q < rq;
              const bool live = real && static_cast<unsigned>(tl - q) < static_cast<unsigned>(w);
              v = live ? v : real ? left : upper;
              if (kBest && live) best = max(best, v);
            }
          }
          if (kBest && kInside) best = max(best, v);
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
        if (lane == 31) {  // the bottom row's cell of this step
          Slot* const at = u < C - 1 ? out_lo + u : out_hi;
          if constexpr (kAffine)
            put_slot(*at, U[R - 1], D1[R - 1], F[R - 1]);
          else
            put_slot(*at, 0, D1[R - 1], 0);
        }
      }
    };
    if (rows == H && tau >= H - 1 && tau + C <= w)
      chunk(std::true_type{});
    else
      chunk(std::false_type{});

    if (hands_on) {
      if (lane == 31) {
        __threadfence_block();  // the chunk's columns before the flag
        store_flag(&flags.done[warp], hi);
      }
    } else {  // the chunk's columns out, one a lane
      __syncwarp();
      const int col = hi - C + 1 + lane;
      if (lane < C && col >= 0 && col <= w) {
        const Slot v = below[(col - 1) & (S - 1)];
        if (!last) {
          if constexpr (kAffine) {
            ring_store(down + col, flat_slot(tag_out, slot_u(v)));
            ring_store(down + stride + col, flat_slot(tag_out, slot_d(v)));
            ring_store(down + 2 * stride + col, flat_slot(tag_out, slot_f(v)));
          } else {
            ring_store(down + col, flat_slot(tag_out, slot_d(v)));
          }
        } else if (col > 0) {
          args.bottom_d[col] = slot_d(v);
          if constexpr (kAffine) args.bottom_f[col] = slot_f(v);
        }
      }
    }
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
  extern __shared__ __align__(16) unsigned char ring_shared[];
  using Slot = RingSlot<kAffine>;
  RingFlags& flags = *reinterpret_cast<RingFlags*>(ring_shared);
  Slot* const rings = reinterpret_cast<Slot*>(ring_shared + kRingFlagBytes);
  unsigned char* const prof = ring_shared + kRingFlagBytes +
                              (kRingWarps + 1) * kRingSpan * sizeof(Slot);  // classes only
  const int warp = threadIdx.x >> 5;
  const int groups = (args.strips + kRingWarps - 1) / kRingWarps;
  if (threadIdx.x == 0) flags.gave_up = 0;
  for (;;) {
    if (threadIdx.x == 0) flags.group = atomicAdd(args.counter, 1);
    if (threadIdx.x < kRingWarps) {
      flags.done[threadIdx.x] = INT_MIN;
      flags.used[threadIdx.x] = -1;
    }
    __syncthreads();
    const int s = flags.group * kRingWarps + warp;
    if (flags.group >= groups) return;
    if (s < args.strips &&
        !ring_strip<kMax, kLocal, kAffine, kClass>(args, s, warp, flags, rings, prof))
      store_flag(&flags.gave_up, 1);
    __syncthreads();  // the claim is done before the next one resets the flags
    if (flags.gave_up) return;
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
// lane (a strip is a warp of 32 of them a lane), warps a CTA (the strips a
// claim), steps a strip takes from the strip above at once.
extern "C" void sz_ring_geometry(int* out) {
  out[0] = kRingRows;
  out[1] = kRingWarps;
  out[2] = kRingChunk;
}

// Bytes of scratch a tile of `rows` x `w` needs: the claim counter's 8 and,
// past one claim's strips, two parities of w + 1 int64 slots of each row a
// claim hands on (D0, D and F when affine; D alone when linear).
extern "C" long long sz_ring_scratch_bytes(int rows, int w, int affine) {
  const long long arrays = affine ? 3 : 1;
  return 8 + (rows > kRingWarps * kRingStripRows ? 2 * arrays * (w + 1LL) * 8 : 0);
}

// One ring tile of `rows` rows and `w` columns in one launch of `ctas` CTAs
// of kRingWarps warps, added to *launches.
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
  if (fn == nullptr || rows < 1 || w < 1 || w > INT_MAX - 2 * kRingStripRows || ctas < 1 ||
      ((config & 1) && table == nullptr))
    return cudaErrorInvalidValue;
  const int strips = (rows + kRingStripRows - 1) / kRingStripRows;
  const long long needed = sz_ring_scratch_bytes(rows, w, (config & 2) != 0);
  if (scratch_bytes < needed) return cudaErrorInvalidValue;
  const size_t shared = ring_shared_bytes((config & 2) != 0, (config & 1) != 0);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(needed), stream);
  if (err != cudaSuccess) return err;
  char* base = static_cast<char*>(scratch);
  TileArgs args{a,        b,      table,  top_d,
                top_f,    bottom_d, bottom_f, left_d,
                left_e,   best,   reinterpret_cast<long long*>(base + 8),
                reinterpret_cast<int*>(base), status,
                Costs{gap, extend, match, mismatch}, rows, w, strips};
  void* params[] = {&args};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(ctas)), dim3(kRingWarps * 32), params,
                         shared, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}
