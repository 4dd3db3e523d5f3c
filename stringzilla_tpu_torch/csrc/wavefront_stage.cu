// One ladder stage of the meet-in-the-middle wavefront, hand-written for
// Hopper (sm_90a): wavefront_stage.
//
// It replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/wavefront_pallas.py:243 _stage_kernel. A stage advances
// one sweep's two latest anti-diagonals (D[d0-1], D[d0-2]) through the steps
// d in [d0, d1) and returns (D[d1-1], D[d1-2]). Diagonal d holds the cells
// (i, d - i) at index i in [0, m]; the recurrence is the JAX kernel's, for
// uniform match/mismatch costs, linear gaps and the min objective, in int32:
//   a cell outside max(d - n, 0) <= i <= min(d, m) holds BIG = 1 << 28;
//   i = 0 (when d <= n) and i = d (when d <= m) hold gap * d;
//   any other cell: min(D[d-1][i] + gap, D[d-1][i-1] + gap,
//                       D[d-2][i-1] + (a[i-1] == b[d-1-i] ? match : mismatch)).
// A stage of zero steps returns its initial state, one of one step returns
// D[d0-1] as its second diagonal.
//
// What bounds it on this card. A cell is about 5 int32 operations, so the
// two sweeps of a 180,000 x 180,000 call are 5 * m * n operations against
// 132 SMs x 64 int32 lanes a clock (9.7 ms); the strings and diagonals are
// O(m + n) bytes. Only one anti-diagonal is independent at a time, so what
// a design must avoid is a wait across the card at every step: the first
// design of this kernel ended each step in a grid barrier and spent 2.7 us
// a step on it, 51x the bound.
//
// The design: a pipeline of row strips with one-way hand-offs and no grid
// barrier. The host's plan (ops/wavefront.py stage_plan) cuts the rows that
// are live at some step of the stage, [max(d0 - n, 0), min(d1 - 1, m)], into
// strips of 32 * R rows aligned at row 0, a warp each, R the fewest rows a
// lane that spreads them over every SM (4 warps a CTA, one a scheduler);
// rows outside every strip are dead for the whole stage and are written BIG
// by every thread before the strips start (stages of 0 and 1 steps copy the
// input instead). Lane l owns the R consecutive rows s0 + l * R + k and
// keeps their D[d-1] and D[d-2] in registers; at step d it computes the
// cell (i, d - i) of each: R independent cells of 5 instructions, the min
// of the two gap moves and the add-min with the diagonal one fused by the
// DPX instruction __viaddmin_s32. A row's neighbour above comes from lane
// l - 1 through one __shfl_up_sync a step (D[d-2][i-1] is that lane's
// D[d-1] of the step before), and b's chars pass down the lanes as a shift
// register, as the TPU kernel's T did: the char a row uses at step d is the
// one the row above used at d - 1. Cells outside the matrix's live band are
// computed from whatever they hold and never read by a live one (a live
// cell reads only live cells), so a strip runs the recurrence everywhere
// and masks its outputs to BIG where dead. Two cells need setting: row 0,
// set in the strip holding it, and the diagonal edge D[d][d] = gap * d,
// which the recurrence itself gives from the second step on when the dead
// cells above the diagonal start at a large enough value (see
// edges_by_recurrence); a stage whose costs leave no int32 room for that
// sets it wherever it lies, with two more instructions a cell while the
// edge crosses a strip, which then holds back every strip below it.
//
// A strip waits only on the strip above it, for that strip's last row. The
// last lane of each strip writes its bottom row's value of each step into a
// ring of 64 tagged slots (value and step in one 64-bit store, so no fence):
// in shared memory when the strip below is a warp of the same CTA, in device
// memory when it heads the next CTA. The strip below reads a chunk of C
// steps at once (lane c holds step tau + c - 1; C = 16 up to R = 16, 8
// above, where 16 spills registers: chunk_of), one chunk ahead of its use,
// checks the tags with one vote and reports what it consumed; the producer
// looks at that count before it overwrites a slot, so the ring bounds how
// far ahead it runs, with no cycle of waits. A chunk's steps are unrolled
// with no exit test and no store guard but in a stage's first and last
// chunks. Strips start together at d0, so the last of s strips starts about
// s * (C + a hop) steps behind the first: the plan keeps strips tall and the
// kernel records that fill (the first and last times a strip began its
// steps). A cooperative launch (checked against the occupancy API) keeps
// every waited-on strip resident. Rows beyond what the resident warps hold
// run in waves: a warp takes its strip of wave w + 1 only once every strip
// of wave w has finished (a count in device memory), and the last strip of
// wave w leaves its whole bottom row, a slot a step, in one of two columns
// of device memory for the first of wave w + 1. Every wait is bounded: one
// that spins past ~2 s sets the status word to 3, every other wait then
// gives up, and the host raises.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSweeps = 2;
constexpr int kWarps = 4;      // warps a CTA, one a scheduler of an SM
constexpr int kRing = 64;      // slots of a hand-off ring, then its consumed count
constexpr int kBig = 1 << 28;  // the JAX kernel's identity
constexpr int kNoChar = -1;    // a char past a string's end: only dead cells compare it
constexpr long long kWaitCycles = 1LL << 32;  // ~2 s at 1.98 GHz
constexpr int kStalled = 3;
constexpr int kSweepFields = 10, kPlanHead = 6, kPlanSweep = 6;

// Steps a strip reads from the strip above at once: 16 up to R = 16; wider
// strips spill registers at 16 and take 8.
__host__ __device__ constexpr int chunk_of(int rows_per_lane) { return rows_per_lane <= 16 ? 16 : 8; }

struct Sweep {
  const int32_t* a;    // [m]
  const int32_t* b;    // [n]
  const int32_t* in1;  // D[d0 - 1], [m + 1]
  const int32_t* in2;  // D[d0 - 2], [m + 1]
  int32_t* out1;       // D[d1 - 1], [m + 1]
  int32_t* out2;       // D[d1 - 2], [m + 1]
  int m, n, d0, d1;
  int above;  // what cells above the diagonal start at, or 0 (see edges_by_recurrence)
  int first_strip, strips;  // strip s0 = (first_strip + s) * 32 * R, s < strips
  int first_cta, ctas;
  unsigned* finished;  // strips of the sweep finished
  unsigned long long* starts;  // [2]: ~first and last time a wave-0 strip began its steps
  long long* rings;    // [ctas][kRing + 1]: ring c feeds CTA c's first warp
  long long* columns;  // [2][d1 - d0] slots: a wave's last bottom row; null in one wave
};

struct Stage {
  Sweep sweep[kMaxSweeps];
  int count, match, mismatch, gap;
  int* status;
};

// What a strip reads from the strip above, or writes for the one below:
// slots of (value, step + 1) in a ring (shared or device memory, with the
// count of steps its reader has consumed) or in a wave column (one slot a
// step), or nothing.
struct Link {
  volatile long long* slots;
  int mask;  // kRing - 1 for a ring, -1 for a column
  volatile long long* consumed;
};

__device__ __forceinline__ int char_at(const int32_t* s, int len, int j) {
  return j >= 0 && j < len ? __ldg(s + j) : kNoChar;
}

// One more round of a bounded wait, decided by lane 0 for the whole warp:
// false once this wait has spun past kWaitCycles (it marks the stage
// stalled) or another warp has marked it.
__device__ __forceinline__ bool still_waiting(long long& start, int* status) {
  int go = 1;
  if ((threadIdx.x & 31) == 0) {
    const long long now = clock64();
    if (start < 0) start = now;
    if (*reinterpret_cast<volatile int*>(status) != 0) {
      go = 0;
    } else if (now - start > kWaitCycles) {
      atomicExch(status, kStalled);
      go = 0;
    }
  }
  return __shfl_sync(kFull, go, 0) != 0;
}

// Waits until `count` reaches `target` (the strips of the earlier waves).
__device__ bool wait_count(const unsigned* count, unsigned target, int* status) {
  long long start = -1;
  for (;;) {
    unsigned seen = 0;
    if ((threadIdx.x & 31) == 0) seen = *reinterpret_cast<const volatile unsigned*>(count);
    if (__shfl_sync(kFull, seen, 0) >= target) break;
    if (!still_waiting(start, status)) return false;
  }
  __threadfence();
  return true;
}

// Rows no strip holds: BIG, or the input for stages of 0 and 1 steps.
__device__ void fill_rest(const Stage& st, int R) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll
  for (int k = 0; k < kMaxSweeps; ++k) {
    if (k >= st.count) break;
    const Sweep& sw = st.sweep[k];
    const int steps = sw.d1 - sw.d0;
    const long long len = sw.m + 1LL;
    if (steps <= 1) {
      for (long long i = first; i < len; i += stride) {
        if (steps == 0) sw.out1[i] = sw.in1[i];
        sw.out2[i] = steps == 0 ? sw.in2[i] : sw.in1[i];
      }
      if (steps == 0) continue;
    }
    long long r0 = len, r1 = len;  // the strips' rows
    if (sw.strips > 0) {
      r0 = static_cast<long long>(sw.first_strip) * 32 * R;
      r1 = min(len, static_cast<long long>(sw.first_strip + sw.strips) * 32 * R);
    }
    for (long long i = first; i < r0; i += stride) {
      sw.out1[i] = kBig;
      if (steps >= 2) sw.out2[i] = kBig;
    }
    for (long long i = r1 + first; i < len; i += stride) {
      sw.out1[i] = kBig;
      if (steps >= 2) sw.out2[i] = kBig;
    }
  }
}

// One strip of 32 * R rows from row s0 through every step of the stage;
// false when a wait stalled.
template <int R>
__device__ bool run_strip(const Stage& st, const Sweep& sw, int s0, Link up, Link down,
                          bool first_wave) {
  constexpr int C = chunk_of(R);
  const int lane = threadIdx.x & 31;
  const int m = sw.m, n = sw.n, d0 = sw.d0, steps = sw.d1 - sw.d0;
  const int gap = st.gap, match = st.match, mismatch = st.mismatch;
  const int base = s0 + lane * R;  // this lane's rows: base .. base + R - 1
  int ac[R], bc[R], D1[R], D2[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = base + k;
    ac[k] = i >= 1 && i <= m ? __ldg(sw.a + i - 1) : kNoChar;
    D1[k] = i <= m ? __ldg(sw.in1 + i) : kBig;
    D2[k] = i <= m ? __ldg(sw.in2 + i) : kBig;
    bc[k] = char_at(sw.b, n, d0 - 1 - i);
  }
  // Row s0 - 1 at d0 - 1 and d0 - 2, lane 0's neighbour at the first step;
  // x2 is the neighbour above at d - 2 (lane l - 1's last row).
  int top1 = s0 >= 1 ? __ldg(sw.in1 + s0 - 1) : kBig;
  int top2 = s0 >= 1 ? __ldg(sw.in2 + s0 - 1) : kBig;
  if (sw.above != 0) {  // the dead cells above the diagonal (i > d) start at `above`
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (base + k > d0 - 1) D1[k] = sw.above;
      if (base + k > d0 - 2) D2[k] = sw.above;
    }
    if (s0 - 1 > d0 - 1) top1 = sw.above;
    if (s0 - 1 > d0 - 2) top2 = sw.above;
  }
  int x2 = __shfl_up_sync(kFull, D2[R - 1], 1);
  if (lane == 0) x2 = top2;
  const bool top_edge = s0 == 0 && lane == 0;  // row 0 holds gap * d

  // Lane c < C of a chunk at step tau: the value above at step tau + c - 1
  // (a tagged slot, prefetched a chunk ahead) and the char of b entering
  // row s0 after step tau + c.
  long long word = 0, consumed = 0, seen = 0;
  int b_next = 0;
  const auto prefetch = [&](int tau) {
    const int slot = tau + lane - 1;
    if (lane < C) {
      b_next = char_at(sw.b, n, d0 + tau + lane - s0);
      if (up.slots != nullptr && slot >= 0 && slot <= steps - 2) word = up.slots[slot & up.mask];
    }
    if (down.consumed != nullptr && lane == 0) consumed = *down.consumed;
  };
  prefetch(0);
  volatile long long* const out = lane == 31 ? down.slots : nullptr;

  for (int tau = 0; tau < steps; tau += C) {
    const int slot = tau + lane - 1;
    const bool need = lane < C && slot >= 0 && slot <= steps - 2;
    int above = kBig;
    if (up.slots != nullptr) {
      long long start = -1;
      while (!__all_sync(kFull, !need || static_cast<int>(word >> 32) == slot + 1)) {
        if (!still_waiting(start, st.status)) return false;
        if (need) word = up.slots[slot & up.mask];
      }
      if (need) above = static_cast<int>(static_cast<unsigned>(word));
      if (up.consumed != nullptr && lane == 0) *up.consumed = tau + C - 1;  // all before it read
    }
    if (slot < 0) above = top1;
    if (tau == 0 && first_wave && lane == 0) {  // the pipeline's fill, in ns
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      atomicMax(sw.starts, ~now);
      atomicMax(sw.starts + 1, now);
    }
    const int b_in = b_next;
    if (down.consumed != nullptr) {  // room in the ring for steps tau .. tau + C - 1
      seen = max(seen, __shfl_sync(kFull, consumed, 0));
      long long start = -1;
      while (seen < tau + C - kRing) {
        if (!still_waiting(start, st.status)) return false;
        long long now = 0;
        if (lane == 0) now = *down.consumed;
        seen = __shfl_sync(kFull, now, 0);
      }
    }
    if (tau + C < steps) prefetch(tau + C);

    // kWhole: every step of the chunk runs and feeds the strip below (none
    // is the stage's last) and no cell needs the diagonal edge set;
    // otherwise each step checks, and the edge i == d is set wherever it
    // lies.
    const auto chunk = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int t = tau + u;
        if (!kWhole && t >= steps) break;
        const int d = d0 + t;
        const int gd = gap * d;
        const int from_ring = __shfl_sync(kFull, above, u);
        const int from_lane = __shfl_up_sync(kFull, D1[R - 1], 1);
        const int x1 = lane == 0 ? from_ring : from_lane;
        const int e = d - base;  // the edge cell i == d is this lane's row e
#pragma unroll
        for (int k = R - 1; k >= 0; --k) {
          const int left = D1[k];
          const int upper = k > 0 ? D1[k - 1] : x1;
          const int diag = k > 0 ? D2[k - 1] : x2;
          // DPX: min(min(left, upper) + gap, diag + sub) in one add-min
          int v = __viaddmin_s32(min(left, upper), gap,
                                 diag + (ac[k] == bc[k] ? match : mismatch));
          if (!kWhole && e == k) v = gd;
          D2[k] = left;
          D1[k] = v;
        }
        if (top_edge) D1[0] = gd;
        x2 = x1;
        const int b_ring = __shfl_sync(kFull, b_in, u);
        const int b_lane = __shfl_up_sync(kFull, bc[R - 1], 1);
#pragma unroll
        for (int k = R - 1; k > 0; --k) bc[k] = bc[k - 1];
        bc[0] = lane == 0 ? b_ring : b_lane;
        if (out != nullptr && (kWhole || t <= steps - 2))
          out[t & down.mask] = (static_cast<long long>(t + 1) << 32) |
                               static_cast<unsigned>(D1[R - 1]);
      }
    };
    const bool edge = sw.above != 0 ? tau == 0 : d0 + tau + C - 1 >= s0 && d0 + tau < s0 + 32 * R;
    if (tau + C <= steps - 1 && !edge)
      chunk(std::true_type{});
    else
      chunk(std::false_type{});
  }

  // D1 = D[d1 - 1], D2 = D[d1 - 2]; a stage of one step leaves D2 to the fill.
  const int dl = sw.d1 - 1;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = base + k;
    if (i <= m) {
      sw.out1[i] = i >= max(dl - n, 0) && i <= dl ? D1[k] : kBig;
      if (steps >= 2) sw.out2[i] = i >= max(dl - 1 - n, 0) && i <= dl - 1 ? D2[k] : kBig;
    }
  }
  return true;
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32) wavefront_stage(Stage st) {
  __shared__ long long shared_rings[kWarps * (kRing + 1)];
  fill_rest(st, R);
  constexpr int warps = kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int x = threadIdx.x; x < warps * (kRing + 1); x += blockDim.x) shared_rings[x] = 0;
  __syncthreads();

  int k = 0;
  while (k + 1 < st.count && static_cast<int>(blockIdx.x) >= st.sweep[k + 1].first_cta) ++k;
  const Sweep sw = st.sweep[k];
  const int cta = static_cast<int>(blockIdx.x) - sw.first_cta;
  if (cta < 0 || cta >= sw.ctas) return;
  const int G = sw.ctas * warps, g = cta * warps + warp;
  const size_t steps = static_cast<size_t>(sw.d1 - sw.d0);
  for (int w = 0; w * G + g < sw.strips; ++w) {
    const int s = w * G + g;
    if (w > 0 && !wait_count(sw.finished, static_cast<unsigned>(w * G), st.status)) return;
    // the ring of local warp x, or of CTA c, feeds that warp, or the CTA's first
    const auto ring = [&](long long* p) { return Link{p, kRing - 1, p + kRing}; };
    const auto column = [&](int parity) {
      return Link{sw.columns + parity * steps, -1, nullptr};
    };
    Link up{nullptr, 0, nullptr}, down{nullptr, 0, nullptr};
    if (s > 0) {
      if (g == 0) up = column(w & 1);
      else if (warp > 0) up = ring(shared_rings + warp * (kRing + 1));
      else up = ring(sw.rings + static_cast<size_t>(cta) * (kRing + 1));
    }
    if (s + 1 < sw.strips) {
      if (g == G - 1) down = column((w + 1) & 1);
      else if (warp + 1 < warps) down = ring(shared_rings + (warp + 1) * (kRing + 1));
      else down = ring(sw.rings + static_cast<size_t>(cta + 1) * (kRing + 1));
    }
    if (!run_strip<R>(st, sw, (sw.first_strip + s) * 32 * R, up, down, w == 0)) return;
    if (up.consumed != nullptr)  // the ring empty for the next wave's strips
      for (int x = lane; x <= kRing; x += 32) up.slots[x] = 0;
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicAdd(sw.finished, 1u);
  }
}

// The kernel of R rows a lane (the plan's choice), or null.
const void* kernel_of(int rows_per_lane) {
  switch (rows_per_lane) {
    case 1: return reinterpret_cast<const void*>(wavefront_stage<1>);
    case 2: return reinterpret_cast<const void*>(wavefront_stage<2>);
    case 4: return reinterpret_cast<const void*>(wavefront_stage<4>);
    case 6: return reinterpret_cast<const void*>(wavefront_stage<6>);
    case 8: return reinterpret_cast<const void*>(wavefront_stage<8>);
    case 12: return reinterpret_cast<const void*>(wavefront_stage<12>);
    case 16: return reinterpret_cast<const void*>(wavefront_stage<16>);
    case 24: return reinterpret_cast<const void*>(wavefront_stage<24>);
    case 32: return reinterpret_cast<const void*>(wavefront_stage<32>);
    default: return nullptr;
  }
}

// The diagonal edge D[d][d] = gap * d by the recurrence itself. From the
// second step on, the cell (d, 0) is min(D[d-1][d] + gap, D[d-1][d-1] + gap,
// D[d-2][d-1] + sub), where D[d-1][d-1] = gap * (d - 1) is the edge of the
// step before and the other two lie above the diagonal: dead cells that no
// live cell reads and that depend only on each other. Started at a value
// A large enough, they stay at least A + t * min(0, costs) after t steps,
// so the min is gap * d and no step needs to set it. A is the least value
// for which that holds over the stage with room to spare; 0 when a stage's
// costs leave no int32 room for it (the edge is then set where it lies).
int edges_by_recurrence(long long d0, long long d1, long long match, long long mismatch,
                        long long gap) {
  const long long steps = d1 - d0;
  const long long low = -std::min({0LL, gap, match, mismatch});
  const long long high = std::max({0LL, gap, match, mismatch});
  const long long sub = std::max(std::llabs(match), std::llabs(mismatch));
  const long long above = std::llabs(gap) * (d1 + 1) + steps * low + sub + 1;
  return above + steps * high + std::llabs(gap) + sub < INT32_MAX ? static_cast<int>(above) : 0;
}

}  // namespace

// CTAs (of 4 warps) of the stage kernel of R rows a lane that an SM holds
// at once.
extern "C" cudaError_t sz_wavefront_stage_occupancy(int rows_per_lane, int* ctas_per_sm) {
  const void* fn = kernel_of(rows_per_lane);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, kWarps * 32, 0);
}

// One stage of n_sweeps (1 or 2) sweeps in one cooperative launch.
//   sweeps   [n_sweeps][10] int64 on the host: a, b, in1, in2, out1, out2
//            (device pointers), m, n, d0, d1 (0 <= m, n < 2^28;
//            2 <= d0 <= d1 <= m + n + 1);
//   plan     [6 + 6 * n_sweeps] int64 on the host, from ops/wavefront.py
//            stage_plan: rows a lane R (1, 2, 4, 6, 8, 12, 16, 24, 32),
//            steps a chunk (chunk_of(R): 16 up to R = 16, else 8), warps a
//            CTA (4), CTAs, ring slots (64), bytes of `handoff` to zero;
//            then per sweep its first live strip, live strips, first CTA,
//            CTAs, and byte offsets in `handoff` of its counters (finished
//            strips, then the first and last times a strip of its first
//            wave began its steps, 8 bytes each; its CTAs' rings follow)
//            and of its two wave columns (-1 when its strips fit one wave);
//   handoff  `handoff_bytes` of device memory: the status word (int32 at
//            byte 0; 3 after a stalled wait, which the host raises on),
//            then what the plan lays out. Zeroed here up to its rings' end.
// Launches on `stream` without synchronising; refuses a plan the card
// cannot hold resident (cudaErrorCooperativeLaunchTooLarge).
extern "C" cudaError_t sz_wavefront_stage(const long long* sweeps, int n_sweeps,
                                          const long long* plan, int match, int mismatch,
                                          int gap, void* handoff, long long handoff_bytes,
                                          cudaStream_t stream) {
  if (n_sweeps < 1 || n_sweeps > kMaxSweeps || handoff_bytes < 8) return cudaErrorInvalidValue;
  const int rows_per_lane = static_cast<int>(plan[0]), chunk = static_cast<int>(plan[1]);
  const int warps = static_cast<int>(plan[2]), ctas = static_cast<int>(plan[3]);
  const long long zeroed = plan[5];
  const void* fn = kernel_of(rows_per_lane);
  if (fn == nullptr || chunk != chunk_of(rows_per_lane) || warps != kWarps || ctas < 1 ||
      plan[4] != kRing ||
      zeroed < 8 || zeroed > handoff_bytes)
    return cudaErrorInvalidValue;

  Stage st{};
  st.count = n_sweeps;
  st.match = match, st.mismatch = mismatch, st.gap = gap;
  char* base = static_cast<char*>(handoff);
  st.status = reinterpret_cast<int*>(base);
  int next_cta = 0;
  for (int k = 0; k < n_sweeps; ++k) {
    const long long* p = sweeps + static_cast<long long>(kSweepFields) * k;
    const long long* q = plan + kPlanHead + static_cast<long long>(kPlanSweep) * k;
    Sweep& sw = st.sweep[k];
    sw.a = reinterpret_cast<const int32_t*>(p[0]);
    sw.b = reinterpret_cast<const int32_t*>(p[1]);
    sw.in1 = reinterpret_cast<const int32_t*>(p[2]);
    sw.in2 = reinterpret_cast<const int32_t*>(p[3]);
    sw.out1 = reinterpret_cast<int32_t*>(p[4]);
    sw.out2 = reinterpret_cast<int32_t*>(p[5]);
    const long long m = p[6], n = p[7], d0 = p[8], d1 = p[9];
    if (m < 0 || n < 0 || m >= (1LL << 28) || n >= (1LL << 28) || d0 < 2 || d1 < d0 ||
        d1 > m + n + 1)
      return cudaErrorInvalidValue;
    sw.m = static_cast<int>(m), sw.n = static_cast<int>(n);
    sw.d0 = static_cast<int>(d0), sw.d1 = static_cast<int>(d1);
    sw.above = edges_by_recurrence(d0, d1, match, mismatch, gap);
    const long long strip_rows = 32LL * rows_per_lane;
    // the strips lie in [0, m] and fill this sweep's CTAs' warps in waves;
    // the rings and the columns lie in the buffer
    if (q[0] < 0 || q[1] < 0 || (q[1] > 0 && (d1 == d0 || q[0] * strip_rows > m ||
                                               (q[0] + q[1] - 1) * strip_rows > m)) ||
        q[2] != next_cta || q[3] < 0 || (q[1] > 0) != (q[3] > 0) || q[4] < 8 ||
        q[4] + 24 + q[3] * (kRing + 1) * 8 > zeroed ||
        (q[1] > q[3] * warps && (q[5] < zeroed || q[5] + 16 * (d1 - d0) > handoff_bytes)))
      return cudaErrorInvalidValue;
    sw.first_strip = static_cast<int>(q[0]), sw.strips = static_cast<int>(q[1]);
    sw.first_cta = static_cast<int>(q[2]), sw.ctas = static_cast<int>(q[3]);
    sw.finished = reinterpret_cast<unsigned*>(base + q[4]);
    sw.starts = reinterpret_cast<unsigned long long*>(base + q[4] + 8);
    sw.rings = reinterpret_cast<long long*>(base + q[4] + 24);
    sw.columns = q[1] > q[3] * warps ? reinterpret_cast<long long*>(base + q[5]) : nullptr;
    next_cta += sw.ctas;
  }
  if (next_cta > ctas) return cudaErrorInvalidValue;

  int device = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (static_cast<long long>(per_sm) * sms < ctas) return cudaErrorCooperativeLaunchTooLarge;

  err = cudaMemsetAsync(handoff, 0, static_cast<size_t>(zeroed), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&st};
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(kWarps * 32), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
