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
// A stage of zero steps returns its initial state.
//
// What bounds it on this card. A cell is about 5 dependent int32 operations,
// so a sweep over an m x n matrix is m * n * 5 operations against 132 SMs x
// 64 int32 lanes a clock; the strings and the diagonals are O(m + n) bytes.
// But only one anti-diagonal is independent at a time, so every step ends in
// a barrier across the whole grid: a 180,000 x 180,000 pair takes 180,000
// of them, and their latency, not the issue rate, sets the time.
//
// What the design does about it, for now: nothing beyond keeping each step
// short. A cooperative launch (every CTA resident, checked with the
// occupancy API) puts at most one CTA of 1024 threads on each SM, enough
// for a thread a cell where the SMs allow; a thread owns the cells i = its
// rank + k * (threads of its sweep). The two sweeps of a meet-in-the-middle
// call share each launch, the SMs split between them in proportion to their
// diagonals, so a call costs one barrier a step rather than two. The three
// latest diagonals of a sweep rotate through a work buffer in device memory
// (2.2 MB a sweep at 180,000 chars, so L2 holds them); a
// step reads D[d-1] and D[d-2] with ld.global.cg, past the SM's L1, because
// other SMs wrote them. The TPU kernel's (rows, 128) tile, its roll-and-select
// shift and its shift register for b are gone: a thread reads b[d-1-i]
// directly. The grid barrier is a counter in device memory: each CTA adds
// one a step and waits for the count of the step, with a bounded wait, so a
// fault returns status 3 instead of hanging the card. Later work: skewed
// multi-step tiles, as wavefront_tile does, so that a barrier covers many
// steps.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStageThreads = 1024;
constexpr int kMaxSweeps = 2;
constexpr int kBig = 1 << 28;
constexpr long long kWaitCycles = 1LL << 32;  // ~2 s at 1.98 GHz; a step takes microseconds
constexpr int kStalled = 3;

struct Sweep {
  const int32_t* a;    // [m]
  const int32_t* b;    // [n]
  const int32_t* in1;  // D[d0 - 1], [m + 1]
  const int32_t* in2;  // D[d0 - 2], [m + 1]
  int32_t* out1;       // D[d1 - 1], [m + 1]
  int32_t* out2;       // D[d1 - 2], [m + 1]
  int32_t* work;       // [3][m + 1]: the three latest diagonals
  int m, n, d0, d1;
  int first_block, blocks;
};

struct Stage {
  Sweep sweep[kMaxSweeps];
  int count;
  int steps;  // the most steps of any sweep: every CTA meets every barrier
  int match, mismatch, gap;
};

// Every CTA of the grid arrives, then waits until `target` arrivals have been
// counted. False (in every thread of the CTA) when the wait stalled or
// another CTA reported a stall.
__device__ bool grid_barrier(unsigned* arrived, int* status, unsigned target) {
  __shared__ int ok;
  __syncthreads();
  if (threadIdx.x == 0) {
    ok = 1;
    __threadfence();  // this CTA's diagonal cells before its arrival
    atomicAdd(arrived, 1u);
    const long long start = clock64();
    while (*reinterpret_cast<volatile unsigned*>(arrived) < target) {
      if (*reinterpret_cast<volatile int*>(status) != 0 || clock64() - start > kWaitCycles) {
        atomicExch(status, kStalled);
        ok = 0;
        break;
      }
    }
    __threadfence();
  }
  __syncthreads();
  return ok != 0;
}

__global__ void __launch_bounds__(kStageThreads, 1)
wavefront_stage(Stage st, unsigned* arrived, int* status) {
  int k = 0;
  while (k + 1 < st.count && static_cast<int>(blockIdx.x) >= st.sweep[k + 1].first_block) ++k;
  const Sweep sw = st.sweep[k];
  const int len = sw.m + 1;
  const auto diag = [&](int s) { return sw.work + static_cast<size_t>(s % 3) * len; };
  const int rank = (blockIdx.x - sw.first_block) * kStageThreads + threadIdx.x;
  const int stride = sw.blocks * kStageThreads;
  const int steps = sw.d1 - sw.d0;
  for (int s = 0; s < st.steps; ++s) {
    if (s < steps) {
      const int d = sw.d0 + s;
      const int32_t* p1 = s == 0 ? sw.in1 : diag(s - 1);
      const int32_t* p2 = s == 0 ? sw.in2 : s == 1 ? sw.in1 : diag(s - 2);
      int32_t* o = diag(s);
      const int lo = max(d - sw.n, 0), hi = min(d, sw.m);
      for (int i = rank; i < len; i += stride) {
        int v = kBig;
        if (i >= lo && i <= hi) {
          if (i == 0 || i == d) {
            v = st.gap * d;
          } else {
            const int sub = __ldg(sw.a + i - 1) == __ldg(sw.b + d - 1 - i) ? st.match : st.mismatch;
            v = min(min(__ldcg(p1 + i), __ldcg(p1 + i - 1)) + st.gap, __ldcg(p2 + i - 1) + sub);
          }
        }
        __stcg(o + i, v);
      }
    }
    if (s + 1 < st.steps && !grid_barrier(arrived, status, (s + 1) * gridDim.x)) return;
  }
  // A thread wrote the same cells at every step, so the last two diagonals'
  // cells of this thread are its own and need no barrier.
  const int32_t* f1 = steps == 0 ? sw.in1 : diag(steps - 1);
  const int32_t* f2 = steps == 0 ? sw.in2 : steps == 1 ? sw.in1 : diag(steps - 2);
  for (int i = rank; i < len; i += stride) {
    sw.out1[i] = __ldcg(f1 + i);
    sw.out2[i] = __ldcg(f2 + i);
  }
}

}  // namespace

// One stage of n_sweeps (1 or 2) sweeps in one cooperative launch.
//   sweeps  [n_sweeps][11] int64 on the host: a, b, in1, in2, out1, out2,
//           work (device pointers), m, n, d0, d1 (m, n >= 0; 2 <= d0 <= d1);
//   ctrl    2 int32 on the device: the barrier's count and the status,
//           zeroed here; the status is 3 after a stalled barrier, which the
//           host raises on.
// Launches on `stream` without synchronising; refuses (cudaError
// CooperativeLaunchTooLarge) when not one CTA fits on an SM.
extern "C" cudaError_t sz_wavefront_stage(const long long* sweeps, int n_sweeps, int match,
                                          int mismatch, int gap, int32_t* ctrl,
                                          cudaStream_t stream) {
  if (n_sweeps < 1 || n_sweeps > kMaxSweeps) return cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavefront_stage, kStageThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;

  Stage st{};
  st.count = n_sweeps;
  st.match = match, st.mismatch = mismatch, st.gap = gap;
  long long cells = 0;
  for (int k = 0; k < n_sweeps; ++k) {
    const long long* p = sweeps + 11LL * k;
    Sweep& sw = st.sweep[k];
    sw.a = reinterpret_cast<const int32_t*>(p[0]);
    sw.b = reinterpret_cast<const int32_t*>(p[1]);
    sw.in1 = reinterpret_cast<const int32_t*>(p[2]);
    sw.in2 = reinterpret_cast<const int32_t*>(p[3]);
    sw.out1 = reinterpret_cast<int32_t*>(p[4]);
    sw.out2 = reinterpret_cast<int32_t*>(p[5]);
    sw.work = reinterpret_cast<int32_t*>(p[6]);
    if (p[7] < 0 || p[8] < 0 || p[7] >= (1LL << 28) || p[8] >= (1LL << 28) || p[9] < 2 ||
        p[10] < p[9] || p[10] > p[7] + p[8] + 1)
      return cudaErrorInvalidValue;
    sw.m = static_cast<int>(p[7]), sw.n = static_cast<int>(p[8]);
    sw.d0 = static_cast<int>(p[9]), sw.d1 = static_cast<int>(p[10]);
    st.steps = std::max(st.steps, sw.d1 - sw.d0);
    cells += sw.m + 1;
  }
  // CTAs: enough for a cell a thread, at most one an SM, each sweep at least
  // one and otherwise a share in proportion to its diagonal.
  long long want = 0;
  for (int k = 0; k < n_sweeps; ++k)
    want += (st.sweep[k].m + kStageThreads) / kStageThreads;
  const int grid = static_cast<int>(want < sms ? want : sms);
  int first = 0;
  for (int k = 0; k < n_sweeps; ++k) {
    Sweep& sw = st.sweep[k];
    const long long need = (sw.m + kStageThreads) / kStageThreads;
    long long share = want <= sms ? need : grid * (sw.m + 1LL) / cells;
    const int left = grid - first - (n_sweeps - 1 - k);  // keep one for each later sweep
    share = share < 1 ? 1 : share > left ? left : share;
    if (k == n_sweeps - 1) share = grid - first;
    sw.first_block = first, sw.blocks = static_cast<int>(share);
    first += sw.blocks;
  }
  err = cudaMemsetAsync(ctrl, 0, 2 * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  unsigned* arrived = reinterpret_cast<unsigned*>(ctrl);
  int32_t* status = ctrl + 1;
  void* args[] = {&st, &arrived, &status};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(wavefront_stage), dim3(grid),
                                    dim3(kStageThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
