// Issue rate of Hopper's DPX add-min / add-max against a plain int32 min,
// for the column DP's operations bound (chip_smoke.py _dp_ops_per_cell).
// Built and driven by tools/dp_hash_sweep.py (its "dpx" part); not part of
// the package.
//
// One CTA of 1024 threads an SM, each thread running kChains independent
// chains of `iters` dependent operations; thread 0 of each CTA records the
// SM clocks between two barriers around the loop, so the rate comes out in
// operations an SM a clock, whatever the clock runs at.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

// op 0: __viaddmin_s32 (VIADDMNMX), 1: __viaddmax_s32_relu, 2: a plain
// min(a, c) (IMNMX). Each chain's other operand is the next chain's value,
// so nothing folds; the loop is unrolled by 4 so its own counter and branch
// are a small part of the instructions (the rate counts only the chains').
template <int kOp>
__global__ void __launch_bounds__(1024) dpx_rate(int iters, int b, int* out, long long* clocks) {
  int a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) a[k] = static_cast<int>(threadIdx.x * 7 + k);
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const int c = a[(k + 1) % kChains];
      if (kOp == 0) a[k] = __viaddmin_s32(a[k], b, c);
      if (kOp == 1) a[k] = __viaddmax_s32_relu(a[k], b, c);
      if (kOp == 2) a[k] = min(a[k], c);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) sum += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

}  // namespace

// Runs `op` on `blocks` CTAs of 1024 threads; out holds blocks * 1024 ints,
// clocks `blocks` cycle counts. Synchronises; returns the status.
extern "C" int sz_dpx_rate(int op, int blocks, int iters, int b, int* out, long long* clocks) {
  switch (op) {
    case 0: dpx_rate<0><<<blocks, 1024>>>(iters, b, out, clocks); break;
    case 1: dpx_rate<1><<<blocks, 1024>>>(iters, b, out, clocks); break;
    case 2: dpx_rate<2><<<blocks, 1024>>>(iters, b, out, clocks); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceSynchronize());
}
