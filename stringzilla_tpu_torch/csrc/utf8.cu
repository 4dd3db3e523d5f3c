// UTF-8 validation (RFC 3629) and rune count in one pass over a byte
// buffer, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/utf8_device.py::_val_kernel and computes the same two
// numbers over the n bytes, with every byte before 0 or from n on read as
// zero:
//   violations = #positions p < n with a bad lead (C0, C1, F5-FF) or a
//                continuation out of range after E0, ED, F0 or F4 (overlong,
//                surrogate, above U+10FFFF)
//              + #positions p < n + 3 where "p is a continuation byte"
//                differs from "a lead in p-1..p-3 still needs one"
//                (structure, which also catches a lead cut off at the end);
//   runes      = #positions p < n that are not continuation bytes.
// A buffer is valid UTF-8 iff violations == 0, and then runes is its count.
//
// What bounds it on this card: operations. The check is ~36 byte-wise SIMD
// compares and logic ops a 4-byte word (~9 a byte) against one byte read;
// at the card's int32 rate that is above the time the bytes take.
//
// What the design does about it. The TPU kernel classified a 128 KiB block
// plus 32-row halos into class bits and lane-rolled them. Here a thread
// takes 16 bytes with one 16-byte load (neighbouring threads on
// neighbouring addresses) and the 4 bytes before them from the previous
// lane by a shuffle, and classifies 4 bytes at a time with the byte-wise
// SIMD intrinsics (__vcmp*4), so the look-back of 1-3 bytes is a funnel
// shift, not a reload. Counts stay in registers over a grid-stride loop,
// are summed per warp and per CTA, and each CTA adds its pair once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t load_word(const uint8_t* s, long long p, long long n) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (p + b >= 0 && p + b < n) w |= static_cast<uint32_t>(s[p + b]) << (8 * b);
  return w;
}

__device__ __forceinline__ uint4 load16(const uint8_t* s, long long p, long long n, int aligned) {
  if (aligned && p + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(s + p));
  return make_uint4(load_word(s, p, n), load_word(s, p + 4, n), load_word(s, p + 8, n),
                    load_word(s, p + 12, n));
}

// 0xFF in each byte of the 4 positions q..q+3 that is below `limit`.
__device__ __forceinline__ uint32_t below(long long q, long long limit) {
  if (q + 4 <= limit) return 0xFFFFFFFFu;
  if (q >= limit) return 0u;
  return (1u << (8 * (limit - q))) - 1u;
}

__device__ __forceinline__ uint32_t rep(uint32_t b) { return 0x01010101u * b; }
__device__ __forceinline__ uint32_t lead2(uint32_t x) {
  return __vcmpgeu4(x, rep(0xC2)) & __vcmpleu4(x, rep(0xDF));
}
__device__ __forceinline__ uint32_t lead3(uint32_t x) {
  return __vcmpeq4(x & rep(0xF0), rep(0xE0));
}
__device__ __forceinline__ uint32_t lead4(uint32_t x) {
  return __vcmpgeu4(x, rep(0xF0)) & __vcmpleu4(x, rep(0xF4));
}

__global__ void __launch_bounds__(kThreads)
utf8_validate_count(const uint8_t* __restrict__ s, long long n, long long vectors, int aligned,
                    unsigned long long* __restrict__ out) {
  __shared__ unsigned long long s_sum[2][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t viol = 0, runes = 0;
  // warp-uniform trip count, so every lane takes part in the shuffle
  for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       v0 < vectors; v0 += stride) {
    const long long v = v0 + lane;
    const long long p0 = 16 * v;
    const uint4 cur = v < vectors ? load16(s, p0, n, aligned) : make_uint4(0, 0, 0, 0);
    uint32_t prev = __shfl_up_sync(0xffffffffu, cur.w, 1);
    if (lane == 0) prev = load_word(s, p0 - 4, n);
    const uint32_t words[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long q = p0 + 4 * t;
      const uint32_t w = words[t];
      const uint32_t w1 = __funnelshift_l(prev, w, 8);   // bytes at p - 1
      const uint32_t w2 = __funnelshift_l(prev, w, 16);  // bytes at p - 2
      const uint32_t w3 = __funnelshift_l(prev, w, 24);  // bytes at p - 3
      prev = w;
      const uint32_t inside = v < vectors ? below(q, n) : 0u;
      const uint32_t near_end = v < vectors ? below(q, n + 3) : 0u;
      const uint32_t cont = __vcmpeq4(w & rep(0xC0), rep(0x80));
      const uint32_t bad_lead =
          __vcmpgeu4(w, rep(0x80)) & ~cont & ~lead2(w) & ~lead3(w) & ~lead4(w);
      const uint32_t must_cont =
          lead2(w1) | lead3(w1) | lead4(w1) | lead3(w2) | lead4(w2) | lead4(w3);
      const uint32_t bad_range =
          cont & ((__vcmpeq4(w1, rep(0xE0)) & __vcmpltu4(w, rep(0xA0))) |
                  (__vcmpeq4(w1, rep(0xED)) & __vcmpgeu4(w, rep(0xA0))) |
                  (__vcmpeq4(w1, rep(0xF0)) & __vcmpltu4(w, rep(0x90))) |
                  (__vcmpeq4(w1, rep(0xF4)) & __vcmpgeu4(w, rep(0x90))));
      const uint32_t bad = ((bad_lead | bad_range) & inside) | ((cont ^ must_cont) & near_end);
      viol += __popc(bad & rep(0x01));
      runes += __popc(~cont & inside & rep(0x01));
    }
  }
  unsigned long long sums[2] = {viol, runes};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    for (int off = 16; off > 0; off >>= 1) sums[i] += __shfl_down_sync(0xffffffffu, sums[i], off);
    if (lane == 0) s_sum[i][threadIdx.x >> 5] = sums[i];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += s_sum[threadIdx.x][w];
    if (total) atomicAdd(out + threadIdx.x, total);
  }
}

}  // namespace

// out[0] = violations, out[1] = rune count over s[0, n) (2 int64 on the
// device, zeroed here). Reads no byte at or past n. Launches on `stream`
// without synchronising; returns the launch status.
extern "C" cudaError_t sz_utf8_validate_count(const uint8_t* s, long long n, long long* out,
                                              int sm_count, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(long long), stream);
  if (err != cudaSuccess) return err;
  const long long vectors = (n + 3 + 15) / 16;  // positions [0, n + 3)
  if (n == 0) return cudaGetLastError();
  long long blocks = (vectors + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count > 0 ? sm_count : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const int aligned = reinterpret_cast<uintptr_t>(s) % 16 == 0;
  utf8_validate_count<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      s, n, vectors, aligned, reinterpret_cast<unsigned long long*>(out));
  return cudaGetLastError();
}
