// 256-entry byte lookup, out[k] = lut[in[k]], hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/memory_pallas.py::_kernel (sz_lookup, reference
// memory.h:153). The class-cost engines run it once per collection, to map
// the byte blob to cost classes before the column DP packs it.
//
// What bounds it on this card: memory. It moves 2 bytes per byte (one read,
// one write) and does one shared-memory load per byte, so at the 3.35 TB/s
// of HBM of the H100 SXM data sheet a buffer of N bytes takes at least
// 2N / 3.35e12 s.
//
// What the design does about it. The TPU kernel split the table into two
// 128-lane planes and shuffled each in registers (its lane gather). Here the
// 256-byte table sits in shared memory and every thread maps 16 bytes
// through one uint4 load and one uint4 store, so the warp's accesses are
// 512 contiguous bytes; a grid-stride loop keeps a few blocks per SM busy.
// Buffers that are not 16-byte aligned, and the tail past the last whole
// 16 bytes, take a scalar path.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t map_word(uint32_t w, const uint8_t* t) {
  return static_cast<uint32_t>(t[w & 0xff]) | (static_cast<uint32_t>(t[(w >> 8) & 0xff]) << 8) |
         (static_cast<uint32_t>(t[(w >> 16) & 0xff]) << 16) |
         (static_cast<uint32_t>(t[w >> 24]) << 24);
}

__global__ void __launch_bounds__(kThreads)
byte_lut(const uint8_t* __restrict__ in, size_t n, size_t vectors, const uint8_t* __restrict__ lut,
         uint8_t* __restrict__ out) {
  __shared__ uint8_t t[256];
  t[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (size_t v = first; v < vectors; v += stride) {
    const uint4 x = in4[v];
    out4[v] = make_uint4(map_word(x.x, t), map_word(x.y, t), map_word(x.z, t), map_word(x.w, t));
  }
  for (size_t k = vectors * 16 + first; k < n; k += stride) out[k] = t[in[k]];
}

}  // namespace

// out[k] = lut[in[k]] for k < n; lut holds 256 bytes on the device. Launches
// on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_lookup(const uint8_t* in, size_t n, const uint8_t* lut, uint8_t* out,
                                 int sm_count, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const size_t vectors = aligned ? n / 16 : 0;
  const size_t work = vectors > 0 ? vectors : n;
  size_t blocks = (work + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sm_count > 0 ? sm_count : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  byte_lut<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(in, n, vectors, lut, out);
  return cudaGetLastError();
}
