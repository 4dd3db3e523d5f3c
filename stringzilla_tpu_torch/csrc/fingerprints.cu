// Rolling MinHash + count-min fingerprints of every document for every
// dimension, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/fingerprints_pallas.py::_kernel, and computes what the
// reference's floating_rolling_hashers<f64> computes
// (fingerprints/serial.hpp:445-560, 1111-1330), bit for bit. Per dimension d
// of width w, multiplier mult, modulo m (just past 2^42) and fused discard
// multiplier fd, at every byte t of a document:
//
//   x = state * mult + fd * old + new,  state = x mod m
//
// with new = byte[t] + 1 and old = byte[t - w] + 1 once t >= w (0 before,
// which makes the roll a plain push). From t = w - 1 on, state is a window's
// hash: the running minimum keeps the smallest, and the count the number of
// windows that reached it (a tie adds one). A document shorter than w keeps
// hash 0xFFFFFFFF and count 0; the minimum is exported as its low 32 bits.
//
// Arithmetic: f64, exact. Every value is an integer: state < m < 2^42.04,
// mult < 640, fd * old < 2^50.04, so x < 2^52 and each product and sum is
// exact in a 53-bit mantissa. The quotient estimate q = floor(x * (1/m))
// is within one of floor(x / m) (x / m < 1024, relative error ~2^-52), so
// r = fma(-q, m, x) is exact and in [-m, 2m), and one +m or -m pins it.
// Chosen over int64 because Hopper's f64 pipe runs a multiply or fma at
// half the float32 rate, while a 64-bit integer % is a software routine of
// dozens of instructions and a 64-bit multiply several 32-bit ones.
//
// What bounds it on this card: operations. A (document, dimension, byte)
// step is ~10 dependent f64 ops (fma, multiply, add, floor, fma, two
// compare-selects, the compare of the minimum); the bytes read are one per
// document byte and the outputs 8 per (document, dimension).
//
// What the design does about it. The TPU kernel laid dimensions down the
// sublanes and 128 documents across the lanes, kept the state in two 21-bit
// int32 limbs (no f64 on a TPU) with an f32 quotient estimate, and unrolled
// the byte loop 8x. Here a CTA takes one document and up to 256 dimensions,
// a thread one dimension, its state, minimum and count in registers, and
// writes its (document, dimension) pair straight into the (n_docs, ndim)
// output. The document streams through shared memory in chunks of kChunk
// bytes with a halo of kHalo bytes before each, so the new byte is a
// broadcast read and the old byte one of a few addresses per warp (one per
// window width in the warp); a width wider than the halo reads its old byte
// from global memory (L1/L2). Documents of any length stream; there is no
// length cap and no padding.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // dimensions per CTA
constexpr int kChunk = 4096;      // document bytes staged per pass
constexpr int kHalo = 1024;       // bytes before a chunk kept for the old byte

__global__ void __launch_bounds__(kMaxThreads)
fingerprint_minhash(const uint8_t* __restrict__ blob, const long long* __restrict__ starts,
                    const long long* __restrict__ lengths, const int32_t* __restrict__ width,
                    const double* __restrict__ mult, const double* __restrict__ modulo,
                    const double* __restrict__ fused_disc, int ndim,
                    int32_t* __restrict__ hashes, int32_t* __restrict__ counts) {
  __shared__ uint8_t buf[kHalo + kChunk];
  const long long doc = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = d < ndim;
  const uint8_t* text = blob + starts[doc];
  const long long len = lengths[doc];

  const long long w = active ? width[d] : 1;
  const double mul = active ? mult[d] : 1.0;
  const double m = active ? modulo[d] : 1.0;
  const double fd = active ? fused_disc[d] : 0.0;
  const double inv_m = 1.0 / m;
  double state = 0.0;
  double minimum = INFINITY;
  int count = 0;

  for (long long c0 = 0; c0 < len; c0 += kChunk) {
    const long long c1 = min(c0 + kChunk, len);
    const long long base = max(c0 - kHalo, 0ll);  // buf[i] holds byte base + i
    __syncthreads();  // the last chunk's reads are done
    for (long long p = base + threadIdx.x; p < c1; p += blockDim.x) buf[p - base] = __ldg(text + p);
    __syncthreads();
    if (!active) continue;
    for (long long t = c0; t < c1; ++t) {
      const double fresh = static_cast<double>(buf[t - base]) + 1.0;
      double old = 0.0;
      if (t >= w) {
        const long long p = t - w;
        old = static_cast<double>(p >= base ? buf[p - base] : __ldg(text + p)) + 1.0;
      }
      const double x = fma(state, mul, fd * old) + fresh;  // exact: < 2^52
      const double q = floor(x * inv_m);
      double r = fma(-q, m, x);  // exact, in [-m, 2m)
      r = r < 0.0 ? r + m : r;
      r = r >= m ? r - m : r;
      state = r;
      if (t >= w - 1) {
        count = r < minimum ? 1 : (r == minimum ? count + 1 : count);
        minimum = fmin(minimum, r);
      }
    }
  }
  if (!active) return;
  const size_t at = static_cast<size_t>(doc) * ndim + d;
  const bool filled = count > 0;
  hashes[at] = filled ? static_cast<int32_t>(static_cast<uint32_t>(
                            static_cast<unsigned long long>(minimum) & 0xffffffffull))
                      : -1;
  counts[at] = count;
}

}  // namespace

// MinHash + count-min of n_docs documents into hashes/counts[n_docs][ndim]
// (int32 holding the u32 bits).
//   blob       document bytes; document k is blob[starts[k] : starts[k] + lengths[k]];
//   width      [ndim] int32 window widths (>= 1);
//   mult, modulo, fused_disc  [ndim] f64 holding the integer parameters.
// Launches on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_fingerprints(const uint8_t* blob, const long long* starts,
                                       const long long* lengths, int n_docs,
                                       const int32_t* width, const double* mult,
                                       const double* modulo, const double* fused_disc,
                                       int ndim, int32_t* hashes, int32_t* counts,
                                       cudaStream_t stream) {
  if (n_docs <= 0 || ndim <= 0) return cudaSuccess;
  const int threads = min(kMaxThreads, (ndim + 31) / 32 * 32);
  const int dim_blocks = (ndim + threads - 1) / threads;
  if (dim_blocks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(n_docs), static_cast<unsigned>(dim_blocks));
  fingerprint_minhash<<<grid, threads, 0, stream>>>(blob, starts, lengths, width, mult, modulo,
                                                    fused_disc, ndim, hashes, counts);
  return cudaGetLastError();
}
