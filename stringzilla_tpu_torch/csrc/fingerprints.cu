// Rolling MinHash + count-min fingerprints of every document for every
// dimension, hand-written for Hopper (sm_90a): `fingerprint_minhash` rolls
// planned byte ranges of the documents, `fingerprint_merge` combines the
// ranges of each document that the plan cut.
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
// The step, exact in f64 with five f64-pipe instructions and nothing else on
// that pipe. Every value is an integer; the wrapper checks, once per
// parameter set, that (m - 1) * (mult + 256) + 256 < 2^52, so with
// 0 <= state < m, 0 <= fd < m and old, new <= 256:
//   1. y = fma(fd, old, new)       fd * old + new < 2^52: exact.
//   2. x = fma(state, mult, y)     x < 2^52: exact.
//   3. c = fma_rd(x, inv_m, 2^52)  inv_m is 1/m rounded UP (the wrapper
//      makes it, exactly, on the host), so 1/m <= inv_m < (1/m)(1 + 2^-52).
//      Write x = q m + r, 0 <= r <= m - 1. Then x * inv_m >= x / m >= q, and
//      x * inv_m < x / m + x 2^-52 / m < x / m + 1 / m <= q + 1 (x < 2^52).
//      So floor(x * inv_m) = q. The fma forms x * inv_m + 2^52 exactly and
//      rounds it toward -inf; in [2^52, 2^53) the doubles are the integers,
//      and x * inv_m < 1024, so c = 2^52 + q exactly.
//   4. q = c - 2^52                exact: both are integers below 2^53.
//   5. r = fma(-q, m, x)           x - q m = r is an integer in [0, m), so
//      the one rounding of the fma is exact: state = r, no correction, and
//      r is +0.0 (never -0.0) when it is zero.
// No byte is converted in the step (the staging converts each byte once per
// CTA, below), nothing takes floor, and the minimum and count are kept off
// the f64 pipe: non-negative doubles order like their bit patterns as
// integers, so a window is a candidate only if the high word of its bits is
// at most the minimum's (one int32 compare and a branch taken rarely: on a
// new minimum or a near tie), and only then are the 64-bit patterns compared.
//
// What bounds it on this card: operations. A (document, dimension, byte)
// step is 5 f64 instructions (fma, fma, fma_rd, add, fma) at 64 an SM a
// clock; the bytes read are one per document byte and the outputs 8 per
// (document, dimension).
//
// What the design does about it. The TPU kernel laid dimensions down the
// sublanes and 128 documents across the lanes, kept the state in two 21-bit
// int32 limbs (no f64 on a TPU) with an f32 quotient estimate, and unrolled
// the byte loop 8x. Here a thread takes one dimension, its state, minimum
// and count in registers; the wrapper orders the dimensions by width, so a
// warp's threads mostly share one width, run the same warm-up and read the
// same old byte. A CTA takes up to 256 dimensions and a run of pieces from
// ops.fingerprints_kernel.minhash_plan: whole documents packed several to a
// CTA, and byte ranges of the longer ones, so that the CTAs of a launch do
// about the same number of steps. A piece covers the windows that END in its
// range [s, e) of its document: each dimension starts from a zero state
// w - 1 bytes before s (at byte 0 for a document's first range), pushes
// those bytes without counting, and then counts every window. A rolling
// hash depends on its window's bytes only, so a range reaches the same
// states as a roll from the document's start. A piece streams through
// shared memory in chunks, each staged with a halo of `halo` bytes before
// it and stored as byte + 1 in f64: the new byte is a broadcast read and
// the old byte one of a few addresses per warp. The wrapper sizes the halo
// to the widest width of the parameter set up to kMaxHalo (rounded up to
// 32; 32 for the default widths), and the chunk to at least four halos, so
// the halo's restaging costs at most a fifth of a chunk's staging. A width
// wider than kMaxHalo rolls its whole piece from global memory instead, in
// a loop of its own after the piece's last chunk. A whole document writes its (document,
// dimension) result directly; a cut range writes its minimum (the integer
// value) and count to a partial slot, and `fingerprint_merge` (a thread a
// dimension, a CTA a cut document) keeps the smallest minimum of the
// document's slots and adds the counts of the slots that reached it; a
// range with no full window holds the sentinel and count 0 and adds
// nothing.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // dimensions per CTA
constexpr int kMaxHalo = 1024;    // the most bytes staged before a chunk (40 KB of staging)
constexpr int kLoads = 5;         // bytes each thread stages a chunk, halo included
// The steady loop's unroll, of 4, 8, 16 and 32 steps on chip_smoke.py's
// phase 4d workloads: 16 the fastest on the lines (32 steps 5.7% slower),
// 1.4% behind 32 on the documents (tools/minhash_ab.py --unroll, which
// builds the library with each -DSZ_MINHASH_UNROLL; PERF.md §6).
#ifndef SZ_MINHASH_UNROLL
#define SZ_MINHASH_UNROLL 16
#endif
constexpr int kUnroll = SZ_MINHASH_UNROLL;
constexpr double kTwo52 = 4503599627370496.0;
// +inf's bits: above the bits of every hash, so the first window replaces it
constexpr unsigned long long kNoWindow = 0x7ff0000000000000ull;
constexpr int kNoWindowHi = 0x7ff00000;

// One step of the roll: state' = (state * mult + y) mod m, y = fd * old + new
// (steps 2-5 of the comment at the top).
__device__ __forceinline__ double roll(double state, double mult, double y, double m,
                                       double inv_m) {
  const double x = fma(state, mult, y);
  const double q = __fma_rd(x, inv_m, kTwo52) - kTwo52;
  return fma(-q, m, x);
}

// Doubles staged a chunk, halo first: kLoads a thread, and at least five
// halos.
__host__ __device__ __forceinline__ int staged_size(int threads, int halo) {
  return kLoads * threads > 5 * halo ? kLoads * threads : 5 * halo;
}

// A window's hash r against the running minimum (its bits and their high
// word) and count.
__device__ __forceinline__ void seen(double r, unsigned long long& min_bits, int& min_hi,
                                     int& count) {
  if (__double2hiint(r) <= min_hi) {
    const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(r));
    count = bits < min_bits ? 1 : count + (bits == min_bits);
    min_bits = bits < min_bits ? bits : min_bits;
    min_hi = static_cast<int>(min_bits >> 32);
  }
}

// pieces: 4 long longs a piece: the blob offset of its document's byte 0, the
// range [s, e) of window ends, and where it writes: the document's row
// (>= 0) or partial slot -1 - out. cta_first[c] .. cta_first[c + 1] are CTA
// c's pieces. The parameters are in kernel order (by width): slot k holds
// dimension dim_of[k]. halo, at most kMaxHalo, is the bytes staged before a
// chunk: widths up to it read their old byte there.
__global__ void __launch_bounds__(kMaxThreads)
fingerprint_minhash(const uint8_t* __restrict__ blob, const long long* __restrict__ pieces,
                    const long long* __restrict__ cta_first, const int32_t* __restrict__ width,
                    const int32_t* __restrict__ dim_of, const double* __restrict__ mult,
                    const double* __restrict__ modulo, const double* __restrict__ fused_disc,
                    const double* __restrict__ inv_modulo, int ndim, int halo,
                    int32_t* __restrict__ hashes, int32_t* __restrict__ counts,
                    long long* __restrict__ part_min, int32_t* __restrict__ part_count) {
  extern __shared__ double buf[];  // staged_size doubles: byte c0 - halo + i at buf[i]
  const int threads = blockDim.x;
  const int chunk = staged_size(threads, halo) - halo;  // >= 4 halos >= every staged w
  const int k = blockIdx.y * threads + threadIdx.x;
  const bool active = k < ndim;
  const int w = active ? width[k] : 1;
  const int dim = active ? dim_of[k] : 0;
  const double mul = active ? mult[k] : 0.0;
  const double m = active ? modulo[k] : 1.0;
  const double fd = active ? fused_disc[k] : 0.0;
  const double inv_m = active ? inv_modulo[k] : 1.0;
  const bool staged = w <= halo;

  for (long long p = cta_first[blockIdx.x]; p < cta_first[blockIdx.x + 1]; ++p) {
    const uint8_t* doc = blob + pieces[4 * p];
    const long long s = pieces[4 * p + 1], e = pieces[4 * p + 2], out = pieces[4 * p + 3];
    double state = 0.0;
    unsigned long long min_bits = kNoWindow;
    int min_hi = kNoWindowHi, count = 0;
    for (long long c0 = s; c0 < e; c0 += chunk) {
      const int n = static_cast<int>(min(static_cast<long long>(chunk), e - c0));
      __syncthreads();  // the last chunk's reads are done
      for (int i = threadIdx.x; i < halo + n; i += threads) {
        const long long at = c0 - halo + i;
        if (at >= 0) buf[i] = static_cast<double>(__ldg(doc + at)) + 1.0;
      }
      __syncthreads();
      if (!active) continue;
      if (staged) {
        int i = 0;  // 32-bit indices inside the chunk: byte c0 + i is buf[halo + i]
        if (c0 == s) {
          // Warm-up: push the lead bytes before s (w - 1, or all of them on
          // a document's first range) and the byte that fills the window.
          const int lead = static_cast<int>(min(s, static_cast<long long>(w - 1)));
          const int full = w - 1 - lead;  // the first full window's i
          const int stop = min(full, n - 1);
          for (int j = -lead; j <= stop; ++j) state = roll(state, mul, buf[halo + j], m, inv_m);
          if (full < n) seen(state, min_bits, min_hi, count);
          i = full + 1;
        }
        const double* fresh = buf + halo;
        const double* old = fresh - w;  // old[i] is byte c0 + i - w, in the halo or the chunk
        // kUnroll steps unrolled: the loads and fma(fd, old, new) of later
        // steps, which do not wait for the state, issue ahead of its chain
#pragma unroll (kUnroll)
        for (; i < n; ++i) {
          state = roll(state, mul, fma(fd, old[i], fresh[i]), m, inv_m);
          seen(state, min_bits, min_hi, count);
        }
      } else if (c0 + chunk >= e) {
        // A width wider than the halo (the wrapper's halo: wider than
        // kMaxHalo): the whole piece from global memory, after its last
        // chunk is staged.
        const long long p0 = max(0ll, s - (w - 1));
        for (long long t = p0; t < e; ++t) {
          const double add = static_cast<double>(__ldg(doc + t)) + 1.0;
          const double sub = t - p0 >= w ? static_cast<double>(__ldg(doc + t - w)) + 1.0 : 0.0;
          state = roll(state, mul, fma(fd, sub, add), m, inv_m);
          if (t - p0 >= w - 1) seen(state, min_bits, min_hi, count);
        }
      }
    }
    if (!active) continue;
    // The minimum as its integer value (exact: < 2^43); LLONG_MAX if no window.
    const long long value =
        count > 0 ? static_cast<long long>(__longlong_as_double(static_cast<long long>(min_bits)))
                  : LLONG_MAX;
    if (out >= 0) {
      const size_t at = static_cast<size_t>(out) * ndim + dim;
      hashes[at] = count > 0 ? static_cast<int32_t>(static_cast<uint32_t>(value)) : -1;
      counts[at] = count;
    } else {
      const size_t at = static_cast<size_t>(-1 - out) * ndim + dim;
      part_min[at] = value;
      part_count[at] = count;
    }
  }
}

// cut[0 .. n_cut) are the cut documents, cut[n_cut + j] .. cut[n_cut + j + 1]
// the partial slots of document j.
__global__ void __launch_bounds__(kMaxThreads)
fingerprint_merge(const long long* __restrict__ cut, int n_cut,
                  const long long* __restrict__ part_min, const int32_t* __restrict__ part_count,
                  int ndim, int32_t* __restrict__ hashes, int32_t* __restrict__ counts) {
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= ndim) return;
  const long long doc = cut[blockIdx.x];
  long long best = LLONG_MAX;
  int count = 0;
  for (long long j = cut[n_cut + blockIdx.x]; j < cut[n_cut + blockIdx.x + 1]; ++j) {
    const long long v = part_min[j * ndim + d];
    const int c = part_count[j * ndim + d];
    count = v < best ? c : count + (v == best ? c : 0);
    best = v < best ? v : best;
  }
  const size_t at = static_cast<size_t>(doc) * ndim + d;
  hashes[at] = count > 0 ? static_cast<int32_t>(static_cast<uint32_t>(best)) : -1;
  counts[at] = count;
}

dim3 threads_for(int ndim) { return dim3(min(kMaxThreads, (ndim + 31) / 32 * 32)); }

}  // namespace

// Rolls n_ctas CTAs of planned pieces (see fingerprint_minhash) for ndim
// dimensions into hashes/counts[n_docs][ndim] (int32 holding the u32 bits;
// rows of whole documents) and part_min/part_count[slots][ndim] (cut
// ranges). width, dim_of int32 and mult, modulo, fused_disc, inv_modulo f64,
// [ndim] each, in kernel order; halo in [1, kMaxHalo]. Launches on `stream`
// without synchronising; returns the launch status.
extern "C" cudaError_t sz_fingerprints(const uint8_t* blob, const long long* pieces,
                                       const long long* cta_first, int n_ctas,
                                       const int32_t* width, const int32_t* dim_of,
                                       const double* mult, const double* modulo,
                                       const double* fused_disc, const double* inv_modulo,
                                       int ndim, int halo, int32_t* hashes,
                                       int32_t* counts, long long* part_min,
                                       int32_t* part_count, cudaStream_t stream) {
  if (halo < 1 || halo > kMaxHalo) return cudaErrorInvalidValue;
  if (n_ctas <= 0 || ndim <= 0) return cudaSuccess;
  const dim3 threads = threads_for(ndim);
  const unsigned dim_blocks = (ndim + threads.x - 1) / threads.x;
  if (dim_blocks > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(double) * staged_size(threads.x, halo);  // <= 40 KB
  fingerprint_minhash<<<dim3(static_cast<unsigned>(n_ctas), dim_blocks), threads, smem, stream>>>(
      blob, pieces, cta_first, width, dim_of, mult, modulo, fused_disc, inv_modulo, ndim, halo,
      hashes, counts, part_min, part_count);
  return cudaGetLastError();
}

// Merges the partial slots of n_cut cut documents (see fingerprint_merge)
// into their rows of hashes/counts[n_docs][ndim].
extern "C" cudaError_t sz_fingerprints_merge(const long long* cut, int n_cut,
                                             const long long* part_min,
                                             const int32_t* part_count, int ndim,
                                             int32_t* hashes, int32_t* counts,
                                             cudaStream_t stream) {
  if (n_cut <= 0 || ndim <= 0) return cudaSuccess;
  const dim3 threads = threads_for(ndim);
  const unsigned dim_blocks = (ndim + threads.x - 1) / threads.x;
  if (dim_blocks > 65535) return cudaErrorInvalidConfiguration;
  fingerprint_merge<<<dim3(static_cast<unsigned>(n_cut), dim_blocks), threads, 0, stream>>>(
      cut, n_cut, part_min, part_count, ndim, hashes, counts);
  return cudaGetLastError();
}
