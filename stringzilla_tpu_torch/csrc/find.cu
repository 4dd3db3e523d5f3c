// Streaming search over a byte buffer, hand-written for Hopper (sm_90a): the
// first start position, the last one, or the number of them, in [lo, hi],
// where either the k bytes from there equal a needle (any k >= 1) or the
// byte there is in a 256-bit set.
//
// Replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/find_pallas.py::_kernel (sz_find, sz_rfind,
// sz_find_byteset and counting; reference find.h:43-431). The TPU kernel
// streamed 128 KiB blocks in a sequential grid, compared at most 16 needle
// offsets with lane rolls and left longer needles to a host loop that
// verified each candidate (find_long). This kernel compares every byte of
// the needle, so it is exact for any k in one launch.
//
// What bounds it on this card: memory. A full scan reads each haystack byte
// once; the first-byte filter costs ~9 32-bit operations a 4-byte word
// (2.25 a byte) and a byteset ~5 a byte, under the ~5 operations a byte
// the card can afford at its memory rate. A forward search that hits early
// reads only up to the hit.
//
// What the design does about it. The start positions are cut into chunks
// of kChunk; a CTA claims chunks from an atomic counter, in ascending order
// for "first" and descending for "last", and stops once its next chunk lies
// past the best hit found so far (atomicMin / atomicMax on the result), so
// an early hit ends the scan as the TPU kernel's skipped compute did. In a
// chunk, each thread owns 16 consecutive start positions per step: one
// 16-byte load (neighbouring threads on neighbouring addresses), the next
// thread's 16 bytes by a warp shuffle, so a thread sees 32 bytes in
// registers. A SWAR compare of 4 bytes at a time against the needle's first
// bytes keeps a 16-bit candidate mask; needle bytes 16 and up are compared
// from global memory (L1/L2) for the rare survivors. The next step's load
// is issued before the current step is compared. Counting sums __popc of
// the masks and adds once per CTA.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                           // start positions a thread owns per step
constexpr long long kStep = kThreads * kVec;       // 4096 start positions per CTA step
constexpr int kStepsPerChunk = 16;
constexpr long long kChunk = kStep * kStepsPerChunk;  // 65,536 start positions per claim
constexpr int kBlocksPerSm = 8;

enum Mode { kFirst = 0, kLast = 1, kCount = 2 };

struct Params {
  const uint8_t* hay;
  long long n;             // bytes of the haystack that exist
  long long k;             // needle length (1 for a byteset)
  const uint8_t* needle;   // the whole needle on the device (read for k > 16)
  uint32_t pattern[16];    // needle byte j replicated into 4 bytes, j < min(k, 16)
  uint32_t byteset[8];     // 256-bit set, bit b of word w is byte 32 w + b
  long long lo, hi;        // inclusive window of valid start positions, lo >= 0
  long long base;          // lo rounded down to 16: the first chunk's first position
  long long chunks;
  int mode, byteset_kind, aligned;
};

__device__ __forceinline__ uint4 load16(const uint8_t* hay, long long p, long long n, int aligned) {
  if (aligned && p + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(hay + p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (p + b < n) w[b >> 2] |= static_cast<uint32_t>(hay[p + b]) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 0x80 in every byte of x that is zero, 0 elsewhere (exact, no carries out).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
}

// 4-bit mask of the bytes of x equal to the replicated byte in `pattern`.
__device__ __forceinline__ uint32_t eq_bits(uint32_t x, uint32_t pattern) {
  return (((zero_bytes(x ^ pattern) >> 7) * 0x01020408u) >> 24) & 0xFu;
}

// Bit i of the result: bytes i + j of the 32-byte window w equal byte j of
// the needle, for i < 16. j is a compile-time constant after unrolling.
template <int J>
__device__ __forceinline__ uint32_t eq_at(const uint32_t (&w)[8], uint32_t pattern) {
  constexpr int q = J / 4, r = J % 4;
  uint32_t bits = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t x = r == 0 ? w[q + t] : __funnelshift_r(w[q + t], w[q + t + 1], 8 * r);
    bits |= eq_bits(x, pattern) << (4 * t);
  }
  return bits;
}

template <int J>
__device__ __forceinline__ void filter(const uint32_t (&w)[8], const Params& P, uint32_t& cand) {
  if (J < P.k && cand) cand &= eq_at<J>(w, P.pattern[J]);
  if constexpr (J + 1 < 16) filter<J + 1>(w, P, cand);
}

// Start positions p0 + i, i < 16, that lie in [lo, hi], as a bit mask.
__device__ __forceinline__ uint32_t window_bits(long long p0, long long lo, long long hi) {
  const long long first = lo > p0 ? lo - p0 : 0;
  const long long last = hi - p0 < 15 ? hi - p0 : 15;
  if (first > last) return 0;
  return ((2u << last) - 1u) & ~((1u << first) - 1u);
}

__global__ void __launch_bounds__(kThreads)
find_search(const Params P, unsigned long long* __restrict__ counter, long long* __restrict__ result) {
  __shared__ long long s_chunk;
  __shared__ unsigned long long s_count[kThreads / 32];
  __shared__ uint32_t s_set[8];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s_set[i] = P.byteset[i];
  }
  unsigned long long found = 0;  // count mode: hits of this thread
  for (;;) {
    if (threadIdx.x == 0) {
      const long long c = static_cast<long long>(atomicAdd(counter, 1ull));
      long long idx = P.mode == kLast ? P.chunks - 1 - c : c;
      bool stop = c >= P.chunks;
      if (!stop && P.mode == kFirst)
        stop = P.base + idx * kChunk > *reinterpret_cast<volatile long long*>(result);
      if (!stop && P.mode == kLast)
        stop = P.base + (idx + 1) * kChunk - 1 < *reinterpret_cast<volatile long long*>(result);
      s_chunk = stop ? -1 : idx;
    }
    __syncthreads();
    const long long chunk = s_chunk;
    __syncthreads();
    if (chunk < 0) break;

    const long long chunk_first = P.base + chunk * kChunk;
    long long p0 = chunk_first + threadIdx.x * kVec;
    uint4 cur = load16(P.hay, p0, P.n, P.aligned);
    uint4 cur_next = lane == 31 ? load16(P.hay, p0 + kVec, P.n, P.aligned) : make_uint4(0, 0, 0, 0);
    for (int s = 0; s < kStepsPerChunk; ++s, p0 += kStep) {
      uint4 nxt = make_uint4(0, 0, 0, 0), nxt_next = make_uint4(0, 0, 0, 0);
      if (s + 1 < kStepsPerChunk) {
        nxt = load16(P.hay, p0 + kStep, P.n, P.aligned);
        if (lane == 31) nxt_next = load16(P.hay, p0 + kStep + kVec, P.n, P.aligned);
      }
      uint32_t w[8] = {cur.x, cur.y, cur.z, cur.w, 0, 0, 0, 0};
      w[4] = __shfl_down_sync(0xffffffffu, cur.x, 1);
      w[5] = __shfl_down_sync(0xffffffffu, cur.y, 1);
      w[6] = __shfl_down_sync(0xffffffffu, cur.z, 1);
      w[7] = __shfl_down_sync(0xffffffffu, cur.w, 1);
      if (lane == 31) {
        w[4] = cur_next.x;
        w[5] = cur_next.y;
        w[6] = cur_next.z;
        w[7] = cur_next.w;
      }
      uint32_t cand = window_bits(p0, P.lo, P.hi);
      if (cand) {
        if (P.byteset_kind) {
          uint32_t hits = 0;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const uint32_t b = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
            hits |= ((s_set[b >> 5] >> (b & 31)) & 1u) << i;
          }
          cand &= hits;
        } else {
          filter<0>(w, P, cand);
          if (P.k > 16) {
            for (uint32_t rest = cand; rest; rest &= rest - 1) {
              const int i = __ffs(rest) - 1;
              const uint8_t* at = P.hay + p0 + i;
              for (long long j = 16; j < P.k; ++j)
                if (at[j] != P.needle[j]) {
                  cand &= ~(1u << i);
                  break;
                }
            }
          }
        }
      }
      if (cand) {
        if (P.mode == kFirst) atomicMin(result, p0 + __ffs(cand) - 1);
        else if (P.mode == kLast) atomicMax(result, p0 + 31 - __clz(cand));
        else found += __popc(cand);
      }
      cur = nxt;
      cur_next = nxt_next;
    }
  }
  if (P.mode == kCount) {
    for (int off = 16; off > 0; off >>= 1) found += __shfl_down_sync(0xffffffffu, found, off);
    if (lane == 0) s_count[threadIdx.x >> 5] = found;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
      for (int i = 0; i < kThreads / 32; ++i) total += s_count[i];
      if (total) atomicAdd(reinterpret_cast<unsigned long long*>(result), total);
    }
  }
}

__global__ void find_init(unsigned long long* counter, long long* result, int mode) {
  *counter = 0;
  *result = mode == kFirst ? LLONG_MAX : (mode == kLast ? -1 : 0);
}

__global__ void find_finish(long long* result) {
  if (*result == LLONG_MAX) *result = -1;
}

}  // namespace

// Streaming search of hay[0, n) over start positions [lo, hi] (the caller
// clips hi to n - k and lo to >= 0). kind 0 compares the k-byte needle
// (needle_host: its first min(k, 16) bytes in host memory; needle_dev: all k
// bytes on the device, read when k > 16); kind 1 tests byteset_host's 8
// words (host memory). mode 0/1/2 = first/last/count. scratch: 2 int64 on
// the device, [chunk counter, result]; the result (position, -1, or count)
// is left in scratch[1]. Launches on `stream` without synchronising; returns
// the launch status.
extern "C" cudaError_t sz_find_search(const uint8_t* hay, long long n, int mode, int kind,
                                      const uint8_t* needle_host, const uint8_t* needle_dev,
                                      long long k, const uint32_t* byteset_host, long long lo,
                                      long long hi, long long* scratch, int sm_count,
                                      cudaStream_t stream) {
  Params P{};
  P.hay = hay;
  P.n = n;
  P.k = kind ? 1 : k;
  P.needle = needle_dev;
  for (int j = 0; j < 16 && j < P.k && !kind; ++j) P.pattern[j] = 0x01010101u * needle_host[j];
  for (int w = 0; w < 8 && kind; ++w) P.byteset[w] = byteset_host[w];
  P.lo = lo < 0 ? 0 : lo;
  P.hi = hi;
  P.base = P.lo & ~15ll;
  P.chunks = P.hi >= P.lo ? (P.hi - P.base) / kChunk + 1 : 0;
  P.mode = mode;
  P.byteset_kind = kind;
  P.aligned = reinterpret_cast<uintptr_t>(hay) % 16 == 0;
  auto* counter = reinterpret_cast<unsigned long long*>(scratch);
  long long* result = scratch + 1;
  find_init<<<1, 1, 0, stream>>>(counter, result, mode);
  if (P.chunks > 0) {
    long long blocks = static_cast<long long>(sm_count > 0 ? sm_count : 1) * kBlocksPerSm;
    if (blocks > P.chunks) blocks = P.chunks;
    find_search<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(P, counter, result);
  }
  if (mode == kFirst) find_finish<<<1, 1, 0, stream>>>(result);
  return cudaGetLastError();
}
