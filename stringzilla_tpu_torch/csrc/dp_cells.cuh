// The cell helpers shared by the wavefront kernels of this directory: the
// flat tier (wavefront.cu) and the ring tile (ring.cu). A cell's costs and
// its min/max, the DP border of the JAX kernels, the clamp of class ids,
// and the tagged 64-bit slots through which a strip of rows hands its
// bottom row to the strip below inside one launch, with the bounded wait on
// them. Everything lies in an anonymous namespace: each source that
// includes this file gets its own copy, and the library exports none.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kClasses = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoChar = -1;  // a char of b past its ends: only masked cells compare it
constexpr long long kQuietCycles = 1 << 15;  // ~16 us between a wait's looks at the flags
constexpr long long kFlatWaitCycles = 1LL << 34;  // ~8.7 s at 1.98 GHz
constexpr int kStalled = 3;

struct Costs {
  int gap;       // linear: open_or_extend; affine: open
  int extend;    // affine only
  int match;     // uniform only
  int mismatch;  // uniform only
};

template <bool kMax>
__device__ __forceinline__ int opt(int a, int b) {
  return kMax ? max(a, b) : min(a, b);
}

// opt(a + b, c) in one DPX instruction, then opt with 0 when local (for max
// in the same instruction).
template <bool kMax, bool kLocal>
__device__ __forceinline__ int add_opt(int a, int b, int c) {
  if (!kLocal) return kMax ? __viaddmax_s32(a, b, c) : __viaddmin_s32(a, b, c);
  return kMax ? __viaddmax_s32_relu(a, b, c) : min(__viaddmin_s32(a, b, c), 0);
}

template <bool kLocal, bool kAffine>
__device__ __forceinline__ int boundary(int k, const Costs& c) {
  if (kLocal) return 0;
  if (kAffine) return k > 0 ? c.gap + c.extend * (k - 1) : 0;
  return c.gap * k;
}

template <bool kLocal, bool kAffine>
__device__ __forceinline__ int gap_boundary(int k, const Costs& c) {
  return boundary<kLocal, kAffine>(k, c) + c.gap + c.extend;
}

__device__ __forceinline__ int clamp_class(int c) {
  return min(max(c, 0), kClasses - 1);
}

// Lane l's class profile of its R rows (R a multiple of 4) in its warp's
// part of shared memory, at byte `warp_base`: byte x of word (k R / 4 + g)
// * 32 + l is table[class of row 4 g + x][k] (table[k][that class] when
// `transposed`), all in bank l, so a cell's cost is one conflict-free
// signed byte load. `rows` points at the lane's first row's char; rows q
// >= rq lie past the matrix and take class 0.
template <int R>
__device__ __forceinline__ void fill_profile(unsigned char* prof, int warp_base,
                                             const int32_t* rows, int rq,
                                             const int32_t* table, bool transposed) {
  static_assert(R % 4 == 0, "a lane's profile packs its rows four to a word");
  const int lane = threadIdx.x & 31;
  int cls[R];
#pragma unroll
  for (int q = 0; q < R; ++q) cls[q] = q < rq ? clamp_class(__ldg(rows + q)) : 0;
  unsigned* words = reinterpret_cast<unsigned*>(prof + warp_base);
  for (int k = 0; k < kClasses; ++k) {
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      unsigned w = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int at = transposed ? k * kClasses + cls[4 * g + x] : cls[4 * g + x] * kClasses + k;
        w |= (static_cast<unsigned>(__ldg(table + at)) & 0xffu) << (8 * x);
      }
      words[(k * (R / 4) + g) * 32 + lane] = w;
    }
  }
}

// Ring words are read and written relaxed at device scope through generic
// addresses (a volatile access would be ordered at system scope), and a
// step's slot is stored under a predicate rather than a branch.
__device__ __forceinline__ long long ring_load(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void ring_store(long long* p, long long v, bool on = true) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q st.relaxed.gpu.b64 [%0], %1;\n\t}"
      ::"l"(p), "l"(v), "r"(static_cast<int>(on)));
}

// One more round of a strip's bounded wait that began at `start`: sleeps a
// little longer each round (up to 1 us), looks at the group's status once
// every kQuietCycles, and marks it stalled past kFlatWaitCycles. False once
// the wait should give up. The clock is the same in every lane.
__device__ __forceinline__ bool flat_waiting(long long& start, long long& looked, unsigned& nap,
                                             int* status) {
  const long long now = clock64();
  if (start < 0) {
    start = looked = now;
    return true;
  }
  __nanosleep(nap);
  nap = min(2 * nap + 32, 1024u);
  if (now - looked < kQuietCycles) return true;
  looked = now;
  int gone = 0;
  if ((threadIdx.x & 31) == 0) {
    if (now - start > kFlatWaitCycles) atomicExch(status, kStalled);
    gone = *reinterpret_cast<volatile int*>(status) != 0;
  }
  return __shfl_sync(kFull, gone, 0) == 0;
}

// A hand-off slot: the writer's tag (its strip number + 1) over the value.
__device__ __forceinline__ long long flat_slot(unsigned tag, int value) {
  return (static_cast<long long>(tag) << 32) | static_cast<unsigned>(value);
}

}  // namespace
