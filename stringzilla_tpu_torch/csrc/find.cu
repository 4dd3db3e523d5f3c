// Streaming search over a byte buffer, hand-written for Hopper (sm_90a): the
// first start position, the last one, or the number of them, in [lo, hi],
// where either the k bytes from there equal a needle (any k >= 1, any byte
// values) or the byte there is in a 256-bit set.
//
// Replaces the JAX package's Pallas kernel
// stringzilla_tpu/ops/find_pallas.py::_kernel (sz_find, sz_rfind,
// sz_find_byteset and counting; reference find.h:43-431). The TPU kernel
// streamed 128 KiB blocks with a halo in a sequential grid, ANDed compares
// at up to 16 needle offsets and left longer needles to a host loop that
// verified each candidate (find_long). This kernel filters on a few offsets
// the host picks and verifies every needle byte of the survivors, so it is
// exact for any k in one launch.
//
// What bounds it on this card: memory. A full scan reads each haystack byte
// once (a tile's 128-byte halo again, mostly from L2); a forward search that
// hits early reads little more than up to the hit.
//
// What the design does about it.
// * Feeding: the start positions are cut into tiles of kTile. One producer
//   warp a CTA claims tiles from an atomic counter (ascending for "first",
//   descending for "last") and copies each tile with its halo into a ring of
//   kStages shared-memory stages by one TMA bulk copy (cp.async.bulk, an
//   mbarrier a stage), so kStages tiles a CTA are in flight with no register
//   or instruction spent on them. What TMA cannot take, a haystack that is
//   not 16-byte aligned and the last < 16 bytes of the buffer, the producer
//   warp copies with plain loads. kCtasPerSm persistent CTAs an SM.
// * Filter: a dense prefix filter does work that grows with the needle's
//   matched prefix (a needle whose first bytes are in every line keeps a
//   candidate in nearly every warp). Instead the host picks 1-3 offsets of
//   the needle (ops/find_kernel.py filter_offsets: the last reachable byte
//   and the rarest others, after the reference's anomaly offsets,
//   find/serial.h:35). Each consumer thread takes one 4-byte word of the
//   tile at a time, neighbouring threads on neighbouring words (conflict-free
//   shared-memory loads), and ANDs one zero-byte test per offset: the word
//   at offset o funnel-shifted into place, XORed with the needle byte and
//   tested with (y - 0x01010101) & ~y, which may flag a byte above a true
//   zero but never misses one. The cost per byte is fixed by the number of
//   offsets, whatever the haystack holds. A byteset looks each byte up in a
//   256-byte table in shared memory (byte_perm to index, byte_perm to pack).
// * Verification: the rare flagged positions compare every needle byte,
//   four at a time from the stage and the needle's head in shared memory,
//   the rest byte by byte (past the stage from global memory, past the
//   head from the needle on the device). Where every needle byte is an
//   offset (k <= 3), the filter's exact form decides instead.
// * Early exit: a "first" or "last" search keeps the best hit a CTA knows
//   of in shared memory. Its consumers test each tile against it before
//   scanning; its producer tests each claim and folds in the grid's best,
//   read once a tile. The producer fetches its next claim and the grid's
//   best a tile ahead, so neither round trip stalls the ring. So an early
//   hit ends the scan within about a tile on every CTA. The producer ends
//   the ring by a stage whose tile is -1, which the consumers read as the
//   stop: every issued copy is waited for.
// * One launch a search: the 3 scratch words (claim counter, finished CTAs,
//   encoded best) are zeroed by a memset on the stream; the last CTA to
//   finish decodes the best into the answer.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;           // + the producer warp
constexpr int kTile = 16384;                        // start positions (and bytes) a tile
constexpr int kHalo = 128;                          // bytes past a tile that its stage holds
constexpr int kStageBytes = kTile + kHalo;
constexpr int kStages = 4;
constexpr int kCtasPerSm = 2;
constexpr int kMaxOffsets = 3;                      // the plan's offsets (FILTER_OFFSETS)
constexpr int kHead = 256;                          // needle bytes held in shared memory
constexpr int kWordsPerThread = kTile / 4 / kConsumers;
constexpr int kGroup = 8;                           // words a thread filters between tests
constexpr long long kWaitCycles = 1ll << 34;        // ~9 s: a stuck ring traps, it does not hang
static_assert(kTile % (4 * kConsumers * kGroup) == 0, "a tile is whole groups for every consumer");
static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned for TMA");

enum Mode { kFirst = 0, kLast = 1, kCount = 2 };

struct Params {
  const uint8_t* hay;
  const uint8_t* needle;         // the whole needle on the device, read past kHead bytes
  long long n;                   // bytes of the haystack that exist
  long long k;                   // needle length (1 for a byteset)
  long long lo, hi;              // inclusive window of start positions, 0 <= lo <= hi <= n - k
  long long base;                // tile 0's first byte: lo + lead rounded down to 16
  long long tiles;
  uint32_t pattern[kMaxOffsets]; // the needle byte at offsets[i], in all 4 bytes
  int word[kMaxOffsets];         // (offsets[i] - lead) / 4
  int shift[kMaxOffsets];        // 8 * ((offsets[i] - lead) % 4)
  int lead;                      // offsets[0]: tile t's positions start at base + t kTile - lead
  int mode, aligned;
  uint32_t byteset[8];           // bit b of word w is byte 32 w + b
  uint32_t head[kHead / 4];      // the needle's first kHead bytes, little-endian words
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// True if no position of the tile whose first position is `pos0` can beat
// the best hit so far. (The grid keeps its best in scratch[2] under
// atomicMax: ~p for "first", p + 1 for "last", 0 meaning none.)
__device__ __forceinline__ bool beaten(long long pos0, long long best, int mode) {
  return mode == kFirst ? pos0 > best : (mode == kLast ? pos0 + kTile - 1 < best : false);
}

// Bit 7 of byte s of the result: position 4u + s of the tile may match (a
// needle: every offset's byte equals, with a rare false flag above a true
// match) or matches (a byteset: s_lut holds 0x80 for each byte of the set).
// S is the stage as words.
template <int kOff>
__device__ __forceinline__ uint32_t filter(const Params& P, const uint32_t* S, int u,
                                           const uint8_t* s_lut) {
  if constexpr (kOff == 0) {
    const uint32_t w = S[u];
    const uint32_t b0 = s_lut[__byte_perm(w, 0, 0x4440)], b1 = s_lut[__byte_perm(w, 0, 0x4441)];
    const uint32_t b2 = s_lut[__byte_perm(w, 0, 0x4442)], b3 = s_lut[__byte_perm(w, 0, 0x4443)];
    return __byte_perm(__byte_perm(b0, b1, 0x1140), __byte_perm(b2, b3, 0x1140), 0x5410);
  } else {
    uint32_t y = S[u] ^ P.pattern[0];
    uint32_t acc = (y - 0x01010101u) & ~y;
#pragma unroll
    for (int i = 1; i < kOff; ++i) {
      const uint32_t lo = S[u + P.word[i]];
      const uint32_t hi = P.shift[i] ? S[u + P.word[i] + 1] : 0u;
      y = __funnelshift_r(lo, hi, P.shift[i]) ^ P.pattern[i];
      acc &= (y - 0x01010101u) & ~y;
    }
    return acc & 0x80808080u;
  }
}

// The filter's exact form, for a needle whose every byte is an offset: bit
// 7 of byte s set iff every offset's byte equals (no carry crosses a byte).
template <int kOff>
__device__ __forceinline__ uint32_t exact(const Params& P, const uint32_t* S, int u) {
  uint32_t acc = 0x80808080u;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const uint32_t lo = S[u + P.word[i]];
    const uint32_t hi = P.shift[i] ? S[u + P.word[i] + 1] : 0u;
    const uint32_t y = __funnelshift_r(lo, hi, P.shift[i]) ^ P.pattern[i];
    acc &= ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y);
  }
  return acc;
}

// Bit 7 of byte s: position p0 + s lies in [lo, hi].
__device__ __forceinline__ uint32_t window(long long p0, long long lo, long long hi) {
  uint32_t m = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (p0 + s >= lo && p0 + s <= hi) m |= 0x80u << (8 * s);
  return m;
}

// Every needle byte at position p, whose tile's stage S8 holds bytes
// [at, at + avail) of the haystack.
__device__ bool verify(const Params& P, const uint8_t* S8, long long at, long long avail,
                       long long p, const uint32_t* s_head) {
  const long long rel = p - at;
  long long j = 0;
  if (rel >= 0) {
    const uint32_t* S = reinterpret_cast<const uint32_t*>(S8);
    const int sh = 8 * static_cast<int>(rel & 3);
    for (; j + 4 <= P.k && j + 4 <= kHead && rel + j + 4 <= avail && rel + j + 8 <= kStageBytes;
         j += 4) {
      const long long q = (rel + j) >> 2;
      if (__funnelshift_r(S[q], S[q + 1], sh) != s_head[j >> 2]) return false;
    }
  }
  const uint8_t* head = reinterpret_cast<const uint8_t*>(s_head);
  for (; j < P.k; ++j) {
    const long long q = rel + j;
    const uint8_t h = q >= 0 && q < avail ? S8[q] : P.hay[p + j];
    if (h != (j < kHead ? head[j] : P.needle[j])) return false;
  }
  return true;
}

// One tile: its stage S8 holds bytes [at, at + avail); its positions start
// at pos0. Returns this thread's hits for "count"; folds "first" and "last"
// into the CTA's best (s_best) and the grid's (best, encoded).
template <int kOff, bool kExact>
__device__ __forceinline__ unsigned long long scan_tile(const Params& P, const uint8_t* S8,
                                                        long long at, long long pos0,
                                                        long long avail, const uint32_t* s_head,
                                                        const uint8_t* s_lut, long long* s_best,
                                                        unsigned long long* best) {
  const uint32_t* S = reinterpret_cast<const uint32_t*>(S8);
  const bool whole = pos0 >= P.lo && pos0 + kTile - 1 <= P.hi;
  unsigned long long found = 0;
  long long local = P.mode == kFirst ? LLONG_MAX : -1;
  // kGroup words filtered with no branch between them (their loads and
  // chains interleave), then one test for the group
  for (int g = 0; g < kWordsPerThread; g += kGroup) {
    uint32_t cand[kGroup], any = 0;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      cand[q] = filter<kOff>(P, S, threadIdx.x + (g + q) * kConsumers, s_lut);
      any |= cand[q];
    }
    if (!any) continue;
    bool stop = false;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      uint32_t c = cand[q];
      if (!c || stop) continue;
      const int u = threadIdx.x + (g + q) * kConsumers;
      const long long p0 = pos0 + 4ll * u;
      if (!whole) c &= window(p0, P.lo, P.hi);
      if constexpr (kOff > 0 && kExact) {
        c &= exact<kOff>(P, S, u);
      } else if constexpr (kOff > 0) {
        uint32_t hits = 0;
        for (uint32_t rest = c; rest; rest &= rest - 1) {
          const int b = __ffs(rest) - 1;
          if (verify(P, S8, at, avail, p0 + (b >> 3), s_head)) hits |= 1u << b;
        }
        c = hits;
      }
      if (!c) continue;
      if (P.mode == kCount) {
        found += __popc(c);
      } else if (P.mode == kFirst) {
        local = p0 + ((__ffs(c) - 1) >> 3);
        stop = true;  // this thread's later words lie further on
      } else {
        local = p0 + ((31 - __clz(c)) >> 3);
      }
    }
    if (stop) break;
  }
  if (P.mode == kFirst && local != LLONG_MAX) {
    atomicMin(s_best, local);
    atomicMax(best, ~static_cast<unsigned long long>(local));
  }
  if (P.mode == kLast && local >= 0) {
    atomicMax(s_best, local);
    atomicMax(best, static_cast<unsigned long long>(local) + 1);
  }
  return found;
}

template <int kOff, bool kExact>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
find_search(const Params P, unsigned long long* __restrict__ scratch) {
  extern __shared__ __align__(128) uint8_t ring[];  // kStages stages of kStageBytes
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ long long tile_of[kStages];
  __shared__ long long s_best;  // the best hit this CTA knows of
  __shared__ uint32_t s_head[kHead / 4];
  __shared__ uint32_t s_set[8];
  __shared__ uint8_t s_lut[256];
  __shared__ unsigned long long s_count[kConsumerWarps];
  unsigned long long* counter = scratch;
  unsigned long long* done = scratch + 1;
  unsigned long long* best = scratch + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s_best = P.mode == kFirst ? LLONG_MAX : -1;
  } else if (threadIdx.x == 32) {
#pragma unroll
    for (int i = 0; i < kHead / 4; ++i) s_head[i] = P.head[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) s_set[i] = P.byteset[i];
  }
  __syncthreads();
  if (kOff == 0 && threadIdx.x < 256)
    s_lut[threadIdx.x] = (s_set[threadIdx.x >> 5] >> (threadIdx.x & 31) & 1u) << 7;
  __syncthreads();

  unsigned long long found = 0;
  if (warp == kConsumerWarps) {
    // the producer: claim a tile, copy it with its halo into the next stage.
    // The next claim and the grid's best are fetched a tile ahead, so that
    // neither round trip holds the ring up.
    int stage = 0;
    uint32_t phase = 0;
    long long c_next = 0;
    unsigned long long seen = 0;  // the grid's best, encoded, as last read
    if (lane == 0) c_next = static_cast<long long>(atomicAdd(counter, 1ull));
    for (;;) {
      bar_wait(&empty[stage], phase ^ 1);
      long long t = -1;
      if (lane == 0 && c_next < P.tiles) {
        t = P.mode == kLast ? P.tiles - 1 - c_next : c_next;
        c_next = static_cast<long long>(atomicAdd(counter, 1ull));
        if (P.mode != kCount) {
          if (seen) {
            if (P.mode == kFirst) atomicMin(&s_best, static_cast<long long>(~seen));
            else atomicMax(&s_best, static_cast<long long>(seen) - 1);
          }
          if (beaten(P.base + t * kTile - P.lead, *reinterpret_cast<volatile long long*>(&s_best),
                     P.mode))
            t = -1;
          seen = *reinterpret_cast<volatile unsigned long long*>(best);
        }
      }
      t = __shfl_sync(0xffffffffu, t, 0);
      uint8_t* buf = ring + stage * kStageBytes;
      if (t < 0) {
        if (lane == 0) {
          tile_of[stage] = -1;
          bar_arrive(&full[stage]);
        }
        break;
      }
      const long long at = P.base + t * kTile;
      const long long avail = P.n - at < kStageBytes ? P.n - at : kStageBytes;
      const long long bulk = P.aligned ? avail & ~15ll : 0;
      for (long long q = bulk + lane; q < avail; q += 32) buf[q] = P.hay[at + q];
      __syncwarp();
      if (lane == 0) {
        tile_of[stage] = t;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_arrive_tx(&full[stage], static_cast<uint32_t>(bulk));
        if (bulk) bulk_load(buf, P.hay + at, static_cast<uint32_t>(bulk), &full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // the consumers: scan each tile the ring brings, until the stop
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      bar_wait(&full[stage], phase);
      const long long t = *reinterpret_cast<volatile long long*>(&tile_of[stage]);
      if (t < 0) break;
      const long long at = P.base + t * kTile;
      const long long pos0 = at - P.lead;
      if (P.mode == kCount ||
          !beaten(pos0, *reinterpret_cast<volatile long long*>(&s_best), P.mode)) {
        const long long avail = P.n - at < kStageBytes ? P.n - at : kStageBytes;
        found += scan_tile<kOff, kExact>(P, ring + stage * kStageBytes, at, pos0, avail, s_head,
                                         s_lut, &s_best, best);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (P.mode == kCount) {
      for (int off = 16; off > 0; off >>= 1) found += __shfl_down_sync(0xffffffffu, found, off);
      if (lane == 0) s_count[warp] = found;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (P.mode == kCount) {
      unsigned long long total = 0;
      for (int i = 0; i < kConsumerWarps; ++i) total += s_count[i];
      if (total) atomicAdd(best, total);
      __threadfence();
    }
    if (atomicAdd(done, 1ull) == gridDim.x - 1) {  // the last CTA: decode the answer
      __threadfence();
      const unsigned long long e = atomicAdd(best, 0ull);
      long long out = static_cast<long long>(e);
      if (P.mode == kFirst) out = e ? static_cast<long long>(~e) : -1;
      if (P.mode == kLast) out = static_cast<long long>(e) - 1;
      *reinterpret_cast<volatile long long*>(best) = out;
    }
  }
}

template <int kOff, bool kExact = false>
cudaError_t launch(const Params& P, unsigned long long* scratch, int sm_count,
                   cudaStream_t stream) {
  constexpr int kRing = kStages * kStageBytes;
  static unsigned long long ready = 0;  // devices whose attribute is set, a bit each
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !(ready >> device & 1)) {
    err = cudaFuncSetAttribute(find_search<kOff, kExact>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
    if (err == cudaSuccess)  // room for kCtasPerSm rings an SM
      err = cudaFuncSetAttribute(find_search<kOff, kExact>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (device < 64) ready |= 1ull << device;
  }
  long long blocks = static_cast<long long>(sm_count > 0 ? sm_count : 1) * kCtasPerSm;
  if (blocks > P.tiles) blocks = P.tiles;
  find_search<kOff, kExact>
      <<<static_cast<unsigned>(blocks), kThreads, kRing, stream>>>(P, scratch);
  return cudaGetLastError();
}

// launch<n_off, kExact>: the kernel of a plan of n_off offsets, tried from kOff up to
// kMaxOffsets; a count outside those is invalid.
template <int kOff, bool kExact>
cudaError_t launch_plan(int n_off, const Params& P, unsigned long long* scratch, int sm_count,
                        cudaStream_t stream) {
  if constexpr (kOff > kMaxOffsets) {
    return cudaErrorInvalidValue;
  } else {
    return n_off == kOff ? launch<kOff, kExact>(P, scratch, sm_count, stream)
                         : launch_plan<kOff + 1, kExact>(n_off, P, scratch, sm_count, stream);
  }
}

}  // namespace

// Streaming search of hay[0, n) over start positions [lo, hi] (the caller
// clips hi to n - k). kind 0 finds the k-byte needle: head holds its first
// min(k, 256) bytes in host memory, needle_dev all k bytes on the device
// (read only when k > 256, may be null otherwise), offsets the n_off (1-3)
// ascending offsets of its filter, each < k and within 127 of the first.
// kind 1 tests the 8 words of byteset (host memory). mode 0/1/2 =
// first/last/count. scratch: 3 int64 on the device, zeroed here; the answer
// (position, -1, or count) is left in scratch[2]. Launches on `stream`
// without synchronising; returns the first failing call's status.
extern "C" cudaError_t sz_find_search(const uint8_t* hay, long long n, int mode, int kind,
                                      const uint8_t* head, const uint8_t* needle_dev,
                                      long long k, const int* offsets, int n_off,
                                      const uint32_t* byteset, long long lo, long long hi,
                                      long long* scratch, int sm_count, cudaStream_t stream) {
  Params P{};
  P.hay = hay;
  P.needle = needle_dev;
  P.n = n;
  P.k = kind ? 1 : k;
  P.mode = mode;
  P.aligned = reinterpret_cast<uintptr_t>(hay) % 16 == 0;
  if (mode < 0 || mode > 2 || P.k < 1 || (!kind && k > kHead && !needle_dev))
    return cudaErrorInvalidValue;
  if (kind) {
    n_off = 0;
    for (int w = 0; w < 8; ++w) P.byteset[w] = byteset[w];
  } else {
    if (n_off < 1 || n_off > kMaxOffsets) return cudaErrorInvalidValue;
    for (int i = 0; i < n_off; ++i)
      if (offsets[i] < 0 || offsets[i] >= k || offsets[i] - offsets[0] >= kHalo ||
          (i && offsets[i] <= offsets[i - 1]))
        return cudaErrorInvalidValue;
    uint8_t* bytes = reinterpret_cast<uint8_t*>(P.head);
    for (long long j = 0; j < k && j < kHead; ++j) bytes[j] = head[j];
    P.lead = offsets[0];
    for (int i = 0; i < n_off; ++i) {
      const int e = offsets[i] - P.lead;
      P.word[i] = e >> 2;
      P.shift[i] = 8 * (e & 3);
      P.pattern[i] = 0x01010101u * bytes[offsets[i]];
    }
  }
  P.lo = lo < 0 ? 0 : lo;
  P.hi = hi < n - P.k ? hi : n - P.k;
  if (P.hi < P.lo)  // no start position: -1, or a count of 0
    return cudaMemsetAsync(scratch + 2, mode == kCount ? 0 : 0xFF, sizeof(long long), stream);
  P.base = (P.lo + P.lead) & ~15ll;
  P.tiles = (P.hi + P.lead - P.base) / kTile + 1;
  auto* words = reinterpret_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, 3 * sizeof(long long), stream);
  if (err != cudaSuccess) return err;
  if (n_off == P.k)  // every needle byte is an offset: the exact filter decides
    return launch_plan<1, true>(n_off, P, words, sm_count, stream);
  return launch_plan<0, false>(n_off, P, words, sm_count, stream);
}

// The kernel's geometry, as ops/find_kernel.py GEOMETRY states it: tile
// positions, halo bytes, ring stages, CTAs an SM, filter offsets at most,
// needle bytes in shared memory, threads a CTA.
extern "C" void sz_find_geometry(int* out) {
  const int g[] = {kTile, kHalo, kStages, kCtasPerSm, kMaxOffsets, kHead, kThreads};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
}
