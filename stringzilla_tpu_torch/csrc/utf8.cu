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
// Both checks are counted once a position, so with zero bytes outside
// [0, n) the same step over any span that covers [0, n + 3) gives them
// exactly: no position needs a mask.
//
// What bounds it on this card: on mostly-ASCII text the bytes (2^28 B read
// once take 0.080 ms at 3.35 TB/s); on multi-byte text the int32 ALU pipe
// (64 lanes an SM a clock; shifts and adds also go to the FMA pipe): a
// 4-byte word's step is ~27 SASS instructions in a row with no byte >= F0
// and ~44 in one with such a byte, most of them LOP3 and shifts
// (tools/utf8_ab.py --probe on an H100). The byte-wise SIMD compares
// (__vcmp*4) have no sm_90 instruction: emulated, a step built on them
// took 195 instructions a word.
//
// What the design does about it:
// - Classes live in bit 7 of each byte, built with shifts, LOP3 and adds
//   that cannot carry across bytes: a = w & (w << 1) is ">= C0",
//   b = a & (a << 1) ">= E0", c = b & (a << 2) ">= F0", and
//   (w & 0x7F..) + k sets bit 7 where the low 7 bits reach 0x80 - k, which
//   with "a" gives ">= C2" and with "c" gives ">= F5". The leads that need a
//   continuation at p + 1, + 2, + 3 are shifted into place with funnel
//   shifts; the previous vector's last word comes from the lane to the left.
// - A continuation out of range is one zero test per word: after E0 or ED,
//   bit 5 of the continuation picks which lead it forbids (E0 + 0x0D * bit
//   5), after F0 or F4, "bits 5-4 not 00" picks F4 over F0; the forbidding
//   lead is built in each byte and xored with the byte before.
// - Rare work runs only where it can matter, in warp-uniform branches: a row
//   of 32 vectors whose bytes and 3-byte look-back are all ASCII costs a few
//   instructions a vector; the >= F0 classes (the F0/F4 ranges, the third
//   byte's look-back, F5-FF) only in a row that holds such a byte; the
//   violation count only in a vector that has one. Positions before 0 or
//   past n occur only in the head (the bytes before the first 16-byte
//   aligned one) and the last rows, which one warp takes with loads that
//   read zeros outside [0, n).
// - The masks come from ops/utf8_device.py as a launch argument (Masks),
//   so the wrapper, this kernel and the numpy model of the step in the
//   tests read one set of constants.
// - Each warp takes groups of kUnroll rows (2 KiB) with 16-byte loads,
//   neighbouring lanes on neighbouring addresses, all four in flight before
//   any is used; counts stay in registers and each CTA adds its pair once.
//   An unaligned buffer costs a head of at most 15 bytes, not byte loads.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kVectorBytes = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows of 32 vectors a warp takes a turn
constexpr int kBlocksPerSm = 4;
constexpr long long kRowBytes = 32 * kVectorBytes;
constexpr long long kGroupBytes = kUnroll * kRowBytes;
constexpr unsigned kFull = 0xffffffffu;

// The step's masks, made by ops/utf8_device.py (MASKS, in this order) and
// passed at launch: the kernel holds no copy of its own.
struct Masks {
  uint32_t high;       // bit 7 of each byte
  uint32_t low7;
  uint32_t ge_c2;      // low 7 bits + ge_c2 reach bit 7 iff >= 0x42
  uint32_t ge_f5;      // ... iff >= 0x75
  uint32_t ones;
  uint32_t lead_e;     // E0 & 0x7F; ED is E0 + e_step
  uint32_t e_step;
  uint32_t lead_f;     // F0 & 0x7F; F4 is F0 ^ f_step
  uint32_t f_step;
  uint32_t bits_54;    // bits 5-4 shifted down; + bits_54 sets bit 2 unless 00
  uint32_t not_first;  // the bytes of a word that reach the next one
};

__device__ __forceinline__ uint32_t load_word(const uint8_t* s, long long p, long long n) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (p + b >= 0 && p + b < n) w |= static_cast<uint32_t>(s[p + b]) << (8 * b);
  return w;
}

// 16 bytes at p, those outside [0, n) read as zero.
__device__ __forceinline__ uint4 load_vector(const uint8_t* s, long long p, long long n) {
  if (p >= 0 && p + 16 <= n && (reinterpret_cast<uintptr_t>(s + p) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(s + p));
  return make_uint4(load_word(s, p, n), load_word(s, p + 4, n), load_word(s, p + 8, n),
                    load_word(s, p + 12, n));
}

// Bit 7 of each byte of w: a ">= C0", b ">= E0", c ">= F0".
__device__ __forceinline__ void ranks(uint32_t w, uint32_t& a, uint32_t& b, uint32_t& c) {
  a = w & (w << 1);
  b = a & (a << 1);
  c = b & (a << 2);
}

// Bit 7 of each byte of w: cont (80-BF), l1 (a continuation must follow
// at p + 1: C2-F4), l2 (at p + 2: E0-F4), l3 (at p + 3: F0-F4), bad (C0,
// C1, F5-FF: a byte >= 80 that is neither a continuation nor a lead).
// kFour false: the caller knows no byte is >= F0 (l3 is 0, no byte F5-FF).
template <bool kFour>
__device__ __forceinline__ void classify(uint32_t w, const Masks& m, uint32_t& cont, uint32_t& l1,
                                         uint32_t& l2, uint32_t& l3, uint32_t& bad) {
  uint32_t a, b, c;
  ranks(w, a, b, c);
  cont = w & ~(w << 1) & m.high;
  const uint32_t x7 = w & m.low7;
  l1 = a & (x7 + m.ge_c2);
  l2 = b;
  l3 = 0;
  if (kFour) {
    const uint32_t f5 = c & (x7 + m.ge_f5);
    l1 &= ~f5;
    l2 &= ~f5;
    l3 = c & ~f5;
  }
  bad = a & ~l1 & m.high;
}

// Continuations out of range after a lead, as "t is zero" in each byte, t
// the low 7 bits of the byte before (a1) xored with the lead that forbids
// byte b. After a 3-byte lead: E0 if bit 5 of b is 0 (80-9F), ED if it is
// 1 (A0-BF).
__device__ __forceinline__ uint32_t after_three(uint32_t a1, uint32_t w, const Masks& m) {
  const uint32_t forbid = ((w >> 5) & m.ones) * m.e_step + m.lead_e;
  return (a1 ^ forbid) & m.low7;
}

// After a 4-byte lead: F0 forbids 80-8F (bits 5-4 00), F4 forbids 90-BF.
__device__ __forceinline__ uint32_t after_four(uint32_t a1, uint32_t w, const Masks& m) {
  const uint32_t above = ((w >> 4) & m.bits_54) + m.bits_54;  // bit 2: bits 5-4 not 00
  return (a1 ^ (above & m.f_step) ^ m.lead_f) & m.low7;
}

// One vector: the 16 positions of w, with prev the 4 bytes before them.
// Adds its continuations to conts and its violations to viol.
template <bool kFour>
__device__ __forceinline__ void vector_step(uint32_t prev, const uint32_t (&w)[4], const Masks& m,
                                            uint32_t& viol, uint32_t& conts) {
  uint32_t p1, p2, p3, unused, c[4], e[4];
  classify<kFour>(prev, m, unused, p1, p2, p3, unused);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t l1, l2, l3, bad;
    classify<kFour>(w[t], m, c[t], l1, l2, l3, bad);
    uint32_t must = __funnelshift_l(p1, l1, 8) | __funnelshift_l(p2, l2, 16);
    if (kFour) must |= __funnelshift_l(p3, l3, 24);
    const uint32_t a1 = __funnelshift_l(prev, w[t], 8);  // the byte before each
    // bit 7 of t + 0x7F.. is clear where t is zero
    uint32_t ok = after_three(a1, w[t], m) + m.low7;
    if (kFour) ok &= after_four(a1, w[t], m) + m.low7;
    e[t] = ((c[t] ^ must) & m.high) | bad | (~ok & a1 & c[t]);
    prev = w[t];
    p1 = l1;
    p2 = l2;
    p3 = l3;
  }
  conts += __popc(c[0] | (c[1] >> 1) | (c[2] >> 2) | (c[3] >> 3));
  if (e[0] | e[1] | e[2] | e[3]) viol += __popc(e[0] | (e[1] >> 1) | (e[2] >> 2) | (e[3] >> 3));
}

// A row of the main loop: every lane a full vector; prev the 4 bytes
// before it. All lanes of the warp take the same branches.
__device__ __forceinline__ void row_step(uint32_t prev, const uint4& v, const Masks& m,
                                         uint32_t& viol, uint32_t& conts) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (!__any_sync(kFull, (w[0] | w[1] | w[2] | w[3] | (prev & m.not_first)) & m.high)) return;
  uint32_t four = 0;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    uint32_t a, b, c;
    ranks(t < 4 ? w[t] : prev, a, b, c);
    four |= c;
  }
  if (__any_sync(kFull, four & m.high))
    vector_step<true>(prev, w, m, viol, conts);
  else
    vector_step<false>(prev, w, m, viol, conts);
}

// Positions [start, end) in rows of 32 vectors a lane each, every byte
// outside [0, n) read as zero: the head before the first aligned byte and
// the last rows, with their 3 positions past n.
__device__ void edge_rows(const uint8_t* s, long long n, long long start, long long end,
                          const Masks& m, int lane, uint32_t& viol, uint32_t& conts) {
  uint32_t carry = load_word(s, start - 4, n);
  for (long long r = start; r < end; r += kRowBytes) {
    const long long p = r + kVectorBytes * lane;
    const bool active = p < end;
    const uint4 v = active ? load_vector(s, p, n) : make_uint4(0, 0, 0, 0);
    const uint32_t left = __shfl_sync(kFull, v.w, (lane + 31) & 31);
    const uint32_t prev = lane == 0 ? carry : left;
    carry = left;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if (active) vector_step<true>(prev, w, m, viol, conts);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
utf8_validate_count(const uint8_t* __restrict__ s, long long n, long long head, long long groups,
                    const Masks m, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long s_sum[2][kWarps];
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const uint8_t* base = s + head;  // 16-byte aligned
  uint32_t viol = 0, conts = 0;
  for (long long g = warp; g < groups; g += warps) {
    const long long p0 = g * kGroupBytes;
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(reinterpret_cast<const uint4*>(base + p0 + u * kRowBytes) + lane);
    uint32_t carry = 0;  // lane 0: the 4 bytes before the group
    if (lane == 0)
      carry = head + p0 >= 4 ? __ldg(reinterpret_cast<const uint32_t*>(base + p0) - 1)
                             : load_word(s, head + p0 - 4, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t left = __shfl_sync(kFull, v[u].w, (lane + 31) & 31);
      row_step(lane == 0 ? carry : left, v[u], m, viol, conts);
      carry = left;
    }
  }
  if (warp == warps - 1) {  // a warp with the fewest groups
    if (head > 0) edge_rows(s, n, head - kVectorBytes, head, m, lane, viol, conts);
    edge_rows(s, n, head + groups * kGroupBytes, n + 3, m, lane, viol, conts);
  }
  // runes = n - continuations, n added once by CTA 0 (unsigned wrap)
  unsigned long long sums[2] = {viol, 0ull - conts};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    for (int off = 16; off > 0; off >>= 1) sums[i] += __shfl_down_sync(kFull, sums[i], off);
    if (lane == 0) s_sum[i][threadIdx.x >> 5] = sums[i];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long total = threadIdx.x == 1 && blockIdx.x == 0 ? n : 0;
    for (int w = 0; w < kWarps; ++w) total += s_sum[threadIdx.x][w];
    if (total) atomicAdd(out + threadIdx.x, total);
  }
}

}  // namespace

// out[0] = violations, out[1] = rune count over s[0, n) (2 int64 on the
// device, zeroed here), with `masks` (host memory) the step's masks in
// Masks' order. One CTA of kThreads for every kWarps groups of 2 KiB, at
// most kBlocksPerSm an SM, at least one. Reads no byte outside [0, n).
// Launches on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_utf8_validate_count(const uint8_t* s, long long n, long long* out,
                                              const uint32_t* masks, int sm_count,
                                              cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(long long), stream);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  long long head = (16 - static_cast<long long>(reinterpret_cast<uintptr_t>(s) % 16)) % 16;
  if (head > n) head = n;
  const long long groups = (n - head) / kGroupBytes;
  long long blocks = (groups + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sm_count > 0 ? sm_count : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  Masks m;
  memcpy(&m, masks, sizeof m);
  utf8_validate_count<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      s, n, head, groups, m, reinterpret_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

// The kernel's geometry, which ops/utf8_device.py mirrors: vector bytes,
// threads a CTA, rows a group, CTAs an SM at most, and the number of masks.
extern "C" void sz_utf8_geometry(int* out) {
  out[0] = kVectorBytes;
  out[1] = kThreads;
  out[2] = kUnroll;
  out[3] = kBlocksPerSm;
  out[4] = sizeof(Masks) / sizeof(uint32_t);
}
