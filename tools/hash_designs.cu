// The table-lookup designs of csrc/hash.cu's hash_short that were timed
// against the one it keeps. Each section below replaces the region of
// csrc/hash.cu from "// -- hash_short's lookups" to "// -- end of
// hash_short's lookups" in a copy that tools/hash_ab.py builds
// (--designs, --sass); they are not part of the kernel library. A section
// defines what the region does: kShortTableWords (the table's 32-bit words
// in shared memory), kShortStageWords (scratch words the build may use),
// build_short_table(T, stage) (each CTA's threads fill T) and
// short_aesenc(s, key, T, lane), one AESENC as lane `lane` of a warp runs it. Its
// header line names the CTA geometry it is built with (the table's size
// bounds how many CTAs share an SM; at 64 registers a thread, 1,024 threads
// an SM either way).
//
// The first four index the table with shifts and masks (x << 5 words for
// entry x); the PRMT ones, as the kept design, by one __byte_perm: entry x
// of lane j at byte 256 x + 4 j (+ 128 for a second table in the same rows).

// == design one_table_shifts threads=512 ctas=2
// T0 replicated per bank, entry x of lane j at word 32 x + j (32 KiB); T1-T3
// are T0 rotated left by 8, 16 and 24 bits, a funnel shift each.
constexpr int kShortTableWords = 256 * 32;
constexpr int kShortStageWords = 0;

__device__ __forceinline__ void build_short_table(uint32_t* T, uint32_t*) {
  for (int w = threadIdx.x; w < kShortTableWords; w += blockDim.x) T[w] = table_entry(w >> 5, 0);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int bits) {
  return __funnelshift_l(x, x, bits);
}

__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key,
                                              const uint32_t* T, uint32_t lane) {
  const uint32_t* L = T + lane;
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    o.w[c] = L[(s.w[c] & 0xFFu) << 5] ^ rotl(L[((s.w[(c + 1) & 3] >> 8) & 0xFFu) << 5], 8) ^
             rotl(L[((s.w[(c + 2) & 3] >> 16) & 0xFFu) << 5], 16) ^
             rotl(L[(s.w[(c + 3) & 3] >> 24) << 5], 24) ^ key.w[c];
  return o;
}

// == design four_tables_shifts threads=1024 ctas=1
// T0-T3, each replicated per bank: entry x of table r for lane j is word
// 8192 r + 32 x + j. No rotations; 128 KiB, so one CTA an SM.
constexpr int kShortTableWords = 4 * 256 * 32;
constexpr int kShortStageWords = 0;

__device__ __forceinline__ void build_short_table(uint32_t* T, uint32_t*) {
  for (int w = threadIdx.x; w < kShortTableWords; w += blockDim.x)
    T[w] = table_entry((w >> 5) & 255, w >> 13);
}

__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key,
                                              const uint32_t* T, uint32_t lane) {
  const uint32_t* L = T + lane;
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    o.w[c] = L[(s.w[c] & 0xFFu) << 5] ^ L[8192 + (((s.w[(c + 1) & 3] >> 8) & 0xFFu) << 5)] ^
             L[16384 + (((s.w[(c + 2) & 3] >> 16) & 0xFFu) << 5)] ^
             L[24576 + ((s.w[(c + 3) & 3] >> 24) << 5)] ^ key.w[c];
  return o;
}

// == design two_tables_shifts threads=512 ctas=2
// T0 and T1 replicated per bank (64 KiB); T2 and T3 are T0 and T1 rotated
// by 16 bits, so a column takes one rotation: T0[a] ^ T1[b] ^ rotl16(T0[c] ^ T1[d]).
constexpr int kShortTableWords = 2 * 256 * 32;
constexpr int kShortStageWords = 0;

__device__ __forceinline__ void build_short_table(uint32_t* T, uint32_t*) {
  for (int w = threadIdx.x; w < kShortTableWords; w += blockDim.x)
    T[w] = table_entry((w >> 5) & 255, w >> 13);
}

__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key,
                                              const uint32_t* T, uint32_t lane) {
  const uint32_t* L = T + lane;
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t hi = L[((s.w[(c + 2) & 3] >> 16) & 0xFFu) << 5] ^
                        L[8192 + ((s.w[(c + 3) & 3] >> 24) << 5)];
    o.w[c] = L[(s.w[c] & 0xFFu) << 5] ^ L[8192 + (((s.w[(c + 1) & 3] >> 8) & 0xFFu) << 5)] ^
             __funnelshift_l(hi, hi, 16) ^ key.w[c];
  }
  return o;
}

// == design sbox_bytes threads=512 ctas=2
// The S-box alone as bytes, replicated per bank: word 32 q + j holds S-box
// bytes 4q..4q+3 for lane j (8 KiB), read a byte at a time. ShiftRows picks
// the bytes of each column; MixColumns is computed in SWAR on the column,
// out = xtime(a ^ rotr8(a)) ^ rotr8(a) ^ rotr16(a) ^ rotr24(a).
constexpr int kShortTableWords = 64 * 32;
constexpr int kShortStageWords = 0;

__device__ __forceinline__ void build_short_table(uint32_t* T, uint32_t*) {
  for (int w = threadIdx.x; w < kShortTableWords; w += blockDim.x) {
    const int q = w >> 5;
    T[w] = static_cast<uint32_t>(kSbox[4 * q]) | (static_cast<uint32_t>(kSbox[4 * q + 1]) << 8) |
           (static_cast<uint32_t>(kSbox[4 * q + 2]) << 16) |
           (static_cast<uint32_t>(kSbox[4 * q + 3]) << 24);
  }
}

__device__ __forceinline__ uint32_t sub_byte(const uint32_t* L, uint32_t x) {
  return reinterpret_cast<const uint8_t*>(L)[((x & 0xFCu) << 5) | (x & 3u)];
}

__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key,
                                              const uint32_t* T, uint32_t lane) {
  const uint32_t* L = T + lane;
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t a = sub_byte(L, s.w[c] & 0xFFu) |
                       (sub_byte(L, (s.w[(c + 1) & 3] >> 8) & 0xFFu) << 8) |
                       (sub_byte(L, (s.w[(c + 2) & 3] >> 16) & 0xFFu) << 16) |
                       (sub_byte(L, s.w[(c + 3) & 3] >> 24) << 24);
    const uint32_t b = __funnelshift_r(a, a, 8);
    const uint32_t t = a ^ b;
    const uint32_t x2 = ((t & 0x7F7F7F7Fu) << 1) ^ (((t >> 7) & 0x01010101u) * 0x1Bu);
    o.w[c] = x2 ^ b ^ __funnelshift_r(a, a, 16) ^ __funnelshift_r(a, a, 24) ^ key.w[c];
  }
  return o;
}

// == design one_table threads=512 ctas=2
// T0 alone in rows of 256 bytes (entry x of lane j at byte 256 x + 4 j; the
// rows' upper halves unused), 64 KiB; T1-T3 by rotation, a funnel shift each.
constexpr int kShortTableWords = 256 * 64;
constexpr int kShortStageWords = 0;

__device__ __forceinline__ void build_short_table(uint32_t* T, uint32_t*) {
  for (int w = threadIdx.x; w < kShortTableWords; w += blockDim.x) T[w] = table_entry(w >> 6, 0);
}

__device__ __forceinline__ uint32_t short_entry(const uint32_t* T, uint32_t w, uint32_t lane,
                                                int k) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint8_t*>(T) +
                                            __byte_perm(w, lane, 0x5504u | (k << 4)));
}

__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key,
                                              const uint32_t* T, uint32_t lane) {
  const uint32_t lo = lane << 2;
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t a = short_entry(T, s.w[c], lo, 0);
    const uint32_t b = short_entry(T, s.w[(c + 1) & 3], lo, 1);
    const uint32_t d = short_entry(T, s.w[(c + 2) & 3], lo, 2);
    const uint32_t e = short_entry(T, s.w[(c + 3) & 3], lo, 3);
    o.w[c] = a ^ __funnelshift_l(b, b, 8) ^ __funnelshift_l(d, d, 16) ^
             __funnelshift_l(e, e, 24) ^ key.w[c];
  }
  return o;
}

// == design two_tables threads=512 ctas=2
// T0 and T1 in the same rows of 256 bytes (T0 at 4 j, T1 at 128 + 4 j),
// 64 KiB; T2 and T3 by a 16-bit rotation: T0[a] ^ T1[b] ^ rotl16(T0[c] ^ T1[d]).
constexpr int kShortTableWords = 256 * 64;
constexpr int kShortStageWords = 0;

__device__ __forceinline__ void build_short_table(uint32_t* T, uint32_t*) {
  for (int w = threadIdx.x; w < kShortTableWords; w += blockDim.x)
    T[w] = table_entry(w >> 6, (w >> 5) & 1);
}

__device__ __forceinline__ uint32_t short_entry(const uint32_t* T, uint32_t w, uint32_t lane,
                                                int k) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint8_t*>(T) +
                                            __byte_perm(w, lane, 0x5504u | (k << 4)));
}

__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key,
                                              const uint32_t* T, uint32_t lane) {
  const uint32_t lo = lane << 2, hi = lo | 128u;
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t up = short_entry(T, s.w[(c + 2) & 3], lo, 2) ^
                        short_entry(T, s.w[(c + 3) & 3], hi, 3);
    o.w[c] = short_entry(T, s.w[c], lo, 0) ^ short_entry(T, s.w[(c + 1) & 3], hi, 1) ^
             __funnelshift_l(up, up, 16) ^ key.w[c];
  }
  return o;
}
