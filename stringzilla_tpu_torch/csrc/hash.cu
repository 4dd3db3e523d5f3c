// AES-round hashing (sz_hash) and AES-CTR random bytes (sz_fill_random),
// hand-written for Hopper (sm_90a).
//
// Replaces three of the JAX package's Pallas kernels:
//   stringzilla_tpu/ops/hash_pallas.py::_kernel       -> hash_short (strings <= 64 B)
//   stringzilla_tpu/ops/hash_pallas.py::_kernel_long  -> hash_long  (strings > 64 B)
//   stringzilla_tpu/ops/aes_pallas.py::_fill_kernel   -> fill_random
// and computes what the reference's serial hash computes
// (hash/serial.h:297-303, 443-599, 953-968), bit for bit.
//
// The TPU kernels held every block as 16 int32 byte planes with strings
// across the lanes, built ShiftRows from sublane rolls and selects, looked
// the S-box up with an in-register lane gather, and added the sum lane's
// u64 halves byte by byte with a Kogge-Stone carry. None of that is carried
// over. Here a 16-byte block is four little-endian u32 columns (bytes
// 4c..4c+3 are column c), and one AESENC (SubBytes, ShiftRows, MixColumns,
// xor key) is the textbook T-table round:
//
//   out[c] = T0[b0(s[c])] ^ T1[b1(s[c+1])] ^ T2[b2(s[c+2])] ^ T3[b3(s[c+3])] ^ key[c]
//
// with column indices mod 4 and Tr[x] the MixColumns column of S-box(x)
// rotated by r bytes. The four tables (4 x 256 u32, 4 KB) are built from the
// S-box into shared memory once per CTA. The sum lane is the byte shuffle
// of hash/serial.h:220-231 followed by two wrapping u64 adds.
//
// What bounds them on this card. One AESENC as written is 48 int32
// operations (16 table loads, 16 byte extracts, 16 xors), a sum-lane update
// ~20 (16 byte moves, two 64-bit adds); a 16-byte block absorbed costs ~68.
//   hash_short: a thread a string. Up to four blocks and three finalising
//     rounds, ~212 operations for a token of one block against ~32 bytes
//     moved (its bytes, its start and length, its digest): operations.
//     Two things kept it from them. Its 16 lookups an AESENC went to
//     T[r][x], bank x mod 32: a warp's 32 random bytes put ~3.15 distinct
//     words in the busiest bank, ~3.15 shared-memory wavefronts a lookup.
//     And a warp ran every lane for its longest string's blocks: a log's
//     words are 1-block words with a 3-block one (the word across each line
//     break) in every warp of 32, so every lane ran 3.
//     Its design: the four tables are replicated per bank (entry x of lane
//     j 256 x + 4 j bytes into its table's rows, 128 KiB), so a lane reads
//     only its own bank (one wavefront a lookup) at an address that one
//     PRMT makes; and a warp takes 32 G consecutive strings at a time,
//     ranks them by block count (each lane counts its own G, a warp scan
//     adds the lanes below), and hashes them in G rounds of 32 in that
//     order, so lanes differ in block count only in the round where one
//     count gives way to the next. Each digest goes to its own index; a
//     round's strings are neighbours of one count, so its loads and
//     stores stay close.
//   hash_long: four threads (a quad) a string, thread l owning lane l of the
//     512-bit state. ~4.25 operations a byte absorbed against the byte itself:
//     bytes, narrowly, for many long strings. A single long string is bound
//     by neither: each lane's AES state is a serial chain by the hash's
//     definition, one dependent AESENC a 64-byte chunk, so its floor is that
//     chain's latency and the instructions one warp issues for it.
//   fill_random: a thread a 16-byte block, one AESENC (48 operations) and a
//     16-byte store: bytes.
// What the design does about it: the tables sit in shared memory (for the
// long path and fill_random as T[4][256], whose bank conflicts stay),
// hash_short and fill_random stride over their strings or blocks with a
// grid of a few CTAs an SM so the tables are built once per CTA, and loads
// are aligned 4-byte words joined with __funnelshift_r (never a byte past
// the blob). The long
// path has two kernels, and each string goes to one of them by its own
// length (ops/hash_kernel.py WIDE_BYTES, passed in as wide_min); the host's
// plan (hash_long_plan) sizes each launch's CTAs so that few strings spread
// over every SM:
//   hash_long, a quad a string, for strings shorter than wide_min (a log's
//     lines): a lane's interior chunks, whose words all lie in the blob,
//     are read with no bounds logic, one chunk ahead; the rest through
//     load_block.
//   hash_long_wide, a warp a string (16 of its threads), for the others:
//     thread t holds word t % 4 of lane t / 4's state, so an AESENC column
//     is three shuffles, four table loads and two xors (in a quad, one
//     thread issued all sixteen loads and their extracts: ~100 instructions
//     a chunk in one instruction stream), and each thread keeps the two
//     words of kPrefetch = 32 interior chunks in flight in a register ring.
//   On chip_smoke.py's documents (a 3 MiB string's chain of 49,152 chunks)
//   a quad with one chunk ahead and the bounds logic at every chunk took
//   0.596 us a chunk, a warp with 32 chunks ahead 0.089 (NVIDIA H100 80GB
//   HBM3 at 700 W; tools/dp_hash_sweep.py times both kernels by length).
//
// Digests are written as int64 (the u64 bits): torch on CUDA lacks most
// uint64 operations.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// 1024 bits of pi (reference README.md:766-773), the seeds' and keys' mask.
__constant__ uint64_t kPi[16] = {
    0x243F6A8885A308D3ull, 0x13198A2E03707344ull, 0xA4093822299F31D0ull, 0x082EFA98EC4E6C89ull,
    0x452821E638D01377ull, 0xBE5466CF34E90C6Cull, 0xC0AC29B7C97C50DDull, 0x3F84D5B5B5470917ull,
    0x9216D5D98979FB1Bull, 0xD1310BA698DFB5ACull, 0x2FFD72DBD01ADFB7ull, 0xB8E1AFED6A267E96ull,
    0xBA7C9045F12C7F99ull, 0x24A19947B3916CF7ull, 0x0801F2E2858EFC16ull, 0x636920D871574E69ull,
};

// The AES S-box (FIPS-197).
__device__ const uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

// Sum-lane byte permutation, as aHash (hash/serial.h:220-231): output byte p
// takes input byte nibble p of kShuffle, i.e. 4, 11, 9, 6, 8, 13, 15, 5, 14,
// 3, 1, 12, 0, 7, 10, 2 (a scalar, so device code may read it).
constexpr uint64_t kShuffle = 0x2A70C13E5FD869B4ull;

// A 16-byte block as four little-endian u32 columns: byte b is byte b % 4 of w[b / 4].
struct Block {
  uint32_t w[4];
};

using Tables = const uint32_t (*)[256];

__device__ __forceinline__ Block from_u64(uint64_t lo, uint64_t hi) {
  return Block{{static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
                static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32)}};
}

__device__ __forceinline__ uint64_t low_u64(const Block& b) {
  return static_cast<uint64_t>(b.w[0]) | (static_cast<uint64_t>(b.w[1]) << 32);
}

__device__ __forceinline__ uint64_t high_u64(const Block& b) {
  return static_cast<uint64_t>(b.w[2]) | (static_cast<uint64_t>(b.w[3]) << 32);
}

// Table r's entry for byte x: the MixColumns column of S-box(x), coefficients
// (2, 1, 1, 3) in bytes 0-3, rotated up by r bytes.
__device__ __forceinline__ uint32_t table_entry(int x, int r) {
  const uint32_t s = kSbox[x];
  const uint32_t d = ((s << 1) ^ ((s >> 7) * 0x1Bu)) & 0xFFu;
  const uint32_t t = d | (s << 8) | (s << 16) | ((d ^ s) << 24);
  return r == 0 ? t : (t << (8 * r)) | (t >> (32 - 8 * r));
}

// One AESENC round: SubBytes, ShiftRows, MixColumns, then xor key.
__device__ __forceinline__ Block aesenc(const Block& s, const Block& key, Tables T) {
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    o.w[c] = T[0][s.w[c] & 0xFFu] ^ T[1][(s.w[(c + 1) & 3] >> 8) & 0xFFu] ^
             T[2][(s.w[(c + 2) & 3] >> 16) & 0xFFu] ^ T[3][s.w[(c + 3) & 3] >> 24] ^ key.w[c];
  return o;
}

// shuffle(sum) + data as two wrapping u64 lanes (hash/serial.h:299-302).
__device__ __forceinline__ Block sum_update(const Block& sum, const Block& data) {
  Block sh;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int src = static_cast<int>((kShuffle >> (4 * (4 * k + b))) & 15);
      w |= ((sum.w[src >> 2] >> (8 * (src & 3))) & 0xFFu) << (8 * b);
    }
    sh.w[k] = w;
  }
  return from_u64(low_u64(sh) + low_u64(data), high_u64(sh) + high_u64(data));
}

// Bytes blob[start, start + count) as a block, zero past count (0 <= count
// <= 16). Reads aligned 4-byte words joined by a funnel shift when every
// word lies inside [blob, blob + n), else single bytes; never a byte outside.
__device__ __forceinline__ Block load_block(const uint8_t* blob, long long n, long long start,
                                            int count) {
  Block out{{0, 0, 0, 0}};
  if (count <= 0) return out;
  const uint8_t* p = blob + start;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(addr & ~static_cast<uintptr_t>(3));
  const int shift = static_cast<int>(addr & 3);
  const int words = (shift + count + 3) >> 2;  // 1..5
  if (start >= 0 && base >= blob && base + 4 * words <= blob + n) {
    uint32_t r[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      r[k] = k < words ? __ldg(reinterpret_cast<const unsigned int*>(base) + k) : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) out.w[k] = __funnelshift_r(r[k], r[k + 1], 8 * shift);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < count && start + b >= 0 && start + b < n)
        out.w[b >> 2] |= static_cast<uint32_t>(p[b]) << (8 * (b & 3));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int valid = count - 4 * k;
    out.w[k] &= valid >= 4 ? 0xFFFFFFFFu : (valid <= 0 ? 0u : (1u << (8 * valid)) - 1u);
  }
  return out;
}

__device__ __forceinline__ int clamp16(long long bytes) {
  return bytes >= 16 ? 16 : (bytes <= 0 ? 0 : static_cast<int>(bytes));
}

// key_with_length: (seed + length, seed) as u64 lanes, wrapping.
__device__ __forceinline__ Block key_with_length(uint64_t seed, long long length) {
  return from_u64(seed + static_cast<uint64_t>(length), seed);
}

// Lane l of the 512-bit long-path state of a string of more than 64 bytes
// (hash/serial.h:587-599, 443-460): absorbs block l of every full 64-byte
// chunk, (length - 1) / 64 of them, then block l of the deferred, zero-padded
// last chunk (1-64 bytes: a length that is a multiple of 64 defers a full
// chunk), and returns the lane's mixed block aesenc(sum, aes).
//
// The interior chunks, [lo, hi): full blocks whose aligned words all lie in
// the blob (load_block's word path with count 16), are read with no bounds
// logic, chunk k + 1's words loaded as chunk k is absorbed. The chunks
// before lo (at most one, when the lane's first word starts before the
// blob) and from hi on go through load_block, one chunk ahead.
__device__ __forceinline__ Block hash_long_lane(const uint8_t* blob, long long n, long long start,
                                                long long length, uint64_t seed, int l,
                                                Tables T) {
  Block aes = from_u64(seed ^ kPi[2 * l], seed ^ kPi[2 * l + 1]);
  Block sum = from_u64(seed ^ kPi[8 + 2 * l], seed ^ kPi[9 + 2 * l]);
  const long long chunks = (length - 1) / 64 + 1;  // the full ones and the deferred one
  const long long end = start + length;
  const long long first = start + 16 * l;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(blob + first);
  const unsigned int* w0 = reinterpret_cast<const unsigned int*>(addr & ~static_cast<uintptr_t>(3));
  const int shift = static_cast<int>(addr & 3);
  const int words = shift ? 5 : 4;
  const long long lo = reinterpret_cast<const uint8_t*>(w0) >= blob ? 0 : 1;
  const long long room = (blob + n) - reinterpret_cast<const uint8_t*>(w0) - 4 * words;
  long long hi = room < 0 ? 0 : room / 64 + 1;  // chunks whose words end inside the blob
  if (hi > chunks - 1) hi = chunks - 1;
  long long k = 0;
  if (hi > lo) {
    for (; k < lo; ++k) {
      const Block data = load_block(blob, n, first + 64 * k, 16);
      aes = aesenc(aes, data, T);
      sum = sum_update(sum, data);
    }
    uint32_t r[5];  // chunk k's words
#pragma unroll
    for (int i = 0; i < 5; ++i) r[i] = i < words ? __ldg(w0 + 16 * lo + i) : 0u;
    Block data;
    for (const unsigned int* w = w0 + 16 * (lo + 1); k + 2 <= hi; ++k, w += 16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) data.w[i] = __funnelshift_r(r[i], r[i + 1], 8 * shift);
#pragma unroll
      for (int i = 0; i < 5; ++i) r[i] = i < words ? __ldg(w + i) : 0u;
      aes = aesenc(aes, data, T);
      sum = sum_update(sum, data);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) data.w[i] = __funnelshift_r(r[i], r[i + 1], 8 * shift);
    aes = aesenc(aes, data, T);  // chunk hi - 1
    sum = sum_update(sum, data);
    ++k;
  }
  long long at = first + 64 * k;
  Block next = load_block(blob, n, at, clamp16(end - at));
  for (; k < chunks - 1; ++k) {
    const Block data = next;
    at += 64;
    next = load_block(blob, n, at, clamp16(end - at));
    aes = aesenc(aes, data, T);
    sum = sum_update(sum, data);
  }
  aes = aesenc(aes, next, T);
  sum = sum_update(sum, next);
  return aesenc(sum, aes, T);
}

// The lane collapse and the two keyed rounds (hash/serial.h:461-500).
__device__ __forceinline__ uint64_t hash_long_collapse(const Block& m0, const Block& m1,
                                                       const Block& m2, const Block& m3,
                                                       uint64_t seed, long long length, Tables T) {
  const Block mixed_all = aesenc(aesenc(m0, m1, T), aesenc(m2, m3, T), T);
  return low_u64(aesenc(aesenc(mixed_all, key_with_length(seed, length), T), mixed_all, T));
}

// fill_random's block l: AESENC(ctr || ctr, nonce ^ PI[2(l % 4)] || nonce ^ PI[2(l % 4) + 1])
// with ctr = nonce + l mod 2^64 (hash/serial.h:953-968).
__device__ __forceinline__ Block fill_block(uint64_t nonce, long long l, Tables T) {
  const uint64_t ctr = nonce + static_cast<uint64_t>(l);
  const int v = static_cast<int>(l & 3);
  return aesenc(from_u64(ctr, ctr), from_u64(nonce ^ kPi[2 * v], nonce ^ kPi[2 * v + 1]), T);
}

// -- kernels ---------------------------------------------------------------

__device__ __forceinline__ void build_tables(uint32_t (*T)[256]) {
  for (int x = threadIdx.x; x < 256; x += blockDim.x) {
#pragma unroll
    for (int r = 0; r < 4; ++r) T[r][x] = table_entry(x, r);
  }
  __syncthreads();
}

// -- hash_short's lookups (tools/hash_designs.cu holds the designs they were
// timed against, tools/hash_ab.py --designs) --------------------------------
// T0-T3, each replicated per bank. Entry x of T0 for lane j is at byte
// 256 x + 4 j of the first 64 KiB, of T1 at 256 x + 128 + 4 j; T2 and T3 the
// same in the second 64 KiB. So a lane reads only its own bank j, and a
// warp's 32 lookups are one wavefront, whatever bytes it looks up. The byte
// address is one PRMT: byte k of a state word into bits 8-15, the lane's 4 j
// (or 128 + 4 j) into bits 0-7. 128 KiB, one CTA an SM.
constexpr int kShortTableWords = 4 * 256 * 32;
constexpr int kShortStageWords = 4 * 256;  // build_short_table's scratch

// Fills T with the CTA's threads; `stage` is kShortStageWords of scratch.
// Each entry is computed once into the stage, then copied 32 times, 16
// bytes a store (the 8 lanes of a quarter-warp fill one 128-byte row half).
__device__ __forceinline__ void build_short_table(uint32_t* T, uint32_t* stage) {
  for (int e = threadIdx.x; e < kShortStageWords; e += blockDim.x)
    stage[e] = table_entry(e & 255, e >> 8);
  __syncthreads();
  uint4* T4 = reinterpret_cast<uint4*>(T);
  for (int v = threadIdx.x; v < kShortTableWords / 4; v += blockDim.x) {
    // vector v: words 4 v..4 v + 3 = row x (v / 16 mod 256) of half v / 4096,
    // table 2 (v / 4096) + (v / 8 mod 2)
    const uint32_t t = stage[256 * (2 * (v >> 12) + ((v >> 3) & 1)) + ((v >> 4) & 255)];
    T4[v] = make_uint4(t, t, t, t);
  }
}

// Byte address of entry (byte k of w) of the table at `offset` in its rows
// (4 j or 128 + 4 j for lane j).
__device__ __forceinline__ uint32_t short_address(uint32_t w, uint32_t offset, int k) {
  return __byte_perm(w, offset, 0x5504u | (static_cast<uint32_t>(k) << 4));
}

__device__ __forceinline__ uint32_t short_entry(const uint32_t* T, uint32_t address) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const uint8_t*>(T) + address);
}

// One AESENC as aesenc computes it, each lookup in lane `lane`'s own bank.
__device__ __forceinline__ Block short_aesenc(const Block& s, const Block& key,
                                              const uint32_t* T, uint32_t lane) {
  const uint32_t lo = lane << 2, hi = lo | 128u;
  const uint32_t* T23 = T + 16384;
  Block o;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    o.w[c] = short_entry(T, short_address(s.w[c], lo, 0)) ^
             short_entry(T, short_address(s.w[(c + 1) & 3], hi, 1)) ^
             short_entry(T23, short_address(s.w[(c + 2) & 3], lo, 2)) ^
             short_entry(T23, short_address(s.w[(c + 3) & 3], hi, 3)) ^ key.w[c];
  return o;
}
// -- end of hash_short's lookups ---------------------------------------------

// hash_short's launch (ops/hash_kernel.py SHORT_GEOMETRY mirrors it): a warp
// takes kShortGroup rounds of 32 strings at a time.
constexpr int kShortGroup = 4;
constexpr int kShortThreads = 1024;
constexpr int kShortCtasPerSm = 1;
constexpr int kShortWarps = kShortThreads / 32;
constexpr int kShortGroupStrings = 32 * kShortGroup;
// The table, then each warp's order (a u16 a string: j | length << 9 for the
// group's string j, j < 512 and length <= 64), which is also the table
// build's stage before the first group.
constexpr int kShortOrderBytes = 2 * kShortThreads * kShortGroup;
constexpr int kShortSmemBytes = 4 * kShortTableWords + kShortOrderBytes;
static_assert(kShortGroupStrings <= 512, "a group's index must fit 9 bits");
static_assert(kShortOrderBytes >= 4 * kShortStageWords, "the stage lies in the order");
static_assert(kShortSmemBytes <= 227 * 1024, "more shared memory than a CTA has");
static_assert(kShortGroup % 2 == 0, "a lane's lengths are read in pairs");

// Bytes [shift, shift + count) of the 32 bytes lo, hi as a block, zero past
// count (0 <= shift < 16, 0 <= count <= 16): words shift / 4.. picked by two
// selects a word, joined by funnel shifts.
__device__ __forceinline__ Block short_extract(const uint4& lo, const uint4& hi, int shift,
                                               int count) {
  const uint32_t r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t a[6], b[5];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = (shift & 8) ? r[k + 2] : r[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) b[k] = (shift & 4) ? a[k + 1] : a[k];
  Block out;
#pragma unroll
  for (int k = 0; k < 4; ++k) out.w[k] = __funnelshift_r(b[k], b[k + 1], 8 * (shift & 3));
  if (count < 16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out.w[k] &= __funnelshift_lc(~0u, 0u, max(8 * count - 32 * k, 0));
  }
  return out;
}

// sz_hash of a string of at most 64 bytes (hash/serial.h:506-579): a
// 128-bit state over 1-4 zero-padded blocks, then three keyed rounds. A
// string whose aligned 16-byte vectors all lie in the blob (nearly every
// one) is read a vector at a time, block b from vectors b and b + 1 of it
// (the second only where the block reaches into it, and kept for block
// b + 1); the others through load_block.
__device__ __forceinline__ uint64_t hash_short_string(const uint8_t* blob, long long n,
                                                      long long start, int length, uint64_t seed,
                                                      const uint32_t* T, uint32_t lane) {
  Block aes = from_u64(seed ^ kPi[0], seed ^ kPi[1]);
  Block sum = from_u64(seed ^ kPi[8], seed ^ kPi[9]);
  const int blocks = length <= 16 ? 1 : (length + 15) >> 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(blob + start);
  const uint4* v = reinterpret_cast<const uint4*>(addr & ~static_cast<uintptr_t>(15));
  const int shift = static_cast<int>(addr & 15);
  const bool inside = start >= 0 && reinterpret_cast<const uint8_t*>(v) >= blob &&
                      reinterpret_cast<const uint8_t*>(v + max((shift + length + 15) >> 4, 1)) <=
                          blob + n;
  uint4 cur = inside ? __ldg(v) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < blocks) {
      const int count = min(length - 16 * b, 16);
      Block data;
      if (inside) {
        if (b > 0 && shift == 0) cur = __ldg(v + b);
        const uint4 next = shift + count > 16 ? __ldg(v + b + 1) : make_uint4(0u, 0u, 0u, 0u);
        data = short_extract(cur, next, shift, count);
        cur = next;
      } else {
        data = load_block(blob, n, start + 16 * b, count);
      }
      aes = short_aesenc(aes, data, T, lane);
      sum = sum_update(sum, data);
    }
  }
  const Block mixed = short_aesenc(sum, aes, T, lane);
  return low_u64(short_aesenc(short_aesenc(mixed, key_with_length(seed, length), T, lane), mixed,
                              T, lane));
}

__global__ void __launch_bounds__(kShortThreads, kShortCtasPerSm)
hash_short(const uint8_t* __restrict__ blob, long long n, const long long* __restrict__ starts,
           const long long* __restrict__ lengths, long long count, uint64_t seed,
           long long* __restrict__ out) {
  extern __shared__ uint4 short_smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(short_smem);
  build_short_table(table, table + kShortTableWords);  // staged in the order's space
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint16_t* order = reinterpret_cast<uint16_t*>(table + kShortTableWords) +
                    warp * kShortGroupStrings;
  const long long groups = (count + kShortGroupStrings - 1) / kShortGroupStrings;
  const long long step = static_cast<long long>(gridDim.x) * kShortWarps;
  const bool paired = (reinterpret_cast<uintptr_t>(lengths) & 15) == 0;
  for (long long g = static_cast<long long>(blockIdx.x) * kShortWarps + warp; g < groups;
       g += step) {
    const long long base = g * kShortGroupStrings;
    // Lane l takes the group's strings j = G l + k, k < G, its lengths 16
    // bytes a load where the group is whole: each one's block count (0 for
    // a length outside 0-64, which is not hashed) and its rank among the
    // lane's own strings of that count (slot: rank | blocks << 12 | length
    // << 16); `own` counts them, blocks 1 and 3 in the low 16 bits of
    // own[0] and own[1], 2 and 4 in the high.
    long long len[kShortGroup];
    if (paired && base + kShortGroupStrings <= count) {
      const longlong2* pairs = reinterpret_cast<const longlong2*>(lengths + base) +
                               lane * (kShortGroup / 2);
#pragma unroll
      for (int h = 0; h < kShortGroup / 2; ++h) {
        const longlong2 two = __ldg(pairs + h);
        len[2 * h] = two.x;
        len[2 * h + 1] = two.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kShortGroup; ++k) {
        const long long i = base + kShortGroup * lane + k;
        len[k] = i < count ? lengths[i] : -1;
      }
    }
    uint32_t slot[kShortGroup];
    uint32_t own[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < kShortGroup; ++k) {
      const bool short_one = static_cast<unsigned long long>(len[k]) <= 64;
      const int nb = short_one ? max(static_cast<int>(len[k]) + 15, 16) >> 4 : 0;
      const int half = (nb - 1) >> 1, at = (nb & 1) ? 0 : 16;
      const uint32_t counts = half ? own[1] : own[0];
      slot[k] = ((counts >> at) & 0xFFFFu) | (nb << 12) |
                (short_one ? static_cast<uint32_t>(len[k]) << 16 : 0u);
      if (short_one) {
        if (half) own[1] += 1u << at;
        else own[0] += 1u << at;
      }
    }
    // The lanes' counts summed over the lanes below (an inclusive scan, less
    // the lane's own) and over the warp: the rounds' order is the 1-block
    // strings first, then 2, 3 and 4, each count's in the group's order.
    uint32_t below[2] = {own[0], own[1]};
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const uint32_t lo = __shfl_up_sync(~0u, below[0], d), hi = __shfl_up_sync(~0u, below[1], d);
      if (lane >= d) {
        below[0] += lo;
        below[1] += hi;
      }
    }
    const uint32_t all0 = __shfl_sync(~0u, below[0], 31), all1 = __shfl_sync(~0u, below[1], 31);
    below[0] -= own[0];
    below[1] -= own[1];
    const int from2 = all0 & 0xFFFFu, from3 = from2 + (all0 >> 16),
              from4 = from3 + (all1 & 0xFFFFu), hashed = from4 + (all1 >> 16);
#pragma unroll
    for (int k = 0; k < kShortGroup; ++k) {
      const int nb = (slot[k] >> 12) & 7;
      if (nb != 0) {
        const uint32_t prior = ((nb > 2 ? below[1] : below[0]) >> ((nb & 1) ? 0 : 16)) & 0xFFFFu;
        const int from = nb == 1 ? 0 : nb == 2 ? from2 : nb == 3 ? from3 : from4;
        order[from + prior + (slot[k] & 4095)] =
            static_cast<uint16_t>((kShortGroup * lane + k) | ((slot[k] >> 16) << 9));
      }
    }
    __syncwarp();
    // Round r: lane l hashes entry 32 r + l; the next round's entry and
    // start are read a round ahead.
    const long long* group_starts = starts + base;
    long long* group_out = out + base;
    unsigned e = lane < hashed ? order[lane] : 0u;
    long long start = lane < hashed ? group_starts[e & 511u] : 0;
    for (int p = lane; p - lane < hashed; p += 32) {
      const unsigned e_next = p + 32 < hashed ? order[p + 32] : 0u;
      const long long start_next = p + 32 < hashed ? group_starts[e_next & 511u] : 0;
      if (p < hashed)
        group_out[e & 511u] = static_cast<long long>(
            hash_short_string(blob, n, start, static_cast<int>(e >> 9), seed, table, lane));
      e = e_next;
      start = start_next;
    }
    __syncwarp();  // every lane has read its entries before the next group's
  }
}

__global__ void __launch_bounds__(kThreads)
hash_long(const uint8_t* __restrict__ blob, long long n, const long long* __restrict__ starts,
          const long long* __restrict__ lengths, long long count, uint64_t seed,
          long long wide_min, long long* __restrict__ out) {
  __shared__ uint32_t T[4][256];
  build_tables(T);
  const int l = threadIdx.x & 3;
  const int quad_in_warp = (threadIdx.x & 31) >> 2;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // Whole warps step together, so every lane reaches the shuffles below.
  for (long long base = warp * 8; base < count; base += warps * 8) {
    const long long i = base + quad_in_warp;
    const long long length = i < count ? lengths[i] : 0;
    const bool active = length > 64 && length < wide_min;
    Block m{{0, 0, 0, 0}};
    if (active) m = hash_long_lane(blob, n, starts[i], length, seed, l, T);
    Block m1, m2, m3;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m1.w[k] = __shfl_down_sync(0xffffffffu, m.w[k], 1, 4);
      m2.w[k] = __shfl_down_sync(0xffffffffu, m.w[k], 2, 4);
      m3.w[k] = __shfl_down_sync(0xffffffffu, m.w[k], 3, 4);
    }
    if (active && l == 0)
      out[i] = static_cast<long long>(hash_long_collapse(m, m1, m2, m3, seed, length, T));
  }
}

// A long string a warp, its state split over 16 threads: thread t holds
// word c = t % 4 of lane l = t / 4's AES state (the sum lane whole, as all
// four threads of a lane compute it alike). An AESENC column needs one byte
// of each of the lane's four words, so each round takes three shuffles and
// four table loads a thread, instead of sixteen loads and their extracts
// in one thread: the chain is a shuffle, a load and two xors.
__device__ __forceinline__ uint32_t aes_column(uint32_t s0, uint32_t s1, uint32_t s2, uint32_t s3,
                                               uint32_t key, Tables T) {
  return T[0][s0 & 0xFFu] ^ T[1][(s1 >> 8) & 0xFFu] ^ T[2][(s2 >> 16) & 0xFFu] ^
         T[3][s3 >> 24] ^ key;
}

constexpr unsigned kHalf = 0xFFFFu;  // the 16 threads of a warp that hold a string

// Lane l's four state words, gathered from its four threads.
__device__ __forceinline__ Block gather_lane(uint32_t word, int l) {
  Block b;
#pragma unroll
  for (int j = 0; j < 4; ++j) b.w[j] = __shfl_sync(kHalf, word, 4 * l + j, 16);
  return b;
}

// Column c of AESENC(lane l's state, key): the state's words c + 1..c + 3
// (mod 4) from the lane's other threads.
__device__ __forceinline__ uint32_t next_column(uint32_t word, uint32_t key, int l, int c,
                                                Tables T) {
  const uint32_t s1 = __shfl_sync(kHalf, word, 4 * l + ((c + 1) & 3), 16);
  const uint32_t s2 = __shfl_sync(kHalf, word, 4 * l + ((c + 2) & 3), 16);
  const uint32_t s3 = __shfl_sync(kHalf, word, 4 * l + ((c + 3) & 3), 16);
  return aes_column(word, s1, s2, s3, key, T);
}

// A chunk of lane l at `at` through load_block, its whole state in every
// thread of the lane (the chunks outside the interior).
__device__ __forceinline__ void absorb_block(const uint8_t* blob, long long n, long long at,
                                             long long end, int l, int c, uint32_t& aes,
                                             Block& sum, Tables T) {
  const Block data = load_block(blob, n, at, clamp16(end - at));
  aes = aesenc(gather_lane(aes, l), data, T).w[c];
  sum = sum_update(sum, data);
}

constexpr int kPrefetch = 32;  // interior chunks a thread of hash_long_wide keeps in flight

__device__ __forceinline__ Block hash_long_lane_wide(const uint8_t* blob, long long n,
                                                     long long start, long long length,
                                                     uint64_t seed, int l, int c, Tables T) {
  uint32_t aes = from_u64(seed ^ kPi[2 * l], seed ^ kPi[2 * l + 1]).w[c];
  Block sum = from_u64(seed ^ kPi[8 + 2 * l], seed ^ kPi[9 + 2 * l]);
  const long long chunks = (length - 1) / 64 + 1;
  const long long end = start + length;
  const long long first = start + 16 * l;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(blob + first);
  const unsigned int* w0 = reinterpret_cast<const unsigned int*>(addr & ~static_cast<uintptr_t>(3));
  const int shift = static_cast<int>(addr & 3);
  const int words = shift ? 5 : 4;
  // The interior chunks of every lane: [lo, hi), the same for all 16 threads.
  long long lo = reinterpret_cast<const uint8_t*>(w0) >= blob ? 0 : 1;
  const long long room = (blob + n) - reinterpret_cast<const uint8_t*>(w0) - 4 * words;
  long long hi = room < 0 ? 0 : room / 64 + 1;
  if (hi > chunks - 1) hi = chunks - 1;
#pragma unroll
  for (int off = 4; off < 16; off *= 2) {
    lo = max(lo, static_cast<long long>(__shfl_xor_sync(kHalf, lo, off, 16)));
    hi = min(hi, static_cast<long long>(__shfl_xor_sync(kHalf, hi, off, 16)));
  }
  long long k = 0;
  if (hi - lo >= kPrefetch) {
    for (; k < lo; ++k) absorb_block(blob, n, first + 64 * k, end, l, c, aes, sum, T);
    // Thread c's word of chunk k is funnel-shifted from words c and c + 1.
    const unsigned int* wc = w0 + c;
    uint32_t ring[kPrefetch][2];
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      ring[r][0] = __ldg(wc + 16 * (lo + r));
      ring[r][1] = c + 1 < words ? __ldg(wc + 16 * (lo + r) + 1) : 0u;
    }
    const unsigned int* w = wc + 16 * (lo + kPrefetch);
    for (; k + 2 * kPrefetch <= hi; k += kPrefetch, w += 16 * kPrefetch) {
#pragma unroll
      for (int r = 0; r < kPrefetch; ++r) {
        const uint32_t d = __funnelshift_r(ring[r][0], ring[r][1], 8 * shift);
        ring[r][0] = __ldg(w + 16 * r);
        ring[r][1] = c + 1 < words ? __ldg(w + 16 * r + 1) : 0u;
        const Block data = gather_lane(d, l);
        aes = next_column(aes, d, l, c, T);
        sum = sum_update(sum, data);
      }
    }
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const uint32_t d = __funnelshift_r(ring[r][0], ring[r][1], 8 * shift);
      const Block data = gather_lane(d, l);
      aes = next_column(aes, d, l, c, T);
      sum = sum_update(sum, data);
    }
    k += kPrefetch;
  }
  for (; k < chunks; ++k) absorb_block(blob, n, first + 64 * k, end, l, c, aes, sum, T);
  return aesenc(sum, gather_lane(aes, l), T);
}

__global__ void __launch_bounds__(kThreads)
hash_long_wide(const uint8_t* __restrict__ blob, long long n, const long long* __restrict__ starts,
               const long long* __restrict__ lengths, long long count, uint64_t seed,
               long long wide_min, long long* __restrict__ out) {
  __shared__ uint32_t T[4][256];
  build_tables(T);
  const int t = threadIdx.x & 31;
  if (t >= 16) return;
  const int l = t >> 2, c = t & 3;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       i < count; i += warps) {
    const long long length = lengths[i];
    if (length <= 64 || length < wide_min) continue;
    const Block m = hash_long_lane_wide(blob, n, starts[i], length, seed, l, c, T);
    Block ms[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int w = 0; w < 4; ++w) ms[j].w[w] = __shfl_sync(kHalf, m.w[w], 4 * j, 16);
    if (t == 0)
      out[i] = static_cast<long long>(
          hash_long_collapse(ms[0], ms[1], ms[2], ms[3], seed, length, T));
  }
}

__global__ void __launch_bounds__(kThreads)
fill_random(uint64_t nonce, long long blocks, uint4* __restrict__ out) {
  __shared__ uint32_t T[4][256];
  build_tables(T);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; l < blocks;
       l += stride) {
    const Block b = fill_block(nonce, l, T);
    out[l] = make_uint4(b.w[0], b.w[1], b.w[2], b.w[3]);
  }
}

unsigned grid_for(long long threads, int sm_count) {
  long long blocks = (threads + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count > 0 ? sm_count : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// sz_hash of every string of at most 64 bytes into out[i] (the u64 bits);
// entries of longer strings are left as they are.
//   blob     the bytes, n of them; string i is blob[starts[i] : starts[i] + lengths[i]];
//   starts, lengths  [count] int64.
// Launches on `stream` without synchronising; returns the launch status.
extern "C" cudaError_t sz_hash_short(const uint8_t* blob, long long n, const long long* starts,
                                     const long long* lengths, long long count,
                                     unsigned long long seed, long long* out, int sm_count,
                                     cudaStream_t stream) {
  if (count <= 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      hash_short, cudaFuncAttributeMaxDynamicSharedMemorySize, kShortSmemBytes);
  if (err != cudaSuccess) return err;
  const long long groups = (count + kShortGroupStrings - 1) / kShortGroupStrings;
  long long blocks = (groups + kShortWarps - 1) / kShortWarps;
  const long long cap = static_cast<long long>(sm_count > 0 ? sm_count : 1) * kShortCtasPerSm;
  if (blocks > cap) blocks = cap;
  hash_short<<<static_cast<unsigned>(blocks), kShortThreads, kShortSmemBytes, stream>>>(
      blob, n, starts, lengths, count, seed, out);
  return cudaGetLastError();
}

// hash_short's geometry, which ops/hash_kernel.py SHORT_GEOMETRY mirrors:
// strings a warp's group holds over 32 (G), threads a CTA, CTAs an SM,
// dynamic shared memory a CTA.
extern "C" void sz_hash_short_geometry(int* out) {
  out[0] = kShortGroup;
  out[1] = kShortThreads;
  out[2] = kShortCtasPerSm;
  out[3] = kShortSmemBytes;
}

// sz_hash of every string of more than 64 and fewer than wide_min bytes
// into out[i] (hash_long, a quad a string); entries of other strings are
// left as they are. Arguments as sz_hash_short's, but the launch is the
// host's plan (ops/hash_kernel.py hash_long_plan): `blocks` CTAs of
// `threads` threads (a multiple of 32, at most 256).
extern "C" cudaError_t sz_hash_long(const uint8_t* blob, long long n, const long long* starts,
                                    const long long* lengths, long long count,
                                    unsigned long long seed, long long wide_min, long long* out,
                                    int threads, int blocks, cudaStream_t stream) {
  if (count <= 0) return cudaSuccess;
  if (threads < 32 || threads > kThreads || threads % 32 != 0 || blocks < 1)
    return cudaErrorInvalidConfiguration;
  hash_long<<<blocks, threads, 0, stream>>>(blob, n, starts, lengths, count, seed, wide_min, out);
  return cudaGetLastError();
}

// The same for the strings of more than 64 and at least wide_min bytes
// (hash_long_wide, a warp a string).
extern "C" cudaError_t sz_hash_long_wide(const uint8_t* blob, long long n,
                                         const long long* starts, const long long* lengths,
                                         long long count, unsigned long long seed,
                                         long long wide_min, long long* out, int threads,
                                         int blocks, cudaStream_t stream) {
  if (count <= 0) return cudaSuccess;
  if (threads < 32 || threads > kThreads || threads % 32 != 0 || blocks < 1)
    return cudaErrorInvalidConfiguration;
  hash_long_wide<<<blocks, threads, 0, stream>>>(blob, n, starts, lengths, count, seed, wide_min,
                                                 out);
  return cudaGetLastError();
}

// sz_fill_random's 16 * blocks bytes into out (16-byte aligned).
extern "C" cudaError_t sz_fill_random(unsigned long long nonce, long long blocks, uint8_t* out,
                                      int sm_count, cudaStream_t stream) {
  if (blocks <= 0) return cudaSuccess;
  fill_random<<<grid_for(blocks, sm_count), kThreads, 0, stream>>>(
      nonce, blocks, reinterpret_cast<uint4*>(out));
  return cudaGetLastError();
}
