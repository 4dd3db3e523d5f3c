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
//   hash_long: four threads (a quad) a string, thread l owning lane l of the
//     512-bit state. ~4.25 operations a byte absorbed against the byte itself:
//     bytes, narrowly, for long strings.
//   fill_random: a thread a 16-byte block, one AESENC (48 operations) and a
//     16-byte store: bytes.
// What the design does about it: the tables sit in shared memory (bank
// conflicts of the random indices stay; later work), every kernel strides
// over its strings or blocks with a grid of 8 CTAs an SM so the tables are
// built once per CTA, and loads are aligned 4-byte words joined with
// __funnelshift_r (never a byte past the blob). hash_long's quad loads its
// next 16-byte block before it absorbs the current one, so a long string's
// chain of rounds does not wait on memory at every step.
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

// sz_hash of a string of at most 64 bytes (hash/serial.h:506-579): a
// 128-bit state over 1-4 zero-padded blocks, then three keyed rounds.
__device__ __forceinline__ uint64_t hash_short_one(const uint8_t* blob, long long n,
                                                   long long start, int length, uint64_t seed,
                                                   Tables T) {
  Block aes = from_u64(seed ^ kPi[0], seed ^ kPi[1]);
  Block sum = from_u64(seed ^ kPi[8], seed ^ kPi[9]);
  const int blocks = length <= 16 ? 1 : (length + 15) >> 4;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < blocks) {
      const int count = length - 16 * b;
      const Block data = load_block(blob, n, start + 16 * b, count > 16 ? 16 : count);
      aes = aesenc(aes, data, T);
      sum = sum_update(sum, data);
    }
  }
  const Block mixed = aesenc(sum, aes, T);
  return low_u64(aesenc(aesenc(mixed, key_with_length(seed, length), T), mixed, T));
}

// Lane l of the 512-bit long-path state of a string of more than 64 bytes
// (hash/serial.h:587-599, 443-460): absorbs block l of every full 64-byte
// chunk, (length - 1) / 64 of them, then block l of the deferred, zero-padded
// last chunk (1-64 bytes: a length that is a multiple of 64 defers a full
// chunk), and returns the lane's mixed block aesenc(sum, aes).
__device__ __forceinline__ Block hash_long_lane(const uint8_t* blob, long long n, long long start,
                                                long long length, uint64_t seed, int l,
                                                Tables T) {
  Block aes = from_u64(seed ^ kPi[2 * l], seed ^ kPi[2 * l + 1]);
  Block sum = from_u64(seed ^ kPi[8 + 2 * l], seed ^ kPi[9 + 2 * l]);
  const long long full = (length - 1) / 64;
  const long long end = start + length;
  long long at = start + 16 * l;
  Block next = load_block(blob, n, at, clamp16(end - at));
  for (long long k = 0; k < full; ++k) {
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

__global__ void __launch_bounds__(kThreads)
hash_short(const uint8_t* __restrict__ blob, long long n, const long long* __restrict__ starts,
           const long long* __restrict__ lengths, long long count, uint64_t seed,
           long long* __restrict__ out) {
  __shared__ uint32_t T[4][256];
  build_tables(T);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const long long length = lengths[i];
    if (length < 0 || length > 64) continue;
    out[i] = static_cast<long long>(
        hash_short_one(blob, n, starts[i], static_cast<int>(length), seed, T));
  }
}

__global__ void __launch_bounds__(kThreads)
hash_long(const uint8_t* __restrict__ blob, long long n, const long long* __restrict__ starts,
          const long long* __restrict__ lengths, long long count, uint64_t seed,
          long long* __restrict__ out) {
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
    const bool active = length > 64;
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
  hash_short<<<grid_for(count, sm_count), kThreads, 0, stream>>>(blob, n, starts, lengths, count,
                                                                 seed, out);
  return cudaGetLastError();
}

// sz_hash of every string of more than 64 bytes into out[i], four threads a
// string; entries of shorter strings are left as they are. Arguments as
// sz_hash_short's.
extern "C" cudaError_t sz_hash_long(const uint8_t* blob, long long n, const long long* starts,
                                    const long long* lengths, long long count,
                                    unsigned long long seed, long long* out, int sm_count,
                                    cudaStream_t stream) {
  if (count <= 0) return cudaSuccess;
  hash_long<<<grid_for(4 * count, sm_count), kThreads, 0, stream>>>(blob, n, starts, lengths,
                                                                    count, seed, out);
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
