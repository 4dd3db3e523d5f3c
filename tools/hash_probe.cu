// AESENC alone in a loop, for counting its SASS instructions
// (tools/hash_ab.py --sass). tools/hash_ab.py appends this file to a copy of
// csrc/hash.cu (or of a design of tools/hash_designs.cu put in its place)
// and builds it into a cubin, so both kernels see the copy's definitions:
//   hash_probe_short   8 short_aesenc a trip: hash_short's lookups;
//   hash_probe_tables  8 aesenc a trip over T[4][256]: the lookups that
//                      hash_long and fill_random keep, and hash_short had.
// A trip's instructions over 8 are one AESENC's, with an eighth of the
// loop's counter and branch.

extern "C" __global__ void __launch_bounds__(1024, 1) hash_probe_short(const uint32_t* in, uint32_t* out, int trips) {
  extern __shared__ uint4 probe_smem[];
  uint32_t* T = reinterpret_cast<uint32_t*>(probe_smem);
  build_short_table(T, T + kShortTableWords);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  Block s{{in[4 * t], in[4 * t + 1], in[4 * t + 2], in[4 * t + 3]}};
  const Block key{{in[4 * t] ^ 1u, in[4 * t + 1] ^ 2u, in[4 * t + 2] ^ 3u, in[4 * t + 3] ^ 4u}};
  for (int r = 0; r < trips; ++r) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s = short_aesenc(s, key, T, threadIdx.x & 31);
  }
  out[t] = s.w[0] ^ s.w[1] ^ s.w[2] ^ s.w[3];
}

extern "C" __global__ void __launch_bounds__(1024, 1) hash_probe_tables(const uint32_t* in, uint32_t* out, int trips) {
  __shared__ uint32_t T[4][256];
  build_tables(T);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  Block s{{in[4 * t], in[4 * t + 1], in[4 * t + 2], in[4 * t + 3]}};
  const Block key{{in[4 * t] ^ 1u, in[4 * t + 1] ^ 2u, in[4 * t + 2] ^ 3u, in[4 * t + 3] ^ 4u}};
  for (int r = 0; r < trips; ++r) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s = aesenc(s, key, T);
  }
  out[t] = s.w[0] ^ s.w[1] ^ s.w[2] ^ s.w[3];
}

// Launches one of the two on `blocks` CTAs of `threads` (tables: 1 for
// hash_probe_tables), each thread reading 4 words of `in` and writing one
// of `out`.
extern "C" cudaError_t hash_probe_launch(int tables, const uint32_t* in, uint32_t* out, int trips,
                                         int blocks, int threads, cudaStream_t stream) {
  if (tables) {
    hash_probe_tables<<<blocks, threads, 0, stream>>>(in, out, trips);
  } else {
    const int smem = 4 * (kShortTableWords + kShortStageWords);
    const cudaError_t err =
        cudaFuncSetAttribute(hash_probe_short, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    hash_probe_short<<<blocks, threads, smem, stream>>>(in, out, trips);
  }
  return cudaGetLastError();
}
