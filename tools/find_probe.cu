// Each filter of csrc/find.cu alone, as the kernel's consumers run it: a
// thread's 16 words of a tile in shared memory, fully unrolled, in a loop
// over tiles, for tools/find_ab.py --sass to count the loop's SASS
// instructions a word (the loop's own counter, compare and branch shared
// by the 16). Built with nvcc -cubin; never launched.

#include "../stringzilla_tpu_torch/csrc/find.cu"

template <int kOff>
__global__ void find_probe(const Params P, int tiles, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t stage[];
  __shared__ uint8_t s_lut[256];
  if (threadIdx.x < 256) s_lut[threadIdx.x] = P.byteset[0] >> (threadIdx.x & 31) << 7;
  __syncthreads();
  uint32_t acc = 0;
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j)
      acc |= filter<kOff>(P, stage, threadIdx.x + j * kConsumers, s_lut);
    __syncwarp();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template __global__ void find_probe<0>(const Params, int, uint32_t*);
template __global__ void find_probe<1>(const Params, int, uint32_t*);
template __global__ void find_probe<2>(const Params, int, uint32_t*);
template __global__ void find_probe<3>(const Params, int, uint32_t*);
