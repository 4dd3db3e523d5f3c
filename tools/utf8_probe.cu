// The UTF-8 pass's word step alone, for counting its SASS instructions
// (tools/utf8_ab.py --probe): csrc/utf8.cu is included as it is, and each
// kernel below runs one of its branches in a loop over 16-byte vectors, so
// the loop's shortest path through its body is that branch's cost a vector.
// Each takes the masks as a launch argument, as the package's kernel does.
// Built with nvcc into a cubin and read with cuobjdump; never launched, not
// part of the package.
//   utf8_probe_load: the loop, its load and an xor (the overhead to take off);
//   utf8_probe_lite: vector_step<false>, a row with no byte >= F0;
//   utf8_probe_four: vector_step<true>, a row with such a byte;
//   utf8_probe_row:  row_step, whose shortest path is an all-ASCII row.

#include "../stringzilla_tpu_torch/csrc/utf8.cu"

extern "C" __global__ void utf8_probe_load(const uint4* __restrict__ v, long long count,
                                           unsigned* out) {
  uint32_t acc = 0;
#pragma unroll 1
  for (long long i = threadIdx.x; i < count; i += blockDim.x) {
    const uint4 x = v[i];
    acc ^= x.x ^ x.y ^ x.z ^ x.w;
  }
  out[threadIdx.x] = acc;
}

template <bool kFour>
__device__ void probe_step(const uint4* __restrict__ v, long long count, const Masks& m,
                           unsigned* out) {
  uint32_t viol = 0, conts = 0, prev = 0;
#pragma unroll 1
  for (long long i = threadIdx.x; i < count; i += blockDim.x) {
    const uint4 x = v[i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    vector_step<kFour>(prev, w, m, viol, conts);
    prev = x.w;
  }
  out[threadIdx.x] = viol + conts;
}

extern "C" __global__ void utf8_probe_lite(const uint4* __restrict__ v, long long count,
                                           const Masks m, unsigned* out) {
  probe_step<false>(v, count, m, out);
}

extern "C" __global__ void utf8_probe_four(const uint4* __restrict__ v, long long count,
                                           const Masks m, unsigned* out) {
  probe_step<true>(v, count, m, out);
}

extern "C" __global__ void utf8_probe_row(const uint4* __restrict__ v, long long count,
                                          const Masks m, unsigned* out) {
  uint32_t viol = 0, conts = 0, prev = 0;
#pragma unroll 1
  for (long long i = threadIdx.x; i < count; i += blockDim.x) {
    const uint4 x = v[i];
    row_step(prev, x, m, viol, conts);
    prev = x.w;
  }
  out[threadIdx.x] = viol + conts;
}
