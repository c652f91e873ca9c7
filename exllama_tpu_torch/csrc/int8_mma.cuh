// The row quantization of the activation that the turbo-prefill matmuls K10
// (q4_prefill_a8.cu) and K11 (w8_matmul.cu) run first (matmul_impl=
// "pallas_a8t", M > 32); their product is the Int8 / W8 mode of the ring
// kernel (q4_ring.cuh):
//
//   sx[m]     = max(max_k |x[m, k]|, 1e-20) / 127
//   xq[m, k]  = clip(rint(x[m, k] / sx[m]), +-127)            (int8)
//   out[m, n] = bf16( float(sum_k xq[m, k] * wq[k, n]) * sx[m] * ws[n] )
//
// wq is the int8 weight: K10 re-quantizes the 4-bit one in the kernel, K11
// reads the resident image.
#pragma once

#include "common.cuh"

namespace i8 {

constexpr int THREADS = 256;

// One block per row of x [M, K] bf16: sx[m] and the int8 row xq[m, :].
__global__ void __launch_bounds__(THREADS) row_quant_kernel(const bf16* __restrict__ x,
                                                            int8_t* __restrict__ xq,
                                                            float* __restrict__ sx, int K) {
  __shared__ float red[THREADS / 32];
  const bf16* row = x + (size_t)blockIdx.x * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS) amax = fmaxf(amax, fabsf(bf2f(row[k])));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(amax, 1e-20f) * (1.0f / 127.0f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* dst = xq + (size_t)blockIdx.x * K;
  // round half to even on a true division, as jnp.round(x / sx)
  for (int k = threadIdx.x; k < K; k += THREADS)
    dst[k] = (int8_t)max(-127, min(127, __float2int_rn(__fdiv_rn(bf2f(row[k]), s))));
}

}  // namespace i8
