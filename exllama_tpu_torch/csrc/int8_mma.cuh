// The int8 tensor-core tile loop shared by K10 (q4_prefill_a8.cu) and K11
// (w8_matmul.cu), the turbo-prefill matmuls (matmul_impl="pallas_a8t",
// M > 32), and the row quantization of the activation that both run first.
//
//   sx[m]     = max(max_k |x[m, k]|, 1e-20) / 127
//   xq[m, k]  = clip(rint(x[m, k] / sx[m]), +-127)            (int8)
//   out[m, n] = bf16( float(sum_k xq[m, k] * w8[k, n]) * sx[m] * ws[n] )
//
// The int32 accumulator lives in registers from the first product to the
// rescale, so it never reaches memory (the point of the TPU kernels
// quant.py:_w8_matmul_kernel and _q4_prefill_kernel_npair_a8). The two
// kernels differ only in who fills the weight tile (the BTile functor).
//
// Bound on the H100: operations, at the dense int8 tensor-core rate
// (1,979 TOP/s): at prefill M the 2*M*K*N operations outweigh the K*N (K11)
// or K*N/2 (K10) weight bytes. Design: a 128x128 output tile per block of 8
// warps, each warp a 64x32 sub-tile as 4x4 mma.sync.m16n8k32.s8 fragments
// with int32 accumulators; per 64-deep K step the block stages its 128x64
// int8 activation tile row-major and the weight tile column-major
// (Bt[n][k]), which is what the .row.col instruction reads: each fragment
// register is four consecutive k of one row or column, one 32-bit
// shared-memory load. Row strides of 80 bytes keep those loads free of bank
// conflicts. The K loop lives inside the block. Not pipelined, no wgmma:
// that is the work of a later performance change.
#pragma once

#include "async_mma.cuh"

namespace i8 {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int LD = BK + 16;  // row stride of both shared tiles, bytes

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

using tc::mma_s8;

// out = rescale(xq @ B); btile(Bt, k0, n0) fills Bt[n][k] = B[k0 + k, n0 + n]
// for k < BK, n < BN (zeros beyond K or N); every thread calls it.
template <class BTile>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const float* __restrict__ ws,
    bf16* __restrict__ out, int M, int K, int N, const BTile btile) {
  __shared__ __align__(16) int8_t As[BM * LD];
  __shared__ __align__(16) int8_t Bt[BN * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int grp = lane >> 2, tig = lane & 3;

  int c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: BM rows x BK int8 = 4 x 16-byte vectors per row
    for (int i = tid; i < BM * BK / 16; i += THREADS) {
      const int r = i >> 2, c16 = (i & 3) * 16;
      const int gm = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M && k0 + c16 < K)
        v = *reinterpret_cast<const uint4*>(xq + (size_t)gm * K + k0 + c16);
      *reinterpret_cast<uint4*>(As + r * LD + c16) = v;
    }
    btile(Bt, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      int a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = As + (wm * 64 + i * 16 + grp) * LD + kk + tig * 4;
        a[i][0] = *reinterpret_cast<const int*>(p);
        a[i][1] = *reinterpret_cast<const int*>(p + 8 * LD);
        a[i][2] = *reinterpret_cast<const int*>(p + 16);
        a[i][3] = *reinterpret_cast<const int*>(p + 8 * LD + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bt + (wn * 32 + j * 8 + grp) * LD + kk + tig * 4;
        b[j][0] = *reinterpret_cast<const int*>(p);
        b[j][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(c[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue from registers: a thread holds rows grp, grp + 8 and the
  // column pair 2*tig, 2*tig + 1 of every 16x8 fragment
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * 64 + i * 16 + grp + 8 * h;
      if (gm >= M) continue;
      const float s = sx[gm];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + wn * 32 + j * 8 + tig * 2;
        if (gn >= N) continue;  // N is even: the pair is inside or outside
        const float v0 = __fmul_rn(__fmul_rn((float)c[i][j][2 * h], s), ws[gn]);
        const float v1 = __fmul_rn(__fmul_rn((float)c[i][j][2 * h + 1], s), ws[gn + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gm * N + gn) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// Quantize the rows of x, then out = rescale(xq @ B) with B from btile.
template <class BTile>
static inline cudaError_t quant_matmul(const bf16* x, int8_t* xq, float* sx, const float* ws,
                                       bf16* out, int M, int K, int N, const BTile& btile,
                                       cudaStream_t st) {
  row_quant_kernel<<<M, THREADS, 0, st>>>(x, xq, sx, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<BTile><<<grid, THREADS, 0, st>>>(xq, sx, ws, out, M, K, N, btile);
  return cudaGetLastError();
}

}  // namespace i8
