// K2 q4_matmul: 4-bit GPTQ matmul for prefill-sized M (M > 32).
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_deqw2_kernel_npair
// (launched at quant.py:996) and its siblings with the same math
// (_q4_deqw_kernel_npair, _q4_deqw_kernel, _q4_deqw2_kernel,
// _q4_deqw2_kernel_npair_ovl): dequantize a weight tile to bf16
// (w = q*s - zs in f32, rounded once), then bf16 products with f32
// accumulation and a bf16 output. Act-order x is gathered by the caller.
//
// Bound on the H100: operations. At prefill M (hundreds to thousands of
// rows) the 2*M*K*N flops outweigh the K*N/2 weight bytes far beyond the
// ~295 flop/byte ridge, so the tensor cores set the floor (989 TFLOP/s
// bf16). Design: 128x128 output tiles, 8 warps each holding a 64x32 f32
// accumulator in WMMA (mma.sync) fragments; per 32-deep K step the block
// stages its x tile and dequantizes its 32x128 weight tile into shared
// memory, so each packed word is unpacked once per block and feeds 128
// rows. The K loop lives inside the block (the TPU kernel's sequential
// grid axis). Not yet pipelined: no cp.async/TMA double buffering and no
// wgmma -- that is the work of a later performance change.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;   // padded row strides (bank spread; 16-byte multiples)
constexpr int B_LD = BN + 8;

__global__ void __launch_bounds__(THREADS) q4_matmul_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qweight,
    const bf16* __restrict__ scales, const bf16* __restrict__ zscale,
    bf16* __restrict__ out, int M, int K, int N, int gs) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM rows x BK bf16 = 4 x 16-byte vectors per row
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int r = i >> 2, c8 = (i & 3) * 8;
      const int gm = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M) v = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + c8);
      *reinterpret_cast<uint4*>(As + r * A_LD + c8) = v;
    }
    // weight tile: BK/8 packed rows x BN columns, each word -> 8 bf16
    for (int i = tid; i < (BK / 8) * BN; i += THREADS) {
      const int wr = i / BN, cc = i - wr * BN;
      const int gn = n0 + cc;
      const int k = k0 + wr * 8;
      if (gn < N) {
        const int32_t w = __ldg(qweight + (size_t)(k >> 3) * N + gn);
        const int grp = k / gs;
        const float s = bf2f(scales[(size_t)grp * N + gn]);
        const float z = bf2f(zscale[(size_t)grp * N + gn]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float q = (float)((w >> (4 * j)) & 0xF);
          Bs[(wr * 8 + j) * B_LD + cc] = f2bf(__fsub_rn(__fmul_rn(q, s), z));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[(wr * 8 + j) * B_LD + cc] = f2bf(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time, casts, masks
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs[warp], c[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * 64 + i * 16 + (e >> 4);
        const int gn = n0 + wn * 32 + j * 16 + (e & 15);
        if (gm < M && gn < N) out[(size_t)gm * N + gn] = f2bf(Cs[warp][e]);
      }
      __syncwarp();
    }
}

}  // namespace

// x [M, K] bf16 (K % 32 == 0, 16-byte aligned rows); qweight [K/8, N] int32;
// scales, zscale [K/gs, N] bf16; out [M, N] bf16.
extern "C" int q4_matmul_launch(const void* x, const void* qweight, const void* scales,
                                const void* zscale, void* out, int M, int K, int N, int gs,
                                void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q4_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int32_t*)qweight, (const bf16*)scales, (const bf16*)zscale,
      (bf16*)out, M, K, N, gs);
  return cudaGetLastError();
}
