// K2 q4_matmul and K12 q4_matmul_glu: the 4-bit GPTQ matmul for prefill-sized
// M (M > 32), the Exact and Glu modes of the pipelined kernel in
// q4_ring.cuh (which holds the design and what bounds it).
//
// K2 replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_deqw2_kernel_npair
// (launched at quant.py:996) and its siblings with the same math
// (_q4_deqw_kernel_npair, _q4_deqw_kernel, _q4_deqw2_kernel,
// _q4_deqw2_kernel_npair_ovl): dequantize a weight tile to bf16 (w = q*s -
// zs in f32, rounded once), then bf16 products with f32 accumulation and a
// bf16 output. Act-order x is gathered by the caller. 256 x 128 tiles.
//
// K12 replaces quant.py:_q4_deqw2_kernel_npair_glu (same launch site): the
// A tile is formed by the producer warps from the raw fused gate|up output
// x [M, W] as bf16(bf16(silu_f32(gate)) * up), gate = x[m, k], up = x[m, ou
// + k] (the cast order of quant.py:680-682), so the [M, K] activation of the
// down projection never exists in memory. 128 x 128 tiles: a ring slot
// holds the gate and the up slab in the bytes of K2's x slab. Each of the
// N/128 column blocks re-reads its rows' gate and up (L2 serves most of it)
// and recomputes the activation, behind the consumers' products.
#include "q4_ring.cuh"

// x [M, K] bf16 (K % 32 == 0, 16-byte aligned rows); qweight [K/8, N] int32;
// scales, zscale [K/gs, N] scale_t (gs a multiple of 32 dividing K); out [M, N]
// bf16.
extern "C" int q4_matmul_launch(const void* x, const void* qweight, const void* scales,
                                const void* zscale, void* out, int M, int K, int N, int gs,
                                void* stream) {
  if (K % 32 || gs % 32 || K % gs) return cudaErrorInvalidValue;
  const ring::Args p{x, (const int32_t*)qweight, (const scale_t*)scales, (const scale_t*)zscale,
                     /*sx=*/nullptr, /*ws=*/nullptr, (bf16*)out, M, K, N, gs, /*ldx=*/K, /*ou=*/0};
  return ring::launch<ring::Mode::Exact>(p, (cudaStream_t)stream);
}

// K12: x [M, W] bf16, the raw fused gate|up output (W % 8 == 0, ou % 8 == 0,
// ou + K <= W, 16-byte aligned rows); the product runs over
// silu(x[:, :K]) * x[:, ou : ou + K]. The other operands as above.
extern "C" int q4_matmul_glu_launch(const void* x, const void* qweight, const void* scales,
                                    const void* zscale, void* out, int M, int K, int N,
                                    int gs, int W, int ou, void* stream) {
  if (K % 32 || gs % 32 || K % gs || W % 8 || ou % 8 || ou + K > W) return cudaErrorInvalidValue;
  const ring::Args p{x, (const int32_t*)qweight, (const scale_t*)scales, (const scale_t*)zscale,
                     /*sx=*/nullptr, /*ws=*/nullptr, (bf16*)out, M, K, N, gs, /*ldx=*/W, ou};
  return ring::launch<ring::Mode::Glu>(p, (cudaStream_t)stream);
}
