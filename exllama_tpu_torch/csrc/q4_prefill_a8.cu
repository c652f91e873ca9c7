// K10 q4_prefill_a8: turbo prefill matmul (M > 32) straight from the packed
// 4-bit weight, matmul_impl="pallas_a8t" on a tensor without an int8 image.
// The Int8 mode of the pipelined kernel in q4_ring.cuh (which holds the
// design and what bounds it), after the row quantization of x.
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:
// _q4_prefill_kernel_npair_a8 (with _a8_requant_store; launched at
// quant.py:996) and its scratch-overlap twin _q4_prefill_kernel_npair_a8_ovl,
// which computes the same function on a TPU-specific schedule: the weight
// tile is dequantized in f32 (w = q*s - zs) and re-quantized per column
// against the static scale ws (clip(rint(w * (1/ws)), +-127), the
// reciprocal multiply of quant.py:757-770), the activation row-quantized,
// and one int8 x int8 -> int32 product over the whole K rescaled by
// sx[m]*ws[n].
//
// Where the TPU kernel re-quantizes a whole [K, bn] column block once into
// VMEM and reuses it for every M tile, a Hopper block has no such room: the
// producer warps of each 256 x 128 block re-quantize its 64 x 128 weight
// slab per K step, behind the consumer warps' int8 products.
#include "int8_mma.cuh"  // row_quant_kernel, shared with K11
#include "q4_ring.cuh"

// x [M, K] bf16 (already normed and in the weight's row order); qweight
// [K/8, N] int32; scales, zscale [K/gs, N] scale_t (gs a multiple of 32
// dividing K); ws [N] f32 column scales; scratch xq [M, K] int8 and sx [M]
// f32; out [M, N] bf16.
extern "C" int q4_prefill_a8_launch(const void* x, const void* qweight, const void* scales,
                                    const void* zscale, const void* ws, void* xq, void* sx,
                                    void* out, int M, int K, int N, int gs, void* stream) {
  if (K % 32 || gs % 32 || K % gs) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  i8::row_quant_kernel<<<M, i8::THREADS, 0, st>>>((const bf16*)x, (int8_t*)xq, (float*)sx, K);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const ring::Args p{xq, (const int32_t*)qweight, (const scale_t*)scales, (const scale_t*)zscale,
                     (const float*)sx, (const float*)ws, (bf16*)out, M, K, N, gs, /*ldx=*/K,
                     /*ou=*/0};
  return ring::launch<ring::Mode::Int8>(p, st);
}
