// K11 w8_matmul: prefill matmul (M > 32) against the resident int8 image of
// a 4-bit weight, matmul_impl="pallas_a8t" on a tensor that carries `w8`.
// The W8 mode of the pipelined kernel in q4_ring.cuh (which holds the design
// and what bounds it), after the row quantization of x.
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_w8_matmul_kernel
// (launched at quant.py:1342 by _q4_matmul_w8): one int8 x int8 -> int32
// product over the whole K with the (row scale x column scale) rescale in
// the epilogue. The row quantization of the activation, which the JAX
// package leaves to XLA ahead of its kernel, is the row_quant kernel of
// int8_mma.cuh, launched here just before the product.
//
// The image is K-major ([N, K], each column of the weight a contiguous row
// of K bytes), where the JAX package keeps [K, N]: the ring copies it into
// the n-major B tile the int8 mma.sync reads without any transpose.
#include "int8_mma.cuh"  // row_quant_kernel, shared with K10
#include "q4_ring.cuh"

// x [M, K] bf16 (already normed and in the weight's row order); w8 [N, K]
// int8; ws [N] f32; scratch xq [M, K] int8 and sx [M] f32; out [M, N] bf16.
// K % 16 == 0; any N.
extern "C" int w8_matmul_launch(const void* x, const void* w8, const void* ws, void* xq,
                                void* sx, void* out, int M, int K, int N, void* stream) {
  if (K % 16) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  i8::row_quant_kernel<<<M, i8::THREADS, 0, st>>>((const bf16*)x, (int8_t*)xq, (float*)sx, K);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ring::Args p{xq, nullptr, nullptr, nullptr, (const float*)sx, (const float*)ws, (bf16*)out,
               M, K, N, /*gs=*/K, /*ldx=*/K, /*ou=*/0};
  p.w8 = (const int8_t*)w8;
  return ring::launch<ring::Mode::W8>(p, st);
}
