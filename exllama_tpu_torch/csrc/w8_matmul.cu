// K11 w8_matmul: prefill matmul (M > 32) against the resident int8 image of
// a 4-bit weight, matmul_impl="pallas_a8t" on a tensor that carries `w8`.
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_w8_matmul_kernel
// (launched at quant.py:1342 by _q4_matmul_w8): one int8 x int8 -> int32
// product over the whole K with the (row scale x column scale) rescale in
// the epilogue. The row quantization of the activation, which the JAX
// package leaves to XLA ahead of its kernel, is the row_quant kernel of
// int8_mma.cuh, launched here just before the product.
//
// Bound on the H100: operations at the dense int8 rate (int8_mma.cuh). The
// image is [K, N] row-major; the block transposes its 64 x 128 slice into
// the column-major shared tile the instruction reads, four rows by four
// columns at a time in registers (__byte_perm), so global loads stay
// coalesced along N and shared stores are whole words.
#include "int8_mma.cuh"

namespace {

using namespace i8;

struct ImageTile {
  const int8_t* w8;  // [K, N]
  int K, N;
  __device__ __forceinline__ void operator()(int8_t* Bt, int k0, int n0) const {
    // units of 4 k x 4 n: BK/4 * BN/4 of them, n fastest
    for (int i = threadIdx.x; i < (BK / 4) * (BN / 4); i += THREADS) {
      const int kq = i / (BN / 4), nq = i - kq * (BN / 4);
      const int k = k0 + kq * 4, n = n0 + nq * 4;
      unsigned r[4] = {0u, 0u, 0u, 0u};
      if (k < K && n < N) {  // K and N are multiples of 4
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = __ldg(reinterpret_cast<const unsigned*>(w8 + (size_t)(k + j) * N + n));
      }
      // 4x4 byte transpose: t[c] = column c of the four rows
      const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140), hi01 = __byte_perm(r[0], r[1], 0x7362);
      const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140), hi23 = __byte_perm(r[2], r[3], 0x7362);
      const unsigned t[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int cidx = 0; cidx < 4; ++cidx)
        *reinterpret_cast<unsigned*>(Bt + (nq * 4 + cidx) * LD + kq * 4) = t[cidx];
    }
  }
};

}  // namespace

// x [M, K] bf16 (already normed and in the weight's row order); w8 [K, N]
// int8; ws [N] f32; scratch xq [M, K] int8 and sx [M] f32; out [M, N] bf16.
// K % 16 == 0, N % 8 == 0.
extern "C" int w8_matmul_launch(const void* x, const void* w8, const void* ws, void* xq,
                                void* sx, void* out, int M, int K, int N, void* stream) {
  const ImageTile bt{(const int8_t*)w8, K, N};
  return (int)quant_matmul((const bf16*)x, (int8_t*)xq, (float*)sx, (const float*)ws,
                           (bf16*)out, M, K, N, bt, (cudaStream_t)stream);
}
