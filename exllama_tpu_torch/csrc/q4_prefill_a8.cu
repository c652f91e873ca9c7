// K10 q4_prefill_a8: turbo prefill matmul (M > 32) straight from the packed
// 4-bit weight, matmul_impl="pallas_a8t" on a tensor without an int8 image.
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
// Bound on the H100: operations at the dense int8 rate (int8_mma.cuh).
// Where the TPU kernel re-quantizes a whole [K, bn] column block once into
// VMEM and reuses it for every M tile, a Hopper block has no such room: each
// 128x128 output block re-quantizes its own 64 x 128 weight slice per K
// step, so the unpack is repeated M/128 times (15 times at M = 1919). One
// packed word is eight consecutive k of one column, which is eight
// consecutive bytes of the column-major shared tile: one 64-bit store.
#include "int8_mma.cuh"

namespace {

using namespace i8;

struct RequantTile {
  const int32_t* qweight;  // [K/8, N]
  const bf16* scales;      // [K/gs, N]
  const bf16* zscale;
  const float* ws;         // [N]
  int K, N, gs;
  __device__ __forceinline__ void operator()(int8_t* Bt, int k0, int n0) const {
    for (int i = threadIdx.x; i < (BK / 8) * BN; i += THREADS) {
      const int wr = i / BN, cc = i - wr * BN;
      const int gn = n0 + cc, k = k0 + wr * 8;
      uint2 packed = make_uint2(0u, 0u);
      if (gn < N && k < K) {
        const int32_t w = __ldg(qweight + (size_t)(k >> 3) * N + gn);
        const int grp = k / gs;
        const float s = bf2f(scales[(size_t)grp * N + gn]);
        const float z = bf2f(zscale[(size_t)grp * N + gn]);
        const float inv = 1.0f / fmaxf(ws[gn], 1e-22f);
        unsigned b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float wf = __fsub_rn(__fmul_rn((float)((w >> (4 * j)) & 0xF), s), z);
          b[j] = (unsigned)max(-127, min(127, __float2int_rn(__fmul_rn(wf, inv)))) & 0xFFu;
        }
        packed.x = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
        packed.y = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
      }
      *reinterpret_cast<uint2*>(Bt + cc * LD + wr * 8) = packed;
    }
  }
};

}  // namespace

// x [M, K] bf16 (already normed and in the weight's row order); qweight
// [K/8, N] int32; scales, zscale [K/gs, N] bf16; ws [N] f32 column scales;
// scratch xq [M, K] int8 and sx [M] f32; out [M, N] bf16. K % 16 == 0.
extern "C" int q4_prefill_a8_launch(const void* x, const void* qweight, const void* scales,
                                    const void* zscale, const void* ws, void* xq, void* sx,
                                    void* out, int M, int K, int N, int gs, void* stream) {
  const RequantTile bt{(const int32_t*)qweight, (const bf16*)scales, (const bf16*)zscale,
                       (const float*)ws, K, N, gs};
  return (int)quant_matmul((const bf16*)x, (int8_t*)xq, (float*)sx, (const float*)ws,
                           (bf16*)out, M, K, N, bt, (cudaStream_t)stream);
}
