// K4 dense_gemv: bf16 GEMV x[M<=32, K] @ w[K, V] -> f32 [M, V].
//
// Replaces the TPU kernel exllama_tpu/ops/dense.py:_kernel (launched at
// dense.py:56): the lm_head product of every forward that returns logits,
// bf16 inputs, f32 accumulation and f32 output. Bound by bytes; the loop,
// and what its design does about that, is dense_stream.cuh's: stream-K over
// (256-column tile, 32-row unit) work on one block an SM, a 5-slab cp.async
// ring, 16-byte loads, a ticketed combine in a fixed order.
#include "dense_stream.cuh"

namespace {

using dstream::Args;

struct StoreF32 {
  float* out;
  int V;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    out[(size_t)m * V + n] = v;
  }
};

template <int MB, bool ALIGNED>
__global__ void __launch_bounds__(dstream::THREADS, 1) dense_gemv_kernel(const Args p, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  dstream::gemv_stream<MB, ALIGNED>(p, smem, StoreF32{out, p.V});
}

template <int MB>
cudaError_t launch(const Args& p, float* out, int grid, cudaStream_t st) {
  constexpr int smem = dstream::Geo<MB>::SMEM;
  auto go = [&](auto kernel, cudaError_t ok) {
    if (ok != cudaSuccess) return ok;
    kernel<<<grid, dstream::THREADS, smem, st>>>(p, out);
    return cudaGetLastError();
  };
  // every row of w on a 16-byte boundary: V % 8 == 0, w aligned
  if (p.V % 8 == 0 && (uintptr_t)p.w % 16 == 0) {
    static const cudaError_t ok = allow_smem(dense_gemv_kernel<MB, true>, smem);
    return go(dense_gemv_kernel<MB, true>, ok);
  }
  static const cudaError_t ok = allow_smem(dense_gemv_kernel<MB, false>, smem);
  return go(dense_gemv_kernel<MB, false>, ok);
}

}  // namespace

// x [M, K] bf16; w [K, V] bf16 (any V >= 1); out [M, V] f32; part f32
// [grid][2][pick_mb(M)][256] and ticket int32 [ceil(V / 256)] (zero) of
// scratch; grid <= ceil(V / 256) * ceil(K / 32) blocks (one an SM).
extern "C" int dense_gemv_launch(const void* x, const void* w, void* out, void* part,
                                 void* ticket, int M, int K, int V, int grid, void* stream) {
  const Args p{(const bf16*)x, (const bf16*)w, (float*)part, (unsigned int*)ticket, M, K, V};
  auto o = (float*)out;
  auto st = (cudaStream_t)stream;
  switch (pick_mb(M)) {
    case 1: return launch<1>(p, o, grid, st);
    case 2: return launch<2>(p, o, grid, st);
    case 4: return launch<4>(p, o, grid, st);
    case 8: return launch<8>(p, o, grid, st);
    case 16: return launch<16>(p, o, grid, st);
    default: return launch<32>(p, o, grid, st);
  }
}
