// K4 dense_gemv: the bf16 lm_head product x[M, K] @ w[K, V] -> f32 [M, V]
// at any M.
//
// Replaces the TPU kernel exllama_tpu/ops/dense.py:_kernel (launched at
// dense.py:56): the lm_head product of every forward that returns logits,
// bf16 inputs, f32 accumulation and f32 output; above 32 rows also the
// product the JAX package leaves to jnp.dot. Bound by bytes at decode rows.
// The kernel is Hopper's (dense_wg.cuh: TMA into an mbarrier ring, wgmma
// with w as A and x's rows as N, the row tile by M, a persistent grid and
// stream-K where the tiles do not fill the card, ops/dense.py:dense_plan);
// its tensor maps are kept per (pointer, shape) (tma_map.cuh).
//
// The stream-K loop of dense_stream.cuh, K4's kernel before the Hopper one
// (a 5-slab cp.async ring, mma.sync at every M; K5 runs it), stays
// reachable here only through dense_gemv_stream_launch, which chip_smoke.py
// times beside the new K4 as its parent; no wrapper of the package calls
// it, and dense_gemv_stream_launches counts its launches.
#include <atomic>

#include "dense_stream.cuh"
#include "dense_wg.cuh"
#include "tma_map.cuh"

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

std::atomic<int> stream_launches{0};  // the parent's, dense_gemv_stream_launch

}  // namespace

// K4: x [M, ldx] bf16 (ldx >= K, a multiple of 8, 16-byte aligned; columns
// K.. are zeros); w [K, V] bf16 (any V >= 1); out [M, V] f32. The plan
// (ops/dense.py:dense_plan): the row tile bm (8, 32 or 64), the grid and
// stream_k (0: data-parallel over whole tiles of bm rows x 256 columns, row
// tile fastest); under stream-K part holds [grid][2][bm * 256] f32 and
// ticket one zero for each of the ceil(M / bm) * ceil(V / 256) tiles. A V
// that is a multiple of 8 needs a 16-byte aligned w.
extern "C" int dense_gemv_launch(const void* x, const void* w, void* out, void* part,
                                 void* ticket, int M, int K, int V, int ldx, int bm, int grid,
                                 int stream_k, void* stream) {
  if (M < 1 || K < 1 || V < 1 || ldx < K || ldx % 8 || grid < 1 ||
      (bm != 8 && bm != 32 && bm != 64))
    return cudaErrorInvalidValue;
  const bool vec = V % 8 == 0 && (uintptr_t)w % 16 == 0;
  if ((uintptr_t)x % 16) return cudaErrorMisalignedAddress;
  const int mtiles = (M + bm - 1) / bm, ktiles = (K + dwg::BK - 1) / dwg::BK;
  const dwg::Args p{(const bf16*)w, (float*)out, (float*)part, (unsigned int*)ticket, M, K, V,
                    mtiles, mtiles * ((V + dwg::BV - 1) / dwg::BV), ktiles, stream_k};
  if (stream_k ? (part == nullptr || ticket == nullptr || grid > p.tiles * ktiles)
               : grid > p.tiles)
    return cudaErrorInvalidValue;
  CUtensorMap maps[2] = {};
  cudaError_t e = tensor_map(&maps[0], {x, (uint64_t)ldx, (uint64_t)M, (uint32_t)dwg::BK,
                                        (uint32_t)bm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                        CU_TENSOR_MAP_SWIZZLE_128B});
  if (e == cudaSuccess && vec)
    e = tensor_map(&maps[1], {w, (uint64_t)V, (uint64_t)K, 64u, (uint32_t)dwg::BK,
                              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, CU_TENSOR_MAP_SWIZZLE_128B});
  if (e != cudaSuccess) return e;
  auto st = (cudaStream_t)stream;
  if (bm == 8) return vec ? dwg::launch<8, true>(maps, p, grid, st) : dwg::launch<8, false>(maps, p, grid, st);
  if (bm == 32) return vec ? dwg::launch<32, true>(maps, p, grid, st) : dwg::launch<32, false>(maps, p, grid, st);
  return vec ? dwg::launch<64, true>(maps, p, grid, st) : dwg::launch<64, false>(maps, p, grid, st);
}

// The parent of K4 (chip_smoke.py's yardstick only): the stream-K loop of
// dense_stream.cuh. x [M <= 32, K] bf16; w [K, V] bf16; out [M, V] f32;
// part f32 [grid][2][pick_mb(M)][256] and ticket int32 [ceil(V / 256)]
// (zero) of scratch; grid <= ceil(V / 256) * ceil(K / 32) blocks (one an SM).
extern "C" int dense_gemv_stream_launch(const void* x, const void* w, void* out, void* part,
                                        void* ticket, int M, int K, int V, int grid,
                                        void* stream) {
  if (M < 1 || M > 32) return cudaErrorInvalidValue;
  const Args p{(const bf16*)x, (const bf16*)w, (float*)part, (unsigned int*)ticket, M, K, V};
  auto o = (float*)out;
  auto st = (cudaStream_t)stream;
  cudaError_t err;
  switch (pick_mb(M)) {
    case 1: err = launch<1>(p, o, grid, st); break;
    case 2: err = launch<2>(p, o, grid, st); break;
    case 4: err = launch<4>(p, o, grid, st); break;
    case 8: err = launch<8>(p, o, grid, st); break;
    case 16: err = launch<16>(p, o, grid, st); break;
    default: err = launch<32>(p, o, grid, st); break;
  }
  if (err == cudaSuccess) ++stream_launches;
  return err;
}

extern "C" int dense_gemv_stream_launches() { return stream_launches.load(); }
