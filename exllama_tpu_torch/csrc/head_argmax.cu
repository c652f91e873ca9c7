// K5 head_argmax: the greedy decode head, M <= 32 rows:
//   ids[m] = argmax_v ( bf16(rms_norm(x[m]) * w_norm) @ W[:, v] )
// with the earliest index winning ties; no logits are materialized.
//
// Replaces the TPU kernel exllama_tpu/ops/dense.py:_head_argmax_kernel
// (launched at dense.py:129). Numerics as dense.py:97-115: f32 RMSNorm,
// the normed row rounded to bf16, f32 dot products.
//
// Bound on the H100: bytes. The lm_head W [K, V] bf16 is read once (262 MB
// at Llama-7B, 78 us at 3.35 TB/s) for 2*M*K*V flops. Design: K4's loop
// (dense_stream.cuh: stream-K over 256-column tiles x 32-row units on one
// block an SM, a 5-slab cp.async ring, mma.sync products, split tiles
// combined by their last block in a fixed order), with the norm applied as
// x is staged (NORM: each block computes the rows' RMS scales first, a few
// KB from L2) and an Emit that keeps, per thread and row, the largest
// 64-bit key over the columns it is handed: an order-preserving image of
// the f32 sum in the high half (-0 as +0), ~index in the low half, so the
// earliest index wins ties. gemv_stream hands each column's final sum to
// exactly one thread once, so the result does not depend on the split. At
// the block's end the keys of each row are reduced over the block and
// combined by one 64-bit atomicMax; the last block to finish (a grid
// ticket) turns the keys into int32 ids and resets them and the ticket to
// 0, so one launch does it all and the scratch is left as it was found.
// Columns >= V are never emitted; an odd V takes dstream's unaligned loads.
#include "dense_stream.cuh"

namespace {

using dstream::Args;

__device__ __forceinline__ unsigned long long argmax_key(float v, int idx) {
  if (v == 0.f) v = 0.f;                 // -0 and +0 tie, as in a float compare
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned int)(~idx);
}

// Each thread's best key per row over the columns handed to it.
template <int MB>
struct KeepMax {
  unsigned long long* best;  // [MB], in registers once inlined
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    const unsigned long long k = argmax_key(v, n);
    if (k > best[m]) best[m] = k;
  }
};

template <int MB, bool ALIGNED, bool WHOLE>
__global__ void __launch_bounds__(dstream::THREADS, 1)
    head_argmax_kernel(const Args p, unsigned long long* keys, int32_t* ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long best[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) best[m] = 0ull;
  dstream::gemv_stream<MB, ALIGNED, true, WHOLE>(p, smem, KeepMax<MB>{best});

  // the block's best key per row: the warp's, then the block's, one atomic
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto* red = reinterpret_cast<unsigned long long*>(smem + dstream::Geo<MB>::RED_OFF);
  __syncthreads();  // every thread is done with gemv_stream's shared memory
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    unsigned long long k = best[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, k, o);
      k = other > k ? other : k;
    }
    if (lane == 0) red[warp * MB + m] = k;
  }
  __syncthreads();
  if (tid < p.M) {
    unsigned long long k = 0ull;
#pragma unroll
    for (int w = 0; w < dstream::WARPS; ++w) {
      const unsigned long long r = red[w * MB + tid];
      k = r > k ? r : k;
    }
    if (k) atomicMax(keys + tid, k);
  }
  // the last block turns the keys into ids and leaves the scratch at 0
  __shared__ bool last;
  __syncthreads();
  unsigned int* grid_ticket = reinterpret_cast<unsigned int*>(keys + 32);
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(grid_ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  if (tid < p.M) {
    const unsigned long long k = atomicExch(keys + tid, 0ull);
    ids[tid] = (int32_t)(~(unsigned int)(k & 0xffffffffull));
  }
  if (tid == 0) *grid_ticket = 0u;
}

// dynamic shared memory a block may take: the H100's 227 KB, less this
// kernel's static few bytes
constexpr int SMEM_MAX = 226 * 1024;

template <int MB, bool ALIGNED, bool WHOLE>
cudaError_t go(const Args& p, unsigned long long* keys, int32_t* ids, int grid, int smem,
               cudaStream_t st) {
  static const cudaError_t ok = cudaFuncSetAttribute(
      head_argmax_kernel<MB, ALIGNED, WHOLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (ok != cudaSuccess) return ok;
  head_argmax_kernel<MB, ALIGNED, WHOLE><<<grid, dstream::THREADS, smem, st>>>(p, keys, ids);
  return cudaGetLastError();
}

// At <= 8 rows the normed x is formed once a block where it fits beside
// the ring (WHOLE: K <= 64K at one row, ~8K at eight); else unit by unit.
template <int MB>
cudaError_t launch(const Args& p, unsigned long long* keys, int32_t* ids, int grid,
                   cudaStream_t st) {
  static_assert(dstream::WARPS * MB * 8 <= MB * dstream::BN * 4, "keys fit the red area");
  // every row of w on a 16-byte boundary: V % 8 == 0, w aligned
  const bool aligned = p.V % 8 == 0 && (uintptr_t)p.w % 16 == 0;
  if constexpr (MB <= 8) {
    const int smem = dstream::whole_smem<MB>(p.K);
    if (smem <= SMEM_MAX)
      return aligned ? go<MB, true, true>(p, keys, ids, grid, smem, st)
                     : go<MB, false, true>(p, keys, ids, grid, smem, st);
  }
  constexpr int smem = dstream::Geo<MB>::SMEM;
  return aligned ? go<MB, true, false>(p, keys, ids, grid, smem, st)
                 : go<MB, false, false>(p, keys, ids, grid, smem, st);
}

}  // namespace

// x [M, K] bf16 (pre-norm); norm_w [K] bf16; w [K, V] bf16 (any V >= 1);
// keys uint64 [33] of scratch (32 keys, then the grid ticket in the low 32
// bits of the last), zero between launches; ids [M] int32 out; part f32
// [grid][2][pick_mb(M)][256] and ticket int32 [ceil(V / 256)] (zero): K4's
// scratch; grid <= ceil(V / 256) * ceil(K / 32) blocks (one an SM).
extern "C" int head_argmax_launch(const void* x, const void* norm_w, const void* w,
                                  void* keys, void* ids, void* part, void* ticket, int M,
                                  int K, int V, int grid, float eps, void* stream) {
  if (M < 1 || M > 32 || grid < 1) return cudaErrorInvalidValue;
  const Args p{(const bf16*)x, (const bf16*)w, (float*)part, (unsigned int*)ticket, M, K, V,
               (const bf16*)norm_w, eps};
  auto ks = (unsigned long long*)keys;
  auto out = (int32_t*)ids;
  auto st = (cudaStream_t)stream;
  switch (pick_mb(M)) {
    case 1: return launch<1>(p, ks, out, grid, st);
    case 2: return launch<2>(p, ks, out, grid, st);
    case 4: return launch<4>(p, ks, out, grid, st);
    case 8: return launch<8>(p, ks, out, grid, st);
    case 16: return launch<16>(p, ks, out, grid, st);
    default: return launch<32>(p, ks, out, grid, st);
  }
}
