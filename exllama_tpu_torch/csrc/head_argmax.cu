// K5 head_argmax: the greedy decode head, M <= 32 rows:
//   ids[m] = argmax_v ( bf16(rms_norm(x[m]) * w_norm) @ W[:, v] )
// with the earliest index winning ties; no logits are materialized.
//
// Replaces the TPU kernel exllama_tpu/ops/dense.py:_head_argmax_kernel
// (launched at dense.py:129). Numerics as dense.py:97-115: f32 RMSNorm,
// the normed row rounded to bf16, f32 dot products.
//
// Bound on the H100: bytes. The lm_head W [K, V] bf16 is read once (262 MB
// at Llama-7B, 78 us at 3.35 TB/s) for 2*M*K*V flops. Design: K4's Hopper
// kernel (dense_wg.cuh: TMA boxes of w into an mbarrier ring, w as wgmma's
// A by ldmatrix.trans, x's rows as N, the row tile and whole tiles or
// stream-K from ops/dense.py:dense_plan, split tiles combined in a fixed
// order by hop::finish_piece), with the norm staged in place in each x slab
// (NORM: the block first computes the rows' 1 / rms, a few KB from L2) and
// an epilogue (ArgmaxEmit) that keeps, per thread and row, the largest
// 64-bit key over the columns it is handed: an order-preserving image of
// the f32 sum in the high half (-0 as +0), ~index in the low half, so the
// earliest index wins ties. The kernel hands each column's final sum (a
// split tile's after its pieces are added) to exactly one thread once, so
// the result does not depend on the split. At the block's end the keys of
// each row are reduced over the block and combined by one 64-bit
// atomicMax; the last block to finish (a grid ticket) turns the keys into
// int32 ids and resets them and the ticket to 0, so one launch does it all
// and the scratch is left as it was found. Columns >= V are never emitted;
// an odd V takes K4's cp.async copies of w (VEC = false).
//
// K5's parent, the stream-K loop of dense_stream.cuh (mma.sync, a 5-slab
// cp.async ring) with the same keys, stays reachable only through
// head_argmax_stream_launch, which chip_smoke.py times beside the new K5;
// head_argmax_stream_launches counts it.
#include <atomic>

#include "dense_stream.cuh"
#include "dense_wg.cuh"

namespace {

using dstream::Args;

__device__ __forceinline__ unsigned long long argmax_key(float v, int idx) {
  if (v == 0.f) v = 0.f;                 // -0 and +0 tie, as in a float compare
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned int)(~idx);
}

// K5's epilogue on dense_wg's kernel: slot s (the thread's row 8(s / 2) +
// 2q + s % 2 of the row tile) keeps the best key of the columns handed to
// it; finish() reduces the block's keys per row, one atomicMax a row, and
// the grid's last block writes the ids and resets the scratch.
template <int BM>
struct ArgmaxEmit {
  static constexpr bool NORM = true;
  unsigned long long* keys;  // [32] then the grid ticket, zero between launches
  int32_t* ids;              // [M]
  unsigned long long best[BM / 4];
  __device__ __forceinline__ void operator()(int slot, int, int c, float v) {
    const unsigned long long k = argmax_key(v, c);
    if (k > best[slot]) best[slot] = k;
  }
  __device__ __forceinline__ void finish(const dwg::Args& p, unsigned char* area, int tid) {
    auto* red = reinterpret_cast<unsigned long long*>(area);  // [8 warps][32 rows]
    const int lane = tid & 31, warp = tid >> 5, q = lane & 3;
    hop::bar_sync(1, dwg::CONSUMERS);  // every consumer is past its last use of the area
#pragma unroll
    for (int sl = 0; sl < BM / 4; ++sl) {
      unsigned long long k = best[sl];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // the lanes of the same rows
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, k, o);
        k = other > k ? other : k;
      }
      if (lane < 4) red[warp * 32 + 8 * (sl >> 1) + 2 * q + (sl & 1)] = k;
    }
    hop::bar_sync(1, dwg::CONSUMERS);
    if (tid < p.M) {
      unsigned long long k = 0ull;
#pragma unroll
      for (int w = 0; w < dwg::CONSUMERS / 32; ++w) {
        const unsigned long long r = red[w * 32 + tid];
        k = r > k ? r : k;
      }
      if (k) atomicMax(keys + tid, k);
    }
    // the last block turns the keys into ids and leaves the scratch at 0
    int* last = reinterpret_cast<int*>(area + 8 * 32 * 8);
    unsigned int* grid_ticket = reinterpret_cast<unsigned int*>(keys + 32);
    hop::bar_sync(1, dwg::CONSUMERS);
    if (tid == 0) {
      __threadfence();
      *last = atomicAdd(grid_ticket, 1u) == gridDim.x - 1;
      __threadfence();
    }
    hop::bar_sync(1, dwg::CONSUMERS);
    if (!*last) return;
    if (tid < p.M) {
      const unsigned long long k = atomicExch(keys + tid, 0ull);
      ids[tid] = (int32_t)(~(unsigned int)(k & 0xffffffffull));
    }
    if (tid == 0) *grid_ticket = 0u;
  }
};

// The parent's: each thread's best key per row over the columns handed to it.
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

std::atomic<int> stream_launches{0};  // the parent's, head_argmax_stream_launch

}  // namespace

// K5: x [M <= 32, ldx] bf16 (pre-norm; ldx >= K, a multiple of 8, 16-byte
// aligned; columns K.. zeros); norm_w [K] bf16; w [K, V] bf16 (any V >= 1);
// keys uint64 [33] of scratch (32 keys, then the grid ticket in the low 32
// bits of the last), zero between launches; ids [M] int32 out. The plan is
// K4's (ops/dense.py:dense_plan: the row tile bm 8 or 32, the grid,
// stream_k) with its scratch: under stream-K part holds [grid][2][bm * 256]
// f32 and ticket one zero a tile.
extern "C" int head_argmax_launch(const void* x, const void* norm_w, const void* w,
                                  void* keys, void* ids, void* part, void* ticket, int M,
                                  int K, int V, int ldx, int bm, int grid, int stream_k,
                                  float eps, void* stream) {
  if (M < 1 || M > 32 || M > bm || K < 1 || V < 1 || ldx < K || ldx % 8 || grid < 1 ||
      (bm != 8 && bm != 32))
    return cudaErrorInvalidValue;
  const int ktiles = (K + dwg::BK - 1) / dwg::BK, tiles = (V + dwg::BV - 1) / dwg::BV;
  const dwg::Args p{(const bf16*)w, (float*)part, (unsigned int*)ticket, M, K, V, 1, tiles,
                    ktiles, stream_k, (const bf16*)x, (const bf16*)norm_w, ldx, eps};
  if (stream_k ? (part == nullptr || ticket == nullptr || grid > tiles * ktiles) : grid > tiles)
    return cudaErrorInvalidValue;
  auto ks = (unsigned long long*)keys;
  auto out = (int32_t*)ids;
  auto st = (cudaStream_t)stream;
  if (bm == 8) return dwg::launch_plan<8>((const bf16*)x, p, ArgmaxEmit<8>{ks, out, {}}, grid, st);
  return dwg::launch_plan<32>((const bf16*)x, p, ArgmaxEmit<32>{ks, out, {}}, grid, st);
}

// The parent of K5 (chip_smoke.py's yardstick only): the stream-K loop of
// dense_stream.cuh. x [M, K] bf16 (pre-norm); norm_w [K] bf16; w [K, V]
// bf16; keys, ids as head_argmax_launch's; part f32
// [grid][2][pick_mb(M)][256] and ticket int32 [ceil(V / 256)] (zero);
// grid <= ceil(V / 256) * ceil(K / 32) blocks (one an SM).
extern "C" int head_argmax_stream_launch(const void* x, const void* norm_w, const void* w,
                                         void* keys, void* ids, void* part, void* ticket,
                                         int M, int K, int V, int grid, float eps,
                                         void* stream) {
  if (M < 1 || M > 32 || grid < 1) return cudaErrorInvalidValue;
  const Args p{(const bf16*)x, (const bf16*)w, (float*)part, (unsigned int*)ticket, M, K, V,
               (const bf16*)norm_w, eps};
  auto ks = (unsigned long long*)keys;
  auto out = (int32_t*)ids;
  auto st = (cudaStream_t)stream;
  cudaError_t err;
  switch (pick_mb(M)) {
    case 1: err = launch<1>(p, ks, out, grid, st); break;
    case 2: err = launch<2>(p, ks, out, grid, st); break;
    case 4: err = launch<4>(p, ks, out, grid, st); break;
    case 8: err = launch<8>(p, ks, out, grid, st); break;
    case 16: err = launch<16>(p, ks, out, grid, st); break;
    default: err = launch<32>(p, ks, out, grid, st); break;
  }
  if (err == cudaSuccess) ++stream_launches;
  return err;
}

extern "C" int head_argmax_stream_launches() { return stream_launches.load(); }
