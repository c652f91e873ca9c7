// K2 q4_matmul and K12 q4_matmul_glu: the 4-bit GPTQ matmul for prefill-sized
// M (M > 32).
//
// K2 replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_deqw2_kernel_npair
// (launched at quant.py:996) and its siblings with the same math
// (_q4_deqw_kernel_npair, _q4_deqw_kernel, _q4_deqw2_kernel,
// _q4_deqw2_kernel_npair_ovl): dequantize the weight to bf16 (w = q*s - zs
// in f32, rounded once), then bf16 products with f32 accumulation and a bf16
// output. Act-order x is gathered by the caller. The kernel is Hopper's:
// TMA into an mbarrier ring, wgmma with the dequantized weight as the
// register operand, the row tile chosen by M, a persistent grid and
// stream-K where the tiles do not fill the card (q4_wgmma.cuh holds the
// design and what bounds it). Its tensor maps are encoded here, through the
// driver's cuTensorMapEncodeTiled reached by cudaGetDriverEntryPoint (the
// library links no driver library), and kept per (pointer, shape).
//
// K12 replaces quant.py:_q4_deqw2_kernel_npair_glu (same launch site): the
// Glu mode of the pipelined mma.sync kernel in q4_ring.cuh, whose A tile is
// formed by the producer warps from the raw fused gate|up output x [M, W] as
// bf16(bf16(silu_f32(gate)) * up), gate = x[m, k], up = x[m, ou + k] (the
// cast order of quant.py:680-682), so the [M, K] activation of the down
// projection never exists in memory. 128 x 128 tiles.
//
// The ring's Exact mode, K2's kernel before the Hopper one, stays reachable
// only through q4_matmul_ring_launch, which chip_smoke.py times beside the
// new K2 as its parent; no wrapper of the package calls it, and
// q4_matmul_ring_launches counts its launches so that the card tests can
// show that.
#include <atomic>
#include <mutex>
#include <unordered_map>

#include "q4_ring.cuh"
#include "q4_wgmma.cuh"

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A 2-D map of a row-major [outer, inner] tensor of `esize`-byte elements,
// boxes of [box_out, box_in]. A map is a function of these values alone, so
// maps are kept by them (a pointer reused for another tensor of the same
// shape gets the same map, which is the right one).
struct MapKey {
  const void* ptr;
  uint64_t inner, outer;
  uint32_t box_in, box_out;
  int dtype, esize, swizzle;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer && box_in == o.box_in &&
           box_out == o.box_out && dtype == o.dtype && esize == o.esize && swizzle == o.swizzle;
  }
};
struct MapHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (uint64_t v : {k.inner, k.outer, (uint64_t)k.box_in << 32 | k.box_out,
                       (uint64_t)k.dtype << 40 | (uint64_t)k.esize << 20 | (uint64_t)k.swizzle})
      h = h * 1000003u ^ std::hash<uint64_t>()(v);
    return h;
  }
};

cudaError_t tensor_map(CUtensorMap* map, const MapKey& key) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapHash> kept;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = kept.find(key);
  if (hit != kept.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {key.inner, key.outer};
  const cuuint64_t strides[1] = {key.inner * key.esize};
  const cuuint32_t box[2] = {key.box_in, key.box_out};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(map, (CUtensorMapDataType)key.dtype, 2, const_cast<void*>(key.ptr), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, (CUtensorMapSwizzle)key.swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (kept.size() >= 4096) kept.clear();
  kept.emplace(key, *map);
  return cudaSuccess;
}

std::atomic<int> ring_launches{0};

}  // namespace

// K2: x [M, K] bf16 (K % 32 == 0, 16-byte aligned); qweight [K/8, N] int32;
// scales, zscale [K/gs, N] scale_t (gs a multiple of 32 dividing K); out
// [M, N] bf16. The plan (ops/quant.py:q4_matmul_plan): the tile bm x bn
// (64 x 256, 128 x 128 or 256 x 128), the grid and stream_k (0:
// data-parallel over whole tiles); under stream-K part holds [grid][2][bm
// * bn] f32 and ticket one zero for each of the ceil(M / bm) * ceil(N /
// bn) tiles. An N that is a multiple of 8 needs 16-byte aligned weight and
// scale tensors.
extern "C" int q4_matmul_launch(const void* x, const void* qweight, const void* scales,
                                const void* zscale, void* out, void* part, void* ticket, int M,
                                int K, int N, int gs, int bm, int bn, int grid, int stream_k,
                                void* stream) {
  if (M < 1 || N < 1 || K % 32 || gs % 32 || K % gs || grid < 1 || (bn != 128 && bn != 256))
    return cudaErrorInvalidValue;
  const bool vec = N % 8 == 0;
  if ((uintptr_t)x % 16 ||
      (vec && ((uintptr_t)qweight % 16 || (uintptr_t)scales % 16 || (uintptr_t)zscale % 16)))
    return cudaErrorMisalignedAddress;
  const int mtiles = (M + bm - 1) / bm, ktiles = (K + wg::BK - 1) / wg::BK;
  const wg::Args p{(const int32_t*)qweight, (const scale_t*)scales, (const scale_t*)zscale,
                   (bf16*)out, (float*)part, (unsigned int*)ticket, M, K, N, gs, mtiles,
                   mtiles * ((N + bn - 1) / bn), ktiles, stream_k};
  if (stream_k && (part == nullptr || ticket == nullptr || grid > p.tiles * ktiles))
    return cudaErrorInvalidValue;
  if (!stream_k && grid > p.tiles) return cudaErrorInvalidValue;
  const CUtensorMapDataType sdt =
      SC_BYTES == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[4] = {};
  cudaError_t e = tensor_map(&maps[0], {x, (uint64_t)K, (uint64_t)M, (uint32_t)wg::BK,
                                        (uint32_t)bm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                        CU_TENSOR_MAP_SWIZZLE_128B});
  if (e == cudaSuccess && vec)
    e = tensor_map(&maps[1], {qweight, (uint64_t)N, (uint64_t)(K / 8), (uint32_t)bn,
                              (uint32_t)(wg::BK / 8), CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                              CU_TENSOR_MAP_SWIZZLE_NONE});
  if (e == cudaSuccess && vec)
    e = tensor_map(&maps[2], {scales, (uint64_t)N, (uint64_t)(K / gs), (uint32_t)bn, 1u, sdt,
                              SC_BYTES, CU_TENSOR_MAP_SWIZZLE_NONE});
  if (e == cudaSuccess && vec)
    e = tensor_map(&maps[3], {zscale, (uint64_t)N, (uint64_t)(K / gs), (uint32_t)bn, 1u, sdt,
                              SC_BYTES, CU_TENSOR_MAP_SWIZZLE_NONE});
  if (e != cudaSuccess) return e;
  return vec ? wg::launch_tile<true>(bm, bn, maps, p, grid, (cudaStream_t)stream)
             : wg::launch_tile<false>(bm, bn, maps, p, grid, (cudaStream_t)stream);
}

// The parent of K2 (chip_smoke.py's yardstick only): the ring's Exact mode,
// 256 x 128 tiles, the arguments of K2 before its Hopper kernel.
extern "C" int q4_matmul_ring_launch(const void* x, const void* qweight, const void* scales,
                                     const void* zscale, void* out, int M, int K, int N, int gs,
                                     void* stream) {
  if (K % 32 || gs % 32 || K % gs) return cudaErrorInvalidValue;
  const ring::Args p{x, (const int32_t*)qweight, (const scale_t*)scales, (const scale_t*)zscale,
                     /*sx=*/nullptr, /*ws=*/nullptr, (bf16*)out, M, K, N, gs, /*ldx=*/K, /*ou=*/0};
  const int err = ring::launch<ring::Mode::Exact>(p, (cudaStream_t)stream);
  if (err == cudaSuccess) ++ring_launches;
  return err;
}

extern "C" int q4_matmul_ring_launches() { return ring_launches.load(); }

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
