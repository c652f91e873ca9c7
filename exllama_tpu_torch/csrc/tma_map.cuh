// The TMA tensor maps of the port's Hopper kernels (K1, K2, K4), encoded on
// the host by the driver's cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (the libraries link no driver library), and kept
// per (pointer, shape) behind a mutex (ctypes releases the GIL). A map is
// passed to its kernel by value (__grid_constant__), so a captured graph
// keeps the maps of its launches. Each library that includes this header
// keeps its own cache, bounded: a cache of 4096 maps is emptied before it
// grows (the eager chunks' many x pointers).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

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

}  // namespace
