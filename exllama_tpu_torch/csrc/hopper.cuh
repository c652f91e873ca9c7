// Hopper's building blocks, shared by the port's kernels on TMA and wgmma:
// K2 (q4_wgmma.cuh), K1 at 2..32 rows (q4_gemv_wg.cuh), K4 and K5
// (dense_wg.cuh) and K3's prefill (flash_prefill_wg.cuh). mbarriers and TMA
// loads, the wgmma products with A from registers (or, Mma64SS, from shared
// memory) and B from a 128-byte swizzled slab in shared memory, K-major or
// (the transposed B of O += P V) MN-major, and the walk of a
// persistent block over its output tiles or its stream-K range of (tile,
// slab) units (stream_k.cuh's division). Every function is inline; the
// libraries that include this header each keep their own copy.
#pragma once

#include <cuda.h>

#include "async_mma.cuh"
#include "stream_k.cuh"

namespace hop {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// An arrival on bar once every cp.async this thread issued before it has
// landed (the arrival is one of the barrier's expected count).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(tc::smem_addr(bar))
               : "memory");
}
// Spin until the barrier's phase differs from `parity`. Built with
// -DWG_WATCHDOG=1 (a first run of a changed kernel), a wait that never ends
// traps instead, so that a hang comes back as a launch failure.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = tc::smem_addr(bar);
  uint32_t done;
#if WG_WATCHDOG
  long long spins = 0;
#endif
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
#if WG_WATCHDOG
    if (++spins > (1ll << 26)) __trap();
#endif
  } while (!done);
}
// A 2-D TMA load of the box at (c0 inner, c1 outer) into dst, completing on bar.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(tc::smem_addr(bar))
      : "memory");
}
// A 3-D TMA load of the box at (c0 inner, c1, c2 outer) into dst.
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(tc::smem_addr(bar))
      : "memory");
}
// A bulk copy of `bytes` contiguous bytes (a multiple of 16; both addresses
// 16-byte aligned) from device memory into dst, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(tc::smem_addr(bar))
      : "memory");
}
// The integer of byte e of w (0..3) as an exact f32, without the
// quarter-rate int-to-float conversion: an unsigned u < 2^8 in the mantissa
// of 2^23 is the float 2^23 + u. MODE 0: int8 (u = b + 128); 1: an int4
// low nibble (u = (b & 15), value u - 8); 2: a high nibble (u = (b >> 4) ^
// 8 on the raw nibble, value u - 8, the two's complement b >> 4).
template <int MODE>
__device__ __forceinline__ float int_of(uint32_t w, int e) {
  uint32_t u = (w >> (8 * e)) & 0xFFu;
  if constexpr (MODE == 0) u ^= 0x80u;
  if constexpr (MODE == 1) u &= 15u;
  if constexpr (MODE == 2) u = (u >> 4) ^ 8u;
  return __uint_as_float(0x4B000000u | u) - (MODE == 0 ? 8388736.f : 8388616.f);
}
// The four integers of w (bytes 0..3; MODE as int_of) as exact f32, the
// byte-wise part done on the whole word and each byte moved into the
// mantissa of 2^23 by one prmt: two operations an integer.
template <int MODE>
__device__ __forceinline__ void ints_of(uint32_t w, float (&f)[4]) {
  uint32_t x = w;
  if constexpr (MODE == 0) x ^= 0x80808080u;
  if constexpr (MODE == 1) x &= 0x0F0F0F0Fu;
  if constexpr (MODE == 2) x = ((x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  constexpr float bias = MODE == 0 ? 8388736.f : 8388616.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t r;  // bytes: x's byte e, 0, 0, 0x4B
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(0x4B000000u), "r"(0x7440u + e));
    f[e] = __uint_as_float(r) - bias;
  }
}
// Fetch a tensor map (a __grid_constant__ kernel parameter) ahead of its
// first TMA load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// Shared memory written by threads (the generic proxy) and then read by
// wgmma (the async proxy): each writing thread fences before it signals.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of these registers across the
// asynchronous products (wgmma reads and writes them behind its back).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// ... and the register A fragments of products about to be issued: their
// last writes stay before the wgmma.fence that follows.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Arrive at named barrier id of n threads without waiting (the producers'
// half of a bar_sync that other threads wait on).
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The shared-memory descriptor of a K-major operand whose rows are 128
// bytes (64 bf16 of k), 128-byte swizzled in 8-row atoms of 1024 bytes, as
// TMA leaves it under CU_TENSOR_MAP_SWIZZLE_128B; the k-step of 16 moves
// the start address by 32 bytes (2 in the 16-byte units of the field).
__device__ __forceinline__ uint64_t kmajor_sw128(const void* p) {
  const uint64_t a = tc::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// The descriptor of an MN-major operand (wgmma's transposed B, imm-trans-b
// 1): B[k][n] with n contiguous, in boxes of 64 n (128 bytes a k-row),
// 128-byte swizzled in 8-row atoms of 1024 bytes, box after box
// `box_bytes` apart. In the canonical MN-major SW128 layout the stride
// between the 8-deep groups of k is the SBO (1024 bytes: the atoms of a
// box follow each other) and the stride between 64-wide groups of n the
// LBO (the next box); a k-step of 16 moves the start by two atoms.
__device__ __forceinline__ uint64_t mnmajor_sw128(const void* p, int box_bytes) {
  const uint64_t a = tc::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((box_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// The byte offset of the 16-byte chunk c (0..7) of row r in such a slab
// (1024-byte aligned): chunk c of row r lies at chunk c ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// D[64 x N] (+)= A[64 x 16] (registers: the m16n8k16 A fragment of the
// warp's 16 rows) * B[16 x N] (in shared memory, descriptor: K-major, or
// MN-major with TB = 1); scale_d = 0 starts D afresh. A loop that runs
// run<0> and run<1> at one N with A fragments of one shape computed its
// second run<0> from the other product's A registers on the card
// (flash_prefill_wg.cuh at BN == D); keep such products on different N.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  template <int TB = 0>
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<16> {
  template <int TB = 0>
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<32> {
  template <int TB = 0>
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<64> {
  template <int TB = 0>
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TB = 0>
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<256> {
  template <int TB = 0>
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
  }
};

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], both K-major in shared memory
// (descriptors): K3's S = Q K^T at head_dim 256, where Q's fragments would
// take 64 registers a thread beside O's 128.
struct Mma64SS {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// A block's work: output tiles (data-parallel: tiles b, b + grid, ...,
// each whole) or, under stream-K, its contiguous range [u0, u1) of the
// tiles x ktiles (tile, slab) units cut at tile edges. Every role of the
// block walks the same ranges.
struct Walk {
  int KT, tiles, grid, t, u0, u1, u;
  long long U;
  bool sk;
  __device__ __forceinline__ Walk(int tiles_, int ktiles, int stream_k)
      : KT(ktiles), tiles(tiles_), grid(gridDim.x), t(blockIdx.x), sk(stream_k != 0) {
    U = (long long)tiles * ktiles;
    u0 = u = sk ? streamk::unit_begin(blockIdx.x, U, grid) : 0;
    u1 = sk ? streamk::unit_begin(blockIdx.x + 1, U, grid) : 0;
  }
  // Stream-K over the first `g` blocks of the grid (one phase of a
  // persistent kernel whose units may be fewer than its blocks, fused_wg.cuh);
  // the blocks past them have no range.
  __device__ __forceinline__ Walk(int tiles_, int ktiles, int g, bool /*phase*/)
      : KT(ktiles), tiles(tiles_), grid(g), t(blockIdx.x), sk(true) {
    U = (long long)tiles * ktiles;
    const bool in = (int)blockIdx.x < g;
    u0 = u = in ? streamk::unit_begin(blockIdx.x, U, g) : 0;
    u1 = in ? streamk::unit_begin(blockIdx.x + 1, U, g) : 0;
  }
  // The next range: tile, slabs [kb, ke). False when the block is done.
  __device__ __forceinline__ bool next(int& tile, int& kb, int& ke) {
    if (sk) {
      if (u >= u1) return false;
      tile = u / KT;
      const int e = min(u1, (tile + 1) * KT);
      kb = u - tile * KT, ke = e - tile * KT, u = e;
      return true;
    }
    if (t >= tiles) return false;
    tile = t, kb = 0, ke = KT, t += grid;
    return true;
  }
  // The first and last blocks of tile t under stream-K, and the scratch
  // slot (0: its first range, 1: its last) in which block blk left its
  // piece of tile t.
  __device__ __forceinline__ int first_of(int tile) const {
    return streamk::block_of((long long)tile * KT, U, grid);
  }
  __device__ __forceinline__ int last_of(int tile) const {
    return streamk::block_of((long long)(tile + 1) * KT - 1, U, grid);
  }
  __device__ __forceinline__ int slot_of(int blk, int tile) const {
    return streamk::unit_begin(blk, U, grid) >= (long long)tile * KT ? 0 : 1;
  }
};

// A stream-K tile's end for a block's range [kb, ke) of tile `tile`: where
// the range is a piece of a tile cut between blocks, `publish(slot)` leaves
// the block's partial sums in its scratch slot, the block takes a ticket,
// and only the tile's last block goes on (returns true) to add the pieces
// in the order of k and reset the ticket: `combine(blk, n, first)` for the
// pieces of blocks blk .. blk + n - 1 (n <= BATCH, loaded together, so a
// batch costs one round trip to L2; first: the tile's first piece, which
// replaces what the caller holds); a whole tile returns true at once. Every
// consumer thread calls it together; `nthreads` of them, named barrier 1;
// `answer` in shared memory.
template <int BATCH, class Publish, class Combine>
__device__ __forceinline__ bool finish_piece(const Walk& w, int tile, int kb, int ke,
                                             unsigned int* ticket, int* answer, int tid,
                                             int nthreads, Publish publish, Combine combine) {
  if (kb == 0 && ke == w.KT) return true;
  publish((long long)tile * w.KT + kb == w.u0 ? 0 : 1);
  bar_sync(1, nthreads);
  if (tid == 0) {
    __threadfence();
    *answer = (int)atomicAdd(ticket + tile, 1u);
    __threadfence();
  }
  bar_sync(1, nthreads);
  const int first = w.first_of(tile), last = w.last_of(tile);
  if (*answer != last - first) return false;  // another block finishes the tile
  for (int blk = first; blk <= last; blk += BATCH)  // in the order of k
    combine(blk, min(BATCH, last + 1 - blk), blk == first);
  if (tid == 0) ticket[tile] = 0u;  // ready for the next launch
  return true;
}

}  // namespace hop
