// K2's kernel on Hopper (q4_matmul.cu): the 4-bit GPTQ matmul for
// prefill-sized M, out = bf16(x @ bf16(q*s - zs)) with the weight
// dequantized in f32 and rounded once to bf16, f32 sums and a bf16 output.
// x [M, K] bf16 (M > 32; act-order x gathered by the caller); the weight as
// stored: packed nibbles [K/8, N] int32 (k = 8j + i at bits 4i of word j)
// with scale and zero-scale rows [K/gs, N] in bf16 or, built with
// -DSCALE_F32=1, f32; gs a multiple of 32 dividing K.
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_deqw2_kernel_npair
// (launched at quant.py:996) and its siblings with the same math.
//
// Bound on the H100: operations at long prefill (2*M*K*N at 989 TFLOP/s
// bf16 against K*N/2 weight bytes at 3.35 TB/s; the ridge lies near M = 78
// rows), bytes at 33-64 rows (the verify step's 40 rows, the admission
// chunks' 64).
//
// Design. The product is taken transposed, out^T = W^T x^T, so that:
//   - the dequantized weight columns are wgmma's 64-row A operand, which
//     wgmma takes from registers: each consumer thread dequantizes its own
//     fragment straight from the packed words in the ring slot, and the
//     weight is never written back to shared memory. A's fragment order is
//     the GPTQ packing's: k = 2q, 2q + 1 (and + 8) of each 16 are byte q of
//     two packed words; a thread's two rows (g, g + 8) are mapped to
//     adjacent weight columns, so one 8-byte load brings both words and
//     one 4-byte load both scales;
//   - x's rows are wgmma's N, 64, 128 or 256 wide, read from shared memory
//     (K-major, 128-byte swizzle), so the row tile follows M and each
//     weight byte is read once for all the rows of a tile. Tiles (rows x
//     weight columns): 64 x 256 up to 64 rows, where the weight's bytes
//     bound the time (each x slab then serves twice the columns), 128 x
//     128 and 256 x 128 above (ops/quant.py:q4_matmul_plan).
// TMA loads each 64-deep slab (x [BM, 64], the packed words [8, BN], the
// two 32-deep halves' scale and zero-scale rows) into a ring of STAGES slots
// with completion on mbarriers; one producer warp issues them, with no
// per-16-byte copies and no address arithmetic. Two consumer warpgroups
// (BN / 2 weight columns each) dequantize slab t while slab t - 1's wgmmas
// run (A double-buffered in registers) and release a slot when the wgmmas
// that read it have finished. The grid is
// persistent, one block an SM: a block walks its output tiles (row tile
// fastest, so the blocks in flight share their weight columns in L2) and
// the producer runs on into the next tile while the consumers write one
// out. Where the tiles would leave the card partly idle (q4_matmul_plan:
// less than 90% of the last wave), the (tile, slab) units are shared out
// stream-K instead (stream_k.cuh), and a tile cut between blocks leaves
// each block's f32 partial sums, in the accumulator fragment's layout, in
// a scratch slot; the last block of the tile (an atomic ticket it resets)
// adds them in the order of k. No float atomics: the sums are the same in
// every run, graphed or eager. The epilogue rounds to bf16, transposes
// through shared memory and leaves in 16-byte stores.
//
// What bounds it now (scripts/k2_ablation.py, PERF.md section 6): at long
// prefill the consumers' dequantization and products do not overlap fully
// and the x slabs are read again for every column tile (L2 traffic); at
// 33-64 rows a fixed cost a launch (the ring's fill, stream-K's combine).
//
// An N that is not a multiple of 8 (a 4-bit lm_head at an odd vocab): the
// rows of the packed words and scales are not 16-byte aligned, which TMA
// needs, so the compile-time variant VEC = false loads those slabs with
// plain loads by 31 lanes of the producer warp (x still by TMA) and writes
// the output element by element. The launcher chooses it by shape.
// Not yet: cluster multicast of the x slab to the blocks of neighbouring
// column tiles, which would halve the L2 reads of x at long prefill.
#pragma once

#include <cuda.h>

#include "async_mma.cuh"
#include "stream_k.cuh"

namespace wg {
SCALE_NS_BEGIN

constexpr int BK = 64;
// two consumer warpgroups and a producer warpgroup, of which one warp works
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int SMEM_MAX = 232448;

// A tile of BM rows (wgmma's N) by BN weight columns: each consumer
// warpgroup takes BN / 2 columns as NW = BN / 128 products of 64 rows.
template <int BM, int BN>
struct Cfg {
  static constexpr int NW = BN / 128;
  static constexpr int NACC = BM / 2;            // f32 accumulators a thread per product
  static constexpr int DEPTH = 1;                // groups of products in flight
  static constexpr int X_BYTES = BM * BK * 2;    // 128-byte swizzled x slab
  static constexpr int W_BYTES = BK / 8 * BN * 4;  // the packed words [8][BN]
  static constexpr int S_BYTES = 4 * BN * SC_BYTES;  // scale rows of the halves, zero-scale rows
  static constexpr int C_LD = BN + 8;            // bf16 elements of an output row in the epilogue
  static constexpr int C_BYTES = BM * C_LD * 2;
  static constexpr int STAGE = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int FREE = SMEM_MAX - C_BYTES - 256;
  static constexpr int STAGES = FREE / STAGE < 12 ? FREE / STAGE : 12;
  static constexpr int W_OFF = STAGES * X_BYTES;  // x slots first: 1024-byte aligned
  static constexpr int S_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int C_OFF = S_OFF + STAGES * S_BYTES;
  static constexpr int BAR_OFF = C_OFF + C_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 16;
  static constexpr uint32_t TX = STAGE;
  static_assert(STAGES >= 4 && SMEM <= SMEM_MAX, "shared memory of one block");
};

struct Args {
  const int32_t* qweight;  // [K/8, N] (read here only by the VEC = false producer)
  const scale_t* scales;   // [K/gs, N]
  const scale_t* zscale;   // [K/gs, N]
  bf16* out;               // [M, N]
  float* part;             // stream-K: [grid][2][BM * BN] f32 partials
  unsigned int* ticket;    // stream-K: one zero a tile
  int M, K, N, gs;
  int mtiles, tiles, ktiles;  // row tiles; row tiles x column tiles; 64-deep slabs
  int stream_k;
};

// ------------------------------------------------------ PTX building blocks

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
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

// D[64 x N] += A[64 x 16] (registers: the m16n8k16 A fragment of the
// warp's 16 rows) * B[16 x N] (K-major in shared memory, descriptor).
template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
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
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};


// Two weights of one column, k and k + 1, from their packed word w (its
// byte q holds their nibbles, the lower k in the low one), as the bf16
// pair of a wgmma A register: q*s - z with one rounding to bf16
// (dequantize_t: q*s - zs in f32, then the cast). `pick` is the thread's
// constant for byte q.
#if SCALE_F32
// f32 scales: the reference's multiply and subtract in f32, then the cast.
struct ColumnScale {
  float s, z;
};
// Columns c and c + 1 of a scale row and a zero-scale row (c even).
__device__ __forceinline__ void load_scales(ColumnScale (&c)[2], const scale_t* s,
                                            const scale_t* z) {
  c[0] = {sc2f(s[0]), sc2f(z[0])}, c[1] = {sc2f(s[1]), sc2f(z[1])};
}
__device__ __forceinline__ uint32_t pick_of(int q) { return 8 * q; }  // a shift
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t pick, const ColumnScale& c) {
  const uint32_t b = w >> pick;
  // 2^23 + q as a float is exact; subtracting 2^23 leaves q
  const float lo = __uint_as_float(0x4B000000u | (b & 0xFu)) - 8388608.f;
  const float hi = __uint_as_float(0x4B000000u | ((b >> 4) & 0xFu)) - 8388608.f;
  return tc::pack_bf16(__fsub_rn(__fmul_rn(lo, c.s), c.z), __fsub_rn(__fmul_rn(hi, c.s), c.z));
}
#else
// bf16 scales: q*s is exact in f32 (a 4-bit q times an 8-bit significand),
// and so is q*s - z wherever z is s times an integer zero point (rounded
// to bf16: the GPTQ format's zero-scales, z >= s, or 0) -- the two
// operands then lie within 2^5 of each other in scale -- so the
// reference's f32 value is exact and its one rounding to bf16 is that of a
// bf16x2 fma on the exact operands: (q + 128) - 128 from the nibbles under
// the exponent of 128 (exact), then q * s - z, two weights an instruction.
struct ColumnScale {
  __nv_bfloat162 s, nz;  // s, -z in both halves
};
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
// Columns c and c + 1 of a scale row and a zero-scale row (c even).
__device__ __forceinline__ void load_scales(ColumnScale (&c)[2], const scale_t* s,
                                            const scale_t* z) {
  const uint32_t sv = *reinterpret_cast<const uint32_t*>(s);
  const uint32_t zv = *reinterpret_cast<const uint32_t*>(z);
  c[0] = {as_bf162(prmt(sv, sv, 0x1010)), __hneg2(as_bf162(prmt(zv, zv, 0x1010)))};
  c[1] = {as_bf162(prmt(sv, sv, 0x3232)), __hneg2(as_bf162(prmt(zv, zv, 0x3232)))};
}
// prmt's selector: byte q of w, then byte q of w >> 4, in bytes 0 and 2
__device__ __forceinline__ uint32_t pick_of(int q) { return q | (4 + q) << 8; }
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t pick, const ColumnScale& c) {
  const uint32_t u = (prmt(w, w >> 4, pick) & 0x000F000Fu) | 0x43004300u;  // 128 + q
  const __nv_bfloat162 q = __hsub2(as_bf162(u), __floats2bfloat162_rn(128.f, 128.f));
  const __nv_bfloat162 r = __hfma2(q, c.s, c.nz);
  return *reinterpret_cast<const uint32_t*>(&r);
}
#endif

// A block's work: output tiles (data-parallel: tiles b, b + grid, ...,
// each whole) or, under stream-K, its contiguous range [u0, u1) of the
// tiles x ktiles (tile, slab) units cut at tile edges. Producer and
// consumers walk the same ranges.
struct Walk {
  int KT, tiles, grid, t, u0, u1, u;
  long long U;
  bool sk;
  __device__ __forceinline__ explicit Walk(const Args& p)
      : KT(p.ktiles), tiles(p.tiles), grid(gridDim.x), t(blockIdx.x), sk(p.stream_k != 0) {
    U = (long long)p.tiles * p.ktiles;
    u0 = u = sk ? streamk::unit_begin(blockIdx.x, U, grid) : 0;
    u1 = sk ? streamk::unit_begin(blockIdx.x + 1, U, grid) : 0;
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
};

// A consumer thread's share of the slabs: wait for a slab's slot,
// dequantize its A fragments (NW products x 4 k-steps of 16) into one of
// DEPTH + 1 register buffers, issue the products, and once only DEPTH
// groups are in flight release the slots of the slabs whose products are
// done.
template <int BM, int BN>
struct Consumer {
  using C = Cfg<BM, BN>;
  using Frag = uint32_t[C::NW][4][4];
  unsigned char* smem;
  uint64_t *full, *empty;
  int r0;                 // the thread's weight columns r0, r0 + 1 (and + 64 j): A rows g, g + 8
  uint32_t pick;          // pick_of(q)
  int lane;
  // slots are taken and freed in order: the next slot to take and its
  // phase, the next to free, the slabs taken and not yet freed
  int st = 0, rst = 0, held = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ void slab(float (&acc)[C::NW][C::NACC], Frag& a) {
    mbar_wait(full + st, phase);
    __syncwarp();
    const uint32_t* W = reinterpret_cast<const uint32_t*>(smem + C::W_OFF + st * C::W_BYTES);
    const scale_t* S = reinterpret_cast<const scale_t*>(smem + C::S_OFF + st * C::S_BYTES);
#pragma unroll
    for (int j = 0; j < C::NW; ++j) {
      const int r = r0 + 64 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the slab's halves (k 0-31, 32-63): a group each
        ColumnScale c[2];  // columns r, r + 1
        load_scales(c, S + h * BN + r, S + (2 + h) * BN + r);
#pragma unroll
        for (int ks = 2 * h; ks < 2 * h + 2; ++ks) {
          // a[0], a[1]: k 16ks + 2q, +1 (byte q of packed row 2ks) of
          // columns r (A row g) and r + 1 (A row g + 8); a[2], a[3]: k + 8
          // (packed row 2ks + 1)
          const uint2 w0 = *reinterpret_cast<const uint2*>(W + (2 * ks) * BN + r);
          const uint2 w1 = *reinterpret_cast<const uint2*>(W + (2 * ks + 1) * BN + r);
          a[j][ks][0] = dequant2(w0.x, pick, c[0]);
          a[j][ks][1] = dequant2(w0.y, pick, c[1]);
          a[j][ks][2] = dequant2(w1.x, pick, c[0]);
          a[j][ks][3] = dequant2(w1.y, pick, c[1]);
        }
      }
    }
    const uint64_t desc = kmajor_sw128(smem + st * C::X_BYTES);
    if (++st == C::STAGES) st = 0, phase ^= 1;
    ++held;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < C::NW; ++j) Mma<BM>::run(acc[j], a[j][ks], desc + 2 * ks);
    wgmma_commit();
    wgmma_wait<C::DEPTH>();
    if (held > C::DEPTH) release();  // the oldest slab's products are done
  }
  // Free the oldest slot taken.
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + rst);
    if (++rst == C::STAGES) rst = 0;
    --held;
  }
  // The products of a range: slabs [kb, ke) into acc, all of them done.
  __device__ __forceinline__ void range(float (&acc)[C::NW][C::NACC], int kb, int ke) {
    Frag a[C::DEPTH + 1];
#pragma unroll
    for (int j = 0; j < C::NW; ++j)
#pragma unroll
      for (int i = 0; i < C::NACC; ++i) acc[j][i] = 0.f;
    for (int kt = kb; kt < ke; kt += C::DEPTH + 1) {
#pragma unroll
      for (int b = 0; b <= C::DEPTH; ++b)
        if (kt + b < ke) slab(acc, a[b]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < C::NW; ++j) fence_regs(acc[j]);
#pragma unroll
    for (int d = 0; d < C::DEPTH; ++d)
      if (held > 0) release();
  }
};

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    q4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __grid_constant__ CUtensorMap zmap, const Args p) {
  using C = Cfg<BM, BN>;
  constexpr int ST = C::STAGES, NW = C::NW, NACC = C::NACC;
  // 1024-byte aligned (the 128-byte swizzle's atoms): the block has no
  // static shared memory, so its dynamic shared memory starts its window.
  // Used as declared (not rounded up through an integer), the compiler
  // keeps the shared address space: ld.shared, not generic loads.
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + ST;
  int* answer = reinterpret_cast<int*>(empty + ST);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    if (tc::smem_addr(smem) & 1023) __trap();
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, VEC ? 1 : 32);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: its first warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != CONSUMERS / 32 || (VEC && lane != 0)) return;
    Walk w(p);
    int tile, kb, ke, st = 0;
    uint32_t phase = 0;  // of slot st; its first wait passes at once (the slots start free)
    while (w.next(tile, kb, ke)) {
      const int m0 = (tile % p.mtiles) * BM, n0 = (tile / p.mtiles) * BN;
      for (int kt = kb; kt < ke; ++kt, st = st + 1 == ST ? 0 : st + 1, phase ^= st == 0) {
        mbar_wait(empty + st, phase ^ 1);
        unsigned char* xs = smem + st * C::X_BYTES;
        unsigned char* ws = smem + C::W_OFF + st * C::W_BYTES;
        unsigned char* ss = smem + C::S_OFF + st * C::S_BYTES;
        const int k0 = kt * BK, g0 = k0 / p.gs, g1 = (k0 + BK / 2) / p.gs;
        if constexpr (VEC) {
          mbar_arrive_tx(full + st, C::TX);
          tma_2d(xs, &xmap, k0, m0, full + st);
          tma_2d(ws, &wmap, n0, kt * (BK / 8), full + st);
          tma_2d(ss, &smap, n0, g0, full + st);
          tma_2d(ss + BN * SC_BYTES, &smap, n0, g1, full + st);
          tma_2d(ss + 2 * BN * SC_BYTES, &zmap, n0, g0, full + st);
          tma_2d(ss + 3 * BN * SC_BYTES, &zmap, n0, g1, full + st);
        } else if (lane == 0) {
          mbar_arrive_tx(full + st, C::X_BYTES);
          tma_2d(xs, &xmap, k0, m0, full + st);
        } else {
          // N % 8 != 0: rows of the words and scales are not 16-byte
          // aligned; lanes 1-31 load the slab's by plain loads
          int32_t* Ws = reinterpret_cast<int32_t*>(ws);
          scale_t* Ss = reinterpret_cast<scale_t*>(ss);
          const int kp0 = k0 / 8, ng = p.K / p.gs;
#pragma unroll 4
          for (int i = lane - 1; i < (BK / 8) * BN; i += 31) {
            const int r = i / BN, c = i % BN;
            const bool ok = kp0 + r < p.K / 8 && n0 + c < p.N;
            Ws[i] = ok ? __ldg(p.qweight + (size_t)(kp0 + r) * p.N + n0 + c) : 0;
          }
#pragma unroll 4
          for (int i = lane - 1; i < 4 * BN; i += 31) {
            const int row = i / BN, c = i % BN, g = (row & 1) ? g1 : g0;
            const scale_t* src = row >> 1 ? p.zscale : p.scales;
            const bool ok = g < ng && n0 + c < p.N;
            Ss[i] = ok ? src[(size_t)g * p.N + n0 + c] : scale_t(0.f);
          }
          mbar_arrive(full + st);
        }
      }
    }
  } else {  // the consumers: warpgroup wgi takes weight columns wgi * BN / 2 ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = warp >> 2, g = lane >> 2, q = lane & 3;
    Consumer<BM, BN> cs{smem, full, empty, wgi * (BN / 2) + (warp & 3) * 16 + 2 * g, pick_of(q),
                        lane};
    float acc[NW][NACC];
    bf16* Cs = reinterpret_cast<bf16*>(smem + C::C_OFF);
    Walk w(p);
    int tile, kb, ke;
    while (w.next(tile, kb, ke)) {
      cs.range(acc, kb, ke);
      const int m0 = (tile % p.mtiles) * BM, n0 = (tile / p.mtiles) * BN;

      if (kb != 0 || ke != p.ktiles) {
        // a part of the tile (stream-K): this block's first (slot 0) or last
        // (slot 1) range, published as a grid barrier does it; the partial
        // sums stay in the accumulators' layout, thread by thread
        const int KT = p.ktiles, seg0 = tile * KT + kb;
        float4* mine = reinterpret_cast<float4*>(
                           p.part + (size_t)(2 * blockIdx.x + (seg0 == w.u0 ? 0 : 1)) * BM * BN) +
                       tid;
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int i = 0; i < NACC / 4; ++i)
            mine[(j * (NACC / 4) + i) * CONSUMERS] =
                make_float4(acc[j][4 * i], acc[j][4 * i + 1], acc[j][4 * i + 2], acc[j][4 * i + 3]);
        bar_sync(1, CONSUMERS);
        if (tid == 0) {
          __threadfence();
          *answer = (int)atomicAdd(p.ticket + tile, 1u);
          __threadfence();
        }
        bar_sync(1, CONSUMERS);
        const int first = streamk::block_of((long long)tile * KT, w.U, w.grid);
        const int last = streamk::block_of((long long)(tile + 1) * KT - 1, w.U, w.grid);
        if (*answer != last - first) continue;  // another block finishes the tile
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int i = 0; i < NACC; ++i) acc[j][i] = 0.f;
        for (int blk = first; blk <= last; ++blk) {  // in the order of k
          const int slot = streamk::unit_begin(blk, w.U, w.grid) >= tile * KT ? 0 : 1;
          const float4* src =
              reinterpret_cast<const float4*>(p.part + (size_t)(2 * blk + slot) * BM * BN) + tid;
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i) {
              const float4 v = __ldcg(src + (j * (NACC / 4) + i) * CONSUMERS);
              acc[j][4 * i] += v.x, acc[j][4 * i + 1] += v.y;
              acc[j][4 * i + 2] += v.z, acc[j][4 * i + 3] += v.w;
            }
        }
        if (tid == 0) p.ticket[tile] = 0u;  // ready for the next launch
      }

      // the output tile: bf16 in registers, transposed through shared memory
      // (Cs[m][n]), out in 16-byte stores
      bar_sync(1, CONSUMERS);  // the last tile's rows have left Cs
      // acc[j][4i + e]: row 8i + 2q + (e & 1) of x, column r0 + 64j + (e >> 1)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int i = 0; i < NACC / 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<uint32_t*>(Cs + (8 * i + 2 * q + e) * C::C_LD + cs.r0 + 64 * j) =
                tc::pack_bf16(acc[j][4 * i + e], acc[j][4 * i + 2 + e]);
      bar_sync(1, CONSUMERS);
      for (int i = tid; i < BM * (BN / 8); i += CONSUMERS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const int gm = m0 + r, gn = n0 + c;
        if (gm >= p.M) break;  // rows only grow with i
        if constexpr (VEC) {
          if (gn < p.N)
            *reinterpret_cast<uint4*>(p.out + (size_t)gm * p.N + gn) =
                *reinterpret_cast<const uint4*>(Cs + r * C::C_LD + c);
        } else {
          for (int e = 0; e < 8 && gn + e < p.N; ++e)
            p.out[(size_t)gm * p.N + gn + e] = Cs[r * C::C_LD + c + e];
        }
      }
    }
  }
}

template <int BM, int BN, bool VEC>
cudaError_t launch(const CUtensorMap (&maps)[4], const Args& p, int grid, cudaStream_t st) {
  using C = Cfg<BM, BN>;
  static const cudaError_t ok = allow_smem(q4_wgmma_kernel<BM, BN, VEC>, C::SMEM);
  if (ok != cudaSuccess) return ok;
  q4_wgmma_kernel<BM, BN, VEC><<<grid, THREADS, C::SMEM, st>>>(maps[0], maps[1], maps[2],
                                                                  maps[3], p);
  return cudaGetLastError();
}

// The tile shapes q4_matmul_plan chooses from: 64 x 256, 128 x 128, 256 x 128.
template <bool VEC>
cudaError_t launch_tile(int bm, int bn, const CUtensorMap (&maps)[4], const Args& p, int grid,
                        cudaStream_t st) {
  if (bm == 64 && bn == 256) return launch<64, 256, VEC>(maps, p, grid, st);
  if (bm == 128 && bn == 128) return launch<128, 128, VEC>(maps, p, grid, st);
  if (bm == 256 && bn == 128) return launch<256, 128, VEC>(maps, p, grid, st);
  return cudaErrorInvalidValue;
}

SCALE_NS_END
}  // namespace wg
