// K2 q4_matmul: 4-bit GPTQ matmul for prefill-sized M (M > 32).
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_deqw2_kernel_npair
// (launched at quant.py:996) and its siblings with the same math
// (_q4_deqw_kernel_npair, _q4_deqw_kernel, _q4_deqw2_kernel,
// _q4_deqw2_kernel_npair_ovl): dequantize a weight tile to bf16
// (w = q*s - zs in f32, rounded once), then bf16 products with f32
// accumulation and a bf16 output. Act-order x is gathered by the caller.
//
// Bound on the H100: operations. At prefill M (hundreds to thousands of
// rows) the 2*M*K*N flops outweigh the K*N/2 weight bytes far beyond the
// ~295 flop/byte ridge, so the tensor cores set the floor (989 TFLOP/s
// bf16). Design: a 256x128 output tile per block, warp specialised. Four
// producer warps keep a ring of four 64-deep slabs in flight with 16-byte
// cp.async copies -- the raw x tile (256x64 bf16), the packed weight slab
// (8 x 128 int32, the GPTQ K-packed layout as it is, no repack) and the
// slab's scale and zero-scale rows (two group rows cover a slab at g32) --
// and dequantize each slab once, from shared memory into one of two bf16
// [64][128] tiles, with 16-byte stores and its scales read once. Eight
// consumer warps, a 64x64 sub-tile each, run ldmatrix + mma.sync.m16n8k16
// bf16 with f32 accumulators in registers on the tile the producers
// filled. Named barriers hand the two bf16 tiles back and forth, so the
// dequant of slab k+1 overlaps the products of slab k. (Measured on an
// H100 in turns: designs in which every warp dequantizes, passes a
// block-wide barrier and multiplies were 13-14% slower at the 7B gate|up
// shape, and their tile shapes moved them by less than 10%.) The epilogue
// rounds to bf16 in registers and leaves through shared memory in 16-byte
// stores. One block an SM (198 KB of shared memory). Ragged M and N are
// masked; for an N that is not a multiple of 8 (rows of weights and scales
// not 16-byte aligned) the producers read the weight and scale slabs by
// plain loads and the output is written element by element. Not yet:
// wgmma (mma.sync reaches a part of Hopper's tensor-core rate only) and
// TMA.
//
// K12, the GLU mode (replaces quant.py:_q4_deqw2_kernel_npair_glu, same
// launch site), keeps the first slice's unpipelined WMMA kernel: the A tile
// is formed from the raw fused gate|up output x [M, W] as
// bf16(bf16(silu_f32(gate)) * up), gate = x[m, k], up = x[m, ou + k] (the
// cast order of quant.py:680-682), so the [M, K] activation of the down
// projection never exists in memory. Each of the N/128 column blocks
// re-reads its rows' gate and up (L2 serves most of it) and recomputes the
// silu.
#include <mma.h>

#include "async_mma.cuh"

namespace {

// ------------------------------------------------------------- K2, pipelined

constexpr int BM = 256, BN = 128, BK = 64, RING = 4;  // tile, slab depth, slabs in flight
constexpr int WARPS_M = 4, WARPS_N = 2;               // the consumer warps
constexpr int CONSUMERS = WARPS_M * WARPS_N * 32;
constexpr int PRODUCERS = 128;                        // 4 warps copy and dequantize
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a consumer warp's tile
constexpr int MI = WM / 16, NP = WN / 16;            // 16-row fragments, 16-column pairs
constexpr int A_LD = BK + 8;  // bf16 elements of a staged x row (144 bytes)
constexpr int B_LD = BN + 8;  // bf16 elements of a dequantized weight row
constexpr int C_LD = BN + 8;  // bf16 elements of an output row in the epilogue
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int W_BYTES = (BK / 8) * BN * 4;
constexpr int SZ_BYTES = 2 * 2 * BN * 2;  // scales, zero-scales: two group rows each
constexpr int WS_BYTES = W_BYTES + SZ_BYTES;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int W_OFF = RING * A_BYTES;
constexpr int B_OFF = W_OFF + RING * WS_BYTES;
constexpr int SMEM = B_OFF + 2 * B_BYTES;
static_assert(BM * C_LD * 2 <= B_OFF, "the epilogue tile fits over the ring");

// Named barriers (0 is __syncthreads): the bf16 tile of slab kt is full
// (1 + kt % 2) or its slab consumed (3 + kt % 2); 5 among the producers.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Producer thread t (of PRODUCERS) issues its share of the copies of slab
// kt (k0 = kt*BK) into ring slot kt % RING: the x tile, BM rows x 8 chunks
// of 8 (K % 32 == 0: a chunk is inside or outside), the packed weights
// [BK/8][BN], then the scale and zero-scale rows [2][BN] each. VEC: N % 8
// == 0, so weight and scale rows are 16-byte aligned; else plain loads.
template <bool VEC>
__device__ __forceinline__ void load_slab(unsigned char* smem, const bf16* __restrict__ x,
                                          const int32_t* __restrict__ qw,
                                          const bf16* __restrict__ scales,
                                          const bf16* __restrict__ zscale, int m0, int n0,
                                          int kt, int M, int K, int N, int gs, int t) {
  bf16* As = reinterpret_cast<bf16*>(smem + (kt % RING) * A_BYTES);
  unsigned char* Wst = smem + W_OFF + (kt % RING) * WS_BYTES;
  const int k0 = kt * BK;
  for (int i = t; i < BM * (BK / 8); i += PRODUCERS) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int gm = m0 + r, k = k0 + c;
    const bool ok = gm < M && k < K;
    tc::cp_async16(As + r * A_LD + c, ok ? x + (size_t)gm * K + k : x, ok ? 16 : 0);
  }
  int32_t* Ws = reinterpret_cast<int32_t*>(Wst);
  bf16* Ss = reinterpret_cast<bf16*>(Wst + W_BYTES);
  const int kp0 = k0 / 8, g0 = k0 / gs, ng = K / gs;
  if constexpr (VEC) {
    for (int i = t; i < (BK / 8) * (BN / 4); i += PRODUCERS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool ok = kp0 + r < K / 8 && n0 + c < N;
      tc::cp_async16(Ws + r * BN + c, ok ? qw + (size_t)(kp0 + r) * N + n0 + c : qw, ok ? 16 : 0);
    }
    for (int i = t; i < 4 * (BN / 8); i += PRODUCERS) {
      const int row = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bf16* src = row >> 1 ? zscale : scales;
      const bool ok = g0 + (row & 1) < ng && n0 + c < N;
      tc::cp_async16(Ss + row * BN + c, ok ? src + (size_t)(g0 + (row & 1)) * N + n0 + c : src,
                     ok ? 16 : 0);
    }
  } else {
    for (int i = t; i < (BK / 8) * BN; i += PRODUCERS) {
      const int r = i / BN, c = i - r * BN;
      const bool ok = kp0 + r < K / 8 && n0 + c < N;
      Ws[r * BN + c] = ok ? __ldg(qw + (size_t)(kp0 + r) * N + n0 + c) : 0;
    }
    for (int i = t; i < 4 * BN; i += PRODUCERS) {
      const int row = i / BN, c = i - row * BN;
      const bf16* src = row >> 1 ? zscale : scales;
      const bool ok = g0 + (row & 1) < ng && n0 + c < N;
      Ss[row * BN + c] = ok ? src[(size_t)(g0 + (row & 1)) * N + n0 + c] : f2bf(0.f);
    }
  }
}

// A dequant unit: eight columns of one packed row and four of its nibbles,
// i.e. four k rows of eight columns, each row one 16-byte store into the
// bf16 tile Bs [BK][B_LD]; its words and scales are read once from shared
// memory (load), then its rows written (row).
struct Unit {
  uint32_t w[8];
  uint4 s, z;
  int row0, c;

  __device__ __forceinline__ void load(const unsigned char* Wst, int u, int k0, int gs) {
    c = (u % (BN / 8)) * 8;
    const int half = (u / (BN / 8)) & 1, pr = u / (BN / 4);
    row0 = pr * 8 + half * 4;
    const int32_t* Ws = reinterpret_cast<const int32_t*>(Wst) + pr * BN + c;
    const bf16* Ss = reinterpret_cast<const bf16*>(Wst + W_BYTES);
    const int gi = (k0 + pr * 8) / gs - k0 / gs;  // 0, or 1 at g32
    const uint4 w0 = *reinterpret_cast<const uint4*>(Ws);
    const uint4 w1 = *reinterpret_cast<const uint4*>(Ws + 4);
    w[0] = w0.x, w[1] = w0.y, w[2] = w0.z, w[3] = w0.w;
    w[4] = w1.x, w[5] = w1.y, w[6] = w1.z, w[7] = w1.w;
    s = *reinterpret_cast<const uint4*>(Ss + gi * BN + c);
    z = *reinterpret_cast<const uint4*>(Ss + (2 + gi) * BN + c);
  }

  // k row j (0..3) of the unit: w = q*s - zs in f32, rounded once to bf16.
  // The nibble becomes an exact float through the exponent field (2^23 + q,
  // minus 2^23): no integer-to-float conversion, which runs at a quarter of
  // the rate.
  __device__ __forceinline__ void row(bf16* Bs, int j) const {
    const int sh = 4 * ((row0 & 4) + j);
    const bf16* sb = reinterpret_cast<const bf16*>(&s);
    const bf16* zb = reinterpret_cast<const bf16*>(&z);
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float q = __uint_as_float(0x4B000000u | ((w[e] >> sh) & 0xFu)) - 8388608.f;
      f[e] = __fsub_rn(__fmul_rn(q, bf2f(sb[e])), bf2f(zb[e]));
    }
    *reinterpret_cast<uint4*>(Bs + (row0 + j) * B_LD + c) =
        make_uint4(tc::pack_bf16(f[0], f[1]), tc::pack_bf16(f[2], f[3]),
                   tc::pack_bf16(f[4], f[5]), tc::pack_bf16(f[6], f[7]));
  }
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1) q4_matmul_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qweight,
    const bf16* __restrict__ scales, const bf16* __restrict__ zscale, bf16* __restrict__ out,
    int M, int K, int N, int gs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  auto b_st = [&](int kt) { return reinterpret_cast<bf16*>(smem + B_OFF + (kt & 1) * B_BYTES); };
  float c[MI][2 * NP][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;

  if (tid >= CONSUMERS) {  // producers
    const int t = tid - CONSUMERS;
    for (int s = 0; s < RING - 2; ++s) {
      if (s < ktiles) load_slab<VEC>(smem, x, qweight, scales, zscale, m0, n0, s, M, K, N, gs, t);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt >= 2) bar_sync(3 + (kt & 1), THREADS);  // slab kt - 2 consumed
      const int nt = kt + RING - 2;
      if (nt < ktiles) load_slab<VEC>(smem, x, qweight, scales, zscale, m0, n0, nt, M, K, N, gs, t);
      tc::cp_async_commit();
      tc::cp_async_wait<RING - 2>();
      bar_sync(5, PRODUCERS);
      const unsigned char* Wst = smem + W_OFF + (kt % RING) * WS_BYTES;
      for (int u = t; u < (BK / 8) * (BN / 8) * 2; u += PRODUCERS) {
        Unit un;
        un.load(Wst, u, kt * BK, gs);
#pragma unroll
        for (int j = 0; j < 4; ++j) un.row(b_st(kt), j);
      }
      bar_arrive(1 + (kt & 1), THREADS);
    }
    tc::cp_async_wait<0>();
  } else {  // consumers
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    for (int kt = 0; kt < ktiles; ++kt) {
      bar_sync(1 + (kt & 1), THREADS);
      const bf16* As = reinterpret_cast<const bf16*>(smem + (kt % RING) * A_BYTES);
      const bf16* Bs = b_st(kt);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MI][4], b[NP][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          tc::ldmatrix_x4(a[i], As + (wm * WM + i * 16 + (lane & 15)) * A_LD + kk * 16 +
                                    (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < NP; ++jp)
          tc::ldmatrix_x4_trans(b[jp], Bs + (kk * 16 + (lane & 15)) * B_LD + wn * WN + jp * 16 +
                                           (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int jp = 0; jp < NP; ++jp) {
            tc::mma_bf16(c[i][2 * jp], a[i], b[jp][0], b[jp][1]);
            tc::mma_bf16(c[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
          }
      }
      if (kt + 2 < ktiles) bar_arrive(3 + (kt & 1), THREADS);
    }
  }
  __syncthreads();  // the ring is free: the output tile goes over it
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  if (tid < CONSUMERS) {
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int gq = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * WM + i * 16 + gq + 8 * h, col = wn * WN + j * 8 + 2 * q4;
          *reinterpret_cast<uint32_t*>(Cs + r * C_LD + col) =
              tc::pack_bf16(c[i][j][2 * h], c[i][j][2 * h + 1]);
        }
  }
  __syncthreads();
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(out + (size_t)gm * N + gn) =
          *reinterpret_cast<const uint4*>(Cs + r * C_LD + col);
    } else {
      for (int e = 0; e < 8 && gn + e < N; ++e) out[(size_t)gm * N + gn + e] = Cs[r * C_LD + col + e];
    }
  }
}

template <bool VEC>
cudaError_t launch_q4(const bf16* x, const int32_t* qw, const bf16* s, const bf16* z, bf16* out,
                      int M, int K, int N, int gs, cudaStream_t st) {
  static const cudaError_t smem_ok = allow_smem(q4_matmul_kernel<VEC>, SMEM);
  if (smem_ok != cudaSuccess) return smem_ok;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q4_matmul_kernel<VEC><<<grid, THREADS, SMEM, st>>>(x, qw, s, z, out, M, K, N, gs);
  return cudaGetLastError();
}

// ------------------------------------------- K12, the GLU mode (first slice)

using namespace nvcuda;

constexpr int G_BK = 32;
constexpr int G_A_LD = G_BK + 8;  // padded row strides (bank spread; 16-byte multiples)
constexpr int G_BM = 128, G_BN = 128, G_THREADS = 256;
constexpr int G_B_LD = G_BN + 8;

// x rows have stride ldx; the row holds gate at [0, K) and up at [ou, ou + K).
__global__ void __launch_bounds__(G_THREADS) q4_matmul_glu_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qweight,
    const bf16* __restrict__ scales, const bf16* __restrict__ zscale,
    bf16* __restrict__ out, int M, int K, int N, int gs, int ldx, int ou) {
  __shared__ __align__(128) bf16 As[G_BM * G_A_LD];
  __shared__ __align__(128) bf16 Bs[G_BK * G_B_LD];
  __shared__ __align__(128) float Cs[G_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * G_BM, n0 = blockIdx.x * G_BN;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += G_BK) {
    // x tile: G_BM rows x G_BK bf16 = 4 x 16-byte vectors per row
    for (int i = tid; i < G_BM * G_BK / 8; i += G_THREADS) {
      const int r = i >> 2, c8 = (i & 3) * 8;
      const int gm = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M) {
        const bf16* src = x + (size_t)gm * ldx + k0 + c8;
        v = *reinterpret_cast<const uint4*>(src);
        const uint4 u = *reinterpret_cast<const uint4*>(src + ou);
        bf16* g8 = reinterpret_cast<bf16*>(&v);
        const bf16* u8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) g8[e] = f2bf(silu_mul(bf2f(g8[e]), bf2f(u8[e])));
      }
      *reinterpret_cast<uint4*>(As + r * G_A_LD + c8) = v;
    }
    // weight tile: G_BK/8 packed rows x G_BN columns, each word -> 8 bf16
    for (int i = tid; i < (G_BK / 8) * G_BN; i += G_THREADS) {
      const int wr = i / G_BN, cc = i - wr * G_BN;
      const int gn = n0 + cc;
      const int k = k0 + wr * 8;
      if (gn < N) {
        const int32_t w = __ldg(qweight + (size_t)(k >> 3) * N + gn);
        const int grp = k / gs;
        const float s = bf2f(scales[(size_t)grp * N + gn]);
        const float z = bf2f(zscale[(size_t)grp * N + gn]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float q = (float)((w >> (4 * j)) & 0xF);
          Bs[(wr * 8 + j) * G_B_LD + cc] = f2bf(__fsub_rn(__fmul_rn(q, s), z));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[(wr * 8 + j) * G_B_LD + cc] = f2bf(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < G_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * G_A_LD + kk, G_A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * G_B_LD + wn * 32 + j * 16, G_B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 fragment at a time, casts, masks
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs[warp], c[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * 64 + i * 16 + (e >> 4);
        const int gn = n0 + wn * 32 + j * 16 + (e & 15);
        if (gm < M && gn < N) out[(size_t)gm * N + gn] = f2bf(Cs[warp][e]);
      }
      __syncwarp();
    }
}

}  // namespace

// x [M, K] bf16 (K % 32 == 0, 16-byte aligned rows); qweight [K/8, N] int32;
// scales, zscale [K/gs, N] bf16 (gs a multiple of 32 dividing K); out [M, N]
// bf16.
extern "C" int q4_matmul_launch(const void* x, const void* qweight, const void* scales,
                                const void* zscale, void* out, int M, int K, int N, int gs,
                                void* stream) {
  if (K % 32 || gs % 32 || K % gs) return cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch((const bf16*)x, (const int32_t*)qweight, (const bf16*)scales,
                  (const bf16*)zscale, (bf16*)out, M, K, N, gs, (cudaStream_t)stream);
  };
  return N % 8 == 0 ? args(launch_q4<true>) : args(launch_q4<false>);
}

// K12: x [M, W] bf16, the raw fused gate|up output (W % 8 == 0, ou % 8 == 0,
// ou + K <= W, 16-byte aligned rows); the product runs over
// silu(x[:, :K]) * x[:, ou : ou + K]. The other operands as above.
extern "C" int q4_matmul_glu_launch(const void* x, const void* qweight, const void* scales,
                                    const void* zscale, void* out, int M, int K, int N,
                                    int gs, int W, int ou, void* stream) {
  dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  q4_matmul_glu_kernel<<<grid, G_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int32_t*)qweight, (const bf16*)scales, (const bf16*)zscale,
      (bf16*)out, M, K, N, gs, W, ou);
  return cudaGetLastError();
}
