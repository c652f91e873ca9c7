// K1 q4_gemv: 4-bit GPTQ GEMV for decode-sized M (M <= 32).
//
// Replaces the TPU kernel exllama_tpu/ops/quant.py:_q4_gemv_kernel_npair
// (and its kgroup twin _q4_gemv_kernel, act-order prologue
// _permute_prologue), launched at quant.py:1217.
//
// Computes out[m, n] = sum_g ( s[g,n] * sum_{k in g} x[m,k]*q[k,n]
//                              - zs[g,n] * sum_{k in g} x[m,k] )
// in f32, cast to bf16: scales and zero-points act on group partial sums,
// never per weight. Optional prologues: RMSNorm of x (rms_norm(x)*w in f32,
// rounded to bf16 before the dots, as quant.py:214-220) and the act-order
// gather x[:, x_map].
//
// Bound on the H100: memory. Every packed weight byte is used once per row
// of x, so at M <= 32 the kernel moves K*N/2 bytes of nibbles plus
// 2*(K/gs)*N*2 bytes of scales for 2*M*K*N flops -- far below the ~295
// flop/byte ridge. Design: one lane per output column, so a warp's int32
// loads of one packed row are 128 contiguous bytes; eight warps of a block
// split the K groups of its 32 columns and add their partials in shared
// memory at the end (the TPU kernel's sequential K grid axis becomes this
// in-block loop -- blocks run in no order on Hopper). Each lane issues a
// group's gs/8 words before using them, keeping loads in flight. x (after
// norm / gather) is staged in shared memory per K chunk together with its
// per-group sums, which all columns share.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 32;                   // output columns per block, one per lane
constexpr int X_SMEM_BYTES = 40 * 1024;  // budget of the staged activation chunk

template <int MB>
__global__ void __launch_bounds__(THREADS) q4_gemv_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qweight,
    const bf16* __restrict__ scales, const bf16* __restrict__ zscale,
    const bf16* __restrict__ norm_w, const int32_t* __restrict__ x_map,
    bf16* __restrict__ out, int M, int K, int N, int gs, int kc, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gpc = kc / gs;                                         // groups per chunk
  bf16* xs = reinterpret_cast<bf16*>(smem);                        // [MB][kc]
  float* xsum = reinterpret_cast<float*>(smem + ((MB * kc * 2 + 15) & ~15));  // [MB][gpc]
  float* rs = xsum + MB * gpc;                                     // [MB]
  float* red = reinterpret_cast<float*>(smem);                     // [WARPS][32], reuses xs

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + lane;
  const bool col_ok = n < N;

  if (norm_w != nullptr) {
    for (int m = warp; m < MB; m += WARPS) {
      float ss = 0.f;
      if (m < M)
        for (int k = lane; k < K; k += 32) {
          const float v = bf2f(x[(size_t)m * K + k]);
          ss += v * v;
        }
      ss = warp_sum(ss);
      if (lane == 0) rs[m] = 1.0f / sqrtf(ss / (float)K + eps);
    }
  }

  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int klen = min(kc, K - k0);
    const int ng = klen / gs;
    __syncthreads();  // rs ready, previous chunk consumed
    for (int i = threadIdx.x; i < MB * klen; i += THREADS) {
      const int m = i / klen, kk = i - m * klen;
      float v = 0.f;
      if (m < M) {
        const int src = x_map ? x_map[k0 + kk] : k0 + kk;
        v = bf2f(x[(size_t)m * K + src]);
        if (norm_w) v = bf2f(f2bf(v * rs[m] * bf2f(norm_w[src])));
      }
      xs[m * kc + kk] = f2bf(v);
    }
    __syncthreads();
    for (int i = warp; i < MB * ng; i += WARPS) {
      const int m = i / ng, g = i - m * ng;
      float s = 0.f;
      for (int j = lane; j < gs; j += 32) s += bf2f(xs[m * kc + g * gs + j]);
      s = warp_sum(s);
      if (lane == 0) xsum[m * gpc + g] = s;
    }
    __syncthreads();
    if (col_ok) {
      for (int g = warp; g < ng; g += WARPS) {
        const int row0 = k0 + g * gs;
        const int32_t* qp = qweight + (size_t)(row0 / 8) * N + n;
        float accq[MB];
#pragma unroll
        for (int m = 0; m < MB; ++m) accq[m] = 0.f;
        for (int w0 = 0; w0 < gs / 8; w0 += 4) {  // gs in {32, 64, 128}
          int32_t wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = __ldg(qp + (size_t)(w0 + j) * N);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bf16* xk = xs + g * gs + (w0 + j) * 8;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float q = (float)((wv[j] >> (4 * i)) & 0xF);
#pragma unroll
              for (int m = 0; m < MB; ++m) accq[m] = fmaf(bf2f(xk[m * kc + i]), q, accq[m]);
            }
          }
        }
        const int grp = row0 / gs;
        const float s = bf2f(scales[(size_t)grp * N + n]);
        const float z = bf2f(zscale[(size_t)grp * N + n]);
#pragma unroll
        for (int m = 0; m < MB; ++m) acc[m] += s * accq[m] - z * xsum[m * gpc + g];
      }
    }
  }

  // add the WARPS partial sums of each (row, column)
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m >= M) break;
    __syncthreads();
    red[warp * 32 + lane] = acc[m];
    __syncthreads();
    if (warp == 0 && col_ok) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[w * 32 + lane];
      out[(size_t)m * N + n] = f2bf(s);
    }
  }
}

template <int MB>
cudaError_t launch(const bf16* x, const int32_t* qw, const bf16* s, const bf16* z,
                   const bf16* nw, const int32_t* xmap, bf16* out, int M, int K,
                   int N, int gs, float eps, cudaStream_t st) {
  int kc = (X_SMEM_BYTES / (2 * MB)) / gs * gs;
  if (kc < gs) kc = gs;
  if (kc > K) kc = K;
  size_t smem = ((MB * kc * 2 + 15) & ~15) + (size_t)(MB * (kc / gs) + MB) * 4;
  if (smem < WARPS * 32 * 4) smem = WARPS * 32 * 4;
  cudaError_t e = allow_smem(q4_gemv_kernel<MB>, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN);
  q4_gemv_kernel<MB><<<grid, THREADS, smem, st>>>(x, qw, s, z, nw, xmap, out, M, K, N, gs,
                                                  kc, eps);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16; qweight [K/8, N] int32; scales, zscale [K/gs, N] bf16;
// norm_w [K] bf16 or NULL; x_map [K] int32 or NULL; out [M, N] bf16.
extern "C" int q4_gemv_launch(const void* x, const void* qweight, const void* scales,
                              const void* zscale, const void* norm_w, const void* x_map,
                              void* out, int M, int K, int N, int gs, float eps,
                              void* stream) {
  auto bx = (const bf16*)x;
  auto qw = (const int32_t*)qweight;
  auto s = (const bf16*)scales;
  auto z = (const bf16*)zscale;
  auto nw = (const bf16*)norm_w;
  auto xm = (const int32_t*)x_map;
  auto o = (bf16*)out;
  auto st = (cudaStream_t)stream;
  switch (pick_mb(M)) {
    case 1: return launch<1>(bx, qw, s, z, nw, xm, o, M, K, N, gs, eps, st);
    case 2: return launch<2>(bx, qw, s, z, nw, xm, o, M, K, N, gs, eps, st);
    case 4: return launch<4>(bx, qw, s, z, nw, xm, o, M, K, N, gs, eps, st);
    case 8: return launch<8>(bx, qw, s, z, nw, xm, o, M, K, N, gs, eps, st);
    case 16: return launch<16>(bx, qw, s, z, nw, xm, o, M, K, N, gs, eps, st);
    default: return launch<32>(bx, qw, s, z, nw, xm, o, M, K, N, gs, eps, st);
  }
}
