// K4 dense_gemv: bf16 GEMV x[M<=32, K] @ w[K, V] -> f32 [M, V].
//
// Replaces the TPU kernel exllama_tpu/ops/dense.py:_kernel (launched at
// dense.py:56): the lm_head product of every forward that returns logits,
// bf16 inputs, f32 accumulation and f32 output.
//
// Bound on the H100: memory. The K*V*2 bytes of the weight are read once
// for 2*M*K*V flops, so at decode M the card can do no better than
// K*V*2 / 3.35 TB/s. Design: each lane owns two adjacent columns (one
// 4-byte bf16x2 load per row, 128 contiguous bytes per warp), a block's
// eight warps split the rows of its 64 columns and add their partials in
// shared memory; the K loop issues four independent row loads before using
// them to keep loads in flight. x is staged per K chunk in shared memory
// and read there as a broadcast.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 64;                   // columns per block, two per lane
constexpr int X_SMEM_BYTES = 40 * 1024;
constexpr int UNROLL = 4;

template <int MB>
__global__ void __launch_bounds__(THREADS) dense_gemv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ out,
    int M, int K, int V, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);     // [MB][kc]
  float2* red = reinterpret_cast<float2*>(smem);  // [WARPS][32], reuses xs

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + 2 * lane;     // first of this lane's two columns
  const bool col_ok = n < V;                    // V is even, so n+1 < V too

  float acc0[MB], acc1[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc0[m] = acc1[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int klen = min(kc, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MB * klen; i += THREADS) {
      const int m = i / klen, kk = i - m * klen;
      xs[m * kc + kk] = m < M ? x[(size_t)m * K + k0 + kk] : f2bf(0.f);
    }
    __syncthreads();
    if (col_ok) {
      const bf16* wp = w + (size_t)k0 * V + n;
      for (int kk = warp * UNROLL; kk < klen; kk += WARPS * UNROLL) {
        __nv_bfloat162 wv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          wv[u] = kk + u < klen
                      ? *reinterpret_cast<const __nv_bfloat162*>(wp + (size_t)(kk + u) * V)
                      : __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (kk + u >= klen) break;
          const float2 wf = __bfloat1622float2(wv[u]);
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            const float xv = bf2f(xs[m * kc + kk + u]);
            acc0[m] = fmaf(xv, wf.x, acc0[m]);
            acc1[m] = fmaf(xv, wf.y, acc1[m]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m >= M) break;
    __syncthreads();
    red[warp * 32 + lane] = make_float2(acc0[m], acc1[m]);
    __syncthreads();
    if (warp == 0 && col_ok) {
      float2 s = make_float2(0.f, 0.f);
      for (int wi = 0; wi < WARPS; ++wi) {
        const float2 r = red[wi * 32 + lane];
        s.x += r.x;
        s.y += r.y;
      }
      *reinterpret_cast<float2*>(out + (size_t)m * V + n) = s;
    }
  }
}

template <int MB>
cudaError_t launch(const bf16* x, const bf16* w, float* out, int M, int K, int V,
                   cudaStream_t st) {
  int kc = X_SMEM_BYTES / (2 * MB);
  kc -= kc % UNROLL;
  if (kc > K) kc = K;
  size_t smem = (size_t)MB * kc * 2;
  if (smem < WARPS * 32 * sizeof(float2)) smem = WARPS * 32 * sizeof(float2);
  dim3 grid((V + BN - 1) / BN);
  dense_gemv_kernel<MB><<<grid, THREADS, smem, st>>>(x, w, out, M, K, V, kc);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16; w [K, V] bf16 (V even, 4-byte aligned); out [M, V] f32.
extern "C" int dense_gemv_launch(const void* x, const void* w, void* out, int M, int K,
                                 int V, void* stream) {
  auto bx = (const bf16*)x;
  auto bw = (const bf16*)w;
  auto o = (float*)out;
  auto st = (cudaStream_t)stream;
  switch (pick_mb(M)) {
    case 1: return launch<1>(bx, bw, o, M, K, V, st);
    case 2: return launch<2>(bx, bw, o, M, K, V, st);
    case 4: return launch<4>(bx, bw, o, M, K, V, st);
    case 8: return launch<8>(bx, bw, o, M, K, V, st);
    case 16: return launch<16>(bx, bw, o, M, K, V, st);
    default: return launch<32>(bx, bw, o, M, K, V, st);
  }
}
