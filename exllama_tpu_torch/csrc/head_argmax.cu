// K5 head_argmax: the greedy decode head, M <= 32 rows:
//   ids[m] = argmax_v ( rms_norm(x[m]) * w_norm ) @ W[:, v]
// with the earliest index winning ties; no logits are materialized.
//
// Replaces the TPU kernel exllama_tpu/ops/dense.py:_head_argmax_kernel
// (launched at dense.py:129). Numerics as dense.py:97-115: f32 RMSNorm,
// the normed row rounded to bf16, f32 dot products.
//
// Bound on the H100: bytes. The lm_head W [K, V] bf16 is read once (262 MB
// at Llama-7B, 78 us at 3.35 TB/s) for 2*M*K*V flops. Design: K4's column
// streaming -- each lane owns two adjacent columns (one 4-byte load per
// row, 128 contiguous bytes per warp), a block's eight warps split the rows
// of its 64 columns -- with the norm applied while x is staged (each block
// recomputes the f32 row norms, a few KB from L2). Each block reduces its
// tile to a (max, index) per row and combines it with one 64-bit atomicMax
// on a key whose high half is an order-preserving image of the f32 value and
// whose low half is ~index, so the result is deterministic and the earliest
// index wins ties. The launcher zeroes the keys first and a one-warp kernel
// turns them into int32 ids. An odd V (rows not 4-byte aligned) takes the
// scalar instantiation: two 2-byte loads a row, the column past V masked
// out of the loads and of the argmax.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 64;                   // columns per block, two per lane
constexpr int X_SMEM_BYTES = 40 * 1024;
constexpr int UNROLL = 4;

__device__ __forceinline__ unsigned long long argmax_key(float v, int idx) {
  if (v == 0.f) v = 0.f;                 // -0 and +0 tie, as in a float compare
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned int)(~idx);
}

template <int MB, bool VEC>
__global__ void __launch_bounds__(THREADS) head_argmax_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ norm_w, const bf16* __restrict__ w,
    unsigned long long* __restrict__ keys, int M, int K, int V, int kc, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                             // [MB][kc]
  float2* red = reinterpret_cast<float2*>(smem + (size_t)MB * kc * 2);  // [WARPS][32]
  float* rs = reinterpret_cast<float*>(red + WARPS * 32);               // [MB]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * BN + 2 * lane;     // first of this lane's two columns
  const bool col_ok = n < V, col1_ok = n + 1 < V;

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

  float acc0[MB], acc1[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc0[m] = acc1[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int klen = min(kc, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MB * klen; i += THREADS) {
      const int m = i / klen, kk = i - m * klen;
      float v = 0.f;
      if (m < M) v = bf2f(x[(size_t)m * K + k0 + kk]) * rs[m] * bf2f(norm_w[k0 + kk]);
      xs[m * kc + kk] = f2bf(v);
    }
    __syncthreads();
    if (col_ok) {
      const bf16* wp = w + (size_t)k0 * V + n;
      for (int kk = warp * UNROLL; kk < klen; kk += WARPS * UNROLL) {
        __nv_bfloat162 wv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if constexpr (VEC) {
            wv[u] = kk + u < klen
                        ? *reinterpret_cast<const __nv_bfloat162*>(wp + (size_t)(kk + u) * V)
                        : __floats2bfloat162_rn(0.f, 0.f);
          } else {
            const bf16* row = wp + (size_t)(kk + u) * V;
            const bf16 zero = f2bf(0.f);
            wv[u] = kk + u < klen ? __halves2bfloat162(row[0], col1_ok ? row[1] : zero)
                                  : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
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
    if (warp == 0) {
      float2 s = make_float2(0.f, 0.f);
      for (int wi = 0; wi < WARPS; ++wi) {
        const float2 r = red[wi * 32 + lane];
        s.x += r.x;
        s.y += r.y;
      }
      // the lane's best column, then the warp's (earliest index on ties)
      unsigned long long key = 0ull;
      if (col_ok) key = col1_ok && s.y > s.x ? argmax_key(s.y, n + 1) : argmax_key(s.x, n);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
        key = other > key ? other : key;
      }
      if (lane == 0) atomicMax(keys + m, key);
    }
  }
}

__global__ void keys_to_ids(const unsigned long long* __restrict__ keys,
                            int32_t* __restrict__ ids, int M) {
  const int m = threadIdx.x;
  if (m < M) ids[m] = (int32_t)(~(unsigned int)(keys[m] & 0xffffffffull));
}

template <int MB>
cudaError_t launch(const bf16* x, const bf16* nw, const bf16* w, unsigned long long* keys,
                   int32_t* ids, int M, int K, int V, float eps, cudaStream_t st) {
  int kc = X_SMEM_BYTES / (2 * MB);
  kc -= kc % UNROLL;
  if (kc > K) kc = K;
  const size_t smem = (size_t)MB * kc * 2 + WARPS * 32 * sizeof(float2) + MB * 4;
  cudaError_t e = cudaMemsetAsync(keys, 0, (size_t)M * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return e;
  dim3 grid((V + BN - 1) / BN);
  if (V % 2 == 0 && (uintptr_t)w % 4 == 0)
    head_argmax_kernel<MB, true><<<grid, THREADS, smem, st>>>(x, nw, w, keys, M, K, V, kc, eps);
  else
    head_argmax_kernel<MB, false><<<grid, THREADS, smem, st>>>(x, nw, w, keys, M, K, V, kc, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  keys_to_ids<<<1, 32, 0, st>>>(keys, ids, M);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 (pre-norm); norm_w [K] bf16; w [K, V] bf16 (any V >= 1);
// keys [M] uint64 scratch; ids [M] int32 out.
extern "C" int head_argmax_launch(const void* x, const void* norm_w, const void* w,
                                  void* keys, void* ids, int M, int K, int V, float eps,
                                  void* stream) {
  auto bx = (const bf16*)x;
  auto nw = (const bf16*)norm_w;
  auto bw = (const bf16*)w;
  auto ks = (unsigned long long*)keys;
  auto out = (int32_t*)ids;
  auto st = (cudaStream_t)stream;
  switch (pick_mb(M)) {
    case 1: return launch<1>(bx, nw, bw, ks, out, M, K, V, eps, st);
    case 2: return launch<2>(bx, nw, bw, ks, out, M, K, V, eps, st);
    case 4: return launch<4>(bx, nw, bw, ks, out, M, K, V, eps, st);
    case 8: return launch<8>(bx, nw, bw, ks, out, M, K, V, eps, st);
    case 16: return launch<16>(bx, nw, bw, ks, out, M, K, V, eps, st);
    default: return launch<32>(bx, nw, bw, ks, out, M, K, V, eps, st);
  }
}
