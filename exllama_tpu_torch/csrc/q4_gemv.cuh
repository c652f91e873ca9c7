// The 4-bit GPTQ group-sum GEMV, as a block-level device function shared by
// K1 (q4_gemv.cu), K6 (q4_mlp.cu) and K7 (layer_tail.cu): the CUDA-core loop
// that serves one row at groupsize 32 / 64 / 128 (2..32 rows, and other
// groupsizes, take the tensor-core GEMV of q4_gemv_tc.cuh, which shares
// this file's staging prologues, XSrc / QW and the a8 quantization).
//
// out[m, n] = sum_g ( s[g,n] * sum_{k in g} x[m,k]*q[k,n]
//                     - zs[g,n] * sum_{k in g} x[m,k] )
// in f32: scales and zero-points act on group partial sums of exact
// nibbles, never per weight (the TPU kernel's math, quant.py:_q4_gemv_kernel
// and ops/mlp.py:_npair_gemv_partials).
//
// A block of 8 warps owns a tile of 32 output columns, one per lane, so a
// warp's int32 loads of one packed row are 128 contiguous bytes; the warps
// split the K groups of the tile (each lane issues four packed words before
// using them) and add their partials in shared memory at the end.
// The activation is staged in shared memory per K chunk, already in the form
// the product takes (RMSNorm, act-order gather or silu(gate)*up applied),
// with its per-group sums. A block may walk several tiles (the persistent
// grids of K6/K7); when the whole K fits one chunk it is staged once.
//
// K9, the W4A8 modes (template parameter MODE; replaces
// exllama_tpu/ops/quant.py:_q4_gemv_kernel_npair_a8 and the a8 / a8x2
// branches of ops/mlp.py:_npair_gemv_partials): per (row, group) the staged
// activation is quantized to int8, sx = max(amax, 1e-20)/127,
// xq = clip(rint(x/sx), +-127), and the group product runs on integers:
//   out += s * sx * sum(xq*q) - zs * sum(x)      (sum(x) stays the exact f32)
// A8X2 adds a second int8 pass over the residual r = x - sx*xq at sx/254.
// A K-packed word holds eight consecutive k of one column; w & 0x0F0F0F0F
// and (w >> 4) & 0x0F0F0F0F are its even and odd nibbles as four bytes each,
// so two __dp4a per word and row, against int8 activations staged in the
// same even/odd order, replace eight converts and eight fmaf. The int8 rows
// overwrite the bf16 chunk in place (xq in the first gs bytes of a group's
// 2*gs, the residual row in the second), so the modes need only the
// [MB][kc/gs] scales on top of the exact mode's shared memory. The bound is
// the exact mode's: the packed weights are streamed once either way.
#pragma once

#include "common.cuh"

namespace q4 {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 32;                   // output columns per tile, one per lane
constexpr int X_SMEM_BYTES = 40 * 1024;  // budget of the staged activation chunk
constexpr int WORDS_IN_FLIGHT = 4;      // packed words a lane loads before using them

// Arithmetic of the group products (the port's matmul_impl values "pallas",
// "pallas_a8", "pallas_a8x2" at M <= 32).
constexpr int EXACT = 0, A8 = 1, A8X2 = 2;

// K1, K6 and K7 are each built once per mode (-DGEMV_MODE=0|1|2, one
// shared library each), so a mode costs no build time of the others.
#ifndef GEMV_MODE
#define GEMV_MODE 0
#endif

// Loads of data another block wrote earlier in the same launch (the fused
// kernels' scratch) bypass L1, which is not coherent across SMs.
__device__ __forceinline__ float ld_cg(const bf16* p) {
  return bf2f(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// How the staged activation x[m, k] (m < M, k < K) is formed.
struct XSrc {
  const bf16* x;          // row m at x + m * ld
  int ld;                 // row stride of x, in elements
  const bf16* norm_w;     // [K] or NULL: x = bf16(x * rs[m] * w) (RMSNorm)
  float eps;
  const int32_t* x_map;   // [K] or NULL: x[m, k] = x[m, x_map[k]]
  int glu_off;            // > 0: x[m, k] = silu_mul(x[m, k], x[m, glu_off + k])
};

// One packed weight matrix: qweight [K/8, N] int32, scales / zscale [K/gs, N].
struct QW {
  const int32_t* qweight;
  const bf16* scales;
  const bf16* zscale;
  int N;
};

// Chunk of K staged at once for tile size MB (a multiple of gs, <= K).
__host__ __device__ inline int gemv_kc(int mb, int K, int gs) {
  int kc = (X_SMEM_BYTES / (2 * mb)) / gs * gs;
  if (kc < gs) kc = gs;
  if (kc > K) kc = K;
  return kc;
}

__host__ __device__ inline size_t gemv_xs_bytes(int mb, int kc) {
  return ((size_t)mb * kc * 2 + 15) & ~(size_t)15;
}

// Shared memory of q4_gemv_tiles: xs [MB][kc] bf16, xsum [MB][kc/gs] f32,
// rs [MB] f32, red [WARPS][32] f32 and, in the a8 modes, sx [MB][kc/gs] f32.
__host__ __device__ inline size_t gemv_smem_bytes(int mb, int K, int gs, int mode = EXACT) {
  const int kc = gemv_kc(mb, K, gs);
  const int groups = mb * (kc / gs);
  return gemv_xs_bytes(mb, kc) +
         (size_t)(groups + mb + WARPS * 32 + (mode != EXACT ? groups : 0)) * 4;
}

// clip(rint(v / scale), +-127): round half to even on a true division, as
// jnp.round(x / sx).
__device__ __forceinline__ int quant8(float v, float scale) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, scale))));
}

// Byte of element e (0 <= e < gs) in a group's int8 row: each block of eight
// k is stored as its four even members, then its four odd ones.
__device__ __forceinline__ int a8_pos(int e) { return (e & ~7) + ((e & 1) << 2) + ((e & 7) >> 1); }

// rs[m] = 1 / sqrt(mean(x[m]^2) + eps) in f32, one warp per row.
template <int MB>
__device__ void norm_scales(const XSrc& src, int M, int K, float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < MB; m += WARPS) {
    float ss = 0.f;
    if (m < M)
      for (int k = lane; k < K; k += 32) {
        const float v = ld_cg(src.x + (size_t)m * src.ld + k);
        ss += v * v;
      }
    ss = warp_sum(ss);
    if (lane == 0) rs[m] = 1.0f / sqrtf(ss / (float)K + src.eps);
  }
}

// Stage x[:, k0 : k0+klen] into xs and its per-group sums into xsum. In the
// a8 modes each group's bf16 values are then replaced by its int8 row(s)
// and its scale goes to sxs.
template <int MB, int MODE>
__device__ void stage_chunk(const XSrc& src, int M, int k0, int klen, int kc, int gs,
                            bf16* xs, float* xsum, const float* rs, float* sxs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gpc = kc / gs, ng = klen / gs;
  __syncthreads();  // rs ready, previous chunk consumed
  for (int i = threadIdx.x; i < MB * klen; i += THREADS) {
    const int m = i / klen, kk = i - m * klen;
    float v = 0.f;
    if (m < M) {
      const int k = src.x_map ? src.x_map[k0 + kk] : k0 + kk;
      const bf16* row = src.x + (size_t)m * src.ld;
      if (src.glu_off > 0) {
        v = silu_mul(ld_cg(row + k), ld_cg(row + src.glu_off + k));
      } else {
        v = ld_cg(row + k);
        if (src.norm_w) v = bf2f(f2bf(v * rs[m] * bf2f(src.norm_w[k])));
      }
    }
    xs[m * kc + kk] = f2bf(v);
  }
  __syncthreads();
  for (int i = warp; i < MB * ng; i += WARPS) {
    const int m = i / ng, g = i - m * ng;
    bf16* xg = xs + m * kc + g * gs;
    if constexpr (MODE == EXACT) {
      float s = 0.f;
      for (int j = lane; j < gs; j += 32) s += bf2f(xg[j]);
      s = warp_sum(s);
      if (lane == 0) xsum[m * gpc + g] = s;
    } else {
      float v[4], s = 0.f, amax = 0.f;  // gs / 32 <= 4 values a lane
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = lane + 32 * t < gs ? bf2f(xg[lane + 32 * t]) : 0.f;
        s += v[t];
        amax = fmaxf(amax, fabsf(v[t]));
      }
      s = warp_sum(s);
      const float sx = fmaxf(warp_max(amax), 1e-20f) * (1.0f / 127.0f);
      const float sx2 = sx * (1.0f / 254.0f);
      __syncwarp();  // every lane has read its bf16 values
      signed char* q8 = reinterpret_cast<signed char*>(xg);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = lane + 32 * t;
        if (e >= gs) break;
        const int q = quant8(v[t], sx);
        q8[a8_pos(e)] = (signed char)q;
        if constexpr (MODE == A8X2)
          q8[gs + a8_pos(e)] =
              (signed char)quant8(__fsub_rn(v[t], __fmul_rn((float)q, sx)), sx2);
      }
      if (lane == 0) {
        xsum[m * gpc + g] = s;
        sxs[m * gpc + g] = sx;
      }
    }
  }
  __syncthreads();
}

// acc[m] += this lane's column n over the staged chunk, this warp's groups.
template <int MB>
__device__ __forceinline__ void gemv_chunk(float (&acc)[MB], const QW& w, int n, int k0,
                                           int klen, int kc, int gs, const bf16* xs,
                                           const float* xsum) {
  const int warp = threadIdx.x >> 5;
  const int ng = klen / gs, gpc = kc / gs;
  for (int g = warp; g < ng; g += WARPS) {
    const int row0 = k0 + g * gs;
    const int32_t* qp = w.qweight + (size_t)(row0 / 8) * w.N + n;
    float accq[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) accq[m] = 0.f;
    for (int w0 = 0; w0 < gs / 8; w0 += WORDS_IN_FLIGHT) {  // gs in {32, 64, 128}
      int32_t wv[WORDS_IN_FLIGHT];
#pragma unroll
      for (int j = 0; j < WORDS_IN_FLIGHT; ++j) wv[j] = __ldg(qp + (size_t)(w0 + j) * w.N);
#pragma unroll
      for (int j = 0; j < WORDS_IN_FLIGHT; ++j) {
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
    const float s = bf2f(w.scales[(size_t)grp * w.N + n]);
    const float z = bf2f(w.zscale[(size_t)grp * w.N + n]);
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[m] += s * accq[m] - z * xsum[m * gpc + g];
  }
}

// The a8 / a8x2 form of gemv_chunk: integer group products of the staged
// int8 rows (stage_chunk) with the nibbles, two __dp4a per word and row.
template <int MB, int MODE>
__device__ __forceinline__ void gemv_chunk_a8(float (&acc)[MB], const QW& w, int n, int k0,
                                              int klen, int kc, int gs, const bf16* xs,
                                              const float* xsum, const float* sxs) {
  const int warp = threadIdx.x >> 5;
  const int ng = klen / gs, gpc = kc / gs;
  const signed char* x8 = reinterpret_cast<const signed char*>(xs);
  for (int g = warp; g < ng; g += WARPS) {
    const int row0 = k0 + g * gs;
    const int32_t* qp = w.qweight + (size_t)(row0 / 8) * w.N + n;
    int d1[MB], d2[MODE == A8X2 ? MB : 1];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      d1[m] = 0;
      if constexpr (MODE == A8X2) d2[m] = 0;
    }
    for (int w0 = 0; w0 < gs / 8; w0 += WORDS_IN_FLIGHT) {
      int32_t wv[WORDS_IN_FLIGHT];
#pragma unroll
      for (int j = 0; j < WORDS_IN_FLIGHT; ++j) wv[j] = __ldg(qp + (size_t)(w0 + j) * w.N);
#pragma unroll
      for (int j = 0; j < WORDS_IN_FLIGHT; ++j) {
        const int even = wv[j] & 0x0F0F0F0F, odd = (wv[j] >> 4) & 0x0F0F0F0F;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const signed char* xg = x8 + 2 * (m * kc + g * gs) + (w0 + j) * 8;
          const int2 a = *reinterpret_cast<const int2*>(xg);
          d1[m] = __dp4a(a.y, odd, __dp4a(a.x, even, d1[m]));
          if constexpr (MODE == A8X2) {
            const int2 r = *reinterpret_cast<const int2*>(xg + gs);
            d2[m] = __dp4a(r.y, odd, __dp4a(r.x, even, d2[m]));
          }
        }
      }
    }
    const int grp = row0 / gs;
    const float s = bf2f(w.scales[(size_t)grp * w.N + n]);
    const float z = bf2f(w.zscale[(size_t)grp * w.N + n]);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float sx = sxs[m * gpc + g];
      float d = (float)d1[m] * sx;
      if constexpr (MODE == A8X2) d += (float)d2[m] * (sx * (1.0f / 254.0f));
      acc[m] += s * d - z * xsum[m * gpc + g];
    }
  }
}

// x [M, K] (formed by src) @ w for the column tiles tile0, tile0 + step, ...;
// epi(m, n, value) receives each finished f32 output (called by warp 0,
// lane = column). Every thread of the block must call this together.
template <int MB, int MODE = EXACT, class Epi>
__device__ void q4_gemv_tiles(const XSrc& src, const QW& w, int M, int K, int gs,
                              int tile0, int step, unsigned char* smem, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = gemv_kc(MB, K, gs);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* xsum = reinterpret_cast<float*>(smem + gemv_xs_bytes(MB, kc));
  float* rs = xsum + MB * (kc / gs);
  float* red = rs + MB;
  float* sxs = red + WARPS * 32;  // a8 modes only
  const int ntiles = (w.N + BN - 1) / BN;
  if (tile0 >= ntiles) return;  // block-uniform
  const bool one_chunk = kc >= K;
  __syncthreads();              // the caller's previous use of smem is over
  if (src.norm_w) norm_scales<MB>(src, M, K, rs);
  if (one_chunk) stage_chunk<MB, MODE>(src, M, 0, K, kc, gs, xs, xsum, rs, sxs);
  for (int tile = tile0; tile < ntiles; tile += step) {
    const int n = tile * BN + lane;
    const bool col_ok = n < w.N;
    float acc[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[m] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kc) {
      const int klen = min(kc, K - k0);
      if (!one_chunk) stage_chunk<MB, MODE>(src, M, k0, klen, kc, gs, xs, xsum, rs, sxs);
      if (col_ok) {
        if constexpr (MODE == EXACT)
          gemv_chunk<MB>(acc, w, n, k0, klen, kc, gs, xs, xsum);
        else
          gemv_chunk_a8<MB, MODE>(acc, w, n, k0, klen, kc, gs, xs, xsum, sxs);
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
        for (int wi = 0; wi < WARPS; ++wi) s += red[wi * 32 + lane];
        epi(m, n, s);
      }
    }
  }
}

}  // namespace q4
