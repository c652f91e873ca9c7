// Pieces shared by the fused decode kernels K6 (q4_mlp.cu) and K7
// (layer_tail.cu): the grid barrier that stands in for the TPU kernels'
// sequential grid phases, rope on one head, the MLP phases, and the
// cooperative launch. The norm prologue and the silu(gate)*up boundary are
// staging modes of the shared GEMV (q4_gemv.cuh: XSrc.norm_w, XSrc.glu_off).
#pragma once

#include "q4_gemv.cuh"

namespace fused {

using q4::QW;
using q4::THREADS;
using q4::XSrc;

// Blocks may be resident at most this many to an SM (more blocks keep more
// loads in flight, but every barrier waits for all of them).
constexpr int MAX_BLOCKS_PER_SM = 4;

// Grid-wide barrier for a cooperative launch (every block co-resident).
// `bar` is a counter zeroed before the launch; barrier number e completes
// when it reaches e * gridDim.x. The fences order each block's global
// writes before its arrival and every later read after the release.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int& epoch) {
  __threadfence();
  __syncthreads();
  epoch += 1;
  if (threadIdx.x == 0) {
    atomicAdd(bar, 1u);
    const unsigned int target = epoch * gridDim.x;
    while (*reinterpret_cast<volatile unsigned int*>(bar) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// Element d of one rope-rotated head (ops/rope.apply_rope_sliced: f32
// x*cos + rotate_half(x)*sin, no fused multiply-add, rounded to bf16).
// `head` points at the head's D bf16 values, written earlier in the launch.
template <int D>
__device__ __forceinline__ float rope_elem(const bf16* head, int d, const float* sin,
                                           const float* cos) {
  const float x = q4::ld_cg(head + d);
  const float rot = d < D / 2 ? -q4::ld_cg(head + d + D / 2) : q4::ld_cg(head + d - D / 2);
  return bf2f(f2bf(__fadd_rn(__fmul_rn(x, cos[d]), __fmul_rn(rot, sin[d]))));
}

// The MLP block of rows h [M, hidden]: gu = bf16(rms_norm(h) @ gateup)
// into scratch, barrier, out = bf16(h + bf16(silu(gate)*up @ down)).
// gateup holds gate in columns [0, inter) and up in [inter, 2*inter). MODE
// is the arithmetic of both GEMVs (q4_gemv.cuh).
template <int MB, int MODE>
__device__ void mlp_phases(const bf16* h, const bf16* norm_w, float eps, const QW& gu,
                           const QW& dn, int M, int hidden, int inter, int gs, bf16* gu_scr,
                           bf16* out, unsigned int* bar, unsigned int& epoch,
                           unsigned char* smem) {
  const int ngu = gu.N;
  const XSrc xa{h, hidden, norm_w, eps, nullptr, 0};
  q4::q4_gemv_tiles<MB, MODE>(xa, gu, M, hidden, gs, blockIdx.x, gridDim.x, smem,
                        [&](int m, int n, float v) { gu_scr[(size_t)m * ngu + n] = f2bf(v); });
  grid_sync(bar, epoch);
  const XSrc xb{gu_scr, ngu, nullptr, 0.f, nullptr, inter};
  q4::q4_gemv_tiles<MB, MODE>(xb, dn, M, inter, gs, blockIdx.x, gridDim.x, smem,
                        [&](int m, int n, float v) {
                          const size_t i = (size_t)m * hidden + n;
                          out[i] = f2bf(q4::ld_cg(h + i) + bf2f(f2bf(v)));
                        });
}

static inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks of a cooperative launch of `kernel` with `smem` bytes: what is
// co-resident, at most MAX_BLOCKS_PER_SM to an SM. 0 if none fits.
template <typename K>
static inline int coop_grid(K kernel, size_t smem) {
  if (allow_smem(kernel, (int)smem) != cudaSuccess) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) !=
      cudaSuccess)
    return 0;
  return (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM) * num_sms();
}

// Zero the barrier counter and launch kernel(params) cooperatively.
template <typename K, typename P>
static inline cudaError_t coop_launch(K kernel, int grid, const P& params, size_t smem,
                                      unsigned int* bar, cudaStream_t st) {
  if (grid <= 0) return cudaErrorCooperativeLaunchTooLarge;
  cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned int), st);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<P*>(&params)};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, smem,
                                  st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace fused
