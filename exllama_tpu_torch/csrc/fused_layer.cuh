// Pieces shared by the fused decode kernels K6 (q4_mlp.cu) and K7
// (layer_tail.cu): the grid barrier that stands in for the TPU kernels'
// sequential grid phases, rope on one head, the MLP phases, and the
// cooperative launch. The norm prologue and the silu(gate)*up boundary are
// staging modes of the shared GEMVs (q4_gemv.cuh: XSrc.norm_w,
// XSrc.glu_off). At one row their GEMV phases stream the weights on a
// cp.async ring, stream-K over (256-column tile, 128-k unit) items
// (q4_stream.cuh); at 2..32 rows they take the tensor-core GEMV
// (q4_gemv_tc.cuh), its (128-column tile, K split) items planned to cover
// the persistent grid (q4tc::plan_splits).
#pragma once

#include "q4_stream.cuh"

namespace fused {

using q4::QW;
using q4::THREADS;
using q4::XSrc;

// Blocks may be resident at most this many to an SM (more blocks keep more
// loads in flight, but every barrier waits for all of them).
constexpr int MAX_BLOCKS_PER_SM = 4;

// Row tile of a fused kernel's instantiation: 1 (the streaming GEMV) or the
// tensor-core GEMV's 16 / 32 padded rows.
static inline int fused_mb(int m) { return m <= 1 ? 1 : m <= 16 ? 16 : 32; }

// The split partials and the tickets of the GEMV phases (and of K7's key
// splits): part >= 2 * gridDim.x * q4s::BN f32 at one row, else
// gridDim.x * MB * q4tc::BN; ticket >= ceil(N / 128)
// uint32 zeros for the widest phase (each phase leaves its tickets zero
// before the next barrier, so phases share them).
struct SplitScratch {
  float* part;
  unsigned int* ticket;
};

// One GEMV phase of the persistent grid: x [M, K] (src) @ w, each finished
// output to epi(m, n, value).
// prefetched: at one row, gemv_prefetch of the same w and K went before
// (and, typically, the grid barrier between them).
template <int MB, int MODE, class Epi>
__device__ void gemv_phase(const XSrc& src, const QW& w, int M, int K, int gs,
                           const SplitScratch& sc, unsigned char* smem, Epi epi,
                           bool prefetched = false) {
  if constexpr (MB == 1)
    q4s::gemv_stream<MODE>(src, w, K, gs, sc.part, sc.ticket, smem, epi, prefetched);
  else
    q4tc::q4_gemv_tc<MB, MODE>(src, w, M, K, gs, blockIdx.x, gridDim.x, 0, sc.part, sc.ticket,
                               smem, epi);
}

// At one row: put the first weight slabs of the next GEMV phase in flight
// before the grid barrier that precedes it (the weights do not depend on
// the phases before); nothing at 2..32 rows.
template <int MB>
__device__ __forceinline__ void gemv_prefetch(const QW& w, int K, int gs, unsigned char* smem) {
  if constexpr (MB == 1) q4s::prefetch(w, K, gs, smem);
}

// Shared memory of gemv_phase.
static inline size_t gemv_smem(int mb, int mode) {
  return mb == 1 ? (size_t)q4s::SMEM : q4tc::smem_bytes(mb, mode);
}

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
// into scratch, barrier, out = bf16(h + bf16(silu(gate)*up @ down)); at
// 2..32 rows silu(gate)*up is formed once between two barriers, at one row
// the down phase forms it as it stages x (a barrier costs more there).
// gateup holds gate in columns [0, inter) and up in [inter, 2*inter). MODE
// is the arithmetic of both GEMVs (q4_gemv.cuh).
// prefetched: gemv_prefetch<MB>(gu, hidden, ...) went before.
template <int MB, int MODE>
__device__ void mlp_phases(const bf16* h, const bf16* norm_w, float eps, const QW& gu,
                           const QW& dn, int M, int hidden, int inter, int gs, bf16* gu_scr,
                           bf16* out, const SplitScratch& sc, unsigned int* bar,
                           unsigned int& epoch, unsigned char* smem, bool prefetched) {
  const int ngu = gu.N;
  const XSrc xa{h, hidden, norm_w, eps, nullptr, 0};
  gemv_phase<MB, MODE>(
      xa, gu, M, hidden, gs, sc, smem,
      [&](int m, int n, float v) { gu_scr[(size_t)m * ngu + n] = f2bf(v); }, prefetched);
  gemv_prefetch<MB>(dn, inter, gs, smem);
  grid_sync(bar, epoch);
  int glu_off = inter;  // the down GEMV stages silu(gate) * up ...
  if constexpr (MB > 1) {
    // ... except at 2..32 rows, where every column tile of the tensor-core
    // GEMV would recompute it for every row: formed once, in place over
    // gate, the same bf16 value the staging forms
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < M * inter; i += gridDim.x * THREADS) {
      bf16* g = gu_scr + (size_t)(i / inter) * ngu + i % inter;
      *g = f2bf(silu_mul(q4::ld_cg(g), q4::ld_cg(g + inter)));
    }
    grid_sync(bar, epoch);
    glu_off = 0;
  }
  const XSrc xb{gu_scr, ngu, nullptr, 0.f, nullptr, glu_off};
  gemv_phase<MB, MODE>(
      xb, dn, M, inter, gs, sc, smem,
      [&](int m, int n, float v) {
        const size_t i = (size_t)m * hidden + n;
        out[i] = f2bf(q4::ld_cg(h + i) + bf2f(f2bf(v)));
      },
      true);
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
