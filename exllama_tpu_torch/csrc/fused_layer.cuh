// Pieces shared by the fused decode kernels K6 (q4_mlp.cu) and K7
// (layer_tail.cu): the grid barrier that stands in for the TPU kernels'
// sequential grid phases, rope on one head, the MLP phases, and the
// cooperative launch. The norm prologue and the silu(gate)*up boundary are
// staging modes of the shared GEMV (q4_gemv.cuh: XSrc.norm_w,
// XSrc.glu_off). Their GEMV phases stream the weights on a cp.async ring,
// stream-K over (256-column tile, 128-k unit) items, at every row count
// (q4_stream.cuh, row tiles of 1, 8, 16, 24 and 32); at one row the next
// phase's first weight slabs are put in flight before each grid barrier.
#pragma once

#include "q4_stream.cuh"

namespace fused {

using q4::QW;
using q4::THREADS;
using q4::XSrc;

// Blocks may be resident at most this many to an SM (more blocks keep more
// loads in flight, but every barrier waits for all of them).
constexpr int MAX_BLOCKS_PER_SM = 4;

// Row tile of a fused kernel's instantiation: 1, 8, 16, 24 or 32 rows.
static inline int fused_mb(int m) { return q4s::row_tile(m); }

// The split partials and the tickets of the GEMV phases (and of K7's key
// splits): part >= 2 * gridDim.x * M * q4s::BN f32; ticket >= ceil(N /
// 128) uint32 zeros for the widest phase and K7's pairs (each phase leaves
// its tickets zero before the next barrier, so phases share them).
struct SplitScratch {
  float* part;
  unsigned int* ticket;
};

// One GEMV phase of the persistent grid: out (q4s::Out: rounded to bf16,
// a residual added where it has one) = x [M, K] (src) @ w.
// prefetched: gemv_prefetch of the same w, K and M went before (and,
// typically, the grid barrier between them; it puts nothing in flight at
// 2..32 rows).
template <int MB, int MODE>
__device__ void gemv_phase(const XSrc& src, const QW& w, int M, int K, int gs,
                           const SplitScratch& sc, unsigned char* smem, const q4s::Out& out,
                           bool prefetched = false) {
  q4s::gemv_stream<MB, MODE>(src, w, M, K, gs, sc.part, sc.ticket, smem, out,
                             MB == 1 && prefetched);
}

// At one row, put the first weight slabs of the next GEMV phase in flight
// before the grid barrier that precedes it (the weights do not depend on
// the phases before); at 2..32 rows this measured 3-6% slower
// (scripts/ring_ablation.py k7_no_prefetch), so nothing.
template <int MB, int MODE>
__device__ __forceinline__ void gemv_prefetch(const QW& w, int M, int K, int gs,
                                              unsigned char* smem) {
  if constexpr (MB == 1) q4s::prefetch<MB, MODE>(w, M, K, gs, smem);
}

// Shared memory of gemv_phase at m rows.
static inline size_t gemv_smem(int mb, int mode, int m) {
  return (size_t)q4s::Geo(mb, mode, m).smem;
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
// into scratch, barrier, out = bf16(h + bf16(silu(gate)*up @ down)). At
// one row the down phase forms silu(gate)*up as it stages each unit of x;
// at 2..32 rows the grid forms it once, in place over gate, between two
// barriers (the same bf16 values; staged by the down phase it measured
// 6-12% slower in K6, PERF.md §6). gateup holds gate in columns [0,
// inter) and up in
// [inter, 2*inter). MODE is the arithmetic of both GEMVs (q4_gemv.cuh).
// prefetched: gemv_prefetch<MB, MODE>(gu, M, hidden, ...) went before.
template <int MB, int MODE>
__device__ void mlp_phases(const bf16* h, const bf16* norm_w, float eps, const QW& gu,
                           const QW& dn, int M, int hidden, int inter, int gs, bf16* gu_scr,
                           bf16* out, const SplitScratch& sc, unsigned int* bar,
                           unsigned int& epoch, unsigned char* smem, bool prefetched) {
  const int ngu = gu.N;
  const XSrc xa{h, hidden, norm_w, eps, nullptr, 0};
  gemv_phase<MB, MODE>(xa, gu, M, hidden, gs, sc, smem, q4s::Out{gu_scr, nullptr, ngu},
                       prefetched);
  gemv_prefetch<MB, MODE>(dn, M, inter, gs, smem);
  grid_sync(bar, epoch);
  int glu_off = inter;  // the down phase stages silu(gate) * up ...
  if constexpr (MB > 1) {
    // ... but at 2..32 rows it is formed once, the same bf16 values
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < M * inter; i += gridDim.x * THREADS) {
      bf16* g = gu_scr + (size_t)(i / inter) * ngu + i % inter;
      *g = f2bf(silu_mul(q4::ld_cg(g), q4::ld_cg(g + inter)));
    }
    grid_sync(bar, epoch);
    glu_off = 0;
  }
  const XSrc xb{gu_scr, ngu, nullptr, 0.f, nullptr, glu_off};
  gemv_phase<MB, MODE>(xb, dn, M, inter, gs, sc, smem, q4s::Out{out, h, hidden}, true);
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

// A barrier counter of the library's own, for the exact mode's parents
// (-DPARENT=1): the `bar` their callers pass is the Hopper kernel's pair of
// zeros, which a parent must not leave counted up (coop_launch clears this
// word before each launch instead).
__device__ unsigned int own_barrier;
static inline unsigned int* own_barrier_word() {
  void* p = nullptr;
  return cudaGetSymbolAddress(&p, own_barrier) == cudaSuccess ? (unsigned int*)p : nullptr;
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
