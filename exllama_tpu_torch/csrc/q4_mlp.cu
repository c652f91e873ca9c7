// K6 q4_mlp: the whole decode MLP block in one launch, M <= 32 rows:
//   out = h + down( silu(gate(xn)) * up(xn) ),  xn = rms_norm(h) * w.
//
// Replaces the TPU kernel exllama_tpu/ops/mlp.py:_q4_mlp_kernel (launched
// at mlp.py:339). Numerics as mlp.py:132-150 and :219-227: the norm in f32
// rounded to bf16; gate and up rounded to bf16; silu in f32 rounded to bf16,
// times up in bf16; down in f32 rounded to bf16, then added to h in bf16.
//
// Bound on the H100: bytes. At M <= 32 it streams the gate|up and down
// nibbles and their scales once (about 72 MB at Llama-7B, 21.5 us at
// 3.35 TB/s) for 2*M*(hidden*2*inter + inter*hidden) flops, far below the
// flop/byte ridge. Design: on the TPU the grid runs in order, so phase B
// (down) simply follows phase A (gate/up); on Hopper down needs every
// gate/up column, a dependency across blocks. So the launch is cooperative
// (every block co-resident, at most 4 to an SM) and one grid barrier
// separates the phases. Each block takes its share of the (256-column
// tile, 128-k unit) items with the streaming GEMV (fused_layer.cuh:
// gemv_phase, q4_stream.cuh; row tiles of 1, 8, 16, 24 or 32), down's first
// weights put in flight before the barrier; gate|up goes to an L2-sized
// scratch [M, 2*inter] bf16 that the wrapper allocates; at one row the
// down phase applies silu(gate)*up while it stages each unit of its
// activation, at 2..32 rows the grid forms it once over the gate half
// between two barriers (fused_layer.cuh: mlp_phases).
//
// Built with -DGEMV_MODE=1 or 2 both GEMVs run the W4A8 arithmetic of K9
// (mlp.py:_q4_mlp_kernel with a8 / a8x2), one library per mode.
//
// In the exact mode (-DGEMV_MODE=0) the kernel is the Hopper design of
// fused_wg.cuh: one persistent block an SM, the two GEMV phases on K1's
// wgmma mainloop, down's weights streamed by TMA while gate|up runs and
// while the consumers wait at the one grid barrier, silu(gate) * up formed
// as the down phase stages each slab (no pass of its own, no second
// barrier), the norm's row rounded to bf16 before the products. The
// streaming-GEMV kernel above stays reachable in the exact mode only through
// q4_mlp_stream_launch, built with -DPARENT=1 into a library of its own
// (q4_mlp_stream), whose launches q4_mlp_stream_launches counts; the a8 /
// a8x2 libraries keep it as their kernel.
#include "fused_layer.cuh"

#ifndef PARENT
#define PARENT 0    // 1: the exact mode's parent alone (q4_mlp_stream_launch)
#endif
#define HOPPER_KERNEL (GEMV_MODE == 0 && !PARENT)
#if HOPPER_KERNEL
#include "fused_wg.cuh"
#else
#include <atomic>
#endif

namespace {

using q4::QW;

struct MlpParams {
  const bf16* h;        // [M, hidden] residual input
  const bf16* norm_w;   // [hidden]
  QW gu;                // hidden -> 2*inter
  QW dn;                // inter -> hidden
  bf16* gu_scr;         // [M, 2*inter]
  fused::SplitScratch sc;  // the GEMV phases' split partials and tickets
  bf16* out;            // [M, hidden]
  unsigned int* bar;    // barrier counter
  int M, hidden, inter, gs;
  float eps;
};

#if !HOPPER_KERNEL
template <int MB>
__global__ void __launch_bounds__(q4::THREADS, q4s::min_blocks(MB))
    q4_mlp_kernel(const MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int epoch = 0;
  fused::mlp_phases<MB, GEMV_MODE>(p.h, p.norm_w, p.eps, p.gu, p.dn, p.M, p.hidden, p.inter,
                                   p.gs, p.gu_scr, p.out, p.sc, p.bar, epoch, smem, false);
}

template <int MB>
cudaError_t launch(const MlpParams& p, cudaStream_t st) {
  const size_t smem = fused::gemv_smem(MB, GEMV_MODE, p.M);
  const int grid = fused::coop_grid(q4_mlp_kernel<MB>, smem);
  return fused::coop_launch(q4_mlp_kernel<MB>, grid, p, smem, p.bar, st);
}
#endif

#if PARENT
std::atomic<int> stream_launches{0};  // q4_mlp_stream_launch's
#endif

int mlp_entry(const void* h, const void* norm_w, const void* gu_q, const void* gu_s,
              const void* gu_z, const void* dn_q, const void* dn_s, const void* dn_z,
              void* gu_scr, void* bar, void* part, void* ticket, void* out, int M, int hidden,
              int inter, int gs, float eps, void* stream) {
  auto st = (cudaStream_t)stream;
  if (M < 1 || M > 32 || part == nullptr || ticket == nullptr) return cudaErrorInvalidValue;
#if HOPPER_KERNEL
  // gate|up = bf16(rms_norm(h) * w) @ Wgu; out = h + bf16(silu(gate) * up @ Wdn)
  const int grid = fwg::num_sms(), bm = fwg::row_tile(M);
  fwg::Plan pl{};
  fwg::Maps maps;
  int nmaps = 0;
  pl.M = M, pl.gs = gs, pl.eps = eps, pl.bar = (unsigned int*)bar;
  pl.part = (float*)part, pl.ticket = (unsigned int*)ticket;
  pl.attn_at = -1;
  cudaError_t e = fwg::add_phase(
      maps, nmaps, pl, {gu_q, gu_s, gu_z, hidden, 2 * inter, h, hidden, 0, norm_w, gu_scr, nullptr,
                        2 * inter},
      bm, 0, grid);
  if (e == cudaSuccess)
    e = fwg::add_phase(maps, nmaps, pl,
                       {dn_q, dn_s, dn_z, inter, hidden, gu_scr, 2 * inter, inter, nullptr, out, h,
                        hidden},
                       bm, 1, grid);
  if (e != cudaSuccess) return e;
  return fwg::launch_by<fwg::NoAttn>(bm, gs % fwg::BK != 0, maps, pl, fwg::NoAttn::Params{}, grid,
                                     st);
#else
  MlpParams p;
  p.h = (const bf16*)h;
  p.norm_w = (const bf16*)norm_w;
  p.gu = QW{(const int32_t*)gu_q, (const scale_t*)gu_s, (const scale_t*)gu_z, 2 * inter};
  p.dn = QW{(const int32_t*)dn_q, (const scale_t*)dn_s, (const scale_t*)dn_z, hidden};
  p.gu_scr = (bf16*)gu_scr;
  p.sc = fused::SplitScratch{(float*)part, (unsigned int*)ticket};
  p.out = (bf16*)out;
  p.bar = PARENT ? fused::own_barrier_word() : (unsigned int*)bar;
  if (p.bar == nullptr) return cudaErrorInvalidValue;
  p.M = M;
  p.hidden = hidden;
  p.inter = inter;
  p.gs = gs;
  p.eps = eps;
  switch (fused::fused_mb(M)) {
    case 1: return launch<1>(p, st);
    case 8: return launch<8>(p, st);
    case 16: return launch<16>(p, st);
    case 24: return launch<24>(p, st);
    default: return launch<32>(p, st);
  }
#endif
}

}  // namespace

// h [M, hidden] bf16; norm_w [hidden] bf16; gate|up: qweight [hidden/8,
// 2*inter] int32, scales / zscale [hidden/gs, 2*inter] scale_t; down: qweight
// [inter/8, hidden], scales / zscale [inter/gs, hidden]; gu_scr [M, 2*inter]
// bf16 scratch; bar one uint32 scratch; part, ticket the split scratch of
// fused::SplitScratch (the grid at most 4 blocks an SM); out [M, hidden]
// bf16.
#if PARENT
// The parent of the exact mode (chip_smoke.py's yardstick only): the
// streaming GEMV phases on up to four blocks an SM, with q4_mlp_launch's
// operands and scratch (fused::SplitScratch); `bar` is not used (the
// library's own counter, fused::own_barrier, stands in for it).
extern "C" int q4_mlp_stream_launch(const void* h, const void* norm_w, const void* gu_q,
                                    const void* gu_s, const void* gu_z, const void* dn_q,
                                    const void* dn_s, const void* dn_z, void* gu_scr, void* bar,
                                    void* part, void* ticket, void* out, int M, int hidden,
                                    int inter, int gs, float eps, void* stream) {
  const int e = mlp_entry(h, norm_w, gu_q, gu_s, gu_z, dn_q, dn_s, dn_z, gu_scr, bar, part,
                          ticket, out, M, hidden, inter, gs, eps, stream);
  if (e == 0) ++stream_launches;
  return e;
}

extern "C" int q4_mlp_stream_launches() { return stream_launches.load(); }
#else
// Exact mode: part holds [grid][2][BM * 256] f32 (grid = the SM count, BM
// the row tile 8 / 16 / 32), ticket one zero a 256-column tile of gate|up;
// bar two uint32 zeros that the launch leaves zero (not cleared here).
extern "C" int q4_mlp_launch(const void* h, const void* norm_w, const void* gu_q,
                             const void* gu_s, const void* gu_z, const void* dn_q,
                             const void* dn_s, const void* dn_z, void* gu_scr, void* bar,
                             void* part, void* ticket, void* out, int M, int hidden, int inter,
                             int gs, float eps, void* stream) {
  return mlp_entry(h, norm_w, gu_q, gu_s, gu_z, dn_q, dn_s, dn_z, gu_scr, bar, part, ticket, out,
                   M, hidden, inter, gs, eps, stream);
}
#endif
