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
// separates the phases. Each block takes its share of the items with the
// shared GEMV (fused_layer.cuh: gemv_phase: at one row the streaming GEMV,
// down's first weights put in flight before the barrier; else the
// tensor-core GEMV, its splits filling one wave of the grid); gate|up goes
// to an L2-sized scratch [M, 2*inter] bf16 that the wrapper allocates; at one
// row the down phase applies silu(gate)*up while it stages its activation
// chunks, so the intermediate [M, inter] never exists in memory; at 2..32
// rows, where each of the down GEMV's column tiles would recompute it, the
// grid forms it once over the gate half between two barriers.
//
// Built with -DGEMV_MODE=1 or 2 both GEMVs run the W4A8 arithmetic of K9
// (mlp.py:_q4_mlp_kernel with a8 / a8x2), one library per mode.
#include "fused_layer.cuh"

namespace {

using q4::QW;

struct MlpParams {
  const bf16* h;        // [M, hidden] residual input
  const bf16* norm_w;   // [hidden]
  QW gu;                // hidden -> 2*inter
  QW dn;                // inter -> hidden
  bf16* gu_scr;         // [M, 2*inter]
  fused::SplitScratch sc;  // the tensor-core GEMV's split partials and tickets
  bf16* out;            // [M, hidden]
  unsigned int* bar;    // barrier counter
  int M, hidden, inter, gs;
  float eps;
};

template <int MB>
__global__ void __launch_bounds__(q4::THREADS, 2) q4_mlp_kernel(const MlpParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int epoch = 0;
  fused::mlp_phases<MB, GEMV_MODE>(p.h, p.norm_w, p.eps, p.gu, p.dn, p.M, p.hidden, p.inter,
                                   p.gs, p.gu_scr, p.out, p.sc, p.bar, epoch, smem, false);
}

template <int MB>
cudaError_t launch(const MlpParams& p, cudaStream_t st) {
  const size_t smem = fused::gemv_smem(MB, GEMV_MODE);
  const int grid = fused::coop_grid(q4_mlp_kernel<MB>, smem);
  return fused::coop_launch(q4_mlp_kernel<MB>, grid, p, smem, p.bar, st);
}

}  // namespace

// h [M, hidden] bf16; norm_w [hidden] bf16; gate|up: qweight [hidden/8,
// 2*inter] int32, scales / zscale [hidden/gs, 2*inter] bf16; down: qweight
// [inter/8, hidden], scales / zscale [inter/gs, hidden]; gu_scr [M, 2*inter]
// bf16 scratch; bar one uint32 scratch; part, ticket the split scratch of
// fused::SplitScratch (the grid at most 4 blocks an SM); out [M, hidden]
// bf16.
extern "C" int q4_mlp_launch(const void* h, const void* norm_w, const void* gu_q,
                             const void* gu_s, const void* gu_z, const void* dn_q,
                             const void* dn_s, const void* dn_z, void* gu_scr, void* bar,
                             void* part, void* ticket, void* out, int M, int hidden, int inter,
                             int gs, float eps, void* stream) {
  MlpParams p;
  p.h = (const bf16*)h;
  p.norm_w = (const bf16*)norm_w;
  p.gu = QW{(const int32_t*)gu_q, (const bf16*)gu_s, (const bf16*)gu_z, 2 * inter};
  p.dn = QW{(const int32_t*)dn_q, (const bf16*)dn_s, (const bf16*)dn_z, hidden};
  p.gu_scr = (bf16*)gu_scr;
  p.sc = fused::SplitScratch{(float*)part, (unsigned int*)ticket};
  p.out = (bf16*)out;
  p.bar = (unsigned int*)bar;
  p.M = M;
  p.hidden = hidden;
  p.inter = inter;
  p.gs = gs;
  p.eps = eps;
  auto st = (cudaStream_t)stream;
  if (M < 1 || M > 32 || part == nullptr || ticket == nullptr) return cudaErrorInvalidValue;
  switch (fused::fused_mb(M)) {
    case 1: return launch<1>(p, st);
    case 16: return launch<16>(p, st);
    default: return launch<32>(p, st);
  }
}
