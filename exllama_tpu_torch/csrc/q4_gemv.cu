// K1 q4_gemv: 4-bit GPTQ GEMV for decode-sized M (M <= 32).
//
// Two routes by shape, both one K1 launch: one row at groupsize 32 / 64 /
// 128 takes the streaming GEMV q4s::gemv_stream (q4_stream.cuh: the
// weights stream-K over the grid on a cp.async ring, products on tensor
// cores, split tiles added by their last block in the order of k), the
// GEMV phases of the fused kernels K6 and K7 at one row; 2 <= M <= 32, and
// one row at any other groupsize (gs % 32 == 0 dividing K, gs = K
// included), take the tensor-core GEMV q4tc::q4_gemv_tc (q4_gemv_tc.cuh),
// its K split across blocks as the wrapper plans
// (ops/quant.gemv_split_plan).
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
// flop/byte ridge.
//
// Built with -DGEMV_MODE=1 or 2 this file is K9, the W4A8 GEMV (replaces
// quant.py:_q4_gemv_kernel_npair_a8, same launch site): int8 activations
// per (row, group) against the nibbles in integer arithmetic (see
// q4_gemv.cuh). Same operands, same entry point, one library per mode.
#include "q4_stream.cuh"

namespace {

using namespace q4;

// The streaming GEMV's grid: what is resident, at most this many blocks an
// SM (the wrapper's scratch holds two partial slots for each).
constexpr int STREAM_BLOCKS_PER_SM = 4;

// one row: the streaming GEMV, its units shared out among the grid
__global__ void __launch_bounds__(THREADS, 2) q4_gemv_stream_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qweight,
    const bf16* __restrict__ scales, const bf16* __restrict__ zscale,
    const bf16* __restrict__ norm_w, const int32_t* __restrict__ x_map,
    bf16* __restrict__ out, float* part, unsigned int* ticket, int K, int N, int gs,
    float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const XSrc src{x, K, norm_w, eps, x_map, 0};
  const QW w{qweight, scales, zscale, N};
  q4s::gemv_stream<GEMV_MODE>(src, w, K, gs, part, ticket, smem,
                              [&](int, int n, float v) { out[n] = f2bf(v); });
}

cudaError_t launch_stream(const bf16* x, const int32_t* qw, const bf16* s, const bf16* z,
                          const bf16* nw, const int32_t* xmap, bf16* out, float* part,
                          unsigned int* ticket, int K, int N, int gs, float eps,
                          cudaStream_t st) {
  static int blocks = 0;  // resident blocks of the card (once per process)
  if (blocks == 0) {
    cudaError_t e = allow_smem(q4_gemv_stream_kernel, q4s::SMEM);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q4_gemv_stream_kernel,
                                                        THREADS, q4s::SMEM);
    if (e != cudaSuccess) return e;
    blocks = sms * (per_sm < STREAM_BLOCKS_PER_SM ? per_sm : STREAM_BLOCKS_PER_SM);
  }
  const long long units = (long long)q4s::tiles_of(N) * q4s::units_of(K);
  const int grid = units < blocks ? (int)units : blocks;
  if (grid < 1 || part == nullptr || ticket == nullptr) return cudaErrorInvalidValue;
  q4_gemv_stream_kernel<<<grid, THREADS, q4s::SMEM, st>>>(x, qw, s, z, nw, xmap, out, part,
                                                          ticket, K, N, gs, eps);
  return cudaGetLastError();
}

// 2..32 rows (or another groupsize): the tensor-core GEMV, one block per
// (128-column tile, K split)
template <int MP>
__global__ void __launch_bounds__(THREADS, 2) q4_gemv_tc_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qweight,
    const bf16* __restrict__ scales, const bf16* __restrict__ zscale,
    const bf16* __restrict__ norm_w, const int32_t* __restrict__ x_map,
    bf16* __restrict__ out, float* part, unsigned int* ticket, int M, int K, int N, int gs,
    int nsplit, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const XSrc src{x, K, norm_w, eps, x_map, 0};
  const QW w{qweight, scales, zscale, N};
  q4tc::q4_gemv_tc<MP, GEMV_MODE>(
      src, w, M, K, gs, blockIdx.x, gridDim.x, nsplit, part, ticket, smem,
      [&](int m, int n, float v) { out[(size_t)m * N + n] = f2bf(v); });
}

template <int MP>
cudaError_t launch_tc(const bf16* x, const int32_t* qw, const bf16* s, const bf16* z,
                      const bf16* nw, const int32_t* xmap, bf16* out, float* part,
                      unsigned int* ticket, int M, int K, int N, int gs, int nsplit, float eps,
                      cudaStream_t st) {
  const size_t smem = q4tc::smem_bytes(MP, GEMV_MODE);
  static const cudaError_t ok = allow_smem(q4_gemv_tc_kernel<MP>, (int)smem);
  if (ok != cudaSuccess) return ok;
  nsplit = q4tc::plan_splits(nsplit, N, K, gs, 1).n;
  if (nsplit > 1 && (part == nullptr || ticket == nullptr)) return cudaErrorInvalidValue;
  dim3 grid((N + q4tc::BN - 1) / q4tc::BN * nsplit);
  q4_gemv_tc_kernel<MP><<<grid, THREADS, smem, st>>>(x, qw, s, z, nw, xmap, out, part, ticket,
                                                     M, K, N, gs, nsplit, eps);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16; qweight [K/8, N] int32; scales, zscale [K/gs, N] bf16;
// norm_w [K] bf16 or NULL; x_map [K] int32 or NULL; out [M, N] bf16.
// Streaming route (one row, gs 32 / 64 / 128): part >= 2 * 4 * SMs * 256
// f32 and ticket ceil(N/256) uint32 zeros; nsplit is not read.
// Tensor-core route: nsplit splits of K (normalised as q4tc::plan_splits),
// part >= ceil(N/128) * nsplit * MP * 128 f32 (MP = 16 at M <= 16, else 32)
// and ticket ceil(N/128) uint32
// zeros (the last block of each tile resets its own); both may be NULL
// with one split.
extern "C" int q4_gemv_launch(const void* x, const void* qweight, const void* scales,
                              const void* zscale, const void* norm_w, const void* x_map,
                              void* out, void* part, void* ticket, int M, int K, int N, int gs,
                              int nsplit, float eps, void* stream) {
  if (M < 1 || M > 32 || gs < 32 || gs % 32 || K % gs) return cudaErrorInvalidValue;
  auto bx = (const bf16*)x;
  auto qw = (const int32_t*)qweight;
  auto s = (const bf16*)scales;
  auto z = (const bf16*)zscale;
  auto nw = (const bf16*)norm_w;
  auto xm = (const int32_t*)x_map;
  auto o = (bf16*)out;
  auto pt = (float*)part;
  auto tk = (unsigned int*)ticket;
  auto st = (cudaStream_t)stream;
  if (M == 1 && gs <= 128 && (gs & (gs - 1)) == 0)
    return launch_stream(bx, qw, s, z, nw, xm, o, pt, tk, K, N, gs, eps, st);
  if (M <= 16) return launch_tc<16>(bx, qw, s, z, nw, xm, o, pt, tk, M, K, N, gs, nsplit, eps, st);
  return launch_tc<32>(bx, qw, s, z, nw, xm, o, pt, tk, M, K, N, gs, nsplit, eps, st);
}
