#!/usr/bin/env python3
"""How fast one producer thread an SM streams a 4-bit weight's packed words
by TMA on one CUDA card, by box shape: the question under the Hopper K1 / K6
/ K7 GEMV phases (csrc/q4_gemv_wg.cuh, fused_wg.cuh), which stream [8, 256]
int32 boxes (8 rows of 1 KB) and two 512-byte scale rows a slab.

    python3 scripts/tma_probe.py

Builds a small kernel (git-ignored exllama_tpu_torch/_build/tma_probe/) in
which, on one block an SM, thread 0 streams the slabs of a stream-K range
of (256-column tile, slab) units of Llama-7B's gate|up words [512, 22016]
int32 (45 MB) into a ring, and one consumer thread waits for each slab and
releases it; and times it (L2 flushed before each run, medians of fenced
runs) for slabs of 8, 16 and 32 rows, as one box of 256 columns or as 4 /
8 boxes of 64 / 32 columns, with and without the two scale-row loads a
slab, on rings of 60, 120, 180 and 220 KB, with one producer thread or
two (``dual``: a thread of another warp issues every other slab; names:
probe|dual_rows_boxes_scales_KB). Prints one JSON line a shape with the card's name
and power limit: ms and TB/s of the words' bytes.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from exllama_tpu_torch import kernels  # noqa: E402

SRC = r'''
#include "hopper.cuh"
#include "tma_map.cuh"
using namespace hop;

constexpr int BN = 256;

template <int ROWS, int NBOX, bool SCALES, int RING>
__global__ void __launch_bounds__(128, 1) probe(const __grid_constant__ CUtensorMap wmap,
                                               const __grid_constant__ CUtensorMap smap,
                                               int tiles, int ktiles, int* sink) {
  constexpr int W_BYTES = ROWS * BN * 4, S_BYTES = SCALES ? 2 * BN * 2 : 0;
  constexpr int STAGE = W_BYTES + S_BYTES;
  constexpr int STAGES = RING / STAGE > 32 ? 32 : RING / STAGE;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1), mbar_init(empty + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // dual (ktiles < 0): threads 0 and 64 each issue every other slab
  const bool dual = ktiles < 0;
  Walk w(tiles, dual ? -ktiles : ktiles, gridDim.x, true);
  int tile, kb, ke, seq = 0;
  if (threadIdx.x == 0 || (dual && threadIdx.x == 64)) {
    const int mine = threadIdx.x == 0 ? 0 : 1;
    while (w.next(tile, kb, ke))
      for (int kt = kb; kt < ke; ++kt, ++seq) {
        if (dual && (seq & 1) != mine) continue;
        const int st = seq % STAGES;
        mbar_wait(empty + st, ((seq / STAGES) & 1) ^ 1);
        unsigned char* dst = smem + st * STAGE;
        mbar_arrive_tx(full + st, STAGE);
#pragma unroll
        for (int b = 0; b < NBOX; ++b)
          tma_2d(dst + b * (W_BYTES / NBOX), &wmap, tile * BN + b * (BN / NBOX), kt * ROWS, full + st);
        if (SCALES) {
          tma_2d(dst + W_BYTES, &smap, tile * BN, kt, full + st);
          tma_2d(dst + W_BYTES + BN * 2, &smap, tile * BN, kt + 1, full + st);
        }
      }
  } else if (threadIdx.x == 32) {
    int acc = 0;
    while (w.next(tile, kb, ke))
      for (int kt = kb; kt < ke; ++kt, ++seq) {
        const int st = seq % STAGES;
        mbar_wait(full + st, (seq / STAGES) & 1);
        acc += smem[st * STAGE + (kt & 63)];
        mbar_arrive(empty + st);
      }
    if (acc == 12345) *sink = acc;
  }
}

template <int ROWS, int NBOX, bool SCALES, int RING>
int run(const void* w, const void* s, int K8, int N, int sms, int* sink, void* stream,
        bool dual) {
  constexpr int W_BYTES = ROWS * BN * 4, S_BYTES = SCALES ? 2 * BN * 2 : 0;
  constexpr int STAGE = W_BYTES + S_BYTES;
  constexpr int STAGES = RING / STAGE > 32 ? 32 : RING / STAGE;
  const int smem = STAGES * STAGE + 2 * STAGES * 8;
  static const cudaError_t ok = cudaFuncSetAttribute(
      probe<ROWS, NBOX, SCALES, RING>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ok != cudaSuccess) return ok;
  CUtensorMap wm, sm;
  cudaError_t e = tensor_map(&wm, {w, (uint64_t)N, (uint64_t)K8, (uint32_t)(BN / NBOX),
                                   (uint32_t)ROWS, CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                                   CU_TENSOR_MAP_SWIZZLE_NONE});
  if (e == cudaSuccess)
    e = tensor_map(&sm, {s, (uint64_t)N, (uint64_t)(K8 / ROWS + 1), (uint32_t)BN, 1u,
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, CU_TENSOR_MAP_SWIZZLE_NONE});
  if (e != cudaSuccess) return e;
  const int tiles = N / BN, ktiles = K8 / ROWS;
  probe<ROWS, NBOX, SCALES, RING><<<sms, 128, smem, (cudaStream_t)stream>>>(
      wm, sm, tiles, dual ? -ktiles : ktiles, sink);
  return cudaGetLastError();
}

#define ENTRY(R, B, S, KB) \
  extern "C" int probe_##R##_##B##_##S##_##KB(const void* w, const void* s, int K8, int N,   \
                                            int sms, void* sink, void* st) {              \
    return run<R, B, S, KB * 1024>(w, s, K8, N, sms, (int*)sink, st, false);               \
  }                                                                                        \
  extern "C" int dual_##R##_##B##_##S##_##KB(const void* w, const void* s, int K8, int N,    \
                                           int sms, void* sink, void* st) {               \
    return run<R, B, S, KB * 1024>(w, s, K8, N, sms, (int*)sink, st, true);                \
  }
ENTRY(8, 1, 1, 120) ENTRY(8, 1, 0, 120) ENTRY(8, 4, 1, 120) ENTRY(16, 1, 1, 120)
ENTRY(32, 8, 0, 120) ENTRY(8, 1, 1, 60) ENTRY(8, 1, 1, 180) ENTRY(8, 1, 1, 220)
ENTRY(16, 1, 1, 220) ENTRY(32, 8, 0, 220)
'''
SHAPES = ("probe_8_1_1_120", "dual_8_1_1_120", "probe_8_1_1_220", "dual_8_1_1_220",
          "probe_32_8_0_220", "dual_32_8_0_220")


def main() -> int:
    if not torch.cuda.is_available():
        print("tma_probe: no CUDA device", file=sys.stderr)
        return 1
    out = kernels.BUILD_DIR / "tma_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SRC)
    lib = out / "probe.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o",
                    str(lib), str(out / "probe.cu")], check=True,
                   stdout=subprocess.DEVNULL)
    so = ctypes.CDLL(str(lib))
    dev = torch.device("cuda", 0)
    k8, n = 512, 22016
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, (k8, n), dtype=torch.int64,
                      device=dev).to(torch.int32)
    s = torch.randn((k8 + 1, n), device=dev).bfloat16()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for shape in SHAPES:
        fn = getattr(so, shape)
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        st = torch.cuda.current_stream().cuda_stream
        call = lambda: fn(w.data_ptr(), s.data_ptr(), k8, n, sms, sink.data_ptr(), st)  # noqa: E731
        times = []
        for i in range(12):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            rc = call()
            b.record()
            b.synchronize()
            if rc:
                raise SystemExit(f"{shape}: launch error {rc}")
            if i >= 2:
                times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        print(json.dumps({"shape": shape, "card": card, "ms": ms,
                          "TB/s": w.numel() * 4 / ms / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
