#!/usr/bin/env python3
"""Where B3's time goes before its redesign: block turnover or the
cross-block atomics.

    python3 probes/b3_turnover.py       # one CUDA card, nvcc

Builds, from the source below, B3 (``split_kernel``) as it stood
before its persistent walk: one 16-byte load a thread, the block's
sum, then one cross-block add per block.  Times it in bf16 at
n = 2^28 normal, half of each tile's rows on the MMAs, in four forms:
block_rows 128 and 512 (a quarter of the blocks), each with the
``atomicAdd`` on one address and with a store into the block's own
slot; and ``torch.sum`` beside them.  Every time is the median of 15
CUDA-event timings of single calls.  Prints the card's ``nvidia-smi``
line and one JSON line; writes ``chiprun_out/probe_b3.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "probes")
N = 1 << 28

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

namespace {
constexpr int kM = 16, kSlab = 256, kPerLane = 8;

__device__ __forceinline__ float collapse(const float (&d)[4]) {
  float v = d[0] + d[2];
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += part[w];
  return s;
}

// B3 bf16 as it stood: one tile a block, the tail masked.
template <bool ATOMIC>
__global__ void __launch_bounds__(1024)
    split_kernel(const uint16_t* x, long long n, int block_rows,
                 int mma_warps, float* out) {
  const int warp = threadIdx.x >> 5;
  const long long i = blockIdx.x * static_cast<long long>(block_rows) * kM +
                      warp * kSlab + (threadIdx.x & 31) * kPerLane;
  uint32_t f[4];
  if (i + kPerLane <= n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + i));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = (i + 2 * j < n) ? x[i + 2 * j] : 0u;
      const uint32_t hi = (i + 2 * j + 1 < n) ? x[i + 2 * j + 1] : 0u;
      f[j] = lo | (hi << 16);
    }
  }
  float v;
  if (warp < mma_warps) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const uint32_t one2 = 0x3f803f80u;
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(f[0]), "r"(f[1]), "r"(f[2]), "r"(f[3]), "r"(one2), "r"(one2));
    v = collapse(d);
  } else {
    float s = 0.0f;
    for (int j = 0; j < 4; ++j)
      s += __uint_as_float(f[j] << 16) + __uint_as_float(f[j] & 0xffff0000u);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    v = s;
  }
  const float s = block_sum(v);
  if (threadIdx.x == 0) {
    if (ATOMIC) atomicAdd(out, s);
    else out[blockIdx.x] = s;
  }
}
}  // namespace

extern "C" int probe_b3(const void* x, long long n, int block_rows,
                        int mma_rows, int atomic, float* out,
                        void* stream) {
  const unsigned grid = static_cast<unsigned>(
      (n + block_rows * kM - 1) / (block_rows * kM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint16_t*>(x);
  if (atomic)
    split_kernel<true><<<grid, 2 * block_rows, 0, s>>>(p, n, block_rows,
                                                       mma_rows / kM, out);
  else
    split_kernel<false><<<grid, 2 * block_rows, 0, s>>>(p, n, block_rows,
                                                        mma_rows / kM, out);
  return cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "probe_b3.cu")
    lib = os.path.join(BUILD, "libprobe_b3.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.probe_b3.argtypes = [ptr, ll, i, i, i, ptr, ptr]
    dll.probe_b3.restype = i
    return dll


def median_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, device="cuda", generator=gen).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    want = float(torch.sum(x, dtype=torch.float64))
    scale = float(torch.sum(x.abs(), dtype=torch.float64))
    rows = []
    for block_rows in (128, 512):
        tiles = -(-N // (block_rows * 16))
        for atomic in (1, 0):
            out = torch.zeros(tiles if not atomic else 1,
                              dtype=torch.float32, device="cuda")

            def call(out=out, block_rows=block_rows, atomic=atomic):
                if atomic:
                    out.zero_()
                rc = lib.probe_b3(x.data_ptr(), N, block_rows,
                                  block_rows // 2, atomic, out.data_ptr(),
                                  stream)
                assert rc == 0, rc

            call()
            got = float(torch.sum(out, dtype=torch.float64))
            assert abs(got - want) <= 2.0 ** -16 * scale, (got, want)
            ms = [median_ms(call), median_ms(call)]
            rows.append({"block_rows": block_rows, "blocks": tiles,
                         "cross_block": "atomicAdd" if atomic else "slot",
                         "ms": min(ms), "ms_runs": ms})
            print(f"  B3 bf16 block_rows {block_rows:3d} ({tiles} blocks), "
                  f"{rows[-1]['cross_block']:9s}: {min(ms):.4f} ms "
                  f"{ms}", flush=True)
    zero = torch.zeros(1, dtype=torch.float32, device="cuda")
    sum_ms = median_ms(lambda: torch.sum(x, dtype=torch.float32))
    zero_ms = median_ms(lambda: zero.zero_())
    bound = N * 2 / 3.35e12 * 1e3
    print(f"  torch.sum {sum_ms:.4f} ms; zeroing the output alone "
          f"{zero_ms:.4f} ms; byte bound {bound:.4f} ms", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    result = {"device": smi, "n": N, "dtype": "bfloat16", "rows": rows,
              "torch_sum_ms": sum_ms, "zero_ms": zero_ms,
              "bound_ms": bound}
    with open(os.path.join(ROOT, "chiprun_out", "probe_b3.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
