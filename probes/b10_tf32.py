#!/usr/bin/env python3
"""Kernel B10's f32 form against a 3xTF32 form on TF32 wgmma: which is
faster at 21 bits or more a product.

    python3 probes/b10_tf32.py       # one CUDA card, nvcc

B10 with f32 x and f32 weights multiplies three bf16 words of
x * (1 + scale) by three of the weights on bf16 wgmma (six products, the
committed form).  The other way the design allowed: two TF32 words of
each side, hi and lo, and the three products hi hi, hi lo, lo hi on TF32
wgmma (m64n128k8, half bf16's rate), which takes only K-major operands,
so a pass writes the weights' words transposed.  This probe builds that
form from its own source (below, compiled with the shared
``csrc/hopper.cuh``): the same 128 x 128 tiles of the combined
projection (64 columns of up beside their 64 of the gate), two consumer
warpgroups and a TMA loading warp, each k step's products chained from
zero and added with __fadd_rn.  TF32 words take 4 bytes, so a 64-column
k step of both sides is 128 KB and only one would fit: the probe walks k
in steps of 32 (64 KB a stage, three stages).  The statistic is not part
of it: rstd comes from PyTorch, and the time compared is the
projections' and the word passes'.

At Gemma-2 2B's MLP (2304 -> 9216, gelu gate), 4096 and 128 rows, f32:
both forms held to the f64 oracle of the inputs (-log2 of the largest
error over each output's absolute-value scale, at 128 rows: a sum of d
products whose errors average down, so it sets the forms side by side
and is not a product's width), then timed in turns (committed, TF32, TF32,
committed): the committed kernel's launches by torch.profiler, the
probe's by CUDA events (median of 10).  Prints the card's ``nvidia-smi``
line and one JSON line; writes ``chiprun_out/probe_b10_tf32.json``.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
BUILD = os.path.join(ROOT, "build", "probes")
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SHAPES = ((4096, 2304, 9216), (128, 2304, 9216))
EPS = 1e-6

SOURCE = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>
#include "hopper.cuh"

namespace {
using namespace hopper;

constexpr int kBM = 128, kHalf = 64, kKS = 32, kThreads = 384;
constexpr int kWords = 2, kStages = 3, kGroup = 16, kAlign = 1024;
constexpr int kASlab = kBM * 128;     // 128 rows x 32 f32: one word of A
constexpr int kBSlab = kHalf * 128;   // 64 columns x 32 f32: one of w / wg
constexpr int kA = kWords * kASlab;
constexpr int kStage = kA + kWords * 2 * kBSlab;
constexpr int kSmem = kAlign + kStages * kStage + 2 * kStages * 8;
constexpr int kBlockRegs = 128 * (2 * 232 + 40);

// Rounded to TF32 with ties away from zero, the low 13 bits cleared.
__device__ __forceinline__ float rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// hi and lo of x (1 + scale), planes of rows x ld.
__global__ void x_words(const float* x, const float* scale, float* planes,
                        long long rows, int d, long long ld) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= rows * d) return;
  const long long r = i / d;
  const int k = static_cast<int>(i - r * d);
  const float v = __fmul_rn(x[i], __fadd_rn(1.0f, scale[k]));
  const float hi = rna(v);
  planes[r * ld + k] = hi;
  planes[rows * ld + r * ld + k] = rna(__fsub_rn(v, hi));
}

// hi and lo of w (d, dout), transposed: planes of dout x ld.
__global__ void w_words_t(const float* w, float* planes, int d, int dout,
                          long long ld) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < 32; j += 8) {
    const int k = k0 + j, n = n0 + tx;
    tile[j][tx] = k < d && n < dout ? w[static_cast<long long>(k) * dout + n]
                                    : 0.0f;
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int n = n0 + j, k = k0 + tx;
    if (n < dout && k < d) {
      const float v = tile[tx][j];
      const float hi = rna(v);
      planes[static_cast<long long>(n) * ld + k] = hi;
      planes[static_cast<long long>(dout) * ld +
             static_cast<long long>(n) * ld + k] = rna(__fsub_rn(v, hi));
    }
  }
}

#define D64(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define R64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D (+)= A B, m64n128k8 tf32 -> f32, both operands K-major in shared
// memory (TF32 wgmma has no transpose).
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", %64, %65, p, 1, 1;\n}\n"
      : D64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float gelu(float g) {
  const float cube = __fmul_rn(__fmul_rn(g, g), g);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(g, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(__fmul_rn(0.5f, g), __fadd_rn(1.0f, tanhf(inner)));
}

__global__ void __launch_bounds__(kThreads, 1)
    tf32_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tg,
                const float* __restrict__ rstd, float* __restrict__ out,
                int rows, int d, int dout, int row_tiles, int col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int block = blockIdx.x;
  const int per_group = kGroup * col_tiles;
  const int group = block / per_group;
  const int first = group * kGroup;
  const int in_group = min(row_tiles - first, kGroup);
  const int local = block - group * per_group;
  const int row0 = (first + local % in_group) * kBM;
  const int n0 = (local / in_group) * kHalf;
  const int steps = (d + kKS - 1) / kKS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      for (int step = 0; step < steps; ++step) {
        const int s = step % kStages;
        if (step >= kStages) mbar_wait(&empty[s], (step / kStages - 1) & 1);
        unsigned char* dst = smem + s * kStage;
        const int k0 = step * kKS;
        mbar_expect_tx(&full[s], kStage);
        for (int i = 0; i < kWords; ++i)
          tma_load_3d(dst + i * kASlab, &ta, &full[s], k0, row0, i);
        for (int j = 0; j < kWords; ++j) {
          unsigned char* b = dst + kA + 2 * j * kBSlab;
          tma_load_3d(b, &tb, &full[s], k0, n0, j);
          tma_load_3d(b + kBSlab, &tg, &full[s], k0, n0, j);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wgi = warp >> 2;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const uint32_t smem_u = smem_u32(smem);
    for (int step = 0; step < steps; ++step) {
      const int s = step % kStages;
      mbar_wait(&full[s], (step / kStages) & 1);
      const uint32_t stage = smem_u + s * kStage;
      const uint64_t da = desc(stage + wgi * (64 * 128), 16, 1024, 1);
      const uint64_t db = desc(stage + kA, 16, 1024, 1);
      wgmma_fence();
      // (lo, hi), (hi, lo), (hi, hi): the smaller first.
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int i = p == 0 ? 1 : 0, j = p == 1 ? 1 : 0;
#pragma unroll
        for (int kk = 0; kk < kKS / 8; ++kk)
          mma_tf32(part, da + ((i * kASlab + kk * 32) >> 4),
                   db + ((2 * j * kBSlab + kk * 32) >> 4), p + kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    const int g = lane >> 2, t = lane & 3;
    const long long ra = row0 + 64 * wgi + 16 * (warp & 3) + g;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = ra + 8 * half;
        const int col = n0 + 8 * jb + 2 * t;
        if (r >= rows) continue;
        const float rs = rstd[r];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= dout) continue;
          const float u = __fmul_rn(acc[4 * jb + 2 * half + e], rs);
          const float gv = __fmul_rn(acc[4 * (jb + 8) + 2 * half + e], rs);
          out[r * dout + col + e] = __fmul_rn(gelu(gv), u);
        }
      }
  }
}

int encode(CUtensorMap* map, const float* base, long long inner,
           long long outer, long long pitch, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch * 4),
                                 static_cast<cuuint64_t>(outer * pitch * 4)};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}
}  // namespace

extern "C" {
int probe_x_words(const float* x, const float* scale, float* planes,
                  long long rows, int d, long long ld, void* stream) {
  const long long n = rows * d;
  x_words<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
            static_cast<cudaStream_t>(stream)>>>(x, scale, planes, rows, d,
                                                 ld);
  return cudaGetLastError();
}

int probe_w_words(const float* w, float* planes, int d, int dout,
                  long long ld, void* stream) {
  const dim3 grid((dout + 31) / 32, (d + 31) / 32);
  w_words_t<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      w, planes, d, dout, ld);
  return cudaGetLastError();
}

int probe_tf32(const float* xp, const float* wp, const float* wgp,
               const float* rstd, float* out, int rows, int d, int dout,
               long long ldx, long long ldw, void* stream) {
  CUtensorMap ta, tb, tg;
  int e = encode(&ta, xp, d, rows, ldx, kBM);
  if (!e) e = encode(&tb, wp, d, dout, ldw, kHalf);
  if (!e) e = encode(&tg, wgp, d, dout, ldw, kHalf);
  if (e) return e;
  cudaFuncAttributes attr;
  cudaError_t ce = cudaFuncGetAttributes(&attr, tf32_kernel);
  if (ce != cudaSuccess) return ce;
  if (attr.numRegs * kThreads < kBlockRegs) return cudaErrorInvalidConfiguration;
  ce = cudaFuncSetAttribute(tf32_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (ce != cudaSuccess) return ce;
  const int row_tiles = (rows + kBM - 1) / kBM;
  const int col_tiles = (dout + kHalf - 1) / kHalf;
  tf32_kernel<<<row_tiles * col_tiles, kThreads, kSmem,
                static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tg, rstd, out, rows, d, dout, row_tiles, col_tiles);
  return cudaGetLastError();
}
}
"""


def build() -> tuple:
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "b10_tf32.cu")
    lib = os.path.join(BUILD, "libb10_tf32.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", CSRC,
         "-o", lib, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise SystemExit(f"probe: nvcc failed:\n{log}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    dll = ctypes.CDLL(lib)
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.probe_x_words.argtypes = [ptr, ptr, ptr, ll, i, ll, ptr]
    dll.probe_w_words.argtypes = [ptr, ptr, i, i, ll, ptr]
    dll.probe_tf32.argtypes = [ptr] * 5 + [i, i, i, ll, ll, ptr]
    for fn in (dll.probe_x_words, dll.probe_w_words, dll.probe_tf32):
        fn.restype = i
    return dll, {"registers": regs, "spill_bytes": spills}


def median_ms(fn, reps: int = 10, warmup: int = 3) -> float:
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


def device_ms(call, calls: int = 5) -> dict:
    """Device ms of each kernel of B10 a call launches, the mean."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", 0) or 0
        for name in ("row_kernel", "weight_kernel", "nm_kernel"):
            if name in ev.key and total:
                out[name] = out.get(name, 0.0) + total / calls / 1e3
    return out


def oracle_bits(got, x, s, w, wg, mnm) -> float:
    """-log2 of the largest |got - f64 oracle| over each output's
    absolute-value scale (chip_smoke.nm_scale without a bias)."""
    xf = x.double()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)
    xs = xf * (1.0 + s.double())
    up, g = rstd * (xs @ w.double()), rstd * (xs @ wg.double())
    want = mnm.apply_act(g, "gelu") * up
    scale = rstd * (xs.abs() @ w.double().abs()) \
        * (2.2 * rstd * (xs.abs() @ wg.double().abs()) + 0.3)
    return float(-torch.log2(((got.double() - want).abs() / scale).max()))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dll, ptxas = build()
    print(f"  TF32 form ptxas {ptxas}", flush=True)
    mnm = importlib.import_module("repro_torch.kernels.mma_norm_matmul")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []
    for rows, d, dout in SHAPES:
        x = torch.randn(rows, d, device="cuda", generator=gen)
        s = 0.1 * torch.randn(d, device="cuda", generator=gen)
        w, wg = (torch.randn(d, dout, device="cuda", generator=gen)
                 / math.sqrt(d) for _ in range(2))
        rstd = torch.rsqrt((x * x).mean(-1) + EPS).contiguous()
        ld = -(-d // 4) * 4
        xp = torch.zeros(2, rows, ld, device="cuda")
        wp, wgp = (torch.zeros(2, dout, ld, device="cuda") for _ in range(2))
        out = torch.empty(rows, dout, device="cuda")

        def run(rc):
            if rc:
                raise RuntimeError(f"probe launch failed ({rc})")
        prep_x = lambda: run(dll.probe_x_words(  # noqa: E731
            x.data_ptr(), s.data_ptr(), xp.data_ptr(), rows, d, ld, stream))
        prep_w = lambda: (run(dll.probe_w_words(  # noqa: E731
            w.data_ptr(), wp.data_ptr(), d, dout, ld, stream)),
            run(dll.probe_w_words(wg.data_ptr(), wgp.data_ptr(), d, dout, ld,
                                  stream)))
        proj = lambda: run(dll.probe_tf32(  # noqa: E731
            xp.data_ptr(), wp.data_ptr(), wgp.data_ptr(), rstd.data_ptr(),
            out.data_ptr(), rows, d, dout, ld, ld, stream))
        committed = lambda: mnm.norm_matmul_cuda(  # noqa: E731
            x, s, w, w_gate=wg, act="gelu")
        prep_x(), prep_w(), proj()
        torch.cuda.synchronize()
        row = {"shape": [rows, d, dout]}
        if rows <= 128:
            row["tf32_bits"] = oracle_bits(out, x, s, w, wg, mnm)
            row["committed_bits"] = oracle_bits(committed(), x, s, w, wg,
                                                mnm)
        runs = {"committed": [], "tf32": []}
        for name in ("committed", "tf32", "tf32", "committed"):
            if name == "committed":
                runs[name].append(device_ms(committed))
            else:
                runs[name].append({"x_words": median_ms(prep_x),
                                   "w_words": median_ms(prep_w),
                                   "projections": median_ms(proj)})
        for name, parts in runs.items():
            best = {k: min(p[k] for p in parts) for k in parts[0]}
            row[name] = best
            row[f"{name}_total_ms"] = sum(best.values())
        rows_out.append(row)
        print(f"  {rows}x{d}x{dout} f32 gelu: committed "
              f"{row['committed_total_ms']:.4f} ms {row['committed']}; "
              f"TF32 {row['tf32_total_ms']:.4f} ms {row['tf32']}"
              + (f"; bits committed {row['committed_bits']:.2f}, TF32 "
                 f"{row['tf32_bits']:.2f}" if "tf32_bits" in row else ""),
              flush=True)
        del x, w, wg, xp, wp, wgp, out
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    result = {"device": smi, "tf32_ptxas": ptxas, "rows": rows_out}
    with open(os.path.join(ROOT, "chiprun_out", "probe_b10_tf32.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
