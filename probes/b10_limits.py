#!/usr/bin/env python3
"""Where kernel B10's time went before its redesign on wgmma: the row
statistic, the word split of x, or the spills.

    git archive f26bcab src/repro_torch/kernels/csrc/mma_norm_matmul.cu \\
        | tar -x -C build/parent
    python3 probes/b10_limits.py \\
        --source build/parent/src/repro_torch/kernels/csrc/mma_norm_matmul.cu

Takes B10's mma.sync source as it stood before the redesign (the commit
above) and builds four variants of it, one ``nvcc`` each, all started
together:

  as_is          the source unchanged;
  no_stat        the row statistic skipped (no ones-MMAs, rstd = 1);
  words_premade  x's two TF32 words of x * (1 + scale) made once, by a
                 pre-pass (timed apart), and loaded by the kernel in
                 place of x: the split leaves the k loop;
  one_block      ``__launch_bounds__(kThreads, 1)``: no register cap, so
                 no spills, one block an SM.

Times each at Gemma-2 2B's MLP (4096 x 2304 x 9216, gelu gate) with x
and weights in f32 and in bf16, in turns (median of 15 CUDA-event
timings of single calls, two rounds), and prints the registers and
spill bytes ptxas reports for each.  Prints the card's ``nvidia-smi``
line and one JSON line; writes ``chiprun_out/probe_b10_limits.json``.
The variants compute wrong outputs where they skip work; only their
times are read.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "probes")
ROWS, D, DOUT = 4096, 2304, 9216
KINDS = {"f32": (torch.float32, torch.float32),
         "bf16": (torch.bfloat16, torch.bfloat16)}
ACT_GELU = 2

# The pre-pass of words_premade: (hi, lo) TF32 words of x * (1 + scale)
# as f32 pairs, the split the kernel's stash did.
PREPASS = r"""
namespace {
__global__ void words_kernel(const void* x, const float* scale, float* out,
                             long long n, int d, int xdt) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const float v = xdt == kF32 ? load<kF32>(x, i) : load<kBF16>(x, i);
  const float xs = __fmul_rn(v, __fadd_rn(1.0f, scale[i % d]));
  const uint32_t hi = tf32_bits(xs);
  out[2 * i] = __uint_as_float(hi);
  out[2 * i + 1] = __uint_as_float(tf32_bits(__fsub_rn(xs, __uint_as_float(hi))));
}
}  // namespace

extern "C" int probe_words(const void* x, const float* scale, float* out,
                           long long n, int d, int xdt, void* stream) {
  words_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, scale, out, n, d,
                                                      xdt);
  return cudaGetLastError();
}
"""

# (old text, new text) edits of each variant; each old text must occur
# exactly once in the source.
EDITS = {
    "as_is": [],
    "no_stat": [
        ("for (int h = 0; h < 2; ++h) {\n      float tile_a, tile_b;",
         "for (int h = 0; h < 0; ++h) {\n      float tile_a, tile_b;"),
        ("row_s[tid] = rsqrtf(__fadd_rn(ms, eps));",
         "row_s[tid] = 1.0f + 0.0f * ms;"),
    ],
    "words_premade": [
        ("float xv[kALoads], wv[kBLoads], sv;",
         "float xv[kALoads], xl[kALoads], wv[kBLoads], sv;"),
        ("xv[j] = row < rows && kc < d ? load<XDT>(x, row * d + kc) : 0.0f;",
         "{ const bool ok = row < rows && kc < d;\n"
         "        const float* xw = static_cast<const float*>(x) +"
         " 2 * (ok ? row * d + kc : 0);\n"
         "        xv[j] = ok ? __ldg(xw) : 0.0f;\n"
         "        xl[j] = ok ? __ldg(xw + 1) : 0.0f; }"),
        ("      const float xs = __fmul_rn(xv[j], s1);\n"
         "      const uint32_t hi = tf32_bits(xs);\n"
         "      xr[i] = xv[j];\n"
         "      a_hi[i] = hi;\n"
         "      a_lo[i] = tf32_bits(__fsub_rn(xs, __uint_as_float(hi)));",
         "      xr[i] = xv[j];\n"
         "      a_hi[i] = __float_as_uint(xv[j]);\n"
         "      a_lo[i] = __float_as_uint(xl[j]);"),
    ],
    "one_block": [
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
    ],
}


def variant_source(base: str, name: str) -> str:
    src = base
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"probe: the {name} edit does not match the "
                             f"source once: {old[:60]!r}")
        src = src.replace(old, new)
    # The pre-pass goes after the anonymous namespace's helpers, before
    # the extern "C" block.
    marker = 'extern "C" {'
    return src.replace(marker, PREPASS + "\n" + marker, 1)


def build(base: str) -> dict:
    os.makedirs(BUILD, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    running = {}
    for name in EDITS:
        src = os.path.join(BUILD, f"b10_{name}.cu")
        lib = os.path.join(BUILD, f"libb10_{name}.so")
        with open(src, "w") as f:
            f.write(variant_source(base, name))
        running[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o",
             lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, ptxas = {}, {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        ptxas[name] = {"registers": [min(regs), max(regs)],
                       "spill_bytes": sum(spills)}
        dll = ctypes.CDLL(lib)
        ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float)
        dll.b10_norm_matmul.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ll, i,
                                        i, i, i, i, f, ptr]
        dll.b10_norm_matmul.restype = i
        dll.probe_words.argtypes = [ptr, ptr, ptr, ll, i, i, ptr]
        dll.probe_words.restype = i
        libs[name] = dll
    return libs, ptxas


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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", required=True,
                        help="B10's CUDA source before the redesign")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with open(args.source) as f:
        base = f.read()
    libs, ptxas = build(base)
    print(f"  ptxas (registers, spill bytes) {ptxas}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []
    for kind, (xdt, wdt) in KINDS.items():
        x = torch.randn(ROWS, D, device="cuda", generator=gen).to(xdt)
        s = 0.1 * torch.randn(D, device="cuda", generator=gen)
        w, wg = ((torch.randn(D, DOUT, device="cuda", generator=gen)
                  / D ** 0.5).to(wdt) for _ in range(2))
        words = torch.empty(ROWS, D, 2, device="cuda")
        out = torch.empty(ROWS, DOUT, device="cuda", dtype=xdt)
        code = {torch.float32: 0, torch.bfloat16: 1}
        prepass = lambda lib: lib.probe_words(  # noqa: E731
            x.data_ptr(), s.data_ptr(), words.data_ptr(), ROWS * D, D,
            code[xdt], stream)
        prepass(libs["words_premade"])
        calls = {}
        for name, lib in libs.items():
            src = words if name == "words_premade" else x

            def call(lib=lib, src=src):
                rc = lib.b10_norm_matmul(
                    src.data_ptr(), s.data_ptr(), w.data_ptr(),
                    wg.data_ptr(), None, out.data_ptr(), ROWS, D, DOUT,
                    code[xdt], code[wdt], ACT_GELU, 1e-6, stream)
                assert rc == 0, (name, rc)
            calls[name] = call
        runs = {name: [] for name in calls}
        for order in (list(calls), list(reversed(list(calls)))):
            for name in order:
                runs[name].append(median_ms(calls[name]))
        pre = [median_ms(lambda: prepass(libs["words_premade"]))
               for _ in range(2)]
        torch.cuda.synchronize()
        for name, ms in runs.items():
            row = {"kind": kind, "variant": name, "ms": min(ms),
                   "ms_runs": ms}
            if name == "words_premade":
                row["prepass_ms"] = min(pre)
            rows_out.append(row)
            extra = (f" (+ pre-pass {min(pre):.4f} ms)"
                     if name == "words_premade" else "")
            print(f"  B10 {ROWS}x{D}x{DOUT} gelu {kind:4s} {name:13s} "
                  f"{min(ms):.4f} ms {ms}{extra}", flush=True)
        del x, w, wg, words, out
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    result = {"device": smi, "shape": [ROWS, D, DOUT], "act": "gelu",
              "ptxas": ptxas, "rows": rows_out}
    with open(os.path.join(ROOT, "chiprun_out", "probe_b10_limits.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
