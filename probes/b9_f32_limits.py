#!/usr/bin/env python3
"""Where kernel B9's f32 prefill time goes: the mma.sync form as it stood
before the f32 prefill form, that form without its per-fragment split of
q, and the f32 prefill form's pieces.

    python3 probes/b9_f32_limits.py       # one CUDA card, nvcc

Builds three variants of ``csrc/mma_attention.cu`` (with the shared
``csrc/hopper.cuh``), one ``nvcc`` each, all started together:

  mma_sync     the f32 prefill form switched off in the chooser, so f32
               prefill runs on ``attn_kernel``, the mma.sync form, whose
               code is the one f32 prefill ran before the f32 form;
  no_qsplit    the same, with q's fragments taken as one TF32 word (hi =
               the f32 bits, lo = 0) instead of split into two at every
               fragment load: the same MMAs without the split;
  s_only       the f32 prefill form with the softmax, the row sums and p
               x v cut: its word pass, then per key block the K steps'
               chains of q.k products alone (no V is loaded);
  clocks       the f32 prefill form with clock() ticks around each part
               of a key block in its consumer warpgroup, summed over its
               threads and blocks (PHASES): where a key block's time goes.

At Gemma-2 2B's attention layer in f32 (8 heads over 4 KV heads, head dim
256, softcap 50): the global layer at 4096 tokens (causal) and the local
one at 8192 (causal, window 4096), random operands from a seed.  Each
variant and the committed f32 form (``attention_cuda``) are timed in
turns (median of 5 CUDA-event timings of single calls, two rounds); the
committed form's two launches (the word pass, the attention kernel) also
by ``torch.profiler``'s device time.  Prints the registers and spill
bytes ptxas reports for each build, the card's ``nvidia-smi`` line and
one JSON line; writes ``chiprun_out/probe_b9_f32_limits.json``.
``no_qsplit`` and ``s_only`` compute wrong outputs where they skip work;
only their times are read; the ticks of ``clocks`` cost some time
themselves, so only its shares are read.
"""

from __future__ import annotations

import ctypes
import importlib
import json
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
SEED = 0
# (label, tokens, window): Gemma-2 2B's global and local layers.
SHAPES = (("prefill global", 4096, None), ("prefill local", 8192, 4096))
KV, G, HD, CAP = 4, 2, 256, 50.0

# (old text, new text) edits of each variant; each old text must occur
# exactly once in the source.
_OFF = ("  return q_dtype == kF32 && kv_dtype == kF32 && rows > 16 &&",
        "  return false && q_dtype == kF32 && kv_dtype == kF32 && "
        "rows > 16 &&")
_QSPLIT = [(f"{' ' * 12}words<QF32>(lds<QF32>(q_s, {a}), ah[{i}], al[{i}]);",
            f"{' ' * 12}words<false>(lds<QF32>(q_s, {a}), ah[{i}], al[{i}]);")
           for i, a in enumerate(("qa", "qa + 8 * qs", "qa + 4",
                                  "qa + 8 * qs + 4"))]
# The clocks variant's phases of a key block, in the consumer warpgroup.
PHASES = ("wait for K", "S: q.k chains", "S: step adds and release",
          "softmax and p's words", "wait for V", "p x v chains and row sums",
          "acc corr + partial", "Kahan and loop")
_TICKS = [
    ("namespace wf {\n\nusing namespace hopper;\n",
     "namespace wf {\n\nusing namespace hopper;\n"
     "__device__ unsigned long long b9_clocks[8];\n"
     "#define B9_TICK(i) { c_now = clock(); clk[i] += c_now - c_at; "
     "c_at = c_now; }\n"),
    ("  mbar_wait(qfull, 0);\n\n  int n = 0;\n",
     "  mbar_wait(qfull, 0);\n\n  unsigned clk[8] = {0, 0, 0, 0, 0, 0, 0, 0};"
     "\n  unsigned c_at = clock(), c_now;\n  int n = 0;\n"),
    ("      const int st = n % nst;\n      mbar_wait(&full[st], (n / nst) & 1);"
     "\n      // Each MMA's descriptors",
     "      const int st = n % nst;\n      B9_TICK(7)\n"
     "      mbar_wait(&full[st], (n / nst) & 1);\n      B9_TICK(0)\n"
     "      // Each MMA's descriptors"),
    ("      fence_regs(part);\n      release(st);\n      if (sl == 0) {",
     "      fence_regs(part);\n      B9_TICK(1)\n      release(st);\n"
     "      if (sl == 0) {"),
    ("    const bool inner = t_all && j0 >= t_maxlo && j0 + kBK <= t_minhi;",
     "    B9_TICK(2)\n"
     "    const bool inner = t_all && j0 >= t_maxlo && j0 + kBK <= t_minhi;"),
    ('    asm volatile("bar.sync 1, %0;\\n" ::"n"(32 * kConsumerWarps) : '
     '"memory");\n',
     '    asm volatile("bar.sync 1, %0;\\n" ::"n"(32 * kConsumerWarps) : '
     '"memory");\n    B9_TICK(3)\n'),
    ("      const int st = n % nst;\n      mbar_wait(&full[st], (n / nst) & 1);"
     "\n      const uint64_t dv",
     "      const int st = n % nst;\n      B9_TICK(7)\n"
     "      mbar_wait(&full[st], (n / nst) & 1);\n      B9_TICK(4)\n"
     "      const uint64_t dv"),
    ("      fence_regs(dl);\n      release(st);\n",
     "      fence_regs(dl);\n      B9_TICK(5)\n      release(st);\n"),
    ("            part[i]);\n    }\n    const bool touch_a",
     "            part[i]);\n      B9_TICK(6)\n    }\n    const bool touch_a"),
    ("  // o = acc / (l - c) where l - c > 0, else 0, in f32.\n",
     "  B9_TICK(7)\n  for (int i = 0; i < 8; ++i)\n"
     "    atomicAdd(&b9_clocks[i], static_cast<unsigned long long>(clk[i]));\n"
     "  // o = acc / (l - c) where l - c > 0, else 0, in f32.\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint b9_probe_clocks(unsigned long long* host, '
     'int reset) {\n  if (reset) {\n    const unsigned long long zero[8] = {};'
     '\n    return cudaMemcpyToSymbol(wf::b9_clocks, zero, sizeof(zero));\n  }'
     '\n  return cudaMemcpyFromSymbol(host, wf::b9_clocks, '
     '8 * sizeof(unsigned long long));\n}\n'),
]
EDITS = {
    "mma_sync": [_OFF],
    "no_qsplit": [_OFF] + _QSPLIT,
    "s_only": [
        ("        for (int item = 0; item < nslab + kChunks; ++item, ++n) {",
         "        for (int item = 0; item < nslab; ++item, ++n) {"),
        ("    const bool inner = t_all && j0 >= t_maxlo && j0 + kBK <= t_minhi;",
         "    if (true) {\n"
         "      acc[0] = __fadd_rn(acc[0], __fadd_rn(s[0], s[31]));\n"
         "      continue;\n"
         "    }\n"
         "    const bool inner = t_all && j0 >= t_maxlo && j0 + kBK <= t_minhi;"),
    ],
    "clocks": _TICKS,
}


def variant_source(base: str, name: str) -> str:
    src = base
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"probe: the {name} edit does not match the "
                             f"source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def start_builds(names=tuple(EDITS)) -> dict:
    """Write each variant's source and start its nvcc; returns {name:
    (library, process)}."""
    os.makedirs(BUILD, exist_ok=True)
    base = open(os.path.join(CSRC, "mma_attention.cu")).read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    running = {}
    for name in names:
        src = os.path.join(BUILD, f"b9_{name}.cu")
        lib = os.path.join(BUILD, f"libb9_{name}.so")
        with open(src, "w") as f:
            f.write(variant_source(base, name))
        running[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I",
             CSRC, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return running


def finish_builds(running: dict) -> tuple:
    """Wait for the builds; returns ({name: library}, {name: ptxas
    registers and spill bytes of the attention kernels})."""
    libs, ptxas = {}, {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n"
                             f"{log[-4000:]}")
        kern = "attn_kernelILb1ELb1E" if name in ("mma_sync", "no_qsplit") \
            else "attn_f32_kernel"
        regs, spills, cur = [], [], None
        for line in log.splitlines():
            got = re.search(r"Compiling entry function '([^']+)'", line)
            if got:
                cur = got.group(1)
                continue
            if cur and kern in cur:
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill stores", line)]
                regs += [int(x) for x in re.findall(r"Used (\d+) registers",
                                                    line)]
        ptxas[name] = {"kernel": kern, "registers": [min(regs), max(regs)],
                       "spill_bytes": sum(spills)}
        dll = ctypes.CDLL(lib)
        ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float)
        dll.b9_attention.argtypes = [ptr] * 7 + [i] * 11 + [ll, f, i, f, ptr]
        dll.b9_attention.restype = i
        if name == "clocks":
            dll.b9_probe_clocks.argtypes = [ptr, i]
            dll.b9_probe_clocks.restype = i
        libs[name] = dll
    return libs, ptxas


def variant_call(dll, qg, k, v, kw):
    """A call of a variant's b9_attention on f32 operands (kw: qpos (B,
    Sq) and kv_len (B,) or None as int32 on the card, causal, window,
    scale, cap): f32 output, the f32 form's word scratch (unused by the
    mma.sync variants)."""
    B, Sq, KV_, G_, hd = qg.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    out = torch.empty(B, Sq, KV_, G_, hd_v, device="cuda")
    words = torch.empty(3 * B * KV_ * (Sq * G_ * hd + Sk * (hd + hd_v)),
                        dtype=torch.bfloat16, device="cuda")
    window, cap, kv_len = kw["window"], kw["cap"], kw["kv_len"]
    args = (qg.data_ptr(), k.data_ptr(), v.data_ptr(), kw["qpos"].data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            words.data_ptr(), B, Sq, Sk, KV_, G_, hd, hd_v, 0, 0,
            int(kw["causal"]), 0 if window is None else 1,
            0 if window is None else int(window), float(kw["scale"]),
            0 if cap is None else 1, 0.0 if cap is None else float(cap),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = dll.b9_attention(*args)
        if rc:
            raise RuntimeError(f"probe: b9_attention returned {rc}")
        return out
    return call


def median_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def device_ms(call, calls: int = 3) -> dict:
    """ms of device time a call's launches take, by kernel (the word pass,
    the attention kernel), the mean over ``calls`` calls under
    torch.profiler."""
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
        for key in ("words_kernel", "attn_f32_kernel"):
            if key in ev.key:
                out[key] = out.get(key, 0.0) + (
                    getattr(ev, "device_time_total", 0) or 0) / calls / 1e3
    return out


def clock_shares(dll, call) -> dict:
    """The clocks variant's share of its consumer clocks by phase, over one
    call (its ticks summed over every consumer thread and block)."""
    torch.cuda.synchronize()
    if dll.b9_probe_clocks(None, 1):
        raise RuntimeError("probe: resetting the clocks failed")
    call()
    torch.cuda.synchronize()
    got = (ctypes.c_ulonglong * 8)()
    if dll.b9_probe_clocks(got, 0):
        raise RuntimeError("probe: reading the clocks failed")
    total = sum(got) or 1
    return {name: got[i] / total for i, name in enumerate(PHASES)}


def operands(tokens: int, window, gen) -> tuple:
    qg = torch.randn(1, tokens, KV, G, HD, device="cuda", generator=gen)
    k = torch.randn(1, tokens, KV, HD, device="cuda", generator=gen)
    v = torch.randn(1, tokens, KV, HD, device="cuda", generator=gen)
    qpos = torch.arange(tokens, device="cuda",
                        dtype=torch.int32)[None].contiguous()
    return qg, k, v, dict(qpos=qpos, causal=True, window=window,
                          kv_len=None, scale=HD ** -0.5, cap=CAP)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    running = start_builds()
    ma = importlib.import_module("repro_torch.kernels.mma_attention")
    ma._lib()                   # the committed library, built meanwhile
    libs, ptxas = finish_builds(running)
    print(f"ptxas (registers, spill bytes): {ptxas}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, tokens, window in SHAPES:
        qg, k, v, kw = operands(tokens, window, gen)
        calls = {name: variant_call(dll, qg, k, v, kw)
                 for name, dll in libs.items()}
        calls["f32_form"] = lambda: ma.attention_cuda(qg, k, v, **kw)
        calls["f32_form_nocap"] = lambda: ma.attention_cuda(
            qg, k, v, **dict(kw, cap=None))
        want = calls["f32_form"]()
        got = calls["mma_sync"]()
        scale = float(want.abs().max())
        diff = float((got - want).abs().max())
        times = {name: [] for name in calls}
        order = list(calls)
        for rnd in range(2):
            for name in (order if rnd == 0 else order[::-1]):
                times[name].append(median_ms(calls[name]))
        dev = device_ms(calls["f32_form"])
        shares = clock_shares(libs["clocks"], calls["clocks"])
        row = {"problem": label, "tokens": tokens, "window": window,
               "ms": {n: min(t) for n, t in times.items()},
               "ms_rounds": times, "f32_form_device_ms": dev,
               "clock_shares": shares,
               "mma_sync_vs_f32_form_max_abs_diff": diff,
               "output_scale": scale}
        rows.append(row)
        print(f"{label}: " + ", ".join(f"{n} {min(t):.4f}" for n, t in
                                       times.items())
              + f" ms; f32 form device ms by launch {dev}; clock shares "
              f"{ {k: round(v, 4) for k, v in shares.items()} }; |mma_sync - "
              f"f32 form| {diff:.3g} of a max |o| {scale:.3g}", flush=True)
        del qg, k, v, want, got
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ptxas": ptxas, "rows": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_b9_f32_limits.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
