#!/usr/bin/env python3
"""Where kernel B9's f32 prefill time goes: the mma.sync form as it stood
before the f32 prefill form, that form without its per-fragment split of
q, and the f32 prefill form's pieces.

    python3 probes/b9_f32_limits.py       # one CUDA card, nvcc

Builds four variants of ``csrc/mma_attention.cu`` through
``probes/b9_variants.py``, one ``nvcc`` each, all started together:

  mma_sync     the f32 prefill and decode forms switched off in the
               chooser, so f32 prefill runs on ``attn_kernel``, the
               mma.sync form, whose code is the one f32 prefill ran
               before the f32 form;
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
by ``torch.profiler``'s device time a launch, beside the launches the
trace holds of 3 calls.  Prints the registers and spill
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
import subprocess
import sys

import torch

import b9_variants as bv

ROOT = bv.ROOT
sys.path.insert(0, os.path.join(ROOT, "src"))
SEED = 0
# (label, tokens, window): Gemma-2 2B's global and local layers.
SHAPES = (("prefill global", 4096, None), ("prefill local", 8192, 4096))
KV, G, HD, CAP = 4, 2, 256, 50.0

# (old text, new text) edits of the variants; each old text must occur
# exactly once in the source.
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
    "mma_sync": bv.MMA_SYNC,
    "no_qsplit": bv.MMA_SYNC + _QSPLIT,
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


def word_bytes(qg, k, v) -> int:
    """The f32 prefill form's scratch: three bf16 word planes of q, k and
    v."""
    B, Sq, KV_, G_, hd = qg.shape
    return 2 * 3 * B * KV_ * (Sq * G_ * hd + k.shape[1] * (hd + v.shape[-1]))


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
    running = bv.start_builds(EDITS, "b9")
    ma = importlib.import_module("repro_torch.kernels.mma_attention")
    ma._lib()                   # the committed library, built meanwhile
    libs, logs = bv.finish_builds(running)
    ptxas = {name: bv.ptxas_report(log, (
        "attn_kernelILb1ELb1E" if name in ("mma_sync", "no_qsplit")
        else "attn_f32_kernel",)) for name, log in logs.items()}
    ptr, i = ctypes.c_void_p, ctypes.c_int
    libs["clocks"].b9_probe_clocks.argtypes = [ptr, i]
    libs["clocks"].b9_probe_clocks.restype = i
    print(f"ptxas (registers, spill bytes): {ptxas}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, tokens, window in SHAPES:
        qg, k, v, kw = operands(tokens, window, gen)
        calls = {name: bv.variant_call(dll, qg, k, v, kw,
                                       word_bytes(qg, k, v))
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
                times[name].append(bv.median_ms(calls[name]))
        dev = bv.device_ms(calls["f32_form"], ("words_kernel",
                                                "attn_f32_kernel"))
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
