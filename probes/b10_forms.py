#!/usr/bin/env python3
"""Kernel B10 in each of its forms: held to its plain version, timed, and
its launches' device times taken apart.

    python3 probes/b10_forms.py       # one CUDA card, nvcc

For x and weights in f32, in bf16, bf16 x with f32 weights and f32 x
with bf16 weights (every form of ``kernels.mma_norm_matmul.walk``):
B10 against ``norm_matmul_plain`` within 2^-20 of each output's
absolute-value scale (bf16 plus one ulp, as ``chip_smoke.py`` phase 2f
holds it), the same bits over two calls, at a few shapes ragged against
the k steps, the tiles and the warpgroups' rows; then each form timed at
Gemma-2 2B's MLP (2304 -> 9216, gelu gate) at 4096 and 128 rows, and
DeepSeek-V3's (7168 -> 18432, silu) in bf16 (median of 10 CUDA-event
timings of single calls, the wrapper's host time included); then, under
``torch.profiler``, the device time of each of a call's launches (the
row pass, an f32 weight's pass, the projections), the mean of 5 calls;
and, where the output is f32 (f32 x), at 128 rows -log2 of the largest
|B10 - f64 oracle of the cast inputs| over each output's absolute-value
scale (a sum of d products whose errors average down: it sets the forms
side by side and is not a product's width).  Prints the card's
``nvidia-smi`` line; writes
``chiprun_out/probe_b10_forms.json``.  Exits 1 if a check fails.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
KINDS = {"f32": (torch.float32, torch.float32),
         "bf16": (torch.bfloat16, torch.bfloat16),
         "mixed": (torch.bfloat16, torch.float32),
         "f32_bf16w": (torch.float32, torch.bfloat16)}
CHECKS = [(1, 40, 8, None, False), (17, 256, 100, "silu", True),
          (65, 2305, 200, "gelu", True), (129, 2305, 9217, "silu", False),
          (257, 33, 129, None, True)]
TIMED = [(4096, 2304, 9216, "gelu", tuple(KINDS)),
         (128, 2304, 9216, "gelu", tuple(KINDS)),
         (4096, 7168, 18432, "silu", ("bf16",)),
         (128, 7168, 18432, "silu", ("bf16",))]
RTOL = 2.0 ** -20


def inputs(rows, d, dout, act, bias, kind, gen):
    xdt, wdt = KINDS[kind]
    x = torch.randn(rows, d, device="cuda", generator=gen).to(xdt)
    s = 0.1 * torch.randn(d, device="cuda", generator=gen)
    w, wg = ((torch.randn(d, dout, device="cuda", generator=gen)
              / math.sqrt(d)).to(wdt) for _ in range(2))
    b = torch.randn(dout, device="cuda", generator=gen) if bias else None
    return x, s, w, (wg if act else None), b


def abs_scale(x, s, w, wg, b) -> torch.Tensor:
    """Each output's absolute-value scale (chip_smoke.nm_scale), f64."""
    xf = x.double()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    xs = (xf * (1.0 + s.double())).abs()
    scale = rstd * (xs @ w.double().abs())
    if b is not None:
        scale = scale + b.double().abs()
    if wg is not None:
        scale = scale * (2.2 * rstd * (xs @ wg.double().abs()) + 0.3)
    return scale


def oracle_bits(got, x, s, w, wg, act, mnm) -> float:
    """-log2 of the largest |got - f64 oracle| over its output's scale."""
    xf = x.double()
    xh = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + s.double())
    want = xh @ w.double()
    if wg is not None:
        want = mnm.apply_act(xh @ wg.double(), act) * want
    ratio = ((got.double() - want).abs()
             / abs_scale(x, s, w, wg, None)).max()
    return float(-torch.log2(ratio))


def within(got, want, x, s, w, wg, b) -> bool:
    """|got - want| within RTOL of each output's absolute-value scale
    (chip_smoke.nm_scale), bf16 plus one ulp."""
    bound = RTOL * abs_scale(x, s, w, wg, b)
    if want.dtype == torch.bfloat16:
        bound = bound + torch.exp2(torch.floor(torch.log2(
            want.double().abs().clamp_min(1e-30))) - 7)
    return bool(torch.all((got.double() - want.double()).abs() <= bound))


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
    """Device ms of each kernel a call launches, the mean over calls."""
    from torch.profiler import ProfilerActivity, profile
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


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    mnm = importlib.import_module("repro_torch.kernels.mma_norm_matmul")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed, checks, timed = 0, [], []
    for kind in KINDS:
        for rows, d, dout, act, bias in CHECKS:
            x, s, w, wg, b = inputs(rows, d, dout, act, bias, kind, gen)
            call = dict(w_gate=wg, bias=b, act=act)
            got = mnm.norm_matmul_cuda(x, s, w, **call)
            ok = within(got, mnm.norm_matmul_plain(x, s, w, **call), x, s,
                        w, wg, b) and torch.equal(
                got, mnm.norm_matmul_cuda(x, s, w, **call))
            failed += not ok
            checks.append({"kind": kind, "shape": [rows, d, dout],
                           "act": act, "bias": bias, "ok": ok})
    print(f"  {len(checks) - failed} of {len(checks)} checks passed",
          flush=True)
    for rows, d, dout, act, kinds in TIMED:
        for kind in kinds:
            x, s, w, wg, _ = inputs(rows, d, dout, act, False, kind, gen)
            call = lambda: mnm.norm_matmul_cuda(  # noqa: E731
                x, s, w, w_gate=wg, act=act)
            row = {"kind": kind, "shape": [rows, d, dout], "act": act,
                   "ms": median_ms(call), "device_ms": device_ms(call)}
            if rows <= 128 and x.dtype == torch.float32:
                row["bits"] = oracle_bits(call(), x, s, w, wg, act, mnm)
            timed.append(row)
            parts = ", ".join(f"{k} {v:.4f}"
                              for k, v in row["device_ms"].items())
            bits = f"; {row['bits']:.2f} bits" if "bits" in row else ""
            print(f"  {kind:9s} {rows}x{d}x{dout}: {row['ms']:.4f} ms a "
                  f"call; device ms {parts}{bits}", flush=True)
            del x, w, wg
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    result = {"device": smi, "checks": checks, "timed": timed}
    with open(os.path.join(ROOT, "chiprun_out", "probe_b10_forms.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
