#!/usr/bin/env python3
"""How steady is the attention pick check of ``chip_smoke.py`` (phase
3i)?  Its decode steps run the attention layer through each engine and
``auto``, timed as the phase times them, many times over.

    python3 probes/attn_pick_noise.py [--rounds 10]    # one CUDA card, nvcc

Builds B9 alone (``kernels/_build``) and, at each of phase 3i's decode
problems (Gemma-2 2B's global and local layers over 128 slots with f32
q and a bf16 ring, or bf16 q; its local layer over an f32 ring; GLM-4
9B's 16 rows a KV head), makes the layer's operands as the phase makes
them.  Each round runs PASSES passes of the methods in the balanced
orders of ``chip_smoke.balanced_orders``, each method in each order a
median of ``REPS`` CUDA-event timings of single calls after one warm
call (``chip_smoke.median_ms``), and reads the pick ratio (auto's time
over the fastest engine's, as ``check_pick`` takes it) three ways:

  phase    each method's least median over the first pass's orders
           (what phase 3i checked);
  passes   its least median over all PASSES passes;
  pooled   the median of all its single-call timings of all passes.

Each problem also reports each method's host time a call
(``chip_smoke.host_us`` over HOST_CALLS calls launched back to back)
and its card time a call over the same calls, so it shows whether a
layer call is held by the host or by the card.

Prints each problem's ratios by round under each reading, their median
and largest, the card's ``nvidia-smi`` line and one JSON line; writes
``chiprun_out/probe_attn_pick_noise.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

PASSES = 3
REPS = 3
HOST_CALLS = 50
READINGS = ("phase", "passes", "pooled")


def timings(fn, reps: int = REPS) -> list:
    """``chip_smoke.median_ms``'s single-call timings, kept."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def one_round(calls: dict) -> dict:
    """The pick ratio of one round under each reading."""
    samples = {m: [] for m in calls}       # [pass][order] -> timings
    for _ in range(PASSES):
        per_pass = {m: [] for m in calls}
        for order in cs.balanced_orders(tuple(calls)):
            for method in order:
                per_pass[method].append(timings(calls[method]))
        for m in calls:
            samples[m].append(per_pass[m])
    times = {
        "phase": {m: min(statistics.median(t) for t in samples[m][0])
                  for m in calls},
        "passes": {m: min(statistics.median(t) for p in samples[m]
                          for t in p) for m in calls},
        "pooled": {m: statistics.median(x for p in samples[m] for t in p
                                        for x in t) for m in calls}}
    out = {}
    for reading, ms in times.items():
        best = min((m for m in ms if m != "auto"), key=ms.get)
        out[reading] = {"ms": ms, "best": best,
                        "ratio": ms["auto"] / ms[best]}
    return out


def device_ms(fn, calls: int = HOST_CALLS) -> float:
    """Card time a call over ``calls`` calls launched back to back."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_pick_noise: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import base, registry
    from repro_torch.kernels import _build
    from repro_torch.models import attention as A
    from repro_torch.models import param

    smi = cs.nvidia_smi()
    _build.build_all(["mma_attention"])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out, params = [], {}
    for label, arch, kind, phase, n, capacity, kinds in cs.attn_problems(
            registry, base):
        if phase != "decode":
            continue
        cfg0 = registry.get_config(arch)
        if arch not in params:
            params[arch] = param.init_tree(gen, A.attn_specs(cfg0),
                                           device="cuda")
        cache = A.make_cache(cfg0, n, capacity,
                             dtype=cs.ATTN_KINDS[kinds[0]][1])
        for key in ("k", "v"):
            cache[key].copy_(torch.randn(cache[key].shape, device="cuda",
                                         generator=gen,
                                         dtype=cache[key].dtype))
        positions = torch.randint(0, base.SHAPES["decode_32k"].seq_len,
                                  (n, 1), device="cuda", generator=gen)
        x32 = torch.randn(n, 1, cfg0.d_model, device="cuda", generator=gen)
        for dkind in kinds:
            x = x32.to(cs.ATTN_KINDS[dkind][0])
            problem = f"{label} {dkind}"
            calls = {}
            for method in ("fused_pallas", "vpu", "auto"):
                cfg = dataclasses.replace(cfg0, attn_method=method)
                calls[method] = (lambda c=cfg, w=params[arch]: A.attention(
                    w, c, x, positions=positions, kind=kind, cache=cache,
                    decode=True)[0])
            rounds = [one_round(calls) for _ in range(args.rounds)]
            summary = {"problem": problem, "rounds": rounds}
            for reading in READINGS:
                ratios = [r[reading]["ratio"] for r in rounds]
                summary[reading] = {
                    "median": statistics.median(ratios), "max": max(ratios),
                    "above_slack": sum(r > cs.PICK_SLACK for r in ratios)}
                print(f"{problem:22s} {reading:6s}: ratios "
                      f"{' '.join(f'{r:.3f}' for r in ratios)}; median "
                      f"{summary[reading]['median']:.3f} max "
                      f"{max(ratios):.3f}", flush=True)
            summary["host_us"] = {m: cs.host_us(f, HOST_CALLS)
                                  for m, f in calls.items()}
            summary["device_ms"] = {m: device_ms(f)
                                    for m, f in calls.items()}
            for what in ("host_us", "device_ms"):
                print(f"{problem:22s} {what} a call "
                      + " ".join(f"{m} {v:.4f}"
                                 for m, v in summary[what].items()),
                      flush=True)
            out.append(summary)
        del cache, x32
    record = {"smi": smi, "pick_slack": cs.PICK_SLACK, "problems": out}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "probe_attn_pick_noise.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({p["problem"]: {r: p[r] for r in READINGS}
                      for p in out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
