#!/usr/bin/env python3
"""Where kernel B9's time goes at a decode step: the mma.sync form the
decode step ran on before the decode form, and the decode form at three
chunk lengths and with its first ring budget, with its two launches apart.

    python3 probes/b9_decode_limits.py       # one CUDA card, nvcc

Builds variants of ``csrc/mma_attention.cu`` through
``probes/b9_variants.py``, one ``nvcc`` each, all started together:

  mma_sync     the decode form and the f32 prefill form switched off in
               the chooser, so a decode step (and f32 prefill) runs on
               ``attn_kernel``, the mma.sync form, whose code is the one
               every decode step ran before the decode form;
  chunk<n>     the decode form with ``dc::kChunk`` = n keys a chunk, for
               each n of CHUNKS (the committed DECODE_CHUNK unedited);
  rows48k      the decode form with the 2-row ring budget of 48 KB at 8
               and 16 rows a block too (``dc::kRingBytesRows``), as the
               form had it first: more stages in flight, fewer blocks
               an SM where q's words take much room.

At PROBLEMS, 128 slots each at a position drawn uniformly from [0, 32768)
and reading min(position + 1, ring) slots, as ``models.attention`` passes
a per-row decode step: Gemma-2 2B's (8 heads over 4 KV heads, head dim
256, softcap 50) over a bf16 ring of 32768 slots (the global layer) and
of 4096 (the local one), with f32 q (``mixed``) and bf16 q; and GLM-4
9B's (32 heads over 2 KV heads, head dim 128, no softcap) and Llama 3.2
Vision 90B's (64 heads over 8 KV heads, head dim 128) over a ring of
32768 with f32 q.  Each variant (a direct call of its library) and
the committed form (``attention_cuda``, host work per call included)
are timed in turns (median of 5 CUDA-event timings of single calls, two
rounds), and the committed form's two launches (the chunks' walk, the
merge) by ``torch.profiler``'s device time a launch, beside the launches
the trace holds of 3 calls.  Prints the registers and spill bytes ptxas
reports for the decode form's kernels in each build, each variant's
largest difference from the committed form, the card's ``nvidia-smi``
line and one JSON line; writes
``chiprun_out/probe_b9_decode_limits.json``.
"""

from __future__ import annotations

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
SLOTS, POSITIONS = 128, 32768
# (label, ring slots, KV heads, rows a KV head, head dim, softcap, q's
# dtype): Gemma-2 2B's global and local layers with f32 q ("mixed") and
# bf16 q, GLM-4 9B's global layer with f32 q (16 rows a KV head, the most
# the decode form takes) and Llama 3.2 Vision 90B's (8 rows a KV head).
PROBLEMS = (
    ("decode global mixed", 32768, 4, 2, 256, 50.0, torch.float32),
    ("decode global bf16", 32768, 4, 2, 256, 50.0, torch.bfloat16),
    ("decode local mixed", 4096, 4, 2, 256, 50.0, torch.float32),
    ("decode local bf16", 4096, 4, 2, 256, 50.0, torch.bfloat16),
    ("decode 16 rows mixed", 32768, 2, 16, 128, None, torch.float32),
    ("decode 8 rows mixed", 32768, 8, 8, 128, None, torch.float32),
)
CHUNKS = (512, 1024, 2048)
# The ring budget at 8 or 16 rows a block of the rows48k variant: the
# 2-row budget, which every block had before the smaller one.
DC_KERNELS = ("attn_decode_kernel", "merge_kernel")
_ROWS48K = ("constexpr int kRingBytesRows = 16384;",
            "constexpr int kRingBytesRows = 49152;")


def committed_chunk() -> int:
    ma = importlib.import_module("repro_torch.kernels.mma_attention")
    return ma.DECODE_CHUNK


def variants() -> dict:
    """{name: (edits, chunk length or None for the mma.sync form)}: the
    committed chunk length among the chunk variants too, so that every
    chunk length is timed through the same direct call."""
    mine = committed_chunk()
    out = {"mma_sync": (bv.MMA_SYNC, None)}
    for n in CHUNKS:
        out[f"chunk{n}"] = ([] if n == mine else [
            (f"constexpr int kChunk = {mine};",
             f"constexpr int kChunk = {n};")], n)
    out["rows48k"] = ([_ROWS48K], mine)
    return out


def scratch_bytes(qg, k, v, chunk) -> int:
    """The decode form's f32 chunk states for chunks of ``chunk`` keys
    (none for the mma.sync form)."""
    if chunk is None:
        return 0
    B, Sq, KV_, G_, _ = qg.shape
    return 4 * B * KV_ * -(-k.shape[1] // chunk) * Sq * G_ * (v.shape[-1]
                                                              + 2)


def operands(ring: int, kv: int, g: int, hd: int, cap, q_dtype,
             gen) -> tuple:
    """A decode step's qg, k, v and kwargs, as models.attention passes a
    per-row step over a ring: no causal mask, no window, kv_len =
    min(position + 1, ring)."""
    qg = torch.randn(SLOTS, 1, kv, g, hd, device="cuda",
                     generator=gen).to(q_dtype)
    k = torch.randn(SLOTS, ring, kv, hd, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    v = torch.randn(SLOTS, ring, kv, hd, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    pos = torch.randint(0, POSITIONS, (SLOTS,), device="cuda",
                        generator=gen)
    kv_len = torch.clamp(pos + 1, max=ring).to(torch.int32)
    return qg, k, v, dict(qpos=pos[:, None].to(torch.int32).contiguous(),
                          causal=False, window=None, kv_len=kv_len,
                          scale=hd ** -0.5, cap=cap)


def bound_ms(qg, k, v, kw) -> float:
    """Bytes each row must read (its kv_len keys and values), q and o, at
    3.35 TB/s."""
    keys = float(kw["kv_len"].sum()) * k.shape[2]
    nbytes = qg.numel() * qg.element_size() \
        + keys * (k.shape[-1] + v.shape[-1]) * 2 \
        + qg.numel() // qg.shape[-1] * v.shape[-1] * 2
    return nbytes / 3.35e12 * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    specs = variants()
    running = bv.start_builds({name: spec[0] for name, spec in
                               specs.items()}, "b9dc")
    ma = importlib.import_module("repro_torch.kernels.mma_attention")
    from repro_torch.kernels import _build
    committed = _build.build_all(["mma_attention"])["mma_attention"]
    ma._lib()
    libs, logs = bv.finish_builds(running)
    ptxas = {name: bv.ptxas_report(log, DC_KERNELS)
             for name, log in logs.items()}
    ptxas["committed"] = bv.ptxas_report(open(f"{committed}.log").read(),
                                         DC_KERNELS)
    print(f"ptxas (registers, spill bytes): {ptxas}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, ring, kv, g, hd, cap, q_dtype in PROBLEMS:
        qg, k, v, kw = operands(ring, kv, g, hd, cap, q_dtype, gen)
        calls = {name: bv.variant_call(
            dll, qg, k, v, kw, scratch_bytes(qg, k, v, specs[name][1]))
            for name, dll in libs.items()}
        calls["committed"] = lambda: ma.attention_cuda(qg, k, v, **kw)
        want = calls["committed"]().float()
        scale = float(want.abs().max())
        diffs = {name: float((calls[name]().float() - want).abs().max())
                 for name in libs}
        times = {name: [] for name in calls}
        order = list(calls)
        for rnd in range(2):
            for name in (order if rnd == 0 else order[::-1]):
                times[name].append(bv.median_ms(calls[name]))
        dev = bv.device_ms(calls["committed"], DC_KERNELS)
        bound = bound_ms(qg, k, v, kw)
        row = {"problem": label, "ring": ring,
               "ms": {n: min(t) for n, t in times.items()},
               "ms_rounds": times, "committed_chunk": ma.DECODE_CHUNK,
               "committed_device_ms": dev, "bound_ms": bound,
               "max_abs_diff_from_committed": diffs,
               "output_scale": scale}
        rows.append(row)
        print(f"{label}: bound {bound:.4f} ms; "
              + ", ".join(f"{n} {min(t):.4f} ({100 * bound / min(t):.1f}"
                          f" %)" for n, t in times.items())
              + f"; committed device ms by launch {dev}; |variant - "
              f"committed| {diffs} of a max |o| {scale:.3g}", flush=True)
        del qg, k, v, want, calls
        torch.cuda.empty_cache()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ptxas": ptxas, "rows": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "probe_b9_decode_limits.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
