"""Kernel B7's forms on the segmented-sum path's four problems, each in
the same run: n = 2^28 values with 128 random or 256 sorted segments,
in f32 and bf16.

The forms: the one-hot it used before its factored form
(``probes/b7_parent.cu``: one MMA per group and 16-segment tile, no
ring, 8 warps a block, 4 blocks an SM), and the factored one-hot built
from ``csrc/mma_segment.cu`` as committed (``committed``: rings of 2
stages a warp; each lane prepares 8 elements of a landed step once,
ids packed and f32 values split into words; a step's 16 groups
unrolled) and with text edits (as
``probes/b9_variants.py`` edits B9's source): without a ring
(``noring``), with rings of 3 and 4 stages (``ring3``, ``ring4``) and
with 4 groups unrolled (``unroll4``); each factored form at three block
sizes (block_rows 128, 256 and 512; a grid of 32 warps an SM or as many
blocks as shared memory holds).  Every form is held to
``segment_plain`` on its own geometry (2^-20 of each segment's sum|x|)
before it is timed (a form that misses is reported and not timed, and
the probe exits 1); ``index_add_`` and ``torch.bincount`` are timed
beside.  Times are medians of 7 CUDA-event timings of single calls, the
lesser of two rounds run in opposite orders.  The card's name and power
limit head the output; the details go to ``chiprun_out/b7_forms.json``.

    python3 probes/b7_forms.py   # one H100, about 15 minutes at most
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
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
BUILD = os.path.join(ROOT, "build", "probes")
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "chiprun_out", "b7_forms.json")

N = 1 << 28
PROBLEMS = (("random", 128), ("sorted", 256))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SEG_RTOL = 2.0 ** -20
HBM_BYTES_PER_S = 3.35e12
SMEM_PER_SM = 233472        # 228 KB, of which 1 KB is reserved a block
BLOCK_ROWS = (128, 256, 512)
# (old text, new text) edits of csrc/mma_segment.cu, each old text once.
VARIANTS = {
    "committed": [],
    "noring": [("constexpr bool kRing = true;",
                "constexpr bool kRing = false;")],
    "ring3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "ring4": [("constexpr int kStages = 2;", "constexpr int kStages = 4;"),
              ("constexpr int kRingBytes = 98304;",
               "constexpr int kRingBytes = 131072;")],
    "unroll4": [("constexpr int kUnroll = 16;",
                 "constexpr int kUnroll = 4;")],
}


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def start_builds() -> dict:
    """Write each form's source and start its nvcc, all together."""
    os.makedirs(BUILD, exist_ok=True)
    base = open(os.path.join(CSRC, "mma_segment.cu")).read()
    sources = {"parent": open(os.path.join(ROOT, "probes",
                                           "b7_parent.cu")).read()}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"probe: the {name} edit does not match "
                                 f"the source once: {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    running = {}
    for name, text in sources.items():
        src = os.path.join(BUILD, f"b7_{name}.cu")
        lib = os.path.join(BUILD, f"libb7_{name}.so")
        with open(src, "w") as f:
            f.write(text)
        running[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I",
             CSRC, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return running


def finish_builds(running: dict) -> tuple:
    libs, ptxas = {}, {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        # Each kernel's spill stores, by its mangled name.
        by_kernel = dict(re.findall(
            r"entry function '(\w+)'[^\n]*\n(?:[^\n]*\n){0,2}?[^\n]*?"
            r"(\d+) bytes spill stores", log))
        ptxas[name] = {"registers": [min(regs), max(regs)],
                       "spill_bytes": spills,
                       "spilling": {k: int(v) for k, v in by_kernel.items()
                                    if int(v)}}
        dll = ctypes.CDLL(lib)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        dll.b7_segment_sum.argtypes = [p, p, ll, i, i, i, i, p, p, p]
        dll.b7_segment_sum.restype = i
        if name != "parent":
            dll.b7_ring_bytes.argtypes = [i, i]
            dll.b7_ring_bytes.restype = i
        libs[name] = dll
    return libs, ptxas


def grid(name: str, dll, dtype: torch.dtype, block_rows: int,
         sms: int) -> int:
    """The form's grid: the parent's 4 blocks an SM; the factored form's
    32 warps an SM, or as many blocks as shared memory holds."""
    warps = block_rows // 16
    if name == "parent":
        per_sm = 4
    else:
        ring = dll.b7_ring_bytes(DTYPES[dtype], block_rows)
        per_sm = min(max(1, 32 // warps), SMEM_PER_SM // (ring + 1024))
    return min(per_sm * sms, -(-N // (256 * warps)))


def form_call(dll, x, ids, s: int, dtype: torch.dtype, block_rows: int,
              blocks: int):
    partials = torch.empty(blocks * s, device="cuda")
    out = torch.zeros(s, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = dll.b7_segment_sum(x.data_ptr(), ids.data_ptr(), N,
                                DTYPES[dtype], s, block_rows, blocks,
                                partials.data_ptr(), out.data_ptr(), stream)
        if rc:
            raise SystemExit(f"probe: b7_segment_sum returned {rc}")
        return out
    return call


def median_ms(fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs, ptxas = finish_builds(start_builds())
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s; "
          f"ptxas {ptxas}", flush=True)
    sg = importlib.import_module("repro_torch.kernels.mma_segment")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(26)
    base = torch.randn(N, device="cuda", generator=gen)
    rows, failed = [], []
    for kind, s in PROBLEMS:
        ids = torch.randint(0, s, (N,), device="cuda", generator=gen,
                            dtype=torch.int32)
        if kind == "sorted":
            ids = torch.sort(ids).values
        for dt in DTYPES:
            x = base if dt == torch.float32 else base.to(dt)
            scale = torch.zeros(s, dtype=torch.float64, device="cuda") \
                .index_add_(0, ids.long(), x.double().abs())
            bound = (N * (4 + x.element_size()) + 4 * s) \
                / HBM_BYTES_PER_S * 1e3
            calls, checks = {}, {}
            for name, dll in libs.items():
                for block_rows in ((128,) if name == "parent"
                                   else BLOCK_ROWS):
                    blocks = grid(name, dll, dt, block_rows, sms)
                    key = f"{name}/B{block_rows}"
                    call = form_call(dll, x, ids, s, dt, block_rows, blocks)
                    got = call().clone()
                    want = sg.segment_plain(x, ids, s,
                                            block_rows=block_rows,
                                            blocks=blocks)
                    ratio = float(((got.double() - want.double()).abs()
                                   / scale.clamp_min(1e-300)).max())
                    checks[key] = {"blocks": blocks, "ratio": ratio,
                                   "ok": ratio <= SEG_RTOL}
                    if ratio <= SEG_RTOL:
                        calls[key] = call
                    else:
                        failed.append(key)
                        print(f"probe: {key} {kind} S={s} {dt}: |form - "
                              f"plain| is {ratio:.3g} of the segment's "
                              f"sum|x|: not timed", flush=True)
                    del want
            calls["index_add_"] = lambda: torch.zeros(
                s, device="cuda").index_add_(0, ids, x.float())
            calls["bincount"] = lambda: torch.bincount(
                ids, weights=x, minlength=s)
            order = list(calls)
            times = {k: [] for k in order}
            for names in (order, order[::-1]):
                for key in names:
                    times[key].append(median_ms(calls[key]))
            best = {k: min(v) for k, v in times.items()}
            row = {"ids": kind, "segments": s, "dtype": str(dt), "n": N,
                   "bound_ms": bound, "ms": best, "rounds": times,
                   "checks": checks}
            rows.append(row)
            print(f"{kind} S={s} {dt} (bound {bound:.4f} ms):", flush=True)
            for key in order:
                share = f" {100 * bound / best[key]:.1f} % of the bound" \
                    if key in checks else ""
                print(f"  {key:18s} {best[key]:.4f} ms{share}", flush=True)
            del x, scale, calls
        del ids
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "nvidia_smi": smi, "torch": torch.__version__,
                   "ptxas": ptxas, "rows": rows, "failed": failed}, f,
                  indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
