#!/usr/bin/env python3
"""B1-B3 of ``csrc/mma_reduce.cu`` beside an earlier source of the same
library, and beside variants of its walk's constants, on one card.

    python3 probes/mma_reduce_walk.py [--parent DIR] [--variants]

``--parent DIR`` names a checkout of an earlier tree (for example one
unpacked with ``git archive`` into a directory that ``.gitignore``
lists); its ``src/repro_torch/kernels/csrc/mma_reduce.cu`` is built
beside this tree's (before the walk its B1 and B3 left ``out`` for the
caller to zero).  ``--variants`` also builds this tree's source with
other values of ``kWalkUnits`` and ``kStageBytes``, with one block a
tile, and with blocks that take contiguous runs of tiles in place of
tiles ``grid`` apart.  Every kernel is first held against the f64 sum
(2^-16 of sum|x|), then timed at n = 2^28 normal, at chain 4
block_rows 128 and chain 1 block_rows 32 (B3: half of each tile's rows
on the MMAs), f32 / bf16 / fp16: the median of 15 CUDA-event timings
of single calls (what ``chip_smoke.py`` phase 5 reports) and the mean
over 20 calls back to back.  Each library is timed twice, in an order
and its reverse (parent, change, variants, variants reversed, change,
parent), and the lesser time kept.  Prints the card's ``nvidia-smi``
line and one JSON line; writes
``chiprun_out/probe_mma_reduce_walk.json``.
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
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "mma_reduce.cu")
BUILD = os.path.join(ROOT, "build", "probes")
N = 1 << 28
GEOMETRIES = ((4, 128), (1, 32))     # (chain, block_rows); B3 at chain 1
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# (label, [(pattern, replacement), ...]) in the source's text.
UNITS = r"constexpr int kWalkUnits = \d+;"
STAGE = r"constexpr int kStageBytes = \d+;"
RUNS = (r"return Span\{b, \(tiles - b \+ grid - 1\) / grid, grid\};",
        "return Span{b * tiles / grid, (b + 1) * tiles / grid - "
        "b * tiles / grid, 1};")
VARIANTS = [(f"walk_units={u}", [(UNITS, f"constexpr int kWalkUnits = {u};")])
            for u in (4, 16, 64)] + [
    ("runs", [RUNS]),
    ("stage_bytes=32", [(STAGE, "constexpr int kStageBytes = 32;")]),
    ("tile_a_block",
     [(r"tiles_for\(tiles_for\(n, tile\), tiles_for\(kWalkUnits, "
       r"chain\)\);", "tiles_for(n, tile);")])]


def build(sources: dict) -> dict:
    """{name: source text} -> {name: loaded library}, one nvcc each, all
    started together."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    running = {}
    for name, text in sources.items():
        src = os.path.join(BUILD, f"{name}.cu")
        lib = os.path.join(BUILD, f"lib{name}.so")
        with open(src, "w") as f:
            f.write(text)
        running[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o",
             lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        print(f"  built {name}: spill bytes {spills}, registers "
              f"{kernel_registers(log)}", flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def kernel_registers(log: str) -> dict:
    """{kernel<dtype, square>: registers} from ptxas's report."""
    regs, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"(single_pass|partials|split)_kernelILi(\d)E"
                          r"(?:Lb(\d)E)?", entry.group(1))
            current = f"{m.group(1)}<{m.group(2)},{m.group(3) or 0}>" \
                if m else entry.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and current:
            regs[current] = int(used.group(1))
    return regs


def bind(lib: ctypes.CDLL) -> None:
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.b1_single_pass.argtypes = [ptr, ll, i, i, i, i, ptr, ptr]
    lib.b2_partials.argtypes = [ptr, ll, i, i, i, ptr, ptr]
    lib.b3_split.argtypes = [ptr, ll, i, i, i, ptr, ptr]


def calls(lib, zeroes: bool, x: torch.Tensor, chain: int,
          block_rows: int) -> dict:
    """{kernel: (call, out)} for one library on x; ``zeroes``: the
    library zeroes B1's and B3's output itself."""
    stream = torch.cuda.current_stream().cuda_stream
    dt = DTYPES[x.dtype]
    one = torch.zeros(1, dtype=torch.float32, device="cuda")
    parts = torch.zeros(-(-x.numel() // (chain * block_rows * 16)),
                        dtype=torch.float32, device="cuda")

    def b1(square):
        def call():
            if not zeroes:
                one.zero_()
            assert lib.b1_single_pass(x.data_ptr(), x.numel(), dt, chain,
                                      block_rows, square, one.data_ptr(),
                                      stream) == 0
        return call

    def b2():
        assert lib.b2_partials(x.data_ptr(), x.numel(), dt, chain,
                               block_rows, parts.data_ptr(), stream) == 0

    def b3():
        if not zeroes:
            one.zero_()
        assert lib.b3_split(x.data_ptr(), x.numel(), dt, block_rows,
                            block_rows // 2, one.data_ptr(), stream) == 0

    return {"b1": (b1(0), one), "b1_square": (b1(1), one),
            "b2": (b2, parts), "b3": (b3, one)}


def single_ms(fn, reps: int = 15, warmup: int = 3) -> float:
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


def stream_ms(fn, iters: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    text = open(SRC).read()
    sources = {"change": text}
    if args.parent:
        parent = os.path.join(args.parent, "src", "repro_torch", "kernels",
                              "csrc", "mma_reduce.cu")
        sources["parent"] = open(parent).read()
    labels = {"change": "change", "parent": "parent"}
    if args.variants:
        for vname, subs in VARIANTS:
            vtext = text
            for pattern, repl in subs:
                vtext, k = re.subn(pattern, repl, vtext)
                assert k == 1, (vname, pattern)
            label = re.sub(r"[=,]", "_", vname)
            sources[label] = vtext
            labels[label] = vname
    built = build(sources)
    libs = {labels[name]: (lib, name != "parent")
            for name, lib in built.items()}
    for lib, _ in libs.values():
        bind(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randn(N, device="cuda", generator=gen)
    rows = []
    for dt in DTYPES:
        x = base.to(dt)
        want = float(torch.sum(x, dtype=torch.float64))
        scale = float(torch.sum(x.abs(), dtype=torch.float64))
        want_sq = float(torch.sum(x * x, dtype=torch.float64))
        scale_sq = float(torch.sum((x * x).abs(), dtype=torch.float64))
        for chain, block_rows in GEOMETRIES:
            fns = {name: calls(lib, zeroes, x, chain, block_rows)
                   for name, (lib, zeroes) in libs.items()}
            for name, by_kernel in fns.items():
                for kname, (fn, out) in by_kernel.items():
                    fn()
                    got = float(torch.sum(out, dtype=torch.float64))
                    w, s = (want_sq, scale_sq) if kname == "b1_square" \
                        else (want, scale)
                    assert abs(got - w) <= 2.0 ** -16 * s, (
                        name, kname, dt, got, w)
            for kname in ("b1", "b1_square", "b2", "b3"):
                # Each library twice, in an order and its reverse.
                order = ["parent"] if "parent" in fns else []
                order += ["change"] + [v for v in fns
                                       if v not in ("parent", "change")]
                order += order[::-1]
                got = {}
                for name in order:
                    fn = fns[name][kname][0]
                    got.setdefault(name, []).append(
                        (single_ms(fn), stream_ms(fn)))
                row = {"dtype": str(dt).removeprefix("torch."),
                       "chain": chain, "block_rows": block_rows,
                       "kernel": kname}
                for name, runs in got.items():
                    row[name] = {"single_ms": min(r[0] for r in runs),
                                 "stream_ms": min(r[1] for r in runs),
                                 "runs": runs}
                rows.append(row)
                print(f"  {row['dtype']:8s} R{chain} B{block_rows} "
                      f"{kname:9s} " + "; ".join(
                          f"{name} {v['single_ms']:.4f} / "
                          f"{v['stream_ms']:.4f}"
                          for name, v in row.items() if isinstance(v, dict)),
                      flush=True)
        sum_ms = min(single_ms(lambda: torch.sum(x, dtype=torch.float32))
                     for _ in range(2))
        rows.append({"dtype": str(dt).removeprefix("torch."),
                     "kernel": "torch.sum", "single_ms": sum_ms,
                     "stream_ms": stream_ms(
                         lambda: torch.sum(x, dtype=torch.float32))})
        print(f"  {rows[-1]['dtype']:8s} torch.sum {sum_ms:.4f} / "
              f"{rows[-1]['stream_ms']:.4f}", flush=True)
        del x
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    result = {"device": smi, "n": N, "rows": rows}
    with open(os.path.join(ROOT, "chiprun_out",
                           "probe_mma_reduce_walk.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
