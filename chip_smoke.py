#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

The main path is the paper's chained ones-MMA reduction:
``repro_torch.core.integration.reduce_sum`` / ``squared_sum`` ->
``core.dispatch`` -> the engines ``pallas`` (kernels B1-B3, CUDA C++ for
sm_90a), ``mma``, ``mma_chained`` and ``vpu``.  Phases, each of which
raises (and so exits non-zero) when it fails:

  1. device: the card's name and power limit, and the kernels' build;
  2. kernels against their plain PyTorch versions on the card, at
     n = 2^20 and 2^20 + 13, in f32, bf16 and fp16, over a few
     (chain, block_rows); and on counting inputs (0 and 1) that end in a
     ragged tail (n = 13, one tile + 13, 2^20 + 13), where kernel, plain
     version and the exact count must agree bit for bit;
  3. the main path at n = 2^28 (uniform [0, 1] and normal; 1 GiB in f32,
     512 MiB in bf16 / fp16) through every engine and ``auto``, held to
     the reference's error ceilings against an f64 oracle on the cast
     input; the kernels' launch counters are zeroed before it and must
     have moved after it;
  4. one measured autotune sweep at n = 2^24, beside the model's pick;
  5. each kernel at the main path's shapes: held against its plain
     version (rounded data) and the exact count (counting data), then
     its median time (CUDA events) beside its bound, its plain version's
     time and ``torch.sum``'s.

It prints the card's ``nvidia-smi`` line, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA card, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

SEED = 0
N_MAIN = 1 << 28
N_CHECK = (1 << 20, (1 << 20) + 13)
N_TUNE = 1 << 24
GEOMETRIES = ((1, 32), (4, 128), (5, 512))      # (chain, block_rows)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
METHODS = ("pallas", "mma", "mma_chained", "vpu", "auto")
VARIANTS = ("single_pass", "recurrence", "split")
# The main path's kernel geometry: the hooks' chain=4 and the plan's
# default block_rows=128.
CHAIN, BLOCK_ROWS = 4, 128

# Percent-error ceilings of scripts/check_error_budget.py GATES (copied:
# this script imports nothing of the JAX package).  The reference gates
# uniform [0, 1] input, where the error relative to sum|x| is its percent
# error; on normal input, whose sum cancels, the same ceilings bound the
# error relative to sum|x| (the sum's condition number is not the
# engine's doing).  squared_sum is held to its engine's ceiling, against
# the squares the engine is specified to take (see run_main_path).
CEILINGS = {"vpu": 5e-4, "mma": 5e-3, "mma_chained": 5e-3, "pallas": 5e-3}

# Kernel against plain version on rounded data, both on the card:
# |kernel - plain| <= 2^-16 * sum|x| (sum of |x*x| with squares; per
# tile for B2).  Both accumulate in f32 in another order (atomics in B1
# and B3 change it from run to run), the tensor cores' adders truncate,
# and f32 input goes in as two TF32 words.  The largest ratio seen in
# sound runs is 2^-18.3 (B1 squares, bf16, n = 2^28), so the bound keeps
# a margin of about 5.  It cannot see one element or one tile go
# missing; the counting checks below can.
KERNEL_RTOL = 2.0 ** -16

# Counting inputs: values 0 and 1, a share of them 1, the last TAIL all
# 1, followed in memory by ones that lie past n.  Every partial sum is
# an integer below 2^24, so f32 adds in any order, the TF32 and 16-bit
# MMAs and the squares are all exact: kernel, plain version and the f64
# count must be equal.  A kernel that drops, repeats or misplaces an
# element, a tile or the tail, or reads past n, misses the count.
TAIL = 13
COUNT_SHARE_CHECK = 0.25        # n <= 2^20 + 13: counts below 2^19
COUNT_SHARE_MAIN = 1.0 / 32     # n = 2^28: counts near 2^23

# The pallas engine squares in the input dtype.  A square rounded to
# nearest in a dtype of unit roundoff u differs from the exact square by
# at most u * x^2, or half the subnormal spacing eta below the normal
# range, so its squared sum may lie at most u * sum x^2 + n * eta
# beyond its ceiling from the exact sum of squares: (u, eta) per dtype.
SQUARE_ROUNDING = {torch.float32: (2.0 ** -24, 2.0 ** -150),
                   torch.bfloat16: (2.0 ** -8, 2.0 ** -134),
                   torch.float16: (2.0 ** -11, 2.0 ** -25)}

# H100 SXM peaks (NVIDIA data sheet, dense): bytes and tensor-core flops.
HBM_BYTES_PER_S = 3.35e12
TC_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12,
            torch.float16: 989e12}
CUDA_CORE_FLOPS = 67e12
# Tensor-core flops per element a ones-MMA link spends: m16n8k16 (bf16,
# fp16) is 4096 flops per 256 elements; f32 runs four m16n8k8 TF32 MMAs
# (hi and lo words) per 256 elements, 8192 flops.
MMA_FLOPS_PER_ELEMENT = {torch.float32: 32, torch.bfloat16: 16,
                         torch.float16: 16}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def nvidia_smi() -> str:
    got = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return got.stdout.strip().splitlines()[0]


def inputs(n: int, dist: str, gen: torch.Generator) -> torch.Tensor:
    if dist == "uniform":
        return torch.rand(n, device="cuda", generator=gen)
    return torch.randn(n, device="cuda", generator=gen)


# ------------------------------------------------ phase 2: kernel checks


def check_kernels(mr, ops, gen) -> dict:
    """Each kernel against its plain version on the same card inputs;
    returns the largest |kernel - plain| per kernel."""
    worst = {k: 0.0 for k in mr.LAUNCHES}
    rows = []
    for n in N_CHECK:
        base = torch.randn(n, device="cuda", generator=gen)
        for dt in DTYPES:
            x = base.to(dt)
            for chain, block_rows in GEOMETRIES:
                tile = chain * block_rows
                x2d = ops._to_tiles(x, tile, mr.M)
                for square in (False, True):
                    got = mr.single_pass_cuda(x, chain=chain,
                                              block_rows=block_rows,
                                              square=square)
                    want = mr.single_pass_plain(x2d, chain=chain,
                                                block_rows=block_rows,
                                                square=square)
                    xs = (x * x) if square else x
                    scale = float(torch.sum(xs.abs(), dtype=torch.float64))
                    err = abs(float(got) - float(want))
                    rows.append(("b1_single_pass", n, name(dt), chain,
                                 block_rows, square, err, scale))
                    worst["b1_single_pass"] = max(worst["b1_single_pass"],
                                                  err)
                    check(err <= KERNEL_RTOL * scale,
                          f"B1 n={n} {dt} R={chain} B={block_rows} "
                          f"square={square}: {float(got)} vs {float(want)}")
                got = mr.partials_cuda(x, chain=chain, block_rows=block_rows)
                want = mr.partials_plain(x2d, chain=chain,
                                         block_rows=block_rows)
                scale = torch.sum(x2d.reshape(want.shape[0], -1).abs(),
                                  dim=1, dtype=torch.float64)
                diff = (got.double() - want.double()).abs()
                check(got.shape == want.shape,
                      f"B2 shape {tuple(got.shape)} vs {tuple(want.shape)}")
                check(bool(torch.all(diff <= KERNEL_RTOL * scale)),
                      f"B2 n={n} {dt} R={chain} B={block_rows}: "
                      f"max diff {float(diff.max())}")
                worst["b2_partials"] = max(worst["b2_partials"],
                                           float(diff.max()))
                rows.append(("b2_partials", n, name(dt), chain, block_rows,
                             False, float(diff.max()), float(scale.max())))
                x2s = ops._to_tiles(x, block_rows, mr.M)
                scale = float(torch.sum(x.abs(), dtype=torch.float64))
                for frac in (0.0, 0.5, 1.0):
                    mma_rows = mr.mma_rows_for(block_rows, frac)
                    got = mr.split_cuda(x, block_rows=block_rows,
                                        mma_rows=mma_rows)
                    want = mr.split_plain(x2s, block_rows=block_rows,
                                          mma_rows=mma_rows)
                    err = abs(float(got) - float(want))
                    worst["b3_split"] = max(worst["b3_split"], err)
                    rows.append(("b3_split", n, name(dt), 1, block_rows,
                                 mma_rows, err, scale))
                    check(err <= KERNEL_RTOL * scale,
                          f"B3 n={n} {dt} B={block_rows} "
                          f"mma_rows={mma_rows}: {float(got)} vs "
                          f"{float(want)}")
    counted = 0
    for dt in DTYPES:
        for chain, block_rows in GEOMETRIES:
            tile = chain * block_rows * mr.M
            for n in (TAIL, tile + TAIL, N_CHECK[1]):
                x = count_input(n, dt, COUNT_SHARE_CHECK, gen)
                counted += check_counts(mr, ops, x, chain, block_rows)
    torch.cuda.synchronize()
    print(f"phase 2: {len(rows)} kernel-vs-plain checks passed, "
          f"worst |diff| {worst}; {counted} exact counts passed",
          flush=True)
    return {"worst": worst, "rows": rows, "counted": counted}


def count_input(n: int, dt: torch.dtype, share: float,
                gen: torch.Generator) -> torch.Tensor:
    """n counting values (see TAIL) at the start of a buffer of ones."""
    buf = torch.ones(n + 64, device="cuda", dtype=dt)
    buf[:n] = (torch.rand(n, device="cuda", generator=gen) < share).to(dt)
    buf[max(0, n - TAIL):n] = 1
    return buf[:n]


def check_counts(mr, ops, x: torch.Tensor, chain: int,
                 block_rows: int) -> int:
    """B1 (with and without squares), B2 and B3 on a counting input: the
    kernel, the plain version and the f64 count must be equal.  Returns
    the number of checks."""
    n = x.numel()
    count = float(torch.sum(x, dtype=torch.float64))
    check(count < 2 ** 24, f"count {count} is not exact in f32")
    where = f"n={n} {name(x.dtype)} R={chain} B={block_rows}"
    x2d = ops._to_tiles(x, chain * block_rows, mr.M)
    for square in (False, True):
        got = float(mr.single_pass_cuda(x, chain=chain,
                                        block_rows=block_rows,
                                        square=square))
        want = float(mr.single_pass_plain(x2d, chain=chain,
                                          block_rows=block_rows,
                                          square=square))
        check(got == want == count, f"B1 count {where} square={square}: "
                                    f"kernel {got}, plain {want}, {count}")
    got = mr.partials_cuda(x, chain=chain, block_rows=block_rows)
    want = mr.partials_plain(x2d, chain=chain, block_rows=block_rows)
    per_tile = torch.sum(x2d.reshape(want.shape[0], -1), dim=1,
                         dtype=torch.float64)
    check(got.shape == want.shape and torch.equal(got, want)
          and torch.equal(got.double(), per_tile),
          f"B2 count {where}: {int((got.double() != per_tile).sum())} "
          f"of {per_tile.numel()} tiles differ")
    x2s = ops._to_tiles(x, block_rows, mr.M)
    for frac in (0.0, 0.5, 1.0):
        mma_rows = mr.mma_rows_for(block_rows, frac)
        got = float(mr.split_cuda(x, block_rows=block_rows,
                                  mma_rows=mma_rows))
        want = float(mr.split_plain(x2s, block_rows=block_rows,
                                    mma_rows=mma_rows))
        check(got == want == count, f"B3 count {where} mma_rows="
                                    f"{mma_rows}: kernel {got}, plain "
                                    f"{want}, {count}")
    return 6


# --------------------------------------------------- phase 3: main path


def run_main_path(integration, kernels, autotune, gen) -> list:
    """reduce_sum / squared_sum through every engine at n = 2^28."""
    results = []
    for dist in ("uniform", "normal"):
        base = inputs(N_MAIN, dist, gen)
        for dt in DTYPES:
            x = base if dt == torch.float32 else base.to(dt)
            x64 = x.to(torch.float64)
            exact = {"reduce_sum": float(torch.sum(x64)),
                     "squared_sum": float(torch.sum(x64 * x64))}
            scale = {"reduce_sum": float(torch.sum(x64.abs())),
                     "squared_sum": exact["squared_sum"]}
            del x64
            # The pallas engine squares in the input dtype (as the
            # reference's kernel does), so its oracle sums those rounded
            # squares, and its distance from the exact sum of squares is
            # held to SQUARE_ROUNDING (the reference gates no pallas
            # squared sum); the other engines square in f32 or f64.
            rounded_sq = float(torch.sum(x * x, dtype=torch.float64))
            calls = []
            for method in METHODS:
                calls.append(("reduce_sum", method, lambda m=method:
                              integration.reduce_sum(x, method=m)))
                calls.append(("squared_sum", method, lambda m=method:
                              integration.squared_sum(x, method=m)))
            for variant in VARIANTS:
                calls.append(("reduce_sum", f"mma_reduce:{variant}",
                              lambda v=variant: kernels.mma_reduce(
                                  x, variant=v)))
            for op, method, fn in calls:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check(out.is_cuda and out.dtype == torch.float32
                      and out.dim() == 0,
                      f"{op}/{method}: result {out.device} {out.dtype} "
                      f"{tuple(out.shape)}")
                got = float(out)
                engine = method.split(":")[0]
                if engine == "auto":
                    engine = autotune.get_plan(x.numel(), x.dtype, op=op,
                                               backend="cuda").method
                if engine == "mma_reduce":
                    engine = "pallas"
                want, ceiling = exact[op], CEILINGS[engine]
                exact_limit = ceiling
                if op == "squared_sum" and engine == "pallas":
                    want = rounded_sq
                    u, eta = SQUARE_ROUNDING[dt]
                    exact_limit += 100.0 * (u + x.numel() * eta / scale[op])
                err = 100.0 * abs(got - want) / scale[op]
                exact_err = 100.0 * abs(got - exact[op]) / scale[op]
                results.append({"dist": dist, "dtype": name(dt), "op": op,
                                "method": method, "engine": engine,
                                "got": got, "want": want,
                                "pct_err_of_abs_sum": err,
                                "pct_err_vs_exact": exact_err,
                                "ceiling_pct": ceiling,
                                "exact_limit_pct": exact_limit,
                                "wall_s": wall})
                print(f"  {dist:7s} {name(dt):8s} {op:11s} {method:24s} "
                      f"engine={engine:11s} err={err:.3e}% "
                      f"(ceiling {ceiling:g}%; vs exact {exact_err:.3e}%, "
                      f"limit {exact_limit:.3g}%) {wall * 1e3:.1f} ms",
                      flush=True)
                check(torch.isfinite(out).item(), f"{op}/{method}: {got}")
                check(err <= ceiling,
                      f"{dist} {dt} {op}/{method}: {err:.3e}% > "
                      f"{ceiling:g}%")
                check(exact_err <= exact_limit,
                      f"{dist} {dt} {op}/{method}: {exact_err:.3e}% from "
                      f"the exact value > {exact_limit:.3g}%")
            del x
        del base
    return results


def run_other_ops(integration, gen) -> list:
    """masked_mean and expert_counts through their engines, against the
    f64 value, at moderate size."""
    rows = []
    n = 1 << 24
    v = torch.randn(n, device="cuda", generator=gen)
    mask = (torch.rand(n, device="cuda", generator=gen) > 0.5).float()
    want = float(torch.sum(v.double() * mask.double())
                 / torch.sum(mask.double()))
    scale = float(torch.sum((v * mask).abs().double())
                  / torch.sum(mask.double()))
    for method in METHODS:
        got = float(integration.masked_mean(v, mask, method=method))
        err = 100.0 * abs(got - want) / scale
        rows.append({"op": "masked_mean", "method": method,
                     "pct_err_of_abs_sum": err})
        check(err <= 5e-3, f"masked_mean/{method}: {got} vs {want}")
    experts = 64
    ids = torch.randint(0, experts, (n // experts,), device="cuda",
                        generator=gen)
    onehot = torch.nn.functional.one_hot(ids, experts).to(torch.bfloat16)
    want = torch.bincount(ids, minlength=experts).float()
    for method in ("mma", "vpu", "auto"):
        got = integration.expert_counts(onehot, method=method)
        rows.append({"op": "expert_counts", "method": method,
                     "max_abs_err": float((got - want).abs().max())})
        check(bool(torch.equal(got, want)), f"expert_counts/{method}")
    print(f"phase 3b: masked_mean and expert_counts agree: {rows}",
          flush=True)
    return rows


# ----------------------------------------------------- phase 5: timings


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


def bound(n: int, dt: torch.dtype, out_values: int, mma_share: float):
    """Least time in ms for one call, and what bounds it: every input
    byte read once and every output written once at HBM rate, against
    the tensor-core flops of the MMA share and the CUDA-core adds of the
    rest at their peaks."""
    itemsize = torch.empty((), dtype=dt).element_size()
    bytes_ms = (n * itemsize + 4 * out_values) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(mma_share * n * MMA_FLOPS_PER_ELEMENT[dt] / TC_FLOPS[dt],
                 (1.0 - mma_share) * n / CUDA_CORE_FLOPS) * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def time_kernels(mr, ops, gen, launches: dict, worst: dict) -> tuple:
    """Each kernel at the main path's geometry and n = 2^28: held to the
    exact count on counting input and to KERNEL_RTOL against its plain
    version on normal input, then timed on the normal input.  The f32
    shape goes to the ``kernels`` line, every dtype to the details."""
    src = "src/repro_torch/kernels/csrc/mma_reduce.cu"
    replaces = {"b1_single_pass": "src/repro/kernels/mma_reduce.py:73",
                "b2_partials": "src/repro/kernels/mma_reduce.py:96",
                "b3_split": "src/repro/kernels/mma_reduce.py:105"}
    tile = CHAIN * BLOCK_ROWS
    mma_rows = mr.mma_rows_for(BLOCK_ROWS, 0.5)
    base = torch.randn(N_MAIN, device="cuda", generator=gen)
    entries, details = [], []
    for dt in DTYPES:
        check_counts(mr, ops, count_input(N_MAIN, dt, COUNT_SHARE_MAIN, gen),
                     CHAIN, BLOCK_ROWS)
        x = base if dt == torch.float32 else base.to(dt)
        x2d = ops._to_tiles(x, tile, mr.M)
        x2s = ops._to_tiles(x, BLOCK_ROWS, mr.M)
        groups = x2d.shape[0] // tile
        abs_sum = torch.sum(x.abs(), dtype=torch.float64)
        scales = {"b1_single_pass": abs_sum, "b3_split": abs_sum,
                  "b1_single_pass_square": torch.sum(
                      (x * x).abs(), dtype=torch.float64),
                  "b2_partials": torch.sum(x2d.reshape(groups, -1).abs(),
                                           dim=1, dtype=torch.float64)}
        cases = {
            "b1_single_pass": (
                lambda: mr.single_pass_cuda(x, chain=CHAIN,
                                            block_rows=BLOCK_ROWS),
                lambda: mr.single_pass_plain(x2d, chain=CHAIN,
                                             block_rows=BLOCK_ROWS),
                lambda: torch.sum(x, dtype=torch.float32), 1, 1.0),
            "b1_single_pass_square": (
                lambda: mr.single_pass_cuda(x, chain=CHAIN,
                                            block_rows=BLOCK_ROWS,
                                            square=True),
                lambda: mr.single_pass_plain(x2d, chain=CHAIN,
                                             block_rows=BLOCK_ROWS,
                                             square=True),
                None, 1, 1.0),
            "b2_partials": (
                lambda: mr.partials_cuda(x, chain=CHAIN,
                                         block_rows=BLOCK_ROWS),
                lambda: mr.partials_plain(x2d, chain=CHAIN,
                                          block_rows=BLOCK_ROWS),
                lambda: torch.sum(x.view(groups, -1), dim=1,
                                  dtype=torch.float32), groups, 1.0),
            "b3_split": (
                lambda: mr.split_cuda(x, block_rows=BLOCK_ROWS,
                                      mma_rows=mma_rows),
                lambda: mr.split_plain(x2s, block_rows=BLOCK_ROWS,
                                       mma_rows=mma_rows),
                lambda: torch.sum(x, dtype=torch.float32), 1,
                mma_rows / BLOCK_ROWS),
        }
        for kname, (kern, plain, lib, outs, share) in cases.items():
            got, want = kern(), plain()
            check(got.shape == want.shape,
                  f"{kname} shape {tuple(got.shape)} vs {tuple(want.shape)}")
            diff = (got.double() - want.double()).abs()
            check(bool(torch.all(diff <= KERNEL_RTOL * scales[kname])),
                  f"{kname} {name(dt)} n=2^28: |kernel - plain| "
                  f"{float(diff.max())} over 2^-16 of sum|x|")
            diff = float(diff.max())
            # plain, kernel, kernel, plain: the two versions in turns.
            p1 = median_ms(plain)
            k1 = median_ms(kern)
            k2 = median_ms(kern)
            p2 = median_ms(plain)
            lib_ms = median_ms(lib) if lib is not None else None
            bound_ms, bound_by = bound(N_MAIN, dt, outs, share)
            row = {"name": kname, "dtype": name(dt), "n": N_MAIN,
                   "chain": CHAIN, "block_rows": BLOCK_ROWS,
                   "ms": min(k1, k2), "ms_runs": [k1, k2],
                   "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": diff}
            details.append(row)
            print(f"  {kname:22s} {name(dt):8s} kernel {row['ms']:.4f} ms "
                  f"plain {row['plain_ms']:.4f} ms library {lib_ms} ms "
                  f"bound {bound_ms:.4f} ms ({bound_by}) |diff| {diff:.3g}",
                  flush=True)
            if dt == torch.float32 and kname in launches:
                entries.append({
                    "name": kname, "route": "cuda", "source": src,
                    "replaces": replaces[kname],
                    "launches": launches[kname],
                    "max_abs_err": max(diff, worst[kname]),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms})
        del x, x2d, x2s
    return entries, details


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import kernels
    from repro_torch.core import autotune, integration
    from repro_torch.kernels import _build, ops
    # The package exports the function mma_reduce under the module's
    # name, so the kernel module is fetched by its full name.
    mr = importlib.import_module("repro_torch.kernels.mma_reduce")

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {sorted(libs)} in {build_s:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(mr, ops, gen)

    print("phase 3: main path at n = 2^28", flush=True)
    mr.reset_launches()
    main_rows = run_main_path(integration, kernels, autotune, gen)
    torch.cuda.synchronize()
    launches = dict(mr.LAUNCHES)
    print(f"phase 3: launches on the main path {launches}", flush=True)
    for kname, count in launches.items():
        check(count > 0, f"kernel {kname} was not launched on the main "
                         f"path")
    other_rows = run_other_ops(integration, gen)

    t0 = time.perf_counter()
    plan = autotune.get_plan(N_TUNE, torch.float32, measure=True,
                             backend="cuda")
    tune_s = time.perf_counter() - t0
    check(plan.source == "measured", f"autotune: {plan}")
    # The cost model's constants are data-sheet estimates, not fitted to
    # the card: its pick is recorded beside the measured one, unchecked.
    model_plan = autotune.autotune(N_TUNE, torch.float32, backend="cuda")
    print(f"phase 4: measured plan at n = 2^24 f32 in {tune_s:.1f} s: "
          f"{plan}; the cost model picks {model_plan.method} "
          f"(chain {model_plan.chain}, block_rows "
          f"{model_plan.block_rows})", flush=True)

    print("phase 5: kernel timings at n = 2^28", flush=True)
    entries, timing_rows = time_kernels(mr, ops, gen, launches,
                                        checks["worst"])

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi,
                   "torch": torch.__version__, "build_s": build_s,
                   "kernel_checks": checks["rows"],
                   "main_path": main_rows, "other_ops": other_rows,
                   "exact_counts": checks["counted"],
                   "launches": launches, "tuned_plan": plan.to_dict(),
                   "model_plan": model_plan.to_dict(),
                   "tune_s": tune_s, "timings": timing_rows,
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
