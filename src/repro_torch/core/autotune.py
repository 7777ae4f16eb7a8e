"""Reduction autotuner: pick (method, variant, chain, block_rows) per
problem, the way the paper picks (R, B) per GPU geometry — the
counterpart of ``repro.core.autotune`` for the reduce and scan
families.

  * ``candidate_plans`` enumerates the paper's R in {1..5} x block
    geometry sweep off the TC-op registry (``repro_torch.core.dispatch``);
  * ``autotune`` scores candidates by CUDA-event measurement on the card
    (``measure=True``) or by an analytical cost model whose constants
    are derived for one H100 (below);
  * ``PlanRegistry`` caches winners keyed by (op, n-bucket, dtype,
    backend[, engine][, precision][, latency][, mesh]) — the
    reference's key grammar and its versioned JSON file format, so a
    table written by either package loads in the other.  The backend
    component is ``cuda`` or ``cpu``: a plan keyed ``|tpu`` or ``|cpu``
    never resolves on ``|cuda``;
  * ``get_plan`` is the one-call entry of ``method='auto'``;
  * ``warmup`` resolves a serving hot set before traffic, and a
    ``SweepWorker`` attached to a registry upgrades the model-cost plans
    ``get_plan`` serves to measured ones on a background thread.

Plans are mesh-aware, as in the reference: under a mesh of more than one
rank the key carries its signature (``|mesh:data4.model2``), and the
sweep tunes the local shard of the global problem, adding the constant
cost of the cross-rank combine (``combine_model_cost``).  A measured mesh
sweep runs on every rank of a live mesh (``compat.make_mesh``) that the
ranks pass together, never on a background ``SweepWorker``, and decides
each candidate by its largest time over the ranks, so that every rank
records the same plan.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import queue
import re
import tempfile
import threading
import time
from typing import Callable, Iterator, Optional

import torch

try:  # POSIX advisory file locking; absent on some platforms.
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX host
    fcntl = None

from repro_torch.core import theory
from repro_torch.core.precision import TF32_WORDS, as_dtype, dtype_name

# The paper's experimental sweep: chain length R (Figs. 3/5) and block
# geometry B (rows of 16 elements per chain link; 2B threads a block).
CHAINS = (1, 2, 3, 4, 5)
BLOCK_ROWS = (32, 128, 512)
DEFAULT_M = 16  # the paper's wmma tile, the Hopper kernels' chain link

# Cost-model constants for one H100 SXM, from NVIDIA's data sheet.  The
# model unit is one microsecond, so each constant is a rate or a time
# in µs.  Ratios rank the candidates of one sweep; the µs anchor gives
# the analytical latency estimates the same scale a measured sweep has.
_MODEL_UNIT_US = 1.0
# Streaming multiprocessors: the blocks the model assumes in flight.
_PARALLELISM = 132
# f32 adds per µs per SM on the CUDA cores: 128 FP32 lanes at the
# 1980 MHz boost clock (67 TFLOP/s = 132 SMs x 128 lanes x 2 x 1.98 GHz).
_VPU_THROUGHPUT = 128 * 1980
# Elements per µs per SM that m=16 ones-MMAs fold: 989 TFLOP/s dense
# bf16 is 4096 flops per clock per SM at 1830 MHz, and a ones-MMA spends
# 2m = 32 flops on each element it folds.
_MXU_THROUGHPUT = 4096 * 1830 // (2 * DEFAULT_M)
# The constants below are fitted, not taken from a data sheet:
# chip_smoke.py (phase 6) times the pallas R x B grid, vpu and mma at
# n = 2^20, 2^24 and 2^28 on one H100 80GB HBM3 (700.00 W) and fits the
# model to those times by non-negative least squares in relative terms,
# beside a per-call host cost that is the same for every engine (14-20
# µs there; it moves no pick, so it stays out).
# µs a thread block adds that its loads do not hide, per wave of SMs,
# for the kernels that take one block per tile (B2, B4, B5, B6, B7; the
# data-sheet estimate was ~200 cycles, 0.1 µs).  Fitted on f32 while B1
# too took one block per tile; phase 6 no longer times such a kernel.
_GRID_STEP_OVERHEAD = 0.042
# µs a block of B1's and B3's walk (``kernels.mma_reduce.walk``: the
# tiles of 8 links a lane) adds beyond its loads, per wave of SMs: its
# start, its collapse and its one atomic.  Phase 6 fits 0 there in f32,
# bf16 and fp16 alike: the loads of the blocks beside it hide a block's
# own cost.
_WALK_BLOCK_US = 0.0
# µs per PRAM step of the paper's depth formulas (estimated at ~30
# cycles, 0.015 µs).  The fit puts it at 0: beside the memory stream
# and the host's cost per call, no time on the card follows the depth.
_STEP_US = 0.0
# Device-memory bytes per µs: 3.35 TB/s.
_HBM_BYTES_PER_US = 3.35e6

# Segment count when timing and modelling segment_sum candidates (the
# plan key does not carry it): 128, the segment count of the
# reference's scan benchmark (benchmarks/bench_scan.py) and the routed
# experts of Arctic (src/repro/configs/arctic_480b.py).
_MEASURE_SEGMENTS = 128
# Two fitted constants of the segment family: chip_smoke.py (phase 5d)
# times kernel B7 and the vpu engine at n = 2^28 f32 with 128 random
# segments on one H100 80GB HBM3 (700 W) and prints them.  µs per group
# of 16 elements and block of 128 segments that B7 adds beyond its
# bytes (its lane work: keys, compares, word split, masks, MMAs, adds):
_B7_GROUP_US = 2.52e-5
# µs per element the vpu engine's float atomics add beyond its memory
# traffic (contention on S addresses):
_SEG_ATOMIC_US = 1.96e-4

# The cross-rank combine: one f32 scalar all_reduce per mesh axis above
# size 1, charged per step of a tree of depth log2(size).  It is the
# same for every candidate of a sweep, so it ranks nothing; it makes a
# mesh plan's recorded cost the whole.  µs a step of a scalar
# all_reduce over a fast axis: chip_smoke.py phase 3m times one over
# each axis of eight gloo ranks on one H100 80GB HBM3 (700 W), whose
# tensors cross the host, and prints the fit: 651-2195 µs over four
# runs (the host's load moves it).
_PSUM_STEP_US = 1500.0
# The slow pod axis crosses the data-centre network, which no run on one
# card reaches: not measured.  Charged at four fast steps a step.
_PSUM_STEP_US_SLOW = 4 * _PSUM_STEP_US

# µs of host time one call of a scan engine costs (Python, allocations,
# launches), whatever n is.  Calls queue on the card, so the host's time
# and the device's overlap: a call costs the larger of the two.  Below
# ~2^22 elements the host's sets a scan's time, and without it the
# model picked the kernel (fewer bytes) where torch.cumsum (one launch)
# ran faster.  chip_smoke.py (phase 6b) times each engine at n = 2^12,
# where the device's work is negligible, and prints the fit; these are
# its values on one H100 80GB HBM3 (700 W); pallas (kernel B6: the
# scratch's zeroing and one launch) was refitted after B6 became one
# launch, the others are an earlier run's.  They move with the load on
# the host the card shares: another run on the same kind of machine fit
# vpu 39.0 and pallas 96.3.  Below the crossover only their order
# decides the pick; their size sets where the crossover falls.
_SCAN_HOST_US = {"vpu": 17.2, "pallas": 41.0, "mma_chained": 177.0,
                 "mma_ec": 528.9}


@dataclasses.dataclass(frozen=True)
class ReductionPlan:
    """One executable reduction configuration — the reference's fields
    and JSON form, with the paper's m = 16 as the default tile.  ``cost``
    is µs (measured or modelled alike), ``error_pct`` the percent-error
    score a budget-aware sweep gave it, ``latency_ms`` the latency
    estimate an SLO sweep scored."""
    method: str
    variant: str = "single_pass"
    chain: int = 1
    block_rows: int = 128
    m: int = DEFAULT_M
    split_words: int = 2
    mma_fraction: float = 0.5
    source: str = "model"       # 'model' | 'measured'
    cost: float = 0.0
    error_pct: Optional[float] = None
    latency_ms: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReductionPlan":
        return cls(**d)


def bucket_n(n: int) -> int:
    """Round n up to a power of two — the plan-cache granularity."""
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)


# ---------------------------------------------------- bucket policies
#
# A bucket policy maps n onto the cap the plan is tuned and keyed at;
# every cap is monotone in n and >= n (the reference's contract).


def _cap_pow2(n: int) -> int:
    return bucket_n(n)


def _cap_geom(n: int, m: int = DEFAULT_M) -> int:
    # m^2-aligned above one m x m tile, m-aligned below.
    n = max(int(n), 1)
    if n <= m:
        return m
    if n <= m * m:
        return math.ceil(n / m) * m
    return math.ceil(n / (m * m)) * (m * m)


BUCKETS: dict[str, Callable[[int], int]] = {
    "pow2": _cap_pow2,
    "geom": _cap_geom,
}

# bucket argument: a policy name from BUCKETS, or None for exact keys.
BucketArg = Optional[str]

DEFAULT_BUCKET = "pow2"


def bucket_cap(n: int, bucket: BucketArg = DEFAULT_BUCKET) -> int:
    """The bucket cap n belongs to (None: n itself); unknown names raise."""
    n = max(int(n), 1)
    if bucket is None:
        return n
    try:
        fn = BUCKETS[bucket]
    except KeyError:
        raise ValueError(
            f"unknown bucket policy {bucket!r} (known: "
            f"{sorted(BUCKETS)} or None for exact keys)") from None
    return fn(n)


def bucket_floor(n: int, bucket: BucketArg = DEFAULT_BUCKET) -> int:
    """Smallest size sharing n's bucket (the cap's lower boundary)."""
    cap = bucket_cap(n, bucket)
    if bucket is None or cap <= 1:
        return cap
    lo, hi = 1, cap
    while lo < hi:  # first k with bucket_cap(k) == cap (caps monotone)
        mid = (lo + hi) // 2
        if bucket_cap(mid, bucket) >= cap:
            hi = mid
        else:
            lo = mid + 1
    return lo


# engine restriction: None = all engines; a method name; or a tuple.
Engine = Optional[object]

# mesh argument: None, an ((axis_name, size), ...) tuple, an object with
# an ordered .shape mapping, or a signature string ("data4.model2").
MeshArg = Optional[object]


def mesh_axes(mesh: MeshArg) -> Optional[tuple]:
    """Normalise a mesh argument to ``((name, size), ...)`` — or None
    for a single device (a device product of 1)."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        axes = []
        for part in mesh.split("."):
            got = re.fullmatch(r"(.*?)(\d+)", part)
            if got is None:
                raise ValueError(
                    f"bad mesh-signature component {part!r} in {mesh!r} "
                    f"(expected '<axis><size>', e.g. 'data4')")
            axes.append((got.group(1), int(got.group(2))))
        axes = tuple(axes)
    elif hasattr(mesh, "shape") and hasattr(mesh.shape, "items"):
        axes = tuple((str(n), int(s)) for n, s in mesh.shape.items())
    else:
        axes = tuple((str(n), int(s)) for n, s in mesh)
    for name, _ in axes:
        if not name or name[-1].isdigit():
            raise ValueError(
                f"mesh axis name {name!r} would make the mesh "
                f"signature ambiguous (names must not end in a "
                f"digit); rename the axis")
    if math.prod(s for _, s in axes) <= 1:
        return None
    return axes


def mesh_signature(mesh: MeshArg) -> str:
    """``"data4.model2"``-style signature, ``""`` for a single device."""
    axes = mesh_axes(mesh)
    if axes is None:
        return ""
    return ".".join(f"{n}{s}" for n, s in axes)


def mesh_device_count(mesh: MeshArg) -> int:
    """Ranks of the mesh: 1 for a single device."""
    axes = mesh_axes(mesh)
    return 1 if axes is None else math.prod(s for _, s in axes)


def _mesh_tag(mesh: MeshArg) -> str:
    sig = mesh_signature(mesh)
    return f"|mesh:{sig}" if sig else ""


def _form_tag(form: tuple) -> str:
    return "|form:" + ",".join(f"{k}={v}" for k, v in form) if form \
        else ""


def _engine_methods(engine: Engine) -> Optional[tuple]:
    if engine is None:
        return None
    if isinstance(engine, str):
        return (engine,)
    return tuple(engine)


def _engine_tag(engine: Engine) -> str:
    methods = _engine_methods(engine)
    return "" if methods is None else "|" + "+".join(methods)


# policy argument: None, or a repro_torch.core.precision.MmaPolicy.
PolicyArg = Optional[object]


def _prec_tag(policy: PolicyArg) -> str:
    return "" if policy is None else f"|prec:{policy.signature()}"


@dataclasses.dataclass(frozen=True)
class LatencyObjective:
    """A per-call latency target: the auto sweep picks the most accurate
    candidate whose latency meets ``latency_slo_ms`` (the fastest when
    none does).  Keys the plan with ``|lat:<signature>``."""
    latency_slo_ms: float

    def __post_init__(self):
        if not self.latency_slo_ms > 0.0:
            raise ValueError(
                f"latency_slo_ms must be positive, got "
                f"{self.latency_slo_ms!r}")

    def signature(self) -> str:
        return f"slo{self.latency_slo_ms:g}ms"

    @classmethod
    def from_signature(cls, sig: str) -> "LatencyObjective":
        got = re.fullmatch(r"slo(.+)ms", sig)
        if got is None:
            raise ValueError(
                f"bad latency-objective signature {sig!r} "
                f"(expected 'slo<ms>ms', e.g. 'slo0.25ms')")
        return cls(latency_slo_ms=float(got.group(1)))


# objective argument: None, a LatencyObjective, a number of ms, or a
# signature string ("slo0.25ms").
ObjectiveArg = Optional[object]


def as_objective(obj: ObjectiveArg) -> Optional[LatencyObjective]:
    """Normalise an ``objective`` argument to a LatencyObjective."""
    if obj is None or isinstance(obj, LatencyObjective):
        return obj
    if isinstance(obj, str):
        return LatencyObjective.from_signature(obj)
    if isinstance(obj, (int, float)):
        return LatencyObjective(latency_slo_ms=float(obj))
    raise TypeError(
        f"objective must be None, a LatencyObjective, a number of "
        f"milliseconds, or an 'slo<ms>ms' signature; got {obj!r}")


def _lat_tag(objective: ObjectiveArg) -> str:
    obj = as_objective(objective)
    return "" if obj is None else f"|lat:{obj.signature()}"


def default_backend() -> str:
    """The backend an entry point runs on when the caller names none:
    ``cuda`` when a card is present, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _live_backends() -> tuple:
    return ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",)


def plan_key(op: str, n: int, dtype, backend: Optional[str] = None,
             engine: Engine = None, mesh: MeshArg = None,
             policy: PolicyArg = None,
             objective: ObjectiveArg = None,
             bucket: BucketArg = DEFAULT_BUCKET, form: tuple = ()) -> str:
    """Registry key: op|n-bucket|dtype|backend[|engine][|prec:sig]
    [|lat:sig][|mesh:sig] — the reference's grammar and ordering — and
    last, for an op whose calls differ in form beyond their size
    (``dispatch.OpSpec.form_of``), ``|form:k=v,...``."""
    if backend is None:
        backend = default_backend()
    return (f"{op}|{bucket_cap(n, bucket)}|{dtype_name(dtype)}|{backend}"
            f"{_engine_tag(engine)}{_prec_tag(policy)}"
            f"{_lat_tag(objective)}{_mesh_tag(mesh)}{_form_tag(form)}")


# The split-word counts the compensated engines sweep when no policy
# pins one: hi+lo (~16-bit multiplicands) and hi+mid+lo (exact f32).
SPLIT_WORDS = (2, 3)


def candidate_plans(n: int, dtype, *, chains=CHAINS, blocks=BLOCK_ROWS,
                    m: int = DEFAULT_M, engine: Engine = None,
                    op: str = "reduce_sum",
                    policy: PolicyArg = None) -> Iterator[ReductionPlan]:
    """Enumerate the sweep space for one problem, off the op registry.

    Geometry-free engines give one candidate, ``('chain',)`` engines
    sweep R, ``('chain', 'block_rows')`` engines the R x B grid, and the
    compensated family also sweeps ``split_words`` over ``SPLIT_WORDS``
    unless ``policy`` pins a word count.  The reference pruned the grid
    by a TPU VMEM budget; the Hopper kernels stage no tile in shared
    memory, and what bounds a block there is its thread count
    (2 * block_rows <= 1024), so the grid keeps the ``block_rows`` the
    kernels take (``kernels.mma_reduce.block_rows_ok``) and, as in the
    reference, drops tiles that are strictly more padding than a
    smaller one.
    """
    from repro_torch.core import dispatch
    from repro_torch.kernels.mma_reduce import block_rows_ok
    spec = dispatch.op_spec(op)
    methods = _engine_methods(engine)
    for eng in spec.engines:
        if methods is not None and eng.name not in methods:
            continue
        if policy is None and methods is None \
                and "float32" not in eng.accum_dtypes:
            continue
        if policy is not None:
            if policy.split_words > eng.max_split_words:
                continue
            if dtype_name(policy.accum_dtype) not in eng.accum_dtypes:
                continue
        if "split_words" not in eng.sweep:
            words_opts = (ReductionPlan.split_words,)
        elif policy is not None and policy.split_words > 1:
            words_opts = (int(policy.split_words),)
        else:
            words_opts = SPLIT_WORDS
        if not eng.sweep:
            yield ReductionPlan(method=eng.name)
            continue
        # An engine that sweeps no chain (B7) runs one plan per
        # block_rows, at chain 1, as in the reference.
        eng_chains = chains if "chain" in eng.sweep else (1,)
        if "block_rows" not in eng.sweep:
            for chain in eng_chains:
                for words in words_opts:
                    yield ReductionPlan(method=eng.name, chain=chain, m=m,
                                        split_words=words)
            continue
        for words in words_opts:
            prev_tile = 0
            for chain in eng_chains:
                for block_rows in blocks:
                    if not block_rows_ok(block_rows):
                        continue
                    tile = chain * block_rows * m
                    if tile > max(n, 1) and prev_tile > max(n, 1):
                        continue  # strictly more padding than smaller
                    prev_tile = tile
                    yield ReductionPlan(method=eng.name, chain=chain,
                                        block_rows=block_rows, m=m,
                                        split_words=words)


# --------------------------------------------------------------- cost


def _cost_vpu(plan: ReductionPlan, n: int) -> float:
    # classic parallel reduction: log-depth + CUDA-core work.
    return theory.t_classic(n) * _STEP_US \
        + n / (_VPU_THROUGHPUT * _PARALLELISM)


def _cost_mma(plan: ReductionPlan, n: int) -> float:
    # one big contraction: two-MMA depth, full tensor-core work.
    return theory.t_tc(n, plan.m) * _STEP_US \
        + n / (_MXU_THROUGHPUT * _PARALLELISM)


def _grid(plan: ReductionPlan, n: int) -> float:
    # µs the kernel's blocks add beyond their loads, per wave of SMs.
    groups = max(1, math.ceil(n / (plan.chain * plan.block_rows * plan.m)))
    return _GRID_STEP_OVERHEAD * groups / _PARALLELISM


def _cost_chained(plan: ReductionPlan, n: int, *,
                  grid_walk: bool = False) -> float:
    # chained engines: PRAM depth + MMA work + block overheads + padding.
    tile = plan.chain * plan.block_rows * plan.m
    groups = max(1, math.ceil(n / tile))
    padded = groups * tile
    depth = theory.t_tc_chained(n, plan.m, plan.chain)
    oc = theory.op_count(padded, m=plan.m, chain=plan.chain,
                         variant=plan.variant)
    work = oc.mma_ops * plan.m * plan.m / (_MXU_THROUGHPUT * _PARALLELISM)
    grid = _grid(plan, n) if grid_walk else 0.0
    waste = (padded - n) / (_MXU_THROUGHPUT * _PARALLELISM)
    return depth * _STEP_US + work + grid + waste


def _cost_pallas(plan: ReductionPlan, n: int) -> float:
    # B1 (B3 at chain 1) launch kernels.mma_reduce.walk's blocks:
    # _WALK_BLOCK_US each a wave of SMs.  B2's levels (variant
    # recurrence) take one block per tile.
    if plan.variant == "recurrence":
        return _cost_chained(plan, n, grid_walk=True)
    from repro_torch.kernels.mma_reduce import walk
    chain = 1 if plan.variant == "split" else plan.chain
    grid, _ = walk(n, chain, plan.block_rows)
    return _cost_chained(plan, n) + _WALK_BLOCK_US * grid / _PARALLELISM


def _cost_ec(plan: ReductionPlan, n: int, *,
             grid_walk: bool = False) -> float:
    # Compensated split-bf16 engines: one ones-MMA chain per word (one
    # grid walk for all words in kernel B4), the split on the CUDA
    # cores (a cvt and a subtract per extra word, a cvt for the last:
    # 2w - 1 f32 ops per element), and the TwoSum combine: one 6-op
    # TwoSum per lane partial of w * n / (chain * m) and a log-depth
    # tree.
    w = max(int(plan.split_words), 1)
    base = w * _cost_chained(plan, n)
    grid = _grid(plan, n) if grid_walk else 0.0
    split = (2 * w - 1) * n / (_VPU_THROUGHPUT * _PARALLELISM)
    lanes = w * n / max(plan.chain * plan.m, 1)
    combine = 6.0 * lanes / (_VPU_THROUGHPUT * _PARALLELISM) \
        + math.log2(max(lanes, 2.0)) * _STEP_US
    return base + grid + split + combine


def _cost_dd(plan: ReductionPlan, n: int, *,
             grid_walk: bool = False) -> float:
    # Double-double engines, CUDA cores only on the card (B5, and the
    # plain twin adds its high words as a + b): n - 1 dd_adds of ~11
    # f32 ops each, and a pairwise merge tree of log2 n levels.
    carry = 11.0 * n / (_VPU_THROUGHPUT * _PARALLELISM)
    grid = _grid(plan, n) if grid_walk else 0.0
    return carry + math.log2(max(n, 2.0)) * _STEP_US + grid


# The scan family (ops ``scan`` and ``masked_cumsum``), in the shape of
# the reference's scan branches: the triangular-MMA depth
# ``theory.t_tc_scan`` and ``theory.op_count_scan``; the plain chained
# core's groups are ``chain`` rows of m, the kernel's ``chain *
# block_rows`` rows; the vpu work carries the reference's Hillis-Steele
# factor of log2(n) / 4 full-width passes.


def _cost_scan_vpu(plan: ReductionPlan, n: int) -> float:
    work = n / (_VPU_THROUGHPUT * _PARALLELISM) \
        * max(math.log2(max(n, 2.0)) / 4.0, 1.0)
    return theory.t_classic(n) * _STEP_US + work


def _cost_scan_chained(plan: ReductionPlan, n: int, *,
                       grid_walk: bool = False) -> float:
    tile = plan.chain * plan.m * (plan.block_rows if grid_walk else 1)
    groups = max(1, math.ceil(n / tile))
    padded = groups * tile
    depth = theory.t_tc_scan(n, plan.m, plan.chain)
    oc = theory.op_count_scan(padded, m=plan.m, chain=plan.chain,
                              variant=plan.variant)
    work = oc.mma_ops * plan.m * plan.m / (_MXU_THROUGHPUT * _PARALLELISM)
    grid = _grid(plan, n) if grid_walk else 0.0
    waste = (padded - n) / (_MXU_THROUGHPUT * _PARALLELISM)
    return depth * _STEP_US + work + grid + waste


def _cost_scan_ec(plan: ReductionPlan, n: int) -> float:
    # One triangular-MMA scan per bf16 word, the split (2w - 1 f32 ops
    # per element) and the TwoSum cascade (6 ops per element and extra
    # word).
    w = max(int(plan.split_words), 1)
    split = (2 * w - 1) * n / (_VPU_THROUGHPUT * _PARALLELISM)
    combine = 6.0 * (w - 1) * n / (_VPU_THROUGHPUT * _PARALLELISM)
    return w * _cost_scan_chained(plan, n) + split + combine


# Per-engine scoring — keyed, not branched, so the only place engine
# names select behaviour stays the dispatch registry.
_SCAN_COSTS = {
    "vpu": _cost_scan_vpu,
    "mma_chained": _cost_scan_chained,
    "mma_ec": _cost_scan_ec,
    "pallas": functools.partial(_cost_scan_chained, grid_walk=True),
}

_ENGINE_COSTS = {
    "vpu": _cost_vpu,
    "mma": _cost_mma,
    "mma_chained": _cost_chained,
    "mma_ec": _cost_ec,
    "pallas": _cost_pallas,
    "pallas_ec": functools.partial(_cost_ec, grid_walk=True),
    "mma_dd": _cost_dd,
    "pallas_dd": functools.partial(_cost_dd, grid_walk=True),
}

# The segment family (op ``segment_sum``).  The plan key carries no
# segment count, so the model prices S = _MEASURE_SEGMENTS.  ``mma``
# builds the (n, S) one-hot (one compare per entry) and contracts it in
# full f32 (one FMA per entry) on the CUDA cores; ``pallas`` (B7) moves
# its bytes once per pass (``_F32_OUT_BYTES``) and takes _B7_GROUP_US
# per group of 16 elements and 128-segment block beside them; ``vpu`` is
# one scatter add per element, plus _SEG_ATOMIC_US per element for the
# float atomics' contention on S addresses.


def _cost_segment_vpu(plan: ReductionPlan, n: int) -> float:
    return _cost_vpu(plan, n) + n * _SEG_ATOMIC_US


def _cost_segment_mma(plan: ReductionPlan, n: int) -> float:
    entries = n * _MEASURE_SEGMENTS
    return _cost_mma(plan, n) \
        + 2.0 * entries / (_VPU_THROUGHPUT * _PARALLELISM)


def _cost_segment_pallas(plan: ReductionPlan, n: int) -> float:
    groups = math.ceil(n / 16)
    blocks = math.ceil(_MEASURE_SEGMENTS / 128)
    return _B7_GROUP_US * groups * blocks + _grid(plan, n)


_SEGMENT_COSTS = {
    "vpu": _cost_segment_vpu,
    "mma": _cost_segment_mma,
    "pallas": _cost_segment_pallas,
}

# The norm_matmul family (op ``norm_matmul``), counted from the runners
# (``core.dispatch``); the call's form (``dispatch._norm_matmul_form``)
# says whether a projection follows the norm.  The norm's bytes per
# element of x (itemsize s): ``fused_pallas`` is B8, one launch that
# reads x once (a row tile's slice stays in a block's shared memory from
# the statistic to the scaling pass) and writes once, 2 s.
# ``unfused_mma`` squares x (reads x, writes 4), contracts the
# squares against ones (reads 4), multiplies x by rstd (reads x, writes
# 4), forms 1 + scale and multiplies (reads 4, writes 4): 28 bytes in
# f32; a 16-bit x adds its f32 copy and the cast back (s + 4 and 4 + s).
# ``vpu`` moves the same bytes, but with w given keeps the normalized
# rows in f32 (no cast back).  The projection, per (d, dout) weight and
# with a second one for the gate: each matmul reads the normalized rows
# (in x.dtype for unfused_mma, f32 for vpu) and the weight (vpu first
# writes and rereads an f32 copy of a 16-bit one, 8 bytes more), and
# does 2 d dout flops per row: on the tensor cores when unfused_mma
# multiplies 16-bit words, else in f32 on the CUDA cores (TF32 is off).
# The outputs: unfused_mma writes up in x.dtype, and a gate adds g, its
# activation and the product (read 2 s, write s each: 1 + 6 outputs'
# worth); vpu does the same in f32 and casts a 16-bit result (4 + s).
# A weight whose dtype is not x's (the form's ``w_dtype``, itemsize w):
# unfused_mma casts it to x's dtype first (reads w, writes s) and its
# matmul reads the cast (s); vpu reads an f32 weight as it is and makes
# an f32 copy of a 16-bit one (w + 8).  ``fused_pallas`` with w given is
# kernel B10 (its form from ``kernels.mma_norm_matmul.walk``): the row
# pass reads x and writes A's bf16 words where the form splits x, an f32
# weight's pass reads it and writes B's words, and the projections read
# both sides (the words, or the operand as it is) and write the output;
# its bytes go at _B10_BYTES_PER_US and its flops at _B10_FLOPS_PER_US
# for its form (x's and the weights' dtypes), the two added.  Not priced:
# a bias (one pass over the output in the
# unfused engines).  With w given a call costs its device time plus its
# host time (_NM_HOST_US): the unfused engines' first launches are
# small kernels that keep the card waiting on the host, and the matmuls
# come last, so at a decode step's 128 rows the two add up (the times
# phase 3h measured there are their sum, not the larger).  In f32 at
# prefill unfused_mma and vpu tie on the card and vpu's fewer launches
# decide.
_TC_FLOPS_PER_US = _MXU_THROUGHPUT * 2 * DEFAULT_M * _PARALLELISM
_F32_FLOPS_PER_US = 2 * _VPU_THROUGHPUT * _PARALLELISM
# Kernel B10's useful flops (2 rows d dout per projection) per µs of
# device time, by its form "x dtype/w dtype": it multiplies bf16 words on
# wgmma, six products a k step with f32 x and f32 weights, three with
# f32 x and bf16 weights, two where x is bf16.  Fitted, not from a data
# sheet: chip_smoke.py (phase 5f) times B10 at Gemma-2 2B's and
# DeepSeek-V3's MLP widths and fits these from its launches' device time
# (torch.profiler): at 4096 rows, flops over the device time the bytes
# leave; at 128 rows, the bytes (b10_bytes) over the device time the
# flops leave, summed over the cases (_B10_BYTES_PER_US).  These are the
# fits of one run on one H100 80GB HBM3 (700.00 W power limit), the
# byte rate's over the summed decode cases (its cases ranged 2.0e6 to
# 7.4e6: the sum of a byte time and a flop time is a crude model where
# the two overlap).
_B10_FLOPS_PER_US = {"float32/float32": 139.2e6,
                     "float32/bfloat16": 245.1e6,
                     "bfloat16/float32": 309.6e6,
                     "bfloat16/bfloat16": 337.2e6}
_B10_BYTES_PER_US = 3.37e6
# µs of host time one norm_matmul call with w given costs (Python, the
# casts' and the kernels' launches), whatever its size: chip_smoke.py
# (phase 5f) times each engine at 8 x 256 x 256 with a gelu gate, where
# the card's work is negligible, in f32, bf16, bf16 rows with f32
# weights and f32 rows with bf16 weights, and prints the fit; these are
# the means of its four values in the same run as B10's rates, on one
# H100 80GB HBM3 (700.00 W).  Runs on the same kind of machine fit
# values up to ~1.5x apart (the host the card shares); the order of the
# engines held.  The norm-only form is not priced so: B8 is one launch
# and the fewest bytes, and its picks are the card's.
_NM_HOST_US = {"fused_pallas": 79.6, "unfused_mma": 227.6, "vpu": 169.1}


def b10_bytes(n: int, x_dtype: str, w_dtype: str, form: dict) -> float:
    """The bytes kernel B10's passes move for n elements of x (the cost
    model's, and what phase 5f of chip_smoke.py fits its byte rate
    over): the row pass reads x and writes A's bf16 words where the form
    splits x, an f32 weight's pass reads it and writes B's words, each
    word is read once more by the projections (x itself where the form
    takes it as it is, a bf16 weight too), and the output is written."""
    from repro_torch.kernels.mma_norm_matmul import walk
    d, dout, mats = form["d"], form["dout"], 1 + form.get("gate", 0)
    itemsize = torch.empty((), dtype=as_dtype(x_dtype)).element_size()
    w_item = torch.empty((), dtype=as_dtype(w_dtype)).element_size()
    wk = walk(d, as_dtype(x_dtype), as_dtype(w_dtype))
    x_side = itemsize if wk.fold_w else 4 * wk.a_words
    w_side = w_item + (4 * wk.b_words if w_dtype == "float32" else 0)
    return n * (itemsize + x_side) + mats * d * dout * w_side \
        + n / d * dout * itemsize


def _cost_b10(n: int, x_dtype: str, w_dtype: str, form: dict) -> float:
    rate = _B10_FLOPS_PER_US.get(f"{x_dtype}/{w_dtype}")
    if rate is None:        # a dtype B10 does not take
        return math.inf
    mats = 1 + form.get("gate", 0)
    return b10_bytes(n, x_dtype, w_dtype, form) / _B10_BYTES_PER_US \
        + 2.0 * n * form["dout"] * mats / rate


def _cost_nm(plan: ReductionPlan, n: int, itemsize: int, dtype,
             form: dict) -> float:
    dout = form.get("dout", 0)
    w_dtype = form.get("w_dtype", dtype_name(dtype))
    w_item = torch.empty((), dtype=as_dtype(w_dtype)).element_size()
    if plan.method == "fused_pallas":
        if not dout:        # the norm-only form: kernel B8
            return 2.0 * itemsize * n / _HBM_BYTES_PER_US
        return _cost_b10(n, dtype_name(dtype), w_dtype, form)
    wide = itemsize >= 4
    vpu = plan.method == "vpu"
    norm = 28.0 if wide else 28.0 + 2.0 * (itemsize + 4.0)
    if dout and vpu and not wide:
        norm -= 4.0 + itemsize
    if not dout:
        return n * norm / _HBM_BYTES_PER_US
    d, mats = form["d"], 1 + form.get("gate", 0)
    rows_in = 4.0 if vpu else itemsize
    if vpu:
        weight = 4.0 if w_item >= 4 else w_item + 8.0
    else:
        weight = w_item if w_item == itemsize else w_item + 2.0 * itemsize
    outputs = rows_in * (1 + 6 * form.get("gate", 0)) \
        + (4.0 + itemsize if vpu and not wide else 0.0)
    nbytes = n * norm + mats * (n * rows_in + d * dout * weight) \
        + n / d * dout * outputs
    rate = _TC_FLOPS_PER_US if not (vpu or wide) else _F32_FLOPS_PER_US
    return nbytes / _HBM_BYTES_PER_US + 2.0 * n * dout * mats / rate


def _cost_norm_matmul(plan: ReductionPlan, n: int, itemsize: int, dtype,
                      form: dict) -> float:
    device = _cost_nm(plan, n, itemsize, dtype, form)
    if not form.get("dout", 0):
        return device
    return device + _NM_HOST_US[plan.method]


# The attention family (op ``attention``), counted from the runners
# (``core.dispatch``).  n is the score count B Sq KV G Sk; the call's form
# (``dispatch._attention_form``) gives the head dims hd / hd_v, the mask,
# ``rows`` = Sq G query rows per (batch, KV head) and ``sk`` keys, so n /
# sk query rows (read as q, written as o) and n / rows key rows (read as
# k and v).  Every engine reads q, k and v and writes o once.  ``vpu``
# (``_direct_attn``) also materialises the scores: per score element the
# q.k output (4 bytes) and its per-head stack (8), the scale (8), the mask
# (8), the softmax (12), its mask (8), the cast to v's dtype (4 + s_v) and
# p.v's read (s_v); a softcap adds three passes (24).  ``unfused_mma``
# (``_chunked_attn``) streams the same passes per chunk but keeps its
# running max, sum and correction (48 + 2 s_v, the cap 24), and updates
# its f32 accumulator once per chunk (p.v's output, its stack, the
# rescale and the add: 24 bytes per accumulator element and chunk).  With
# f32 queries beside a bf16 cache both widen each head's keys to f32
# (read, write and reread: 8 more bytes per key element).  Both do
# 2 (hd + hd_v) flops per score element, masked or not, each product on
# the tensor cores when both its operands are 16-bit, else in f32 on
# the CUDA cores (TF32 off).  Kernel B9 reads and writes the operands
# once and skips whole blocks past the causal / window band; its loads
# overlap its MMAs, so it costs the larger of its bytes at
# _B9_BYTES_PER_US (_B9_SYNC_BYTES_PER_US where ``walk`` sends the call
# to its mma.sync form) and its flops, 2 (hd + hd_v) per live score, at
# _B9_FLOPS_PER_US (_B9_DECODE_FLOPS_PER_US where ``walk`` sends it to
# the decode form).  A call also costs host time (_ATTN_HOST_US; for
# unfused_mma per chunk, at the plan's chunk).  Not priced: blocks B9
# skips past a dynamic kv_len (the model counts every slot).
# The fitted constants below come from chip_smoke.py (phase 5g) on one
# H100 80GB HBM3 (700 W), which prints their fit each run.  Kernel B9's
# useful flops per µs by its (q, kv) dtypes, fitted at Gemma-2 2B's
# prefill shapes as flops over time, the mean of the global (4096
# tokens) and local (8192) fits.  bf16 prefill runs on B9's wgmma form,
# f32 prefill on its f32 prefill form (48.83e6: 46.7e6 global, 51.0e6
# local; the mma.sync form it replaced fitted 14.17e6).  f32 q beside a
# bf16 cache runs on the mma.sync form only past 16 rows a head and keeps
# that form's f32 rate.
_B9_FLOPS_PER_US = {"float32": 48.83e6, "bfloat16": 255.1e6,
                    "float32/bfloat16": 14.17e6}
# With at most 16 rows a head B9 takes its decode form, whose work a key
# grows with the rows (q's words are the MMAs' columns, one warp a block
# runs the softmax of every row): at GLM-4 9B's step, 16 rows a KV head
# at hd 128 over the 32768-slot ring with f32 q, it runs at 34 % of its
# byte bound.  Fitted there as the model's flops (every slot) over time;
# at Gemma-2 2B's 2 rows a head the bytes price it (the flops at this
# rate take under a third of their time).
_B9_DECODE_FLOPS_PER_US = 39.34e6
# Bytes per µs B9's decode form streams (a bf16 cache; 128 slots, each
# row's keys in chunks of 2048 that blocks walk side by side), fitted as
# the model's bytes (every slot) over time where the rows read nearly
# all of the cache (the 4096-slot ring, the slowest decode case; 2.742e6
# and 2.752e6 with f32 and bf16 q): 82 % of the card's 3.35 TB/s.  Where
# the rows read about half of the cache (the 32768-slot ring at spread
# positions) B9 runs about twice as fast as this prices it (ROADMAP queue
# B item 10); the pick is B9 there all the same.  The mma.sync form it
# replaced at decode fitted 1.436e6.
_B9_BYTES_PER_US = 2.742e6
# ... and its mma.sync form at a decode step over an f32 cache, where one
# block walks a row's keys alone (Gemma-2 2B's local ring of 4096 f32
# slots), fitted the same way; vpu runs that step 1.35x faster than B9
# (the layer's time), and the model takes vpu there.
_B9_SYNC_BYTES_PER_US = 1.386e6
# µs of host time an attention call costs (Python, the context and plan
# lookup, the per-head bmms' and the elementwise ops' launches; for
# unfused_mma per chunk), fitted at a toy size (1 x 64 tokens, 4 KV
# heads of 2, hd 256), the means of the f32 and bf16 fits; they move
# ~1.5x from run to run with the host the card shares.
_ATTN_HOST_US = {"fused_pallas": 141.6, "unfused_mma": 1018.4, "vpu": 764.1}


def _attn_live_share(form: dict) -> float:
    """The share of scores B9 computes: under a causal mask over rows at
    the tail of the keys (prefill) with an optional window w, (w -
    w^2 / 2 Sk) / Sk of them; without one, every score."""
    sk = max(int(form.get("sk", 1)), 1)
    if not form.get("causal"):
        return 1.0
    w = min(int(form.get("window") or sk), sk)
    return (w - w * w / (2.0 * sk)) / sk


def _cost_attention(plan: ReductionPlan, n: int, itemsize: int, dtype,
                    form: dict) -> float:
    hd, hd_v = form.get("hd", 64), form.get("hd_v", form.get("hd", 64))
    sk = max(int(form.get("sk", math.isqrt(n))), 1)
    rows = max(int(form.get("rows", math.isqrt(n))), 1)
    q_name = dtype_name(dtype)
    kv_name = form.get("kv_dtype", q_name)
    kv_item = torch.empty((), dtype=as_dtype(kv_name)).element_size()
    io = n / sk * (hd * itemsize + hd_v * kv_item) \
        + n / rows * (hd + hd_v) * kv_item
    if plan.method == "fused_pallas":
        kind = q_name if kv_name == q_name else f"{q_name}/{kv_name}"
        rate = _B9_FLOPS_PER_US.get(kind)
        if rate is None:        # dtypes B9 does not take
            return math.inf
        from repro_torch.kernels.mma_attention import walk
        b9_form = walk(q_name, kv_name, rows, hd, hd_v)[0]
        if b9_form == "decode":
            rate = _B9_DECODE_FLOPS_PER_US
        flops = 2.0 * (hd + hd_v) * n * _attn_live_share(form)
        byte_rate = _B9_SYNC_BYTES_PER_US if b9_form == "mma_sync" \
            else _B9_BYTES_PER_US
        return max(io / byte_rate, flops / rate) \
            + _ATTN_HOST_US[plan.method]
    cap = 24.0 if form.get("cap") else 0.0
    nbytes = io + (n / rows * hd * 8.0 if kv_item < itemsize else 0.0)
    host = _ATTN_HOST_US[plan.method]
    if plan.method == "vpu":
        nbytes += n * (44.0 + 2.0 * kv_item + cap) + n / sk * hd_v * 8.0
    else:
        chunks = math.ceil(sk / max(plan.chain * plan.block_rows, 1))
        nbytes += n * (48.0 + 2.0 * kv_item + cap) \
            + chunks * n / sk * hd_v * 24.0
        host *= chunks
    qk_rate = _TC_FLOPS_PER_US if max(itemsize, kv_item) < 4 \
        else _F32_FLOPS_PER_US
    pv_rate = _TC_FLOPS_PER_US if kv_item < 4 else _F32_FLOPS_PER_US
    flops_us = 2.0 * n * (hd / qk_rate + hd_v / pv_rate)
    return nbytes / _HBM_BYTES_PER_US + flops_us + host


_FAMILY_COSTS = {"reduce": _ENGINE_COSTS, "scan": _SCAN_COSTS,
                 "segment": _SEGMENT_COSTS}

# Device-memory bytes an engine moves per element, counted from its
# runner (``core.dispatch``).  The reduce family's counts are per element
# of f32 input and scale by the input's itemsize over 4.  The kernels
# read their input once (4).  The plain engines run each step as its own
# PyTorch kernel, which streams its operands from device memory and
# writes its result back: ``mma`` writes a ones tensor and reads it
# beside x (12; squares read x twice, 8), ``vpu`` squares write and
# reread x * x (12), ``mma_chained`` writes and rereads its (n / 16) row
# sums (4.5; squares 12.5), ``mma_dd`` runs ~11 elementwise ops of 12
# bytes per output of its merge tree, n outputs in all, plus its lo
# plane (136; squares add the ~25 ops of the dd square, 436).
# ``mma_ec``: see ``_ec_bytes``.
_BYTES_PER_ELEMENT = {
    ("reduce_sum", "mma"): 12.0, ("squared_sum", "mma"): 8.0,
    ("squared_sum", "vpu"): 12.0,
    ("reduce_sum", "mma_chained"): 4.5, ("squared_sum", "mma_chained"): 12.5,
    ("reduce_sum", "mma_dd"): 136.0, ("squared_sum", "mma_dd"): 436.0,
}

# The scan and segment families write f32 whatever the input's dtype, so
# their bytes per element come in three parts: reads of the input (which
# scale with its itemsize), f32 bytes (which do not), and whether the
# runner first writes an f32 copy of a 16-bit input and rereads it
# (``_f32(x)`` / ``split_f32_words``: 8 more bytes).  Scans: ``vpu``
# reads x and writes the cumsum (1, 4, copy: 8 in f32, 14 in bf16),
# kernel B6 reads x once and writes once (1, 4: 8 / 6), ``mma_chained``
# reads x in its first matmul, writes P and builds the output in two
# elementwise adds over P (1, 20: 24 / 22); ``mma_ec`` see
# ``_scan_ec_bytes`` (its split starts from an f32 copy).  Segment sums
# read the values and int32 ids, which do not shrink: ``pallas`` (B7) the
# two once per pass of segments (1, 4: 8 / 6), ``vpu`` also writes and
# rereads an in-range flag and a slot index and adds an f32 copy of the
# values (1, 18, copy: 22 / 28), ``mma`` writes its bool compare and f32
# one-hot and rereads both, 9 bytes per entry, S = _MEASURE_SEGMENTS
# entries per element (1, 4 + 9 S).
_F32_OUT_BYTES = {
    ("scan", "vpu"): (1, 4.0, True), ("scan", "pallas"): (1, 4.0, False),
    ("scan", "mma_chained"): (1, 20.0, False),
    ("segment", "pallas"): (1, 4.0, False),
    ("segment", "vpu"): (1, 18.0, True),
    ("segment", "mma"): (1, 4.0 + 9.0 * _MEASURE_SEGMENTS, False),
}


def _ec_bytes(plan: ReductionPlan, op: str) -> float:
    # mma_ec's split: 24 bytes per extra word (cast to bf16, back to f32,
    # subtract), 6 for the last; 2.6 per word for its MMA chain and
    # 4.5 per word for the TwoSum tree over its lanes; squares +8.
    w = max(int(plan.split_words), 1)
    return 24.0 * (w - 1) + 6.0 + 7.1 * w + (8.0 if op == "squared_sum"
                                             else 0.0)


def _scan_ec_bytes(plan: ReductionPlan) -> float:
    # The split as for the reduce family (24 per extra word, 6 for the
    # last), a bf16 word's scan (reads 2, then as mma_chained: 22 per
    # word), the TwoSum cascade (seven f32 elementwise ops of 12 bytes
    # per extra word) and the final out + err with its zeroed err (16);
    # in f32, the input's one read (4) included.
    w = max(int(plan.split_words), 1)
    return 24.0 * (w - 1) + 6.0 + 22.0 * w + 84.0 * (w - 1) + 16.0


def _bytes_per_element(plan: ReductionPlan, op: str, family: str,
                       itemsize: int) -> float:
    """Device-memory bytes one element costs ``plan`` on an input of
    ``itemsize`` bytes."""
    if family == "reduce":
        per_f32 = _ec_bytes(plan, op) if plan.method == "mma_ec" \
            else _BYTES_PER_ELEMENT.get((op, plan.method), 4.0)
        return per_f32 * itemsize / 4.0
    if (family, plan.method) == ("scan", "mma_ec"):
        parts = (1, _scan_ec_bytes(plan) - 4.0, True)
    else:
        parts = _F32_OUT_BYTES[(family, plan.method)]
    reads, f32_bytes, copies = parts
    return reads * itemsize + f32_bytes \
        + (8.0 if copies and itemsize < 4 else 0.0)


# ------------------------------------------------------- error model

_EPS32 = 2.0 ** -24     # f32 unit roundoff
_BF16_BITS = 8          # bf16 significand bits (incl. implicit)
_INPUT_BITS = {"bfloat16": _BF16_BITS, "float16": 11}
_F32_BITS = 24
# The TwoSum-compensated engine family and the double-double family
# (keyed, like _ENGINE_COSTS, so engine names select no branch ladder).
_COMPENSATED = frozenset({"mma_ec", "pallas_ec"})
_DOUBLE_DOUBLE = frozenset({"mma_dd", "pallas_dd"})
# Significand bits each engine's multiplicands carry on Hopper: the
# plain matmuls run in full f32 (TF32 off), the kernels B1-B3 in
# TF32_WORDS TF32 words of 11 bits; None marks the split family, whose
# width is 8 bits per bf16 word.
# The norm_matmul family's roundings after the statistic, each up to
# eps32 relative: the square, / d, + eps, rsqrt (2 ulp, halved through
# the root: 1), x * rstd, 1 + scale and the scale's multiply.
_NM_EPILOGUE_ROUNDINGS = 6
# The attention family's roundings beside its sums, each up to eps32
# relative: the scale, the softcap's division, tanh and multiply, the
# exponent's subtraction and exp, the correction and the division by l.
_ATTN_ROUNDINGS = 8
_ENGINE_BITS = {"vpu": _F32_BITS, "mma": _F32_BITS,
                "mma_chained": _F32_BITS, "pallas": 11 * TF32_WORDS,
                "mma_ec": None, "pallas_ec": None}


def _multiplicand_bits(plan: ReductionPlan, dtype,
                       op: str = "reduce_sum", form: tuple = ()) -> int:
    """Effective significand bits the engine's multiplicands carry; a
    16-bit input caps every engine at its own width, and so does a
    16-bit cache beside the input (the form's ``kv_dtype``).  An op
    whose registry entry declares ``engine_bits`` overrides the table per
    engine (norm_matmul's ``unfused_mma``)."""
    from repro_torch.core import dispatch
    in_bits = min(_INPUT_BITS.get(dtype_name(dtype), _F32_BITS),
                  _INPUT_BITS.get(dict(form).get("kv_dtype"), _F32_BITS))
    over = dispatch.op_spec(op).engine_bits or {}
    eng_bits = over.get(plan.method,
                        _ENGINE_BITS.get(plan.method, _F32_BITS))
    if eng_bits is None:
        eng_bits = min(_BF16_BITS * max(int(plan.split_words), 1),
                       _F32_BITS)
    return min(in_bits, eng_bits)


def model_percent_error(plan: ReductionPlan, n: int, dtype,
                        op: str = "reduce_sum", form: tuple = ()) -> float:
    """Modelled % error vs the fp64 oracle — the reference's model: a
    representation term 2^-(bits+1) from the multiplicand width and an
    accumulation term, ~eps32 * sqrt(n) of random-walk rounding for the
    plain engines, ~eps32^2 * n plus one final rounding for the
    compensated family; the dd family carries no multiplicand
    truncation and ~log2(n) second-order terms, 2^-48 (4 + log2 n).
    The norm_matmul family adds its epilogue's roundings
    (``_NM_EPILOGUE_ROUNDINGS`` of eps32).  An attention output sums
    over one row's keys, not over all n scores: its accumulation term
    takes the larger of the call's Sk and hd (``form``) in n's place,
    and it adds the softmax's roundings (_ATTN_ROUNDINGS)."""
    from repro_torch.core import dispatch
    n = max(int(n), 1)
    if plan.method in _DOUBLE_DOUBLE:
        return 100.0 * (2.0 ** -48) * (4.0 + math.log2(n))
    rep = 2.0 ** -(_multiplicand_bits(plan, dtype, op, form) + 1)
    family = dispatch.op_spec(op).family
    if family == "attention":
        f = dict(form)
        n = max(int(f.get("sk", n)), int(f.get("hd", 1)), 1)
    if plan.method in _COMPENSATED:
        acc = _EPS32 * _EPS32 * n + 2.0 ** -25
    else:
        acc = _EPS32 * math.sqrt(n)
    if family == "norm_matmul":
        acc += _NM_EPILOGUE_ROUNDINGS * _EPS32
    if family == "attention":
        acc += _ATTN_ROUNDINGS * _EPS32
    return 100.0 * (rep + acc)


def measured_percent_error(plan: ReductionPlan, n: int, dtype, *,
                           op: str = "reduce_sum", seed: int = 0,
                           policy: PolicyArg = None,
                           backend: Optional[str] = None) -> float:
    """Measured % error vs the fp64 oracle for one plan on a uniform
    [0,1] probe of the bucket size (capped at 2^22), run on ``backend``.
    Reduce-family only: other families, and ops with their own
    measurement inputs, use the model."""
    from repro_torch.core import dispatch, precision
    spec = dispatch.op_spec(op)
    if spec.family != "reduce" or spec.measure is not None:
        return model_percent_error(plan, n, dtype, op=op)
    probe_n = min(max(int(n), 1), 1 << 22)
    x = torch.from_numpy(precision.uniform_input(probe_n, seed=seed)
                         .astype("float32"))
    x = x.to(backend or default_backend()).to(as_dtype(dtype))
    kw = {} if policy is None else {"policy": policy}
    got = precision.dd_value(execute_plan(x, plan, op=op, **kw))
    x64 = x.to("cpu", torch.float64).numpy()
    if op == "squared_sum":
        x64 = x64 ** 2
    return precision.percent_error(got, x64)


def model_cost(plan: ReductionPlan, n: int, dtype,
               op: str = "reduce_sum", form: tuple = ()) -> float:
    """Analytical score in µs: depth + work/P + block overheads +
    padding, plus the time the engine's device-memory traffic takes
    (``_bytes_per_element``: a kernel streams its input once, the plain
    engines' intermediate tensors go through memory too); a scan engine
    costs at least its host time per call, a norm_matmul engine with w
    given and an attention engine their host time on top.  The op's
    family (``dispatch.OpSpec.family``) picks the reduce, scan, segment,
    norm_matmul or attention terms (the last two: bytes and, for the
    products that ``form`` names, flops; ``_cost_nm``,
    ``_cost_attention``)."""
    from repro_torch.core import dispatch
    family = dispatch.op_spec(op).family
    n = max(int(n), 1)
    itemsize = torch.empty((), dtype=as_dtype(dtype)).element_size()
    if family == "norm_matmul":
        return _cost_norm_matmul(plan, n, itemsize, dtype, dict(form))
    if family == "attention":
        return _cost_attention(plan, n, itemsize, dtype, dict(form))
    mem = n * _bytes_per_element(plan, op, family, itemsize) \
        / _HBM_BYTES_PER_US
    device = _FAMILY_COSTS[family][plan.method](plan, n) + mem
    if family == "scan":
        return max(device, _SCAN_HOST_US[plan.method])
    return device


def _measure_problem(op: str, n: int, dtype, seed: int, device: str,
                     form: tuple = ()):
    """The op-representative timed problem (input + op kwargs) of the
    call's ``form``."""
    import numpy as np
    from repro_torch.core import dispatch
    spec = dispatch.op_spec(op)
    rng = np.random.default_rng(seed)
    if spec.measure is not None:
        return spec.measure(n, dtype, rng, device, **dict(form))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    kwargs = {}
    if spec.family == "segment":
        kwargs = {"segment_ids": torch.from_numpy(
            rng.integers(0, _MEASURE_SEGMENTS, n).astype(np.int32))
            .to(device), "num_segments": _MEASURE_SEGMENTS}
    return x.to(device).to(as_dtype(dtype)), kwargs


def combine_model_cost(mesh: MeshArg) -> float:
    """µs of the cross-rank scalar combine: one term per mesh axis above
    size 1, growing with log2 of its size, dearer on a slow axis
    (``distributed.collectives.SLOW_AXES``); 0 without a mesh.  The fast
    step is measured (gloo ranks sharing one card, see
    ``_PSUM_STEP_US``); the slow axis's factor is not, so a plan's cost
    over a ``pod`` axis holds an unmeasured term."""
    from repro_torch.distributed.collectives import SLOW_AXES
    axes = mesh_axes(mesh)
    if axes is None:
        return 0.0
    return sum((_PSUM_STEP_US_SLOW if name in SLOW_AXES else _PSUM_STEP_US)
               * math.log2(size) for name, size in axes if size > 1)


def _measure_mesh(mesh: MeshArg):
    """The live mesh a measured mesh sweep runs on: ``mesh`` itself,
    which every rank of it passes.  A signature or a tuple names no
    ranks and is refused: building a mesh here would start collectives
    (``new_group``) that the other ranks do not match."""
    from repro_torch import compat
    if isinstance(mesh, compat.Mesh):
        return mesh
    raise ValueError(
        f"cannot measure mesh {mesh_signature(mesh_axes(mesh))!r} plans "
        f"without a live mesh that every rank passes (compat.make_mesh); "
        f"use the analytical model (measure=False) or tune on the target "
        f"mesh")


def _mesh_max(value: float, mesh, device) -> float:
    """The largest ``value`` over the ranks of ``mesh``."""
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.float64, device=device)
    for name in mesh.axis_names:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(name))
    return float(t)


def _sharded_executor(plan: ReductionPlan, op: str, mesh, x, kwargs: dict):
    """The timed callable of a mesh-keyed measured sweep: every operand
    with x's leading dimension split over all the mesh's axes, this
    rank's block through ``execute_plan``, then the fast-before-slow
    scalar combine: the structure ``distributed.tc_collectives`` runs."""
    from repro_torch import compat
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import P
    names = mesh.axis_names
    if x.shape[0] % mesh_device_count(mesh):
        raise ValueError(
            f"measured-sweep problem of leading dim {x.shape[0]} does not "
            f"shard over {mesh_device_count(mesh)} ranks")
    arr_keys = tuple(k for k, v in kwargs.items()
                     if isinstance(v, torch.Tensor) and v.ndim >= 1
                     and v.shape[0] == x.shape[0])
    static = {k: v for k, v in kwargs.items() if k not in arr_keys}

    def body(xl, *arrs):
        partial = execute_plan(xl, plan, op=op, **static,
                               **dict(zip(arr_keys, arrs)))
        return coll.mesh_psum(partial, names, mesh=mesh)

    f = compat.shard_map(body, mesh=mesh,
                         in_specs=(P(names),) * (1 + len(arr_keys)),
                         out_specs=P())
    extras = tuple(kwargs[k] for k in arr_keys)
    return lambda v: f(v, *extras)


def measure_cost(plan: ReductionPlan, n: int, dtype, *, iters: int = 5,
                 warmup: int = 2, seed: int = 0,
                 op: str = "reduce_sum", mesh: MeshArg = None,
                 policy: PolicyArg = None,
                 backend: Optional[str] = None,
                 form: tuple = ()) -> float:
    """Microseconds for one plan on ``backend`` (default: the card when
    present): CUDA events around ``iters`` runs on the card, the host
    clock on the CPU.  Measuring for a backend this host lacks raises.
    With ``mesh`` (a live mesh, passed by every rank of it) the size-n
    problem is global: each rank times its block and the scalar combine
    (host clock), and every rank returns the largest time over the
    ranks."""
    if _NO_TIMING is not None:
        raise RuntimeError(
            f"{_NO_TIMING} takes its plans from the cost model alone: a "
            f"timed sweep of op {op!r} ({plan.method}, n={n}) would run")
    backend = backend or default_backend()
    if backend not in _live_backends():
        raise ValueError(f"cannot measure for backend {backend!r} on "
                         f"this host (live: {_live_backends()})")
    x, kwargs = _measure_problem(op, n, dtype, seed, backend, form)
    if policy is not None:
        kwargs = dict(kwargs, policy=policy)
    live = None
    if mesh_axes(mesh) is None:
        fn = lambda v: execute_plan(v, plan, op=op, **kwargs)  # noqa: E731
    else:
        live = _measure_mesh(mesh)
        fn = _sharded_executor(plan, op, live, x, kwargs)
    for _ in range(warmup):
        fn(x)
    if backend == "cuda" and live is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    if backend == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    if backend == "cuda":
        torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / iters * 1e6
    return us if live is None else _mesh_max(us, live, backend)


def execute_plan(x, plan: ReductionPlan, *, op: str = "reduce_sum",
                 **op_kwargs):
    """Run one problem under ``plan`` — the subsystem's one executor
    (``repro_torch.core.dispatch.execute``)."""
    from repro_torch.core import dispatch
    return dispatch.execute(op, x, plan, **op_kwargs)


# ----------------------------------------------------------- registry

# On-disk schema version: {"version": 1, "plans": {key: plan-dict}};
# the legacy bare {key: plan-dict} form still loads, a future version
# is refused.  The same format as the reference's.
SCHEMA_VERSION = 1


@contextlib.contextmanager
def _store_lock(path: str, shared: bool = False):
    """Advisory lock on ``<path>.lock`` serialising store writers."""
    if fcntl is None:  # pragma: no cover - non-POSIX host
        yield
        return
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _atomic_write(path: str, text: str) -> None:
    """Write-to-temp + ``os.replace``: readers never see a torn store."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = tempfile.NamedTemporaryFile(
        "w", dir=d, prefix=os.path.basename(path) + ".",
        suffix=".tmp", delete=False)
    try:
        with tmp:
            tmp.write(text)
            tmp.flush()
            os.fsync(tmp.fileno())
        os.replace(tmp.name, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp.name)
        raise


def _prefer_incoming(ours: ReductionPlan,
                     theirs: ReductionPlan) -> bool:
    """Merge rule: measured beats model; among equals, cheaper wins."""
    rank = {"model": 0, "measured": 1}
    ro, rt = rank.get(ours.source, 0), rank.get(theirs.source, 0)
    if rt != ro:
        return rt > ro
    return theirs.cost < ours.cost


class PlanRegistry:
    """Thread-safe in-memory plan cache over a shareable on-disk store
    (versioned JSON; ``save`` locks, merges the on-disk table in, and
    replaces the file atomically)."""

    def __init__(self, path: Optional[str] = None):
        self._plans: dict[str, ReductionPlan] = {}
        self._mu = threading.Lock()
        self.path = path
        # The plan ``dispatch``'s auto resolved per call context, so that
        # a repeated call skips the engine checks and the plan key (tens
        # of µs of host time, a tenth of a decode step's); emptied
        # whenever a plan changes.
        self.auto_memo: dict = {}
        # A ``SweepWorker`` that upgrades the model plans ``get_plan``
        # serves (None: no background sweeps).
        self.sweep_worker: Optional["SweepWorker"] = None

    def get(self, key: str) -> Optional[ReductionPlan]:
        return self._plans.get(key)

    def put(self, key: str, plan: ReductionPlan) -> None:
        with self._mu:
            self._plans[key] = plan
            self.auto_memo.clear()

    def items(self):
        with self._mu:
            return sorted(self._plans.items())

    def clear(self) -> None:
        with self._mu:
            self._plans.clear()
            self.auto_memo.clear()

    def __len__(self) -> int:
        return len(self._plans)

    def mesh_signatures(self) -> tuple:
        """Every distinct ``|mesh:`` signature keyed in the registry,
        sorted."""
        return tuple(sorted({key.rsplit("|mesh:", 1)[1]
                             for key, _ in self.items()
                             if "|mesh:" in key}))

    def invalidate_mesh(self, mesh: MeshArg) -> tuple:
        """Drop every plan keyed to mesh signature ``mesh`` (a signature
        string, or anything ``mesh_signature`` accepts): plans tuned for
        a dead mesh geometry must not serve another.  Returns the removed
        keys, sorted."""
        sig = mesh if isinstance(mesh, str) else mesh_signature(mesh)
        if not sig:
            return ()
        suffix = f"|mesh:{sig}"
        with self._mu:
            dead = sorted(k for k in self._plans if k.endswith(suffix))
            for k in dead:
                del self._plans[k]
            if dead:
                self.auto_memo.clear()
        return tuple(dead)

    def merge(self, other: "PlanRegistry") -> int:
        """Adopt ``other``'s entries per the merge rule; returns the
        number adopted."""
        adopted = 0
        for key, theirs in other.items():
            with self._mu:
                ours = self._plans.get(key)
                if ours is None or _prefer_incoming(ours, theirs):
                    self._plans[key] = theirs
                    self.auto_memo.clear()
                    adopted += 1
        return adopted

    def to_json(self) -> str:
        return json.dumps(
            {"version": SCHEMA_VERSION,
             "plans": {k: p.to_dict() for k, p in self.items()}},
            indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PlanRegistry":
        data = json.loads(text)
        if "version" in data or "plans" in data:
            version = data.get("version")
            if not isinstance(version, int):
                raise ValueError(
                    f"plan-store schema: 'plans' present but "
                    f"'version' is {version!r} (expected an int)")
            if version > SCHEMA_VERSION:
                raise ValueError(
                    f"plan store was written by schema version "
                    f"{version}, but this build reads at most "
                    f"{SCHEMA_VERSION}")
            table = data["plans"]
        else:
            table = data  # legacy bare {key: plan-dict} form
        reg = cls()
        for k, d in table.items():
            reg.put(k, ReductionPlan.from_dict(d))
        return reg

    def save(self, path: Optional[str] = None) -> None:
        """Atomically persist, merging the on-disk table in first."""
        path = path if path is not None else self.path
        if not path:
            raise ValueError(
                "PlanRegistry.save: no path given and none bound "
                "(pass path= or construct with PlanRegistry(path))")
        with _store_lock(path):
            if os.path.exists(path):
                self.merge(PlanRegistry.load(path))
            _atomic_write(path, self.to_json())
        self.path = self.path or path

    @classmethod
    def load(cls, path: str) -> "PlanRegistry":
        with open(path) as f:
            reg = cls.from_json(f.read())
        reg.path = path
        return reg

    def reload(self) -> int:
        """Merge the bound store file back into memory; returns the
        number of entries adopted (0 when unbound or absent)."""
        if not self.path or not os.path.exists(self.path):
            return 0
        with _store_lock(self.path, shared=True):
            disk = PlanRegistry.load(self.path)
        return self.merge(disk)


_default_registry: Optional[PlanRegistry] = None

# Why no timed sweep may run now (``model_plans_only``), or None.
_NO_TIMING: Optional[str] = None


def default_registry() -> PlanRegistry:
    """Process-wide registry; pre-seeded from $REPRO_AUTOTUNE_CACHE if
    that file exists (ship a tuned table, skip the sweep)."""
    global _default_registry
    if _default_registry is None:
        path = os.environ.get("REPRO_AUTOTUNE_CACHE", "")
        if path and os.path.exists(path):
            _default_registry = PlanRegistry.load(path)
        else:
            _default_registry = PlanRegistry()
    return _default_registry


@contextlib.contextmanager
def model_plans_only(what: str):
    """Inside, ``auto`` takes its plans from the cost model and the memo
    alone: the process-wide registry is a new one (no plan of a store,
    so no measured one, and no sweep worker), and a timed sweep
    (``measure_cost``: ``warmup(measure=True)``, a ``SweepWorker``, a
    measured ``get_plan``) raises, naming ``what``.  The dry run
    (``launch.dryrun``) runs on fake tensors, which a timing cannot
    take."""
    global _default_registry, _NO_TIMING
    old = _default_registry, _NO_TIMING
    _default_registry, _NO_TIMING = PlanRegistry(), what
    try:
        yield
    finally:
        _default_registry, _NO_TIMING = old


def bind_default_registry(path: str) -> PlanRegistry:
    """Bind the process-wide registry to a store file and merge it in."""
    reg = default_registry()
    reg.path = path
    reg.reload()
    return reg


def reset_default_registry() -> None:
    """Drop the process-wide cache (tests / re-tuning), closing any
    attached background sweep worker first."""
    global _default_registry
    if _default_registry is not None and \
            _default_registry.sweep_worker is not None:
        _default_registry.sweep_worker.close()
    _default_registry = None


# ----------------------------------------------------------- autotune


class SweepCancelled(RuntimeError):
    """Raised by ``autotune`` when its ``cancel`` predicate fires: how a
    background sweep worker abandons an in-flight measured sweep at a
    candidate boundary during shutdown."""


def autotune(n: int, dtype, *, op: str = "reduce_sum",
             measure: bool = False, chains=CHAINS, blocks=BLOCK_ROWS,
             m: int = DEFAULT_M, engine: Engine = None,
             mesh: MeshArg = None, policy: PolicyArg = None,
             objective: ObjectiveArg = None,
             bucket: BucketArg = DEFAULT_BUCKET,
             backend: Optional[str] = None,
             form: tuple = (), cancel=None,
             iters: int = 5) -> ReductionPlan:
    """Sweep the candidate space for one problem and return the winner.

    Scored at ``bucket_cap(n, bucket)`` by the model, or timed on
    ``backend`` when ``measure=True``, for a call of ``form``
    (``dispatch.OpSpec.form_of``).  A policy with an
    ``error_budget_pct`` makes the winner the fastest candidate within
    the budget (the most accurate one when none meets it); an
    ``objective`` makes it the most accurate candidate within the SLO
    (the fastest eligible one when none meets it) — the reference's
    selection rules.

    With ``mesh`` the size-n problem is global and the sweep tunes the
    local shard: candidates are enumerated and modelled at the shard's
    bucket (plus ``combine_model_cost``), or timed on ``mesh`` (then a
    live mesh that every rank of it passes) at the bucket rounded up to
    a multiple of the rank count, so that every shard is whole.  Every
    engine is legal there: the shard is a local tensor.
    """
    axes = mesh_axes(mesh)
    objective = as_objective(objective)
    nb = bucket_cap(n, bucket)
    need = mesh_device_count(axes)
    local = max(math.ceil(nb / need), 1)
    local_nb = nb if axes is None else bucket_cap(local, bucket)
    measure_nb = nb if axes is None else local * need
    combine = combine_model_cost(axes)
    live = None
    if measure and axes is not None:
        live = _measure_mesh(mesh)
    budget = None if policy is None else policy.error_budget_pct
    want_err = budget is not None or objective is not None
    best = fastest = fallback = None
    for cand in candidate_plans(local_nb, dtype, chains=chains,
                                blocks=blocks, m=m, engine=engine, op=op,
                                policy=policy):
        if cancel is not None and cancel():
            raise SweepCancelled(
                f"autotune sweep for op={op!r} n={n} cancelled")
        if measure:
            cost = measure_cost(cand, measure_nb, dtype, iters=iters, op=op,
                                mesh=live, policy=policy, backend=backend,
                                form=form)
            cand = dataclasses.replace(cand, source="measured", cost=cost)
        else:
            cost = model_cost(cand, local_nb, dtype, op=op,
                              form=form) + combine
            cand = dataclasses.replace(cand, source="model", cost=cost)
        if objective is not None:
            cand = dataclasses.replace(
                cand, latency_ms=cost * _MODEL_UNIT_US / 1e3)
        if want_err:
            err = (measured_percent_error(cand, local_nb, dtype, op=op,
                                          policy=policy, backend=backend)
                   if measure else
                   model_percent_error(cand, local_nb, dtype, op=op,
                                       form=form))
            if live is not None:
                err = _mesh_max(err, live, backend or default_backend())
            cand = dataclasses.replace(cand, error_pct=err)
            if fallback is None or err < fallback.error_pct:
                fallback = cand
            if budget is not None and err > budget:
                continue
        if fastest is None or cand.cost < fastest.cost:
            fastest = cand
        if objective is None:
            continue
        if cand.latency_ms <= objective.latency_slo_ms and \
                (best is None or cand.error_pct < best.error_pct):
            best = cand
    best = best or fastest or fallback
    if best is None:
        raise ValueError(f"no reduction candidates for engine={engine!r}")
    return best


def get_plan(n: int, dtype, *, op: str = "reduce_sum",
             backend: Optional[str] = None,
             registry: Optional[PlanRegistry] = None,
             measure: bool = False, engine: Engine = None,
             mesh: MeshArg = None, policy: PolicyArg = None,
             objective: ObjectiveArg = None,
             bucket: BucketArg = DEFAULT_BUCKET,
             form: tuple = ()) -> ReductionPlan:
    """Cached plan lookup — the entry point of ``method='auto'``.

    A registry hit is returned (a model entry is re-tuned when
    ``measure=True`` asks for timings); a miss is tuned once for its key
    and cached.  ``backend`` (default: the card when present) is part of
    the key; measuring for a backend this host lacks raises.  A miss
    never waits for a measured sweep: the model's winner is returned at
    once, and when the registry has a ``sweep_worker`` attached the key
    is queued for a measured sweep off the hot path.
    """
    backend = backend or default_backend()
    reg = registry if registry is not None else default_registry()
    key = plan_key(op, n, dtype, backend, engine, mesh, policy,
                   objective, bucket, form)
    plan = reg.get(key)
    if plan is None or (measure and plan.source != "measured"):
        if measure and backend not in _live_backends():
            raise ValueError(
                f"cannot measure for backend {backend!r} on this host "
                f"(live: {_live_backends()}); use the analytical model "
                f"(measure=False) or tune on the target hardware")
        plan = autotune(n, dtype, op=op, measure=measure, engine=engine,
                        mesh=mesh, policy=policy, objective=objective,
                        bucket=bucket, backend=backend, form=form)
        reg.put(key, plan)
    if plan.source != "measured" and reg.sweep_worker is not None \
            and backend in _live_backends():
        reg.sweep_worker.submit(
            key, dict(n=n, dtype=dtype, op=op, engine=engine, mesh=mesh,
                      policy=policy, objective=objective, bucket=bucket,
                      backend=backend, form=form))
    return plan


# ------------------------------------------- warmup & background sweeps


def warmup(ops, shapes, *, dtype=None, registry=None, measure=False,
           backend=None, engine=None, mesh=None, policy=None,
           objective=None, bucket=DEFAULT_BUCKET, form: tuple = ()) -> dict:
    """Pre-resolve the serving hot set so live traffic never tunes.

    ``ops`` is an op name or an iterable of them; ``shapes`` an iterable
    of sizes or ``(n, dtype)`` pairs (``dtype``, default float32, covers
    bare sizes).  Each (op, shape) is resolved through ``get_plan`` under
    the bucket policy, so shapes that share a bucket cap tune once.
    Returns ``{"resolved", "tuned", "keys"}``: ``tuned`` counts the
    registry misses.
    """
    reg = registry if registry is not None else default_registry()
    base_dtype = torch.float32 if dtype is None else dtype
    if isinstance(ops, str):
        ops = (ops,)
    tuned = 0
    keys: dict[str, None] = {}
    for op in ops:
        for shape in shapes:
            n, dt = shape if isinstance(shape, tuple) \
                else (shape, base_dtype)
            key = plan_key(op, n, dt, backend, engine, mesh, policy,
                           objective, bucket, form)
            if reg.get(key) is None:
                tuned += 1
            get_plan(n, dt, op=op, backend=backend, registry=reg,
                     measure=measure, engine=engine, mesh=mesh,
                     policy=policy, objective=objective, bucket=bucket,
                     form=form)
            keys[key] = None
    return {"resolved": len(keys), "tuned": tuned, "keys": tuple(keys)}


class SweepWorker:
    """Background measured-sweep upgrader for model-cost plans.

    ``get_plan`` serves a miss from the cost model at once and, with a
    worker attached (``registry.sweep_worker = worker``), submits the key
    here; the worker re-tunes it with ``measure=True`` on its own thread
    and puts the measured winner into the registry (``put`` clears the
    registry's ``auto_memo`` under its lock).  The worker's queue gets
    are timed, so it re-checks its stop event; a submit never blocks (a
    full queue drops the upgrade, which the next serve of the model plan
    submits again); ``close()`` sets the stop event, drains the queue and
    joins with a timeout, and a sweep in flight stops at its next
    candidate (``SweepCancelled``), so a shutdown never deadlocks.

    On the card the worker times on the same device as the caller, so
    its timings include whatever else runs there.
    """

    def __init__(self, registry=None, *, max_pending: int = 256,
                 iters: int = 3, poll_s: float = 0.1):
        self._registry = registry
        self._iters = iters
        self._poll_s = poll_s
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._stop = threading.Event()
        self._inflight: set[str] = set()
        self._mu = threading.Lock()
        self.upgraded = 0
        self.failed = 0
        self._thread = threading.Thread(
            target=self._run, name="autotune-sweep", daemon=True)
        self._thread.start()

    def _reg(self) -> PlanRegistry:
        return self._registry if self._registry is not None \
            else default_registry()

    def submit(self, key: str, spec: dict) -> bool:
        """Queue ``key`` for a measured upgrade (non-blocking; a key in
        flight is not queued twice).  ``spec`` holds the ``autotune``
        arguments of the model plan.  Returns whether it was queued.  A
        mesh key (``|mesh:``) is not: its sweep is collective, every
        rank of the mesh at once, which one rank's thread cannot run."""
        if self._stop.is_set() or "|mesh:" in key:
            return False
        with self._mu:
            if key in self._inflight:
                return False
            self._inflight.add(key)
        try:
            self._q.put_nowait((key, spec))
            return True
        except queue.Full:
            with self._mu:
                self._inflight.discard(key)
            return False

    def pending(self) -> int:
        with self._mu:
            return len(self._inflight)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait until every submitted key was swept or ``timeout_s``
        passed; returns whether none is left."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self.pending():
                return True
            time.sleep(self._poll_s / 2)
        return not self.pending()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                key, spec = self._q.get(timeout=self._poll_s)
            except queue.Empty:
                continue
            try:
                reg = self._reg()
                current = reg.get(key)
                if current is not None and current.source == "measured":
                    continue            # a peer already upgraded it
                spec = dict(spec)
                n, dtype = spec.pop("n"), spec.pop("dtype")
                plan = autotune(n, dtype, measure=True, iters=self._iters,
                                cancel=self._stop.is_set, **spec)
                reg.put(key, plan)
                self.upgraded += 1
            except SweepCancelled:
                pass    # shutdown raced the sweep; the model plan serves
            except Exception:  # noqa: BLE001 - the worker must keep running
                # A failed sweep (a problem this host cannot time) keeps
                # the model plan serving; ``failed`` reports it.
                self.failed += 1
            finally:
                with self._mu:
                    self._inflight.discard(key)

    def close(self, timeout_s: float = 5.0) -> None:
        """Idempotent shutdown: stop, drain the queue, join."""
        self._stop.set()
        while True:
            try:
                key, _ = self._q.get_nowait()
            except queue.Empty:
                break
            with self._mu:
                self._inflight.discard(key)
        self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "SweepWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
