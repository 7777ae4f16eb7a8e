"""Reduction autotuner: pick (method, variant, chain, block_rows) per
problem, the way the paper picks (R, B) per GPU geometry — the
counterpart of ``repro.core.autotune`` for the reduce family.

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
  * ``get_plan`` is the one-call entry of ``method='auto'``.

Mesh-keyed plans keep their key grammar (``|mesh:``) so stored tables
round-trip, but tuning one waits for the distributed slice of the port:
``autotune`` refuses a multi-device mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
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
# µs a thread block adds that its loads do not hide: launch and
# retirement, ~200 cycles at 1.98 GHz.  An estimate, not yet fitted to
# timings on the card (ROADMAP.md queue C); measured sweeps replace the
# model.
_GRID_STEP_OVERHEAD = 0.1
# µs per PRAM step of the paper's depth formulas: one dependent MMA or
# shuffle, ~30 cycles at 1.98 GHz.
_STEP_US = 0.015
# Device-memory bytes per µs: 3.35 TB/s.
_HBM_BYTES_PER_US = 3.35e6


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


def _mesh_tag(mesh: MeshArg) -> str:
    sig = mesh_signature(mesh)
    return f"|mesh:{sig}" if sig else ""


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
             bucket: BucketArg = DEFAULT_BUCKET) -> str:
    """Registry key: op|n-bucket|dtype|backend[|engine][|prec:sig]
    [|lat:sig][|mesh:sig] — the reference's grammar and ordering."""
    if backend is None:
        backend = default_backend()
    return (f"{op}|{bucket_cap(n, bucket)}|{dtype_name(dtype)}|{backend}"
            f"{_engine_tag(engine)}{_prec_tag(policy)}"
            f"{_lat_tag(objective)}{_mesh_tag(mesh)}")


def candidate_plans(n: int, dtype, *, chains=CHAINS, blocks=BLOCK_ROWS,
                    m: int = DEFAULT_M, engine: Engine = None,
                    op: str = "reduce_sum",
                    policy: PolicyArg = None) -> Iterator[ReductionPlan]:
    """Enumerate the sweep space for one problem, off the op registry.

    Geometry-free engines give one candidate, ``('chain',)`` engines
    sweep R, ``('chain', 'block_rows')`` engines the R x B grid.  The
    reference pruned the grid by a TPU VMEM budget; the Hopper kernels
    stage no tile in shared memory, and what bounds a block there is
    its thread count (2 * block_rows <= 1024), so the grid keeps the
    ``block_rows`` the kernels take (``kernels.mma_reduce.
    block_rows_ok``) and, as in the reference, drops tiles that are
    strictly more padding than a smaller one.
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
        if not eng.sweep:
            yield ReductionPlan(method=eng.name)
            continue
        if "block_rows" not in eng.sweep:
            for chain in chains:
                yield ReductionPlan(method=eng.name, chain=chain, m=m)
            continue
        prev_tile = 0
        for chain in chains:
            for block_rows in blocks:
                if not block_rows_ok(block_rows):
                    continue
                tile = chain * block_rows * m
                if tile > max(n, 1) and prev_tile > max(n, 1):
                    continue  # strictly more padding than smaller
                prev_tile = tile
                yield ReductionPlan(method=eng.name, chain=chain,
                                    block_rows=block_rows, m=m)


# --------------------------------------------------------------- cost


def _cost_vpu(plan: ReductionPlan, n: int) -> float:
    # classic parallel reduction: log-depth + CUDA-core work.
    return theory.t_classic(n) * _STEP_US \
        + n / (_VPU_THROUGHPUT * _PARALLELISM)


def _cost_mma(plan: ReductionPlan, n: int) -> float:
    # one big contraction: two-MMA depth, full tensor-core work.
    return theory.t_tc(n, plan.m) * _STEP_US \
        + n / (_MXU_THROUGHPUT * _PARALLELISM)


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
    grid = _GRID_STEP_OVERHEAD * groups / _PARALLELISM if grid_walk else 0.0
    waste = (padded - n) / (_MXU_THROUGHPUT * _PARALLELISM)
    return depth * _STEP_US + work + grid + waste


# Per-engine scoring — keyed, not branched, so the only place engine
# names select behaviour stays the dispatch registry.
_ENGINE_COSTS = {
    "vpu": _cost_vpu,
    "mma": _cost_mma,
    "mma_chained": _cost_chained,
    "pallas": functools.partial(_cost_chained, grid_walk=True),
}


# ------------------------------------------------------- error model

_EPS32 = 2.0 ** -24     # f32 unit roundoff
_INPUT_BITS = {"bfloat16": 8, "float16": 11}
_F32_BITS = 24
# Significand bits each engine's multiplicands carry on Hopper: the
# plain matmuls run in full f32 (TF32 off), the kernels in TF32_WORDS
# TF32 words of 11 bits.
_ENGINE_BITS = {"vpu": _F32_BITS, "mma": _F32_BITS,
                "mma_chained": _F32_BITS, "pallas": 11 * TF32_WORDS}


def model_percent_error(plan: ReductionPlan, n: int, dtype,
                        op: str = "reduce_sum") -> float:
    """Modelled % error vs the fp64 oracle: a representation term
    2^-(bits+1) from the multiplicand width and an accumulation term
    ~eps32 * sqrt(n) — the reference's model for the plain engines."""
    n = max(int(n), 1)
    bits = min(_INPUT_BITS.get(dtype_name(dtype), _F32_BITS),
               _ENGINE_BITS.get(plan.method, _F32_BITS))
    return 100.0 * (2.0 ** -(bits + 1) + _EPS32 * math.sqrt(n))


def measured_percent_error(plan: ReductionPlan, n: int, dtype, *,
                           op: str = "reduce_sum", seed: int = 0,
                           policy: PolicyArg = None,
                           backend: Optional[str] = None) -> float:
    """Measured % error vs the fp64 oracle for one plan on a uniform
    [0,1] probe of the bucket size (capped at 2^22), run on ``backend``.
    Ops with their own measurement inputs use the model."""
    from repro_torch.core import dispatch, precision
    spec = dispatch.op_spec(op)
    if spec.measure is not None:
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
               op: str = "reduce_sum") -> float:
    """Analytical score in µs: depth + work/P + block overheads +
    padding, plus the time to stream the input once from device memory
    (every engine pays it; it anchors the estimate to the card)."""
    n = max(int(n), 1)
    itemsize = torch.empty((), dtype=as_dtype(dtype)).element_size()
    mem = n * itemsize / _HBM_BYTES_PER_US
    return _ENGINE_COSTS[plan.method](plan, n) + mem


def _measure_problem(op: str, n: int, dtype, seed: int, device: str):
    """The op-representative timed problem (input + op kwargs)."""
    import numpy as np
    from repro_torch.core import dispatch
    spec = dispatch.op_spec(op)
    rng = np.random.default_rng(seed)
    if spec.measure is not None:
        return spec.measure(n, dtype, rng, device)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x.to(device).to(as_dtype(dtype)), {}


def measure_cost(plan: ReductionPlan, n: int, dtype, *, iters: int = 5,
                 warmup: int = 2, seed: int = 0,
                 op: str = "reduce_sum", mesh: MeshArg = None,
                 policy: PolicyArg = None,
                 backend: Optional[str] = None) -> float:
    """Microseconds for one plan on ``backend`` (default: the card when
    present): CUDA events around ``iters`` runs on the card, the host
    clock on the CPU.  Measuring for a backend this host lacks raises."""
    if mesh_axes(mesh) is not None:
        raise NotImplementedError(
            "mesh-keyed plans are tuned in the distributed slice")
    backend = backend or default_backend()
    if backend not in _live_backends():
        raise ValueError(f"cannot measure for backend {backend!r} on "
                         f"this host (live: {_live_backends()})")
    x, kwargs = _measure_problem(op, n, dtype, seed, backend)
    if policy is not None:
        kwargs = dict(kwargs, policy=policy)
    for _ in range(warmup):
        execute_plan(x, plan, op=op, **kwargs)
    if backend == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            execute_plan(x, plan, op=op, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        execute_plan(x, plan, op=op, **kwargs)
    return (time.perf_counter() - t0) / iters * 1e6


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

    def get(self, key: str) -> Optional[ReductionPlan]:
        return self._plans.get(key)

    def put(self, key: str, plan: ReductionPlan) -> None:
        with self._mu:
            self._plans[key] = plan

    def items(self):
        with self._mu:
            return sorted(self._plans.items())

    def clear(self) -> None:
        with self._mu:
            self._plans.clear()

    def __len__(self) -> int:
        return len(self._plans)

    def merge(self, other: "PlanRegistry") -> int:
        """Adopt ``other``'s entries per the merge rule; returns the
        number adopted."""
        adopted = 0
        for key, theirs in other.items():
            with self._mu:
                ours = self._plans.get(key)
                if ours is None or _prefer_incoming(ours, theirs):
                    self._plans[key] = theirs
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


def bind_default_registry(path: str) -> PlanRegistry:
    """Bind the process-wide registry to a store file and merge it in."""
    reg = default_registry()
    reg.path = path
    reg.reload()
    return reg


def reset_default_registry() -> None:
    """Drop the process-wide cache (tests / re-tuning)."""
    global _default_registry
    _default_registry = None


# ----------------------------------------------------------- autotune


def autotune(n: int, dtype, *, op: str = "reduce_sum",
             measure: bool = False, chains=CHAINS, blocks=BLOCK_ROWS,
             m: int = DEFAULT_M, engine: Engine = None,
             mesh: MeshArg = None, policy: PolicyArg = None,
             objective: ObjectiveArg = None,
             bucket: BucketArg = DEFAULT_BUCKET,
             backend: Optional[str] = None) -> ReductionPlan:
    """Sweep the candidate space for one problem and return the winner.

    Scored at ``bucket_cap(n, bucket)`` by the model, or timed on
    ``backend`` when ``measure=True``.  A policy with an
    ``error_budget_pct`` makes the winner the fastest candidate within
    the budget (the most accurate one when none meets it); an
    ``objective`` makes it the most accurate candidate within the SLO
    (the fastest eligible one when none meets it) — the reference's
    selection rules.
    """
    if mesh_axes(mesh) is not None:
        raise NotImplementedError(
            "mesh-keyed plans are tuned in the distributed slice")
    objective = as_objective(objective)
    nb = bucket_cap(n, bucket)
    budget = None if policy is None else policy.error_budget_pct
    want_err = budget is not None or objective is not None
    best = fastest = fallback = None
    for cand in candidate_plans(nb, dtype, chains=chains, blocks=blocks,
                                m=m, engine=engine, op=op,
                                policy=policy):
        if measure:
            cost = measure_cost(cand, nb, dtype, op=op, policy=policy,
                                backend=backend)
            cand = dataclasses.replace(cand, source="measured", cost=cost)
        else:
            cost = model_cost(cand, nb, dtype, op=op)
            cand = dataclasses.replace(cand, source="model", cost=cost)
        if objective is not None:
            cand = dataclasses.replace(
                cand, latency_ms=cost * _MODEL_UNIT_US / 1e3)
        if want_err:
            err = (measured_percent_error(cand, nb, dtype, op=op,
                                          policy=policy, backend=backend)
                   if measure else
                   model_percent_error(cand, nb, dtype, op=op))
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
             bucket: BucketArg = DEFAULT_BUCKET) -> ReductionPlan:
    """Cached plan lookup — the entry point of ``method='auto'``.

    A registry hit is returned (a model entry is re-tuned when
    ``measure=True`` asks for timings); a miss is tuned once for its key
    and cached.  ``backend`` (default: the card when present) is part of
    the key; measuring for a backend this host lacks raises.
    """
    backend = backend or default_backend()
    reg = registry if registry is not None else default_registry()
    key = plan_key(op, n, dtype, backend, engine, mesh, policy,
                   objective, bucket)
    plan = reg.get(key)
    if plan is None or (measure and plan.source != "measured"):
        if measure and backend not in _live_backends():
            raise ValueError(
                f"cannot measure for backend {backend!r} on this host "
                f"(live: {_live_backends()}); use the analytical model "
                f"(measure=False) or tune on the target hardware")
        plan = autotune(n, dtype, op=op, measure=measure, engine=engine,
                        mesh=mesh, policy=policy, objective=objective,
                        bucket=bucket, backend=backend)
        reg.put(key, plan)
    return plan
