"""The TC-op registry: one declarative dispatch layer for the reduce
family — the counterpart of ``repro.core.dispatch`` for this slice.

Each op (``reduce_sum``, ``squared_sum``, ``masked_mean``,
``expert_counts``) is an :class:`OpSpec` declaring its engines
(:class:`EngineSpec`, each with a ``run(x, plan, **op_kwargs)``
callable and capability flags), a plain reference oracle, and the
autotuner hooks.  The engines keep the reference's spellings:

  * ``'mma'``          one f32-accumulated ones-contraction (matmul),
                       axis-aware, distribution-safe;
  * ``'mma_chained'``  the paper-structured ``tc_reduce`` core;
  * ``'pallas'``       the hand-written Hopper kernels B1-B3
                       (``repro_torch.kernels``) — the name is kept so
                       plan keys and configs carry across packages;
  * ``'vpu'``          the classic f32 sum, the baseline.

``dispatch(op, x, method=..., **op_kwargs)`` is the one entry point of
the framework hooks: an explicit method is capability-checked (an
illegal or undeclared engine raises ``ValueError`` naming the reason),
``'auto'`` runs the autotuner's plan for the legal engines through
``execute``.  The compensated (``_ec``) and double-double (``_dd``)
engines are not registered yet, so naming one raises like any
undeclared engine.

Device rule: a ``torch.Tensor`` runs on its own device (a CPU tensor is
how a caller asks for the CPU); a numpy array or Python scalar goes to
the card, and with no card the call raises instead of running on the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.precision import (ACCUM_DTYPE, MmaPolicy, as_dtype,
                                        as_policy, dtype_name)


def as_tensor(x) -> torch.Tensor:
    """The device rule: tensors stay where they are; anything else goes
    to the card, or raises when there is none."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card unless given "
            "CPU tensors (pass a torch.Tensor on the CPU to run there)")
    return torch.as_tensor(np.asarray(x)).to("cuda")


# ------------------------------------------------------------- context


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """The static facts one dispatch decision is made from."""
    op: str
    shape: tuple
    dtype: str
    multi_device: bool
    axis: Optional[tuple] = None    # reduced-axis subset, None = all
    mesh_axes: Optional[tuple] = None  # None on a single device
    policy: Optional[MmaPolicy] = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def axis_subset(self) -> bool:
        """True when only *some* axes are reduced (batched reduction)."""
        return self.axis is not None and len(self.axis) < self.ndim


def _live_mesh_axes() -> Optional[tuple]:
    """The ambient multi-device mesh: None on one card (the port's
    distributed slice will read its process group here)."""
    return None


# -------------------------------------------------------------- engines


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One execution engine of an op, with declarative capabilities:
    ``sweep`` names the plan knobs the autotuner enumerates, the flags
    are evaluated by :func:`capability_reason`."""
    name: str
    run: Callable
    multi_device_safe: bool = False
    axis_subsets: bool = False      # batched reductions (axis=...)
    ndim: Optional[int] = None      # exact input rank, None = any
    sweep: tuple = ()               # of 'chain' / 'block_rows'
    max_split_words: int = 1        # split-bf16 words the engine runs
    accum_dtypes: tuple = ("float32",)  # accumulators it can honour


def capability_reason(eng: EngineSpec, ctx: DispatchContext, *,
                      env: bool = True) -> Optional[str]:
    """Why ``eng`` cannot serve ``ctx`` — or None when it can.
    ``env=False`` skips the multi-device predicate (the executor's
    structural check of an already-chosen plan)."""
    if env and ctx.multi_device and not eng.multi_device_safe:
        return ("not distribution-safe: flatten-and-pad forces a "
                "re-layout of sharded operands under a live "
                "multi-device mesh")
    if ctx.axis_subset and not eng.axis_subsets:
        return "flatten-only engine: no axis-subset (batched) support"
    if eng.ndim is not None and ctx.ndim != eng.ndim:
        return f"requires an ndim == {eng.ndim} input"
    return _policy_reason(eng, ctx.policy)


def _policy_reason(eng: EngineSpec,
                   policy: Optional[MmaPolicy]) -> Optional[str]:
    """Why ``eng`` cannot honour ``policy`` — or None when it can."""
    if policy is None:
        if "float32" not in eng.accum_dtypes:
            return ("double-word engine: returns a (hi, lo) dd pair, "
                    "not the default f32 scalar — request it with an "
                    "explicit MmaPolicy(accum_dtype=torch.float64)")
        return None
    acc = dtype_name(policy.accum_dtype)
    if acc not in eng.accum_dtypes:
        return (f"cannot honour accum_dtype={acc} (engine "
                f"accumulates in {eng.accum_dtypes})")
    if policy.split_words > eng.max_split_words:
        return (f"cannot honour split_words={policy.split_words}: "
                f"the engine runs at most {eng.max_split_words} "
                f"multiplicand word(s) — use the mma_ec family")
    return None


# ------------------------------------------------------------------ ops


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One registered TC-op: its ordered engines, the plain reference
    oracle, and the autotuner's measurement-input builder."""
    name: str
    engines: tuple                  # tuple[EngineSpec, ...]
    reference: Callable
    measure: Optional[Callable] = None   # (n, dtype, rng, device) -> (x, kw)

    def engine(self, name: str) -> Optional[EngineSpec]:
        for eng in self.engines:
            if eng.name == name:
                return eng
        return None

    def engine_names(self) -> tuple:
        return tuple(e.name for e in self.engines)


_REGISTRY: dict[str, OpSpec] = {}


def register(spec: OpSpec) -> OpSpec:
    """Add (or replace) one op in the registry."""
    _REGISTRY[spec.name] = spec
    return spec


def ops() -> tuple:
    """Registered op names, sorted."""
    return tuple(sorted(_REGISTRY))


def op_spec(name: str) -> OpSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown TC-op {name!r}; registered: {', '.join(ops())}")
    return spec


def build_context(op: str, x, *, axis=None,
                  multi_device: Optional[bool] = None,
                  mesh_axes: Optional[tuple] = None,
                  policy: Optional[MmaPolicy] = None) -> DispatchContext:
    if multi_device is None:
        if mesh_axes is None:
            mesh_axes = _live_mesh_axes()
        multi_device = mesh_axes is not None
    return DispatchContext(
        op=op, shape=tuple(x.shape), dtype=dtype_name(x.dtype),
        multi_device=multi_device, axis=axis, mesh_axes=mesh_axes,
        policy=policy)


def legal_engines(spec: OpSpec, ctx: DispatchContext) -> tuple:
    """Engine names (registration order) whose capabilities cover ctx."""
    return tuple(e.name for e in spec.engines
                 if capability_reason(e, ctx) is None)


def _unknown_method(spec: OpSpec, method: str) -> ValueError:
    accepted = spec.engine_names()
    return ValueError(
        f"unknown {spec.name} method: {method!r} (accepted: 'auto', "
        + ", ".join(repr(a) for a in sorted(accepted)) + ")")


def _plan_words(policy: Optional[MmaPolicy]) -> dict:
    """Plan-field overrides an explicit policy pins (split words)."""
    if policy is None or policy.split_words == 1:
        return {}
    return {"split_words": int(policy.split_words)}


def supported_method(op: str, x, method: str, *, precision=None,
                     **op_kwargs) -> bool:
    """Would ``dispatch(op, x, method=...)`` accept this call?"""
    if method == "auto":
        return True
    spec = op_spec(op)
    eng = spec.engine(method)
    if eng is None:
        return False
    ctx = _context_for(spec, x, op_kwargs, policy=as_policy(precision))
    return capability_reason(eng, ctx) is None


def resolve_method(op: str, x, method: str, *, fallback: str = "vpu",
                   precision=None, **op_kwargs) -> str:
    """``method`` when ``dispatch`` would accept it, else ``fallback`` —
    raising when the fallback cannot serve the call either."""
    if supported_method(op, x, method, precision=precision,
                        **op_kwargs):
        return method
    if not supported_method(op, x, fallback, precision=precision,
                            **op_kwargs):
        pol = as_policy(precision)
        raise ValueError(
            f"no engine of op {op!r} serves this call: {method!r} and "
            f"the fallback {fallback!r} both fail the capability "
            f"predicates"
            + (f" under precision policy {pol.signature()!r}"
               if pol is not None else ""))
    return fallback


# -------------------------------------------------------- entry points


def dispatch(op: str, x, *, method: str = "auto", chain=None,
             precision=None, objective=None, bucket: str = "pow2",
             **op_kwargs):
    """THE dispatch path: every framework hook lands here.

    Explicit ``method`` spellings name an engine and are
    capability-checked; ``'auto'`` runs the plan the autotuner keyed
    for this (op, n, dtype, device) under the legal engine subset.
    ``chain`` overrides the plan's chain on the explicit path (``'auto'``
    resolves the engine-restricted tuned plan).  ``precision`` narrows
    the legal engines, keys the auto plan and casts the plain engines'
    multiplicands; ``objective`` and ``bucket`` key the auto plan.
    """
    from repro_torch.core import autotune
    x = as_tensor(x)
    op_kwargs = {k: torch.as_tensor(v, device=x.device)
                 if isinstance(v, np.ndarray) else v
                 for k, v in op_kwargs.items()}
    spec = op_spec(op)
    policy = as_policy(precision)
    ctx = _context_for(spec, x, op_kwargs, policy=policy)
    if policy is not None:
        op_kwargs = dict(op_kwargs, policy=policy)
    backend = x.device.type
    if method == "auto":
        legal = legal_engines(spec, ctx)
        if not legal:
            raise ValueError(f"no engine of op {op!r} supports this "
                             f"input: shape={ctx.shape}")
        sweepable = tuple(e.name for e in spec.engines
                          if _policy_reason(e, policy) is None)
        restrict = None if legal == sweepable else legal
        plan = autotune.get_plan(x.numel(),
                                 x.dtype, op=op, engine=restrict,
                                 mesh=ctx.mesh_axes, policy=policy,
                                 objective=objective, bucket=bucket,
                                 backend=backend)
        return execute(op, _cast_in(x, policy, spec, plan.method),
                       plan, **op_kwargs)
    eng = spec.engine(method)
    if eng is None:
        raise _unknown_method(spec, method)
    reason = capability_reason(eng, ctx)
    if reason is not None:
        raise ValueError(
            f"engine {eng.name!r} cannot run op {op!r} here: {reason}")
    x = _cast_in(x, policy, spec, eng.name)
    if chain == "auto":
        plan = autotune.get_plan(x.numel(),
                                 x.dtype, op=op, engine=(eng.name,),
                                 mesh=ctx.mesh_axes, policy=policy,
                                 objective=objective, bucket=bucket,
                                 backend=backend)
        return execute(op, x, plan, **op_kwargs)
    overrides = {} if chain is None else {"chain": int(chain)}
    overrides.update(_plan_words(policy))
    plan = autotune.ReductionPlan(method=eng.name, **overrides)
    return eng.run(x, plan, **op_kwargs)


def _cast_in(x, policy: Optional[MmaPolicy], spec: OpSpec,
             engine_name: str):
    """Apply the policy's multiplicand cast for the plain engines (the
    split-word engines decompose the full-precision input themselves)."""
    if policy is None or policy.input_dtype is None:
        return x
    eng = spec.engine(engine_name)
    if eng is not None and eng.max_split_words > 1:
        return x
    return policy.cast_in(x)


def execute(op: str, x, plan, **op_kwargs):
    """Run ``x`` under an already-chosen plan — the single executor,
    structurally validated (not against the mesh)."""
    x = as_tensor(x)
    spec = op_spec(op)
    eng = spec.engine(plan.method)
    if eng is None:
        raise ValueError(f"unknown plan method {plan.method!r} for op "
                         f"{op!r} (engines: {spec.engine_names()})")
    reason = capability_reason(eng, _context_for(spec, x, op_kwargs),
                               env=False)
    if reason is not None:
        raise ValueError(
            f"engine {eng.name!r} cannot run op {op!r} here: {reason}")
    return eng.run(x, plan, **op_kwargs)


def _context_for(spec: OpSpec, x, op_kwargs: dict, *,
                 policy: Optional[MmaPolicy] = None) -> DispatchContext:
    if policy is None:
        policy = op_kwargs.get("policy")
    return build_context(spec.name, x, axis=op_kwargs.get("axis"),
                         policy=policy)


# ===================================================== engine runners
#
# Lazy imports: the registry imports without the kernels or the core.


def _f32(x):
    return x.to(ACCUM_DTYPE)


def _reduce_mma(x, plan, *, axis=None, **_):
    from repro_torch.core import reduction as R
    if axis is None:
        return R.tc_contract(x, torch.ones_like(x))
    return R.tc_reduce_axes(x, axis)


def _reduce_chained(x, plan, **_):
    from repro_torch.core import reduction as R
    return R.tc_reduce(x, variant=plan.variant, chain=plan.chain,
                       m=plan.m, mma_fraction=plan.mma_fraction)


def _reduce_pallas(x, plan, **_):
    from repro_torch.kernels import mma_reduce
    return mma_reduce(x, variant=plan.variant, chain=plan.chain,
                      block_rows=plan.block_rows)


def _reduce_vpu(x, plan, *, axis=None, **_):
    if axis is None:
        return torch.sum(x, dtype=ACCUM_DTYPE)
    return torch.sum(x, dim=axis, dtype=ACCUM_DTYPE)


def _sq_mma(x, plan, *, axis=None, **_):
    from repro_torch.core import reduction as R
    if axis is None:
        return R.tc_contract(x, x)
    return R.tc_reduce_axes(x, axis, b=x)


def _sq_chained(x, plan, **_):
    xf = _f32(x)
    return _reduce_chained(xf * xf, plan)


def _sq_pallas(x, plan, **_):
    from repro_torch.kernels import mma_squared_sum
    return mma_squared_sum(x, chain=plan.chain,
                           block_rows=plan.block_rows)


def _sq_vpu(x, plan, *, axis=None, **_):
    xf = _f32(x)
    return _reduce_vpu(xf * xf, plan, axis=axis)


def _masked_mean_with(reduce_run):
    """Lift one reduce engine into the masked-mean op: numerator and
    denominator both ride that engine; the all-masked denominator is
    floored at 1 (an empty mask yields 0, not NaN)."""
    def run(values, plan, *, mask, **_):
        num = reduce_run(values * mask, plan)
        den = reduce_run(mask, plan)
        return num / torch.clamp(den, min=1.0)
    return run


def _masked_mean_mma(values, plan, *, mask, **_):
    # Fused form: the mask plays the ones-matrix role.
    from repro_torch.core import reduction as R
    num = R.tc_contract(values, mask)
    den = R.tc_contract(mask, torch.ones_like(mask))
    return num / torch.clamp(den, min=1.0)


def _counts_mma(x, plan, **_):
    from repro_torch.core import reduction as R
    return R.tc_reduce_rows(x.T)            # (E,) f32


def _counts_vpu(x, plan, **_):
    return torch.sum(x, dim=0, dtype=ACCUM_DTYPE)


# ================================================= reference oracles
#
# The classic baseline IS each op's semantic reference, so the oracles
# are the vpu runners with the plan argument dropped.


def _ref_reduce_sum(x, **kw):
    return _reduce_vpu(x, None, **kw)


def _ref_squared_sum(x, **kw):
    return _sq_vpu(x, None, **kw)


def _ref_masked_mean(values, *, mask, **_):
    vm = _f32(values) * _f32(mask)
    return torch.sum(vm) / torch.clamp(torch.sum(_f32(mask)), min=1.0)


def _ref_expert_counts(x, **kw):
    return _counts_vpu(x, None, **kw)


# ----------------------------------------------- measurement inputs


def _measure_masked_mean(n, dtype, rng, device):
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    mask = torch.from_numpy((rng.random(n) > 0.5).astype(np.float32))
    dt = as_dtype(dtype)
    return x.to(device, dt), {"mask": mask.to(device, dt)}


def _measure_expert_counts(n, dtype, rng, device):
    e = 16                                  # one 16-wide chain link
    t = max(n // e, 1)
    onehot = torch.eye(e)[torch.from_numpy(rng.integers(0, e, t))]
    return onehot.to(device, as_dtype(dtype)), {}


# ==================================================== registrations
#
#   mma          single f32-accumulated contraction — distribution-safe,
#                axis-aware (batched).
#   mma_chained  plain chained core: flatten-and-pad, single device.
#   pallas       the Hopper kernels B1-B3: flatten-only, single device.
#   vpu          classic baseline: safe everywhere.

_REDUCE_ENGINES = (
    EngineSpec("mma", _reduce_mma, multi_device_safe=True,
               axis_subsets=True),
    EngineSpec("mma_chained", _reduce_chained, sweep=("chain",)),
    EngineSpec("pallas", _reduce_pallas, sweep=("chain", "block_rows")),
    EngineSpec("vpu", _reduce_vpu, multi_device_safe=True,
               axis_subsets=True),
)

register(OpSpec(
    name="reduce_sum", engines=_REDUCE_ENGINES,
    reference=_ref_reduce_sum))

register(OpSpec(
    name="squared_sum",
    engines=(
        EngineSpec("mma", _sq_mma, multi_device_safe=True,
                   axis_subsets=True),
        EngineSpec("mma_chained", _sq_chained, sweep=("chain",)),
        EngineSpec("pallas", _sq_pallas, sweep=("chain", "block_rows")),
        EngineSpec("vpu", _sq_vpu, multi_device_safe=True,
                   axis_subsets=True),
    ),
    reference=_ref_squared_sum))

register(OpSpec(
    name="masked_mean",
    engines=(
        EngineSpec("mma", _masked_mean_mma, multi_device_safe=True),
        EngineSpec("mma_chained", _masked_mean_with(_reduce_chained),
                   sweep=("chain",)),
        EngineSpec("pallas", _masked_mean_with(_reduce_pallas),
                   sweep=("chain", "block_rows")),
        EngineSpec("vpu", _masked_mean_with(_reduce_vpu),
                   multi_device_safe=True),
    ),
    reference=_ref_masked_mean, measure=_measure_masked_mean))

register(OpSpec(
    name="expert_counts",
    engines=(
        EngineSpec("mma", _counts_mma, multi_device_safe=True, ndim=2),
        EngineSpec("vpu", _counts_vpu, multi_device_safe=True, ndim=2),
    ),
    reference=_ref_expert_counts, measure=_measure_expert_counts))
