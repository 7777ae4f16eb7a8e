"""The TC-op registry: one declarative dispatch layer for the reduce,
scan, segment, attention and norm_matmul families — the counterpart of
``repro.core.dispatch`` for the ported slices.

Each op (``reduce_sum``, ``squared_sum``, ``masked_mean``,
``expert_counts``; ``scan`` and ``masked_cumsum``; ``segment_sum``;
``attention``; ``norm_matmul``) is an
:class:`OpSpec` declaring its family, its engines (:class:`EngineSpec`,
each with a ``run(x, plan, **op_kwargs)`` callable and capability
flags), alias spellings, a plain reference oracle, and the autotuner
hooks.  The engines keep the reference's spellings:

  * ``'mma'``          one f32-accumulated ones-contraction (matmul),
                       axis-aware, distribution-safe;
  * ``'mma_chained'``  the paper-structured ``tc_reduce`` core;
  * ``'mma_ec'``       the compensated split-bf16 core ``tc_reduce_ec``
                       (2-3 bf16 words per f32 value, TwoSum combine);
  * ``'pallas'``       the hand-written Hopper kernels B1-B3
                       (``repro_torch.kernels``) — the name is kept so
                       plan keys and configs carry across packages;
  * ``'pallas_ec'``    kernel B4, the hand-written twin of ``mma_ec``;
  * ``'mma_dd'``       the double-double core ``tc_reduce_dd``: a
                       shape-(2,) f32 ``[hi, lo]`` pair, f64-equivalent;
  * ``'pallas_dd'``    kernel B5, the hand-written twin of ``mma_dd``;
  * ``'vpu'``          the classic f32 sum, the baseline.

The scan family has ``mma_chained`` (``core.scan.tc_scan``; ``'mma'`` is
its alias, a scan having no single-contraction form), ``mma_ec``
(``tc_scan_ec``), ``pallas`` (kernel B6, flat inputs only) and ``vpu``
(``torch.cumsum``).  The segment family (``segment_sum``) has ``mma``
(``core.scan.tc_segment_reduce``; ``'mma_chained'`` is its alias),
``pallas`` (kernel B7) and ``vpu`` (``index_add_`` after dropping the ids
outside [0, S), which torch would refuse and JAX drops).  The
``norm_matmul`` family (``rmsnorm(x) @ w``, or the norm alone with
``w=None``) has ``fused_pallas`` (kernel B10 with ``w`` given, kernel B8
for the norm-only form), ``unfused_mma`` (the two-op path) and ``vpu``
(all f32); ``'pallas'`` and ``'mma'`` are their aliases.  The
``attention`` family has ``fused_pallas`` (kernel B9), ``unfused_mma``
(``models.attention._chunked_attn``, the KV-chunked online softmax) and
``vpu`` (``models.attention._direct_attn``, the unchunked oracle), with
the same aliases.

The dd engines declare ``accum_dtypes=('float64',)``: they run only
under an explicit f64 policy (``precision.F64_EQUIVALENT``), and every
f32-scalar engine refuses that policy, each naming its reason.

``dispatch(op, x, method=..., **op_kwargs)`` is the one entry point of
the framework hooks: an explicit method is capability-checked (an
illegal or undeclared engine raises ``ValueError`` naming the reason),
``'auto'`` runs the autotuner's plan for the legal engines through
``execute``.

Device rule: a ``torch.Tensor`` runs on its own device (a CPU tensor is
how a caller asks for the CPU); a numpy array or Python scalar goes to
the card, and with no card the call raises instead of running on the
CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.precision import (ACCUM_DTYPE, MmaPolicy, as_dtype,
                                        as_policy, dtype_name)
from repro_torch.distributed import sharding as shd


def default_device(device=None):
    """``device`` when given, else the card; with no card, raise rather
    than run on the CPU (a caller asks for the CPU by naming it)."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card unless given "
            "CPU tensors (pass a torch.Tensor on the CPU to run there)")
    return "cuda"


def as_tensor(x) -> torch.Tensor:
    """The device rule: tensors stay where they are; anything else goes
    to the card, or raises when there is none."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x)).to(default_device())


# ------------------------------------------------------------- context


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """The static facts one dispatch decision is made from."""
    op: str
    shape: tuple
    dtype: str
    multi_device: bool
    axis: Optional[tuple] = None    # reduce family: reduced-axis subset
    scan_axis: Optional[int] = None  # scan family: the scanned axis
    mesh_axes: Optional[tuple] = None  # None on a single device
    policy: Optional[MmaPolicy] = None
    extras: Optional[tuple] = None  # op-family facts: ((key, value), ...)
    grad: bool = False  # an input the engine would read requires grad

    def extra(self, key: str, default=None):
        """Look up one op-family fact recorded in ``extras``."""
        for k, v in self.extras or ():
            if k == key:
                return v
        return default

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def axis_subset(self) -> bool:
        """True when only *some* axes are reduced (batched reduction)."""
        return self.axis is not None and len(self.axis) < self.ndim

    @property
    def flat(self) -> bool:
        """Effectively 1-D: the op's axis walk IS the flattened order."""
        if self.ndim <= 1:
            return True
        if self.scan_axis is None:
            return False
        return (self.scan_axis == self.ndim - 1
                and all(d == 1 for d in self.shape[:-1]))


def _live_mesh_axes() -> Optional[tuple]:
    """((name, size), ...) of the ambient mesh of more than one rank
    (``distributed.sharding.current_mesh``), or None: a one-rank mesh is
    no mesh to dispatch (every engine is legal, plans carry no mesh
    signature)."""
    mesh = shd.current_mesh()
    if mesh is None:
        return None
    from repro_torch.core import autotune
    return autotune.mesh_axes(mesh)


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
    needs_flat: bool = False        # requires an effectively-1-D layout
    ndim: Optional[int] = None      # exact input rank, None = any
    dtypes: Optional[tuple] = None  # allowed input dtype names, None = any
    sweep: tuple = ()               # of 'chain' / 'block_rows' / 'split_words'
    max_split_words: int = 1        # split-bf16 words the engine runs
    accum_dtypes: tuple = ("float32",)  # accumulators it can honour
    predicate: Optional[Callable] = None  # (ctx) -> reason or None
    kernel: bool = False            # launches a hand-written kernel


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
    if eng.needs_flat and not ctx.flat:
        return ("operates on the flattened input; use a batched engine "
                "for multi-axis inputs")
    if eng.ndim is not None and ctx.ndim != eng.ndim:
        return f"requires an ndim == {eng.ndim} input"
    if eng.dtypes is not None and ctx.dtype not in eng.dtypes:
        return f"dtype {ctx.dtype} not in {eng.dtypes}"
    reason = _policy_reason(eng, ctx.policy)
    if reason is not None:
        return reason
    if eng.predicate is not None:
        reason = eng.predicate(ctx)
        if reason is not None:
            return reason
    return _grad_reason(eng, ctx)


def _grad_reason(eng: EngineSpec, ctx: DispatchContext) -> Optional[str]:
    """Why ``eng`` cannot serve a call under autograd — or None.  A
    hand-written kernel has no backward (the reference cannot
    differentiate its ``pallas_call`` either): its output would carry no
    ``grad_fn`` and every gradient upstream of it would be lost without
    an error."""
    if ctx.grad and eng.kernel:
        return (f"engine {eng.name!r} launches a hand-written kernel, "
                f"which has no backward: op {ctx.op!r} is called on a "
                f"tensor that requires grad; use a differentiable engine "
                f"('mma', 'unfused_mma', 'vpu', or 'auto')")
    return None


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
    """One registered TC-op: its family (which picks the autotuner's
    cost terms), its ordered engines, the accepted alias spellings, the
    plain reference oracle, the problem size the plan registry keys on
    (``size_of``; default every element), the problem's form beyond its
    size (``form_of``: facts that key its plans and that its cost model
    and measurement input read) and the autotuner's measurement-input
    builder."""
    name: str
    family: str                     # 'reduce' | 'scan' | 'segment'
    engines: tuple                  # tuple[EngineSpec, ...]
    reference: Callable
    aliases: Optional[dict] = None
    size_of: Optional[Callable] = None   # (x, op_kwargs) -> int
    form_of: Optional[Callable] = None   # (x, op_kwargs) -> ((k, v), ...)
    # (n, dtype, rng, device, **form) -> (x, kw)
    measure: Optional[Callable] = None
    # Per-op override of the autotuner's engine -> multiplicand-bits
    # table (autotune._ENGINE_BITS), as in the reference.
    engine_bits: Optional[dict] = None   # {engine name: bits}

    def engine(self, name: str) -> Optional[EngineSpec]:
        name = (self.aliases or {}).get(name, name)
        for eng in self.engines:
            if eng.name == name:
                return eng
        return None

    def engine_names(self) -> tuple:
        return tuple(e.name for e in self.engines)

    def problem_size(self, x, op_kwargs: dict) -> int:
        if self.size_of is not None:
            return self.size_of(x, op_kwargs)
        return x.numel()

    def problem_form(self, x, op_kwargs: dict) -> tuple:
        return () if self.form_of is None else self.form_of(x, op_kwargs)


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


def build_context(op: str, x, *, axis=None, scan_axis=None,
                  multi_device: Optional[bool] = None,
                  mesh_axes: Optional[tuple] = None,
                  policy: Optional[MmaPolicy] = None,
                  extras: Optional[tuple] = None,
                  grad: bool = False) -> DispatchContext:
    if multi_device is None:
        if mesh_axes is None:
            mesh_axes = _live_mesh_axes()
        multi_device = mesh_axes is not None
    return DispatchContext(
        op=op, shape=tuple(x.shape), dtype=dtype_name(x.dtype),
        multi_device=multi_device, axis=axis, scan_axis=scan_axis,
        mesh_axes=mesh_axes, policy=policy, extras=extras, grad=grad)


def legal_engines(spec: OpSpec, ctx: DispatchContext) -> tuple:
    """Engine names (registration order) whose capabilities cover ctx."""
    return tuple(e.name for e in spec.engines
                 if capability_reason(e, ctx) is None)


def _unknown_method(spec: OpSpec, method: str) -> ValueError:
    accepted = spec.engine_names() + tuple(spec.aliases or ())
    return ValueError(
        f"unknown {spec.name} method: {method!r} (accepted: 'auto', "
        + ", ".join(repr(a) for a in sorted(accepted)) + ")")


def known_method(op: str, method: str) -> bool:
    """Does ``method`` spell an engine (or alias, or ``'auto'``) the op
    declares, whatever its capabilities?"""
    return method == "auto" or op_spec(op).engine(method) is not None


def local_plan(op: str, n: int, dtype, method: str = "auto", *,
               mesh=None, chain: int = 4, precision=None,
               objective=None, bucket: str = "pow2",
               backend: Optional[str] = None):
    """Resolve a method spelling to a plan for a size-n problem without
    running it: how the mesh collectives
    (``repro_torch.distributed.tc_collectives``) pick each rank's
    partial engine.

    ``'auto'`` consults the plan registry (mesh-keyed when ``mesh`` is
    given: tuned for the local shard of the global problem; keyed by the
    policy, the objective and the ``bucket`` policy as ``dispatch``
    keys them); an explicit spelling resolves through the op's aliases
    to a one-engine plan with the hooks' default ``chain`` (and the
    policy's split words), and an engine the op does not declare raises
    as ``dispatch`` does.  Capabilities are checked when the plan runs
    (``execute``, which skips the multi-device predicate: the shard is
    local there).
    """
    from repro_torch.core import autotune
    spec = op_spec(op)
    policy = as_policy(precision)
    if method == "auto":
        return autotune.get_plan(n, dtype, op=op, mesh=mesh, policy=policy,
                                 objective=objective, bucket=bucket,
                                 backend=backend)
    eng = spec.engine(method)
    if eng is None:
        raise _unknown_method(spec, method)
    reason = _policy_reason(eng, policy)
    if reason is not None:
        raise ValueError(
            f"engine {eng.name!r} cannot serve op {op!r} under this "
            f"precision policy: {reason}")
    return autotune.ReductionPlan(method=eng.name, chain=chain,
                                  **_plan_words(policy))


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
    raising when the fallback cannot serve the call either.  A kernel
    engine refused only because the call is under autograd raises (as
    ``dispatch`` does): a kernel spelling in a training step is an error,
    not a capability to fall back from."""
    if supported_method(op, x, method, precision=precision,
                        **op_kwargs):
        return method
    spec = op_spec(op)
    eng = spec.engine(method)
    if eng is not None:
        ctx = _context_for(spec, as_tensor(x), op_kwargs,
                           policy=as_policy(precision))
        reason = capability_reason(eng, ctx)
        if reason is not None and reason == _grad_reason(eng, ctx):
            raise ValueError(
                f"engine {eng.name!r} cannot run op {op!r} here: {reason}")
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
    op_kwargs = _tensor_kwargs(x, op_kwargs)
    spec = op_spec(op)
    policy = as_policy(precision)
    ctx = _context_for(spec, x, op_kwargs, policy=policy)
    if policy is not None:
        op_kwargs = dict(op_kwargs, policy=policy)
    backend = x.device.type
    if method == "auto":
        plan = _auto_plan(spec, x, ctx, op_kwargs, policy, objective,
                          bucket)
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
        plan = autotune.get_plan(spec.problem_size(x, op_kwargs),
                                 x.dtype, op=op, engine=(eng.name,),
                                 mesh=ctx.mesh_axes, policy=policy,
                                 objective=objective, bucket=bucket,
                                 backend=backend,
                                 form=spec.problem_form(x, op_kwargs))
        return execute(op, x, plan, **op_kwargs)
    overrides = {} if chain is None else {"chain": int(chain)}
    overrides.update(_plan_words(policy))
    plan = autotune.ReductionPlan(method=eng.name, **overrides)
    return eng.run(x, plan, **op_kwargs)


def _tensor_kwargs(x, op_kwargs: dict) -> dict:
    return {k: torch.as_tensor(v, device=x.device)
            if isinstance(v, np.ndarray) else v
            for k, v in op_kwargs.items()}


def _auto_plan(spec: OpSpec, x, ctx: DispatchContext, op_kwargs: dict,
               policy: Optional[MmaPolicy], objective, bucket: str):
    from repro_torch.core import autotune
    # The context holds every fact the plan is chosen from (op, shape,
    # dtype, axes, mesh, policy, the op's form), so a repeated call takes
    # the registry's memo of it.
    memo = autotune.default_registry().auto_memo
    try:
        key = (ctx, objective, bucket, x.device.type)
        plan = memo.get(key)
    except TypeError:                   # an unhashable objective
        key = plan = None
    if plan is None:
        plan = _resolve_auto_plan(spec, x, ctx, op_kwargs, policy,
                                  objective, bucket)
        if key is not None:
            memo[key] = plan
    return plan


def _resolve_auto_plan(spec: OpSpec, x, ctx: DispatchContext,
                       op_kwargs: dict, policy: Optional[MmaPolicy],
                       objective, bucket: str):
    from repro_torch.core import autotune
    legal = legal_engines(spec, ctx)
    if not legal:
        raise ValueError(f"no engine of op {spec.name!r} supports this "
                         f"input: shape={ctx.shape}")
    sweepable = tuple(e.name for e in spec.engines
                      if _policy_reason(e, policy) is None)
    restrict = None if legal == sweepable else legal
    return autotune.get_plan(spec.problem_size(x, op_kwargs), x.dtype,
                             op=spec.name, engine=restrict,
                             mesh=ctx.mesh_axes, policy=policy,
                             objective=objective, bucket=bucket,
                             backend=x.device.type,
                             form=spec.problem_form(x, op_kwargs))


def auto_plan(op: str, x, *, precision=None, objective=None,
              bucket: str = "pow2", **op_kwargs):
    """The plan ``dispatch(op, x, method='auto', ...)`` runs for this
    call, without running it."""
    x = as_tensor(x)
    op_kwargs = _tensor_kwargs(x, op_kwargs)
    spec = op_spec(op)
    policy = as_policy(precision)
    ctx = _context_for(spec, x, op_kwargs, policy=policy)
    return _auto_plan(spec, x, ctx, op_kwargs, policy, objective, bucket)


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


def _needs_grad(x, op_kwargs: dict) -> bool:
    """Is the call under autograd with an input that requires grad (x or
    a tensor operand: keys, values, weights, scale, mask)?"""
    if not torch.is_grad_enabled():
        return False
    return any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in (x, *op_kwargs.values()))


def _context_for(spec: OpSpec, x, op_kwargs: dict, *,
                 policy: Optional[MmaPolicy] = None) -> DispatchContext:
    if policy is None:
        policy = op_kwargs.get("policy")
    grad = _needs_grad(x, op_kwargs)
    if spec.family == "scan":
        scan_axis = op_kwargs.get("axis", -1) % max(x.ndim, 1)
        return build_context(spec.name, x, scan_axis=scan_axis,
                             policy=policy, grad=grad)
    if spec.family == "attention":
        return build_context(spec.name, x, policy=policy,
                             extras=_attention_extras(x, op_kwargs),
                             grad=grad)
    if spec.family == "norm_matmul":
        return build_context(spec.name, x, policy=policy,
                             extras=_norm_matmul_extras(x, op_kwargs),
                             grad=grad)
    return build_context(spec.name, x, axis=op_kwargs.get("axis"),
                         policy=policy, grad=grad)


def _attention_extras(qg, op_kwargs: dict) -> tuple:
    """The attention family's context facts (shapes, dtypes and flags
    only, never an operand, so the context stays hashable).
    ``has_kv_len`` is True only for a dynamic valid-length mask (the
    decode ring buffer); a static ``kv_len == Sk`` is the dense no-op
    every engine handles."""
    k = op_kwargs.get("k")
    v = op_kwargs.get("v")
    qpos = op_kwargs.get("qpos")
    kv_len = op_kwargs.get("kv_len")
    window = op_kwargs.get("window")
    kv_seq = int(k.shape[1]) if k is not None else 0
    return (
        ("causal", bool(op_kwargs.get("causal", False))),
        ("window", int(window) if window is not None else None),
        ("has_kv_len",
         kv_len is not None
         and not (isinstance(kv_len, int) and kv_len == kv_seq)),
        ("per_row", qpos is not None and getattr(qpos, "ndim", 1) == 2),
        ("head_dim", int(qg.shape[-1])),
        ("v_head_dim",
         int(v.shape[-1]) if v is not None else int(qg.shape[-1])),
        ("kv_seq", kv_seq),
        ("kv_dtypes", tuple(dtype_name(t.dtype) for t in (k, v)
                            if t is not None)),
    )


def _attention_form(qg, op_kwargs: dict) -> tuple:
    """What the attention cost model prices beside the score count: the
    head dims, the mask (causal, window, a dynamic kv_len), a softcap,
    the query rows per KV head (Sq G) and the keys (Sk), which split the
    score count into q / o rows and K / V rows, and the cache's dtype
    when it is not qg's (f32 activations against a bf16 cache)."""
    k, v = op_kwargs["k"], op_kwargs["v"]
    ctx = dict(_attention_extras(qg, op_kwargs))
    form = (("hd", int(qg.shape[-1])), ("hd_v", int(v.shape[-1])),
            ("causal", int(ctx["causal"])), ("window", ctx["window"] or 0),
            ("cap", int(op_kwargs.get("cap") is not None)),
            ("has_kv_len", int(ctx["has_kv_len"])),
            ("rows", int(qg.shape[1] * qg.shape[3])),
            ("sk", int(k.shape[1])))
    if k.dtype != qg.dtype:
        form += (("kv_dtype", dtype_name(k.dtype)),)
    return form


def _norm_matmul_form(x, op_kwargs: dict) -> tuple:
    """The projection the cost model prices beside the norm: none for
    the norm-only form (w=None), else (d, dout, gate), and the weight's
    dtype when it is not x's (a model's f32 weights beside bf16
    activations: B10 multiplies them in f32, unfused_mma casts them)."""
    w = op_kwargs.get("w")
    if w is None:
        return ()
    form = (("d", int(x.shape[-1])), ("dout", int(w.shape[-1])),
            ("gate", int(op_kwargs.get("w_gate") is not None)))
    if w.dtype != x.dtype:
        form += (("w_dtype", dtype_name(w.dtype)),)
    return form


def _norm_matmul_extras(x, op_kwargs: dict) -> tuple:
    """The norm_matmul family's context facts (shapes, dtypes and flags
    only)."""
    w = op_kwargs.get("w")
    weights = tuple(dtype_name(wi.dtype) for wi in
                    (w, op_kwargs.get("w_gate")) if wi is not None)
    return (
        ("d_model", int(x.shape[-1])),
        ("d_out", int(w.shape[-1]) if w is not None else 0),
        ("has_gate", op_kwargs.get("w_gate") is not None),
        ("has_bias", op_kwargs.get("bias") is not None),
        ("w_dtypes", weights),
    )


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


def _reduce_ec(x, plan, **_):
    from repro_torch.core import reduction as R
    return R.tc_reduce_ec(x, split_words=plan.split_words,
                          chain=plan.chain, m=plan.m)


def _reduce_pallas_ec(x, plan, **_):
    from repro_torch.kernels import mma_ec_reduce
    return mma_ec_reduce(x, split_words=plan.split_words,
                         chain=plan.chain, block_rows=plan.block_rows)


def _reduce_dd(x, plan, **_):
    from repro_torch.core import reduction as R
    return R.tc_reduce_dd(x)


def _reduce_pallas_dd(x, plan, **_):
    from repro_torch.kernels import mma_dd_reduce
    return mma_dd_reduce(x, chain=plan.chain, block_rows=plan.block_rows)


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


def _sq_ec(x, plan, **_):
    # Square in f32 (one rounding per element, as every engine), then
    # the compensated reduce adds no first-order error.
    xf = _f32(x)
    return _reduce_ec(xf * xf, plan)


def _sq_pallas_ec(x, plan, **_):
    from repro_torch.kernels import mma_ec_squared_sum
    return mma_ec_squared_sum(x, split_words=plan.split_words,
                              chain=plan.chain, block_rows=plan.block_rows)


def _sq_dd(x, plan, **_):
    from repro_torch.core import reduction as R
    return R.tc_reduce_dd(x, square=True)


def _sq_pallas_dd(x, plan, **_):
    from repro_torch.kernels import mma_dd_squared_sum
    return mma_dd_squared_sum(x, chain=plan.chain,
                              block_rows=plan.block_rows)


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


# ---- scan family


def _scan_chained(x, plan, *, axis=-1, inclusive=True, policy=None, **_):
    from repro_torch.core import scan as S
    return S.tc_scan(x, axis=axis, inclusive=inclusive,
                     variant=plan.variant, chain=plan.chain, m=plan.m,
                     precision=policy)


def _scan_ec(x, plan, *, axis=-1, inclusive=True, **_):
    from repro_torch.core import scan as S
    return S.tc_scan_ec(x, axis=axis, inclusive=inclusive,
                        split_words=plan.split_words, chain=plan.chain,
                        m=plan.m)


def _scan_pallas(x, plan, *, inclusive=True, **_):
    from repro_torch.kernels import mma_scan
    return mma_scan(x, inclusive=inclusive, chain=plan.chain,
                    block_rows=plan.block_rows)


def _scan_vpu(x, plan, *, axis=-1, inclusive=True, **_):
    from repro_torch.core import scan as S
    out = torch.cumsum(_f32(x), dim=axis)
    if not inclusive:
        out = torch.movedim(
            S._shift_exclusive(torch.movedim(out, axis, -1)), -1, axis)
    return out


# ---- segment family


def _segment_mma(values, plan, *, segment_ids, num_segments, **_):
    from repro_torch.core import scan as S
    return S.tc_segment_reduce(values, segment_ids, num_segments,
                               m=plan.m)


def _segment_pallas(values, plan, *, segment_ids, num_segments, **_):
    from repro_torch.kernels import mma_segment_sum
    return mma_segment_sum(values, segment_ids, num_segments,
                           block_rows=plan.block_rows)


def _segment_vpu(values, plan, *, segment_ids, num_segments, **_):
    # The scatter-add baseline.  index_add_ raises on an index outside
    # [0, S) where jax.ops.segment_sum drops it, so such ids go to a
    # spare slot S that is cut off.
    s = int(num_segments)
    v = _f32(values).reshape(-1)
    ids = torch.as_tensor(segment_ids, device=v.device).reshape(-1)
    slot = torch.where((ids >= 0) & (ids < s), ids, s)
    out = torch.zeros(s + 1, dtype=ACCUM_DTYPE, device=v.device)
    return out.index_add_(0, slot, v)[:s]


# ---- attention family
#
# Operand surface (every runner): qg (B, Sq, KV, G, hd) grouped
# queries; k (B, Sk, KV, hd); v (B, Sk, KV, hd_v — MLA's value width
# may differ); qpos (Sq,) or per-row (B, Sq) absolute positions; key
# positions are always 0..Sk-1 (the ring-buffer slot order).  Returns
# (B, Sq, KV, G, hd_v) in v.dtype.


def _attn_scale(qg, scale):
    return 1.0 / math.sqrt(qg.shape[-1]) if scale is None else scale


def _attn_vpu(qg, plan, *, k, v, qpos, causal=False, window=None,
              kv_len=None, scale=None, cap=None, **_):
    from repro_torch.models.attention import _direct_attn
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    return _direct_attn(qg, k, v, qpos=qpos, kpos=kpos, causal=causal,
                        window=window, kv_len=kv_len,
                        scale=_attn_scale(qg, scale), cap=cap)


def _attn_unfused(qg, plan, *, k, v, qpos, causal=False, window=None,
                  kv_len=None, scale=None, cap=None, chunk=None, **_):
    # kv_len is None or statically the full Sk here (the capability
    # predicate refuses the dynamic ring-buffer form), so the chunked
    # loop's built-in kv_len == Sk bound is exact.
    from repro_torch.models.attention import _chunked_attn
    chunk = int(chunk) if chunk else plan.chain * plan.block_rows
    return _chunked_attn(qg, k, v, qpos=qpos, causal=causal,
                         window=window, scale=_attn_scale(qg, scale),
                         cap=cap, chunk=chunk)


def _attn_fused(qg, plan, *, k, v, qpos, causal=False, window=None,
                kv_len=None, scale=None, cap=None, **_):
    from repro_torch.kernels import ops
    return ops.mma_attention(qg, k, v, qpos=qpos, causal=causal,
                             window=window, kv_len=kv_len,
                             scale=_attn_scale(qg, scale), cap=cap)


# The reference capped the fused kernel at a padded head dim of 512
# lanes, its TPU kernel's f32 working set against a 16 MB VMEM budget.
# Kernel B9 holds in shared memory its 64 query rows, two stages of a
# block of 32 keys and 32 values, and 128 row bounds; an f32 row of d
# elements takes 4 (round_up(d, 32) + 4) bytes, a bf16 row
# 2 (round_up(d, 64) + 8) (kernels.mma_attention.smem_bytes), within the
# H100's 232,448 bytes a block.  Its accumulator is hd_v / 2 f32
# registers a thread, so hd_v <= 256.  At hd_v = 256 in f32 the largest
# hd that fits is 288: 64 x 1168 + 64 (1168 + 1040) + 512 = 216,576
# bytes (320 would take 232,960).  The limit holds for every dtype form,
# so a head dim is served alike in f32 and bf16: Gemma-2 2B's and
# RecurrentGemma's 256, the other configs' 128 and MLA's 192 / 128 fit.
# B9's bf16 prefill form (wgmma, 128 rows and two stages of 64 keys)
# takes head dims up to 256 within 199,280 bytes; the head dims past it,
# up to this limit, keep the mma.sync form.
_FUSED_MAX_HEAD = 288


def _attn_fused_predicate(ctx: DispatchContext) -> Optional[str]:
    from repro_torch.kernels.mma_attention import refusal
    hd = int(ctx.extra("head_dim", 0))
    hd_v = int(ctx.extra("v_head_dim", 0))
    if hd > _FUSED_MAX_HEAD:
        return (f"head dim {hd} exceeds kernel B9's {_FUSED_MAX_HEAD} "
                f"(its shared-memory tiles); use the unfused engines")
    reason = refusal(hd, hd_v, (ctx.dtype,) + tuple(ctx.extra("kv_dtypes",
                                                              ())))
    return None if reason is None else f"{reason}; use the unfused engines"


def _attn_unfused_predicate(ctx: DispatchContext) -> Optional[str]:
    if ctx.extra("has_kv_len"):
        return ("dense-prefill engine: the KV-chunked loop has no "
                "dynamic valid-length (ring-buffer kv_len) mask; "
                "decode needs the fused kernel or the vpu oracle")
    return None


# ---- norm_matmul family: rmsnorm(x) @ W
#
# Op surface (all engines): x (..., d), scale (d,) with gemma
# (1 + scale) weighting, w (d, dout) or None for the norm-only form
# (output = the normalized activations), optional bias (dout,), optional
# w_gate (d, dout) + act for the MLP up/gate pair
# act(xh @ w_gate) * (xh @ w [+ bias]).  Output in x.dtype.


def _nm_weight(w, policy):
    # policy.cast_in on the weight operand: dispatch's _cast_in handles
    # x, but the weight never passes through it.
    return w if policy is None else policy.cast_in(w)


def _nm_scale(scale, x):
    return _f32(torch.as_tensor(scale, device=x.device))


def _nm_vpu(x, plan, *, w, scale, w_gate=None, bias=None, act=None,
            eps=1e-6, policy=None, **_):
    from repro_torch.kernels.mma_norm_matmul import apply_act
    xf = _f32(x)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    xh = xf * rstd * (1.0 + _nm_scale(scale, x))
    if w is None:
        return xh.to(x.dtype)
    up = xh @ _f32(_nm_weight(w, policy))
    if bias is not None:
        up = up + _f32(torch.as_tensor(bias, device=x.device))
    if w_gate is not None:
        g = xh @ _f32(_nm_weight(w_gate, policy))
        up = apply_act(g, act) * up
    return up.to(x.dtype)


def _nm_unfused(x, plan, *, w, scale, w_gate=None, bias=None, act=None,
                eps=1e-6, policy=None, **_):
    # The two-op path, spelled to stay BIT-identical to
    # layers.rmsnorm(method='mma') followed by the layers.mlp-style
    # matmul in x.dtype: the same reduction primitive (tc_reduce_axes on
    # the last dim), the same multiply association, the same casts.
    from repro_torch.core import reduction as R
    from repro_torch.kernels.mma_norm_matmul import apply_act
    xf = _f32(x)
    ms = R.tc_reduce_axes(xf * xf, (x.ndim - 1,))[..., None] \
        / x.shape[-1]
    rstd = torch.rsqrt(ms + eps)
    xh = (xf * rstd * (1.0 + _nm_scale(scale, x))).to(x.dtype)
    if w is None:
        return xh
    up = xh @ _nm_weight(w, policy).to(x.dtype)
    if bias is not None:
        up = up + torch.as_tensor(bias, device=x.device).to(x.dtype)
    if w_gate is not None:
        g = xh @ _nm_weight(w_gate, policy).to(x.dtype)
        up = apply_act(g, act) * up
    return up


def _nm_fused(x, plan, *, w, scale, w_gate=None, bias=None, act=None,
              eps=1e-6, policy=None, **_):
    from repro_torch.kernels import ops
    if w is None:
        # The norm-only form: kernel B8.
        return ops.mma_rmsnorm(x, scale, eps=eps, weight_offset=1.0)
    wg = None if w_gate is None else _nm_weight(w_gate, policy)
    return ops.mma_norm_matmul(x, scale, _nm_weight(w, policy), w_gate=wg,
                               bias=bias, act=act, eps=eps)


# The reference capped the fused kernel at a padded d_model of 512
# (_NM_FUSED_MAX_D): its TPU kernel held the whole (rows, dout) f32
# accumulator and a 128-lane k-block of the weights in VMEM.  Kernel B10
# walks k in steps of 64 columns inside its loop and holds one 128 x 128
# tile's accumulators in registers, so its shared memory (a ring of two
# to four stages of one k step, by the form: 193 KB) does not grow with
# d or dout; only its int indexing bounds them
# (kernels.mma_norm_matmul.refusal).


def _nm_fused_predicate(ctx: DispatchContext) -> Optional[str]:
    # B8 (w=None) serves any d_model >= 1; B10 (w given) what its
    # refusal allows (x's dtype is the engine's dtypes check).
    dout = int(ctx.extra("d_out", 0))
    if not dout:
        return None
    policy_dtype = None if ctx.policy is None else ctx.policy.input_dtype
    weights = ctx.extra("w_dtypes", ()) if policy_dtype is None \
        else (dtype_name(policy_dtype),)
    from repro_torch.kernels.mma_norm_matmul import refusal
    reason = refusal(math.prod(ctx.shape[:-1]),
                     int(ctx.extra("d_model", 0)), dout,
                     bool(ctx.extra("has_gate")), weights)
    return None if reason is None else f"{reason}; use the unfused engines"


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


def _ref_scan(x, **kw):
    return _scan_vpu(x, None, **kw)


def _ref_segment_sum(values, **kw):
    return _segment_vpu(values, None, **kw)


def _ref_attention(qg, **kw):
    kw.pop("chunk", None)
    return _attn_vpu(qg, None, **kw)


def _ref_norm_matmul(x, **kw):
    return _nm_vpu(x, None, **kw)


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


def _measure_attention(n, dtype, rng, device, hd=64, hd_v=None, causal=1,
                       window=0, cap=0, has_kv_len=0, rows=None, sk=None,
                       kv_dtype=None):
    """A representative problem of ~n score elements in the call's form
    (``_attention_form``): ``rows`` query rows per KV head (one head, G
    = 1) against ``sk`` keys, n / (rows sk) batch rows; without a form
    the reference's causal self-attention, Sq == Sk == sqrt(n), hd 64.
    A dynamic kv_len admits every key (the engines' work is the same)."""
    if sk is None:
        rows = sk = max(int(math.isqrt(max(int(n), 1))), 8)
    hd_v = hd if hd_v is None else hd_v
    b = max(int(n) // (rows * sk), 1)
    dt = as_dtype(dtype)
    kdt = dt if kv_dtype is None else as_dtype(kv_dtype)

    def t(shape, d):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(device, d)
    qg = t((b, rows, 1, 1, hd), dt)
    kw = {"k": t((b, sk, 1, hd), kdt), "v": t((b, sk, 1, hd_v), kdt),
          "qpos": torch.arange(sk - rows, sk, device=device)
          if rows <= sk else torch.arange(rows, device=device),
          "causal": bool(causal), "window": window or None,
          "scale": 1.0 / math.sqrt(hd), "cap": 50.0 if cap else None}
    if has_kv_len:
        kw["kv_len"] = torch.full((b,), sk, dtype=torch.int32,
                                  device=device)
    return qg, kw


# A representative problem of ~n input elements in the call's form
# (``_norm_matmul_form``): the norm-only form at Gemma-2 2B's width
# (d = 2304, repro_torch/configs/gemma2_2b.py) when the form is empty,
# else rows x d activations with (d, dout) projections in x's dtype or
# ``w_dtype``, a gelu-gated pair when ``gate``.
_MEASURE_NM_D = 2304


def _measure_norm_matmul(n, dtype, rng, device, d=_MEASURE_NM_D, dout=0,
                         gate=0, w_dtype=None):
    dt = as_dtype(dtype)
    wdt = dt if w_dtype is None else as_dtype(w_dtype)
    rows = max(int(n) // d, 1)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    scale = torch.from_numpy((0.1 * rng.standard_normal(d))
                             .astype(np.float32))
    kw = {"w": None, "scale": scale.to(device)}
    if dout:
        def weight():
            w = rng.standard_normal((d, dout)) / np.sqrt(d)
            return torch.from_numpy(w.astype(np.float32)).to(device, wdt)
        kw["w"] = weight()
        if gate:
            kw.update(w_gate=weight(), act="gelu")
    return x.to(device, dt), kw


# ==================================================== registrations
#
#   mma          single f32-accumulated contraction — distribution-safe,
#                axis-aware (batched).
#   mma_chained  plain chained core: flatten-and-pad, single device.
#   mma_ec       compensated split-bf16 core: the only family honouring
#                policy split_words > 1; flatten-only, single device.
#   pallas       the Hopper kernels B1-B3: flatten-only, single device.
#   pallas_ec    kernel B4, the twin of mma_ec.
#   mma_dd       double-double core: a (hi, lo) pair, accum_dtypes
#                ('float64',) — refused without an explicit f64 policy.
#   pallas_dd    kernel B5, the twin of mma_dd.
#   vpu          classic baseline: safe everywhere.
#
# The scan family: mma_chained (alias mma) is the triangular-MMA core,
# batch axes untouched, so distribution-safe; mma_ec its compensated
# twin; pallas kernel B6, on the flattened input only.
#
# The segment family: mma is the one-hot contraction, batch-free and
# distribution-safe; pallas kernel B7; vpu the scatter-add baseline.

_REDUCE_ENGINES = (
    EngineSpec("mma", _reduce_mma, multi_device_safe=True,
               axis_subsets=True),
    EngineSpec("mma_chained", _reduce_chained, sweep=("chain",)),
    EngineSpec("mma_ec", _reduce_ec, max_split_words=3,
               sweep=("chain", "split_words")),
    EngineSpec("pallas", _reduce_pallas, kernel=True,
               sweep=("chain", "block_rows")),
    EngineSpec("pallas_ec", _reduce_pallas_ec, kernel=True,
               max_split_words=3,
               sweep=("chain", "block_rows", "split_words")),
    EngineSpec("mma_dd", _reduce_dd, max_split_words=2,
               accum_dtypes=("float64",)),
    EngineSpec("pallas_dd", _reduce_pallas_dd, kernel=True,
               max_split_words=2,
               accum_dtypes=("float64",), sweep=("chain", "block_rows")),
    EngineSpec("vpu", _reduce_vpu, multi_device_safe=True,
               axis_subsets=True),
)

register(OpSpec(
    name="reduce_sum", family="reduce", engines=_REDUCE_ENGINES,
    reference=_ref_reduce_sum))

register(OpSpec(
    name="squared_sum", family="reduce",
    engines=(
        EngineSpec("mma", _sq_mma, multi_device_safe=True,
                   axis_subsets=True),
        EngineSpec("mma_chained", _sq_chained, sweep=("chain",)),
        EngineSpec("mma_ec", _sq_ec, max_split_words=3,
                   sweep=("chain", "split_words")),
        EngineSpec("pallas", _sq_pallas, kernel=True,
                   sweep=("chain", "block_rows")),
        EngineSpec("pallas_ec", _sq_pallas_ec, kernel=True,
                   max_split_words=3,
                   sweep=("chain", "block_rows", "split_words")),
        EngineSpec("mma_dd", _sq_dd, max_split_words=2,
                   accum_dtypes=("float64",)),
        EngineSpec("pallas_dd", _sq_pallas_dd, kernel=True,
                   max_split_words=2,
                   accum_dtypes=("float64",),
                   sweep=("chain", "block_rows")),
        EngineSpec("vpu", _sq_vpu, multi_device_safe=True,
                   axis_subsets=True),
    ),
    reference=_ref_squared_sum))

register(OpSpec(
    name="masked_mean", family="reduce",
    engines=(
        EngineSpec("mma", _masked_mean_mma, multi_device_safe=True),
        EngineSpec("mma_chained", _masked_mean_with(_reduce_chained),
                   sweep=("chain",)),
        EngineSpec("pallas", _masked_mean_with(_reduce_pallas), kernel=True,
                   sweep=("chain", "block_rows")),
        EngineSpec("vpu", _masked_mean_with(_reduce_vpu),
                   multi_device_safe=True),
    ),
    reference=_ref_masked_mean, measure=_measure_masked_mean))

register(OpSpec(
    name="expert_counts", family="reduce",
    engines=(
        EngineSpec("mma", _counts_mma, multi_device_safe=True, ndim=2),
        EngineSpec("vpu", _counts_vpu, multi_device_safe=True, ndim=2),
    ),
    reference=_ref_expert_counts, measure=_measure_expert_counts))

_SCAN_ENGINES = (
    EngineSpec("mma_chained", _scan_chained, multi_device_safe=True,
               sweep=("chain",)),
    EngineSpec("mma_ec", _scan_ec, max_split_words=3,
               sweep=("chain", "split_words")),
    EngineSpec("pallas", _scan_pallas, kernel=True, needs_flat=True,
               sweep=("chain", "block_rows")),
    EngineSpec("vpu", _scan_vpu, multi_device_safe=True),
)

for _op in ("scan", "masked_cumsum"):
    register(OpSpec(
        name=_op, family="scan", engines=_SCAN_ENGINES,
        aliases={"mma": "mma_chained"}, reference=_ref_scan,
        size_of=lambda x, kw: x.shape[kw.get("axis", -1)]))

register(OpSpec(
    name="segment_sum", family="segment",
    engines=(
        EngineSpec("mma", _segment_mma, multi_device_safe=True),
        EngineSpec("pallas", _segment_pallas, kernel=True,
                   sweep=("block_rows",)),
        EngineSpec("vpu", _segment_vpu, multi_device_safe=True),
    ),
    aliases={"mma_chained": "mma"}, reference=_ref_segment_sum))

# attention engines:
#   fused_pallas  kernel B9 (kernels/mma_attention.py): qg f32 or bf16,
#                 k and v f32 or bf16 (one dtype, not necessarily qg's),
#                 head dims within _FUSED_MAX_HEAD and hd_v <= 256
#                 (_attn_fused_predicate); causal, window, GQA, per-row
#                 decode positions and the ring-buffer kv_len.
#   unfused_mma   the KV-chunked online softmax (models.attention.
#                 _chunked_attn): dense prefill only (no dynamic
#                 kv_len), any dtype, distribution-safe.
#   vpu           the unchunked oracle (models.attention._direct_attn):
#                 safe everywhere; materialises the score matrix.

register(OpSpec(
    name="attention", family="attention",
    engines=(
        # B9's geometry is fixed by the card and chosen by its form (the
        # mma.sync form: 64 query rows, 32 keys a step; the bf16 prefill
        # form: 128 rows, 64 keys): nothing to sweep.
        EngineSpec("fused_pallas", _attn_fused, kernel=True, ndim=5,
                   dtypes=("float32", "bfloat16"),
                   predicate=_attn_fused_predicate),
        EngineSpec("unfused_mma", _attn_unfused, ndim=5,
                   multi_device_safe=True, sweep=("block_rows",),
                   predicate=_attn_unfused_predicate),
        EngineSpec("vpu", _attn_vpu, ndim=5, multi_device_safe=True),
    ),
    aliases={"pallas": "fused_pallas", "mma": "unfused_mma"},
    reference=_ref_attention,
    # plan keys bucket on score elements, so prefill (Sq*Sk) and decode
    # (1*Sk) land in different n-buckets.
    size_of=lambda qg, kw: (qg.shape[0] * qg.shape[1] * qg.shape[2]
                            * qg.shape[3] * kw["k"].shape[1]),
    form_of=_attention_form, measure=_measure_attention,
    # vpu and unfused_mma multiply in full f32 (TF32 off: 24 bits);
    # B9 in 3xTF32, two TF32 words of each f32 operand with lo x lo
    # dropped, about 2^-22 relative a product: 21 bits.  The reference's
    # TPU engines carried 8.  A bf16 operand caps every engine at 8.
    engine_bits={"vpu": 24, "unfused_mma": 24, "fused_pallas": 21}))


# norm_matmul engines:
#   fused_pallas  kernel B10 with w given (x f32 or bf16, weights f32 or
#                 bf16, any d_model: _nm_fused_predicate), kernel B8 for
#                 the norm-only form (w=None): f32 and bf16, any d_model.
#   unfused_mma   the two-op path (the statistic through tc_reduce_axes,
#                 the matmul in x.dtype), distribution-safe.
#   vpu           the all-f32 baseline, safe everywhere.

register(OpSpec(
    name="norm_matmul", family="norm_matmul",
    engines=(
        # B8's and B10's geometries are fixed by the card (B8's walk a
        # function of d and the dtype; B10's of d and the dtypes, one
        # 128 x 128 tile a block): nothing to sweep.
        EngineSpec("fused_pallas", _nm_fused, kernel=True,
                   dtypes=("float32", "bfloat16"),
                   predicate=_nm_fused_predicate),
        EngineSpec("unfused_mma", _nm_unfused, multi_device_safe=True),
        EngineSpec("vpu", _nm_vpu, multi_device_safe=True),
    ),
    aliases={"pallas": "fused_pallas", "mma": "unfused_mma"},
    reference=_ref_norm_matmul, form_of=_norm_matmul_form,
    measure=_measure_norm_matmul,
    # The unfused statistic and matmul run in full f32 (TF32 off).  The
    # fused kernels' statistics take exact bf16 words of the squares (24
    # bits).  B10 with f32 x multiplies three bf16 words of
    # x * (1 + scale) by three of an f32 weight (the products with
    # i + j < 3) or by a bf16 weight itself: about 2^-22 relative per
    # product, so 21 bits, what is declared, hold for f32 x whatever the
    # weights' dtype (kernels.mma_norm_matmul.walk and product_bits).  A
    # bf16 x keeps 16 bits (two words of x * (1 + scale), or x itself
    # beside two words of (1 + scale) w), and the budget caps every
    # engine at 8 bits there.  The reference's TPU kernel carried 8 (its
    # default).
    engine_bits={"unfused_mma": 24, "fused_pallas": 21}))
