"""The port's TC-op registry (``repro_torch.core.dispatch``) against the
JAX package's, on shared numpy inputs.

Registry-driven, as ``tests/test_dispatch.py`` is: every registered op x
every engine (and ``auto``) x {f32, bf16} matches the op's reference
oracle and the JAX package's result for the same method, under that
file's tolerances (f32: 1e-4 relative and 1e-4 * sqrt(n) absolute; bf16
inputs: 2e-2 and 2e-2 * sqrt(n)).  The reference's error ceilings
(``scripts/check_error_budget.py`` GATES) hold for every engine the port
registers, at the gate's probe size.  The double-double engines return
a (hi, lo) pair and run under the f64 policy, as the gate runs them.
The norm_matmul op runs the reference's full-surface problem (d = 40,
gate, bias, silu); the attention op a small grouped-query problem
(causal, a window, a softcap).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import dispatch as jd
from repro.core import precision as jp
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as td
from repro_torch.core import precision as tp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import check_error_budget as gates  # noqa: E402

N = 4_097
PORT_OPS = ("attention", "expert_counts", "masked_cumsum", "masked_mean",
            "norm_matmul", "reduce_sum", "scan", "segment_sum",
            "squared_sum")
# The ops whose output keeps the input's dtype (every reduction is f32).
SAME_DTYPE_OPS = ("attention", "norm_matmul")
DD_ENGINES = ("mma_dd", "pallas_dd")


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _op_inputs(op: str, dtype: str = "float32", seed: int = 0):
    """One numpy problem per op, as the reference's test builds it, and
    its (jax, torch) forms."""
    rng = np.random.default_rng(seed)
    if op == "expert_counts":
        x = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 300)]
        kw = {}
    elif op == "attention":
        # qg (B, Sq, KV, G, hd) against 21 keys, hd_v != hd.
        x = rng.normal(size=(2, 9, 2, 2, 16)).astype(np.float32)
        kw = {"k": rng.normal(size=(2, 21, 2, 16)).astype(np.float32),
              "v": rng.normal(size=(2, 21, 2, 8)).astype(np.float32)}
    elif op == "norm_matmul":
        # tests/test_dispatch.py's full surface: d and dout off any tile,
        # gate + bias + act.
        def t(*shape):
            return rng.normal(size=shape).astype(np.float32)
        x = t(6, 40)
        kw = {"w": t(40, 24), "scale": t(40) * 0.1, "w_gate": t(40, 24),
              "bias": t(24)}
    else:
        x = rng.normal(size=N).astype(np.float32)
        kw = {}
        if op == "masked_mean":
            kw = {"mask": (rng.random(N) > 0.5).astype(np.float32)}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = tp.as_dtype(dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x.copy()).to(tdt)
    jkw = {k: jnp.asarray(v).astype(jdt) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in kw.items()}
    if op == "norm_matmul":
        jkw["act"] = tkw["act"] = "silu"
    if op == "attention":
        qpos = np.arange(12, 21, dtype=np.int32)
        common = {"causal": True, "window": 8, "cap": 20.0, "scale": 0.25}
        jkw.update(qpos=jnp.asarray(qpos), **common)
        tkw.update(qpos=torch.from_numpy(qpos), **common)
    if op == "segment_sum":
        # Integer ids (-1 and one past the end add nothing) and a count.
        ids = rng.integers(-1, 38, N).astype(np.int32)
        jkw = {"segment_ids": jnp.asarray(ids), "num_segments": 37}
        tkw = {"segment_ids": torch.from_numpy(ids), "num_segments": 37}
    return (jx, jkw), (tx, tkw)


def _tol(dtype: str, n: int = N):
    scale = float(np.sqrt(n))
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2 * scale)
    return dict(rtol=1e-4, atol=1e-4 * scale)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(t, np.float64)


def test_registry_mirrors_the_reference_for_this_slice():
    assert td.ops() == PORT_OPS
    for op in PORT_OPS:
        ref = jd.op_spec(op)
        port = td.op_spec(op)
        want = ref.engines
        assert port.engine_names() == tuple(e.name for e in want)
        assert (port.family, port.aliases) == (ref.family, ref.aliases)
        # The precisions that differ: the port's fused kernels B10 and
        # B9 multiply in 3xTF32 (21 bits), where the reference's TPU
        # kernels took the default (8), and the port declares its plain
        # attention engines' full f32 (24) beside B9's.
        bits = dict(ref.engine_bits or {})
        if op == "norm_matmul":
            bits["fused_pallas"] = 21
        if op == "attention":
            bits.update(vpu=24, unfused_mma=24, fused_pallas=21)
        assert port.engine_bits == (bits or ref.engine_bits), op
        for pe, je in zip(port.engines, want):
            # The one knob that differs: the reference sweeps its fused
            # kernels' Pallas grids, while the port's fused_pallas is
            # kernel B8 (w=None; 16 rows, 8 warps a block), B10 (w given;
            # one 128 x 64 tile a block) or B9 (attention; 64 query rows,
            # 32 keys a step), whose geometries are fixed by the card, so
            # it sweeps nothing.
            sweep = () if je.name == "fused_pallas" else je.sweep
            assert (pe.multi_device_safe, pe.axis_subsets, pe.needs_flat,
                    pe.ndim, pe.dtypes, pe.sweep, pe.max_split_words,
                    pe.accum_dtypes, pe.predicate is None) \
                == (je.multi_device_safe, je.axis_subsets, je.needs_flat,
                    je.ndim, je.dtypes, sweep, je.max_split_words,
                    je.accum_dtypes, je.predicate is None), pe.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", PORT_OPS)
def test_every_engine_matches_oracle_and_reference(op, dtype,
                                                   fresh_registries):
    spec = td.op_spec(op)
    (jx, jkw), (tx, tkw) = _op_inputs(op, dtype)
    want = _np(spec.reference(tx, **tkw))
    np.testing.assert_allclose(want, _np(jd.op_spec(op).reference(jx, **jkw)),
                               **_tol(dtype))
    for method in spec.engine_names() + ("auto",):
        # (norm_matmul's fused_pallas with w given is kernel B10's plain
        # version here, held to the reference's kernel in interpret mode.)
        dd = method in DD_ENGINES
        tpol = {"precision": tp.F64_EQUIVALENT} if dd else {}
        jpol = {"precision": jp.F64_EQUIVALENT} if dd else {}
        got = td.dispatch(op, tx, method=method, **tpol, **tkw)
        # norm_matmul and attention return the input's dtype, every
        # reduction f32.
        out_dtype = tx.dtype if op in SAME_DTYPE_OPS else torch.float32
        assert got.device.type == "cpu" and got.dtype == out_dtype
        if dd:
            assert got.shape == (2,)
            got = torch.tensor(tp.dd_value(got))
        np.testing.assert_allclose(_np(got), want, err_msg=f"{op}/{method}",
                                   **_tol(dtype))
        if method != "auto":
            ref = jd.dispatch(op, jx, method=method, **jpol, **jkw)
            ref = jp.dd_value(ref) if dd else ref
            np.testing.assert_allclose(
                _np(got), _np(ref),
                err_msg=f"{op}/{method} vs the JAX package", **_tol(dtype))


@pytest.mark.parametrize("op", ["reduce_sum", "squared_sum"])
@pytest.mark.parametrize("method", ["bogus"])
def test_engines_not_registered_yet_raise(op, method):
    x = torch.ones(64)
    with pytest.raises(ValueError, match="unknown"):
        td.dispatch(op, x, method=method)
    assert not td.supported_method(op, x, method)


def test_capability_refusals_match_the_reference():
    x2 = np.ones((4, 32), np.float32)
    tx, jx = torch.from_numpy(x2), jnp.asarray(x2)
    for method in ("mma_chained", "pallas"):
        for pkg, x in ((td, tx), (jd, jx)):
            with pytest.raises(ValueError, match="flatten-only"):
                pkg.dispatch("reduce_sum", x, method=method, axis=(1,))
    for pkg, x in ((td, tx), (jd, jx)):
        with pytest.raises(ValueError, match="unknown"):
            pkg.dispatch("expert_counts", x, method="pallas")
        with pytest.raises(ValueError, match="ndim == 2"):
            pkg.dispatch("expert_counts", x.reshape(-1), method="mma")
    for op in PORT_OPS:
        tctx = td.build_context(op, tx, multi_device=True)
        jctx = jd.build_context(op, jx, multi_device=True)
        assert td.legal_engines(td.op_spec(op), tctx) \
            == jd.legal_engines(jd.op_spec(op), jctx)


def test_supported_and_resolve_method_match_the_reference():
    x2 = np.ones((4, 32), np.float32)
    tx, jx = torch.from_numpy(x2), jnp.asarray(x2)
    for method in ("mma", "mma_chained", "pallas", "vpu", "auto"):
        for axis in (None, (1,)):
            assert td.supported_method("reduce_sum", tx, method, axis=axis) \
                == jd.supported_method("reduce_sum", jx, method, axis=axis)
            assert td.resolve_method("reduce_sum", tx, method, axis=axis) \
                == jd.resolve_method("reduce_sum", jx, method, axis=axis)
    split = tp.MmaPolicy(split_words=2)
    with pytest.raises(ValueError, match="no engine"):
        td.resolve_method("reduce_sum", tx, "pallas", precision=split)
    with pytest.raises(ValueError, match="no engine"):
        jd.resolve_method("reduce_sum", jx, "pallas",
                          precision=jp.MmaPolicy(split_words=2))


def test_precision_policies(fresh_registries):
    x = torch.from_numpy(
        np.random.default_rng(5).normal(size=1000).astype(np.float32))
    cast = tp.MmaPolicy(input_dtype=torch.bfloat16)
    assert float(td.dispatch("reduce_sum", x, method="mma",
                             precision=cast)) \
        == float(td.dispatch("reduce_sum", x.to(torch.bfloat16),
                             method="mma"))
    got = td.dispatch("reduce_sum", x, method="pallas", precision="highest")
    np.testing.assert_allclose(float(got), float(x.double().sum()),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="split_words=2"):
        td.dispatch("reduce_sum", x, method="pallas",
                    precision=tp.MmaPolicy(split_words=2))
    with pytest.raises(ValueError, match="accum_dtype=float64"):
        td.dispatch("reduce_sum", x, method="vpu",
                    precision=tp.F64_EQUIVALENT)
    td.dispatch("reduce_sum", x, precision=cast)
    assert [k for k, _ in tat.default_registry().items()] \
        == ["reduce_sum|1024|float32|cpu|prec:bfloat16.float32"]


def test_auto_keys_match_the_reference(fresh_registries):
    x = np.random.default_rng(6).normal(size=(8, 300)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for kw in ({}, {"axis": (1,)}):
        td.dispatch("reduce_sum", tx, **kw)
        jd.dispatch("reduce_sum", jx, **kw)
    td.dispatch("squared_sum", tx, method="pallas", chain="auto")
    jd.dispatch("squared_sum", jx, method="pallas", chain="auto")
    port_keys = [k for k, _ in tat.default_registry().items()]
    ref_keys = [k for k, _ in jat.default_registry().items()]
    assert port_keys == ref_keys == [
        "reduce_sum|4096|float32|cpu",
        "reduce_sum|4096|float32|cpu|mma+vpu",
        "squared_sum|4096|float32|cpu|pallas"]


def test_device_rule(monkeypatch):
    x = np.arange(10, dtype=np.float32)
    got = td.dispatch("reduce_sum", torch.from_numpy(x), method="vpu")
    assert got.device.type == "cpu" and float(got) == 45.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.dispatch("reduce_sum", x, method="vpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.as_tensor(3.0)


@pytest.mark.parametrize("seed", gates.SEEDS)
def test_reference_gates_hold_for_the_port_engines(seed):
    x32 = jp.uniform_input(gates.PROBE_N, seed=seed).astype(np.float32)
    checked = []
    for label, op, plan, ceiling in gates.GATES:
        if op not in PORT_OPS or td.op_spec(op).engine(plan.method) is None:
            continue
        port_plan = tat.ReductionPlan(method=plan.method, chain=plan.chain,
                                      block_rows=plan.block_rows,
                                      split_words=plan.split_words)
        # As the gate runs them: the dd engines only under the f64 policy.
        gated = td._policy_reason(td.op_spec(op).engine(plan.method),
                                  None) is not None
        kw = {"policy": tp.F64_EQUIVALENT} if gated else {}
        got = tp.dd_value(td.execute(op, torch.from_numpy(x32), port_plan,
                                     **kw))
        err = tp.percent_error(got, gates.oracle_for(x32, op))
        assert err <= ceiling, (label, err, ceiling)
        checked.append(label)
    assert checked == [label for label, *_ in gates.GATES]
    assert len(checked) == 13
