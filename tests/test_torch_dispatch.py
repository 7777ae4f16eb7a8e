"""The port's TC-op registry (``repro_torch.core.dispatch``) against the
JAX package's, on shared numpy inputs.

Registry-driven, as ``tests/test_dispatch.py`` is: every registered op x
every engine (and ``auto``) x {f32, bf16} matches the op's reference
oracle and the JAX package's result for the same method, under that
file's tolerances (f32: 1e-4 relative and 1e-4 * sqrt(n) absolute; bf16
inputs: 2e-2 and 2e-2 * sqrt(n)).  The reference's error ceilings
(``scripts/check_error_budget.py`` GATES) hold for every engine the port
registers, at the gate's probe size.
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
PORT_OPS = ("expert_counts", "masked_mean", "reduce_sum", "squared_sum")
LATER_ENGINES = ("mma_ec", "pallas_ec", "mma_dd", "pallas_dd")


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
        want = tuple(e for e in ref.engines if e.name not in LATER_ENGINES)
        assert port.engine_names() == tuple(e.name for e in want)
        for pe, je in zip(port.engines, want):
            assert (pe.multi_device_safe, pe.axis_subsets, pe.ndim,
                    pe.sweep, pe.max_split_words, pe.accum_dtypes) \
                == (je.multi_device_safe, je.axis_subsets, je.ndim,
                    je.sweep, je.max_split_words, je.accum_dtypes), pe.name


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
        got = td.dispatch(op, tx, method=method, **tkw)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, err_msg=f"{op}/{method}",
                                   **_tol(dtype))
        if method != "auto":
            np.testing.assert_allclose(
                _np(got), _np(jd.dispatch(op, jx, method=method, **jkw)),
                err_msg=f"{op}/{method} vs the JAX package", **_tol(dtype))


@pytest.mark.parametrize("op", ["reduce_sum", "squared_sum"])
@pytest.mark.parametrize("method", LATER_ENGINES + ("bogus",))
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
                                      block_rows=plan.block_rows)
        got = tp.dd_value(td.execute(op, torch.from_numpy(x32), port_plan))
        err = tp.percent_error(got, gates.oracle_for(x32, op))
        assert err <= ceiling, (label, err, ceiling)
        checked.append(label)
    assert checked == ["vpu", "mma", "mma_chained", "pallas", "sq_vpu"]
