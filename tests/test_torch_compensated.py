"""The compensated (ec) and double-double (dd) tier of the PyTorch port
against the JAX package's, on shared numpy inputs, with m = 16 on both
sides.

On the CPU the port's wrappers run the kernels' plain versions
(``ec_plain``, ``dd_plain``); the reference's Pallas kernels run in
interpret mode, as its own tests run them.  Tolerances:

  * ec: 1e-7 of sum|x| (the reference's own rtol for its kernel against
    its compensated oracle, ``tests/test_precision.py``): both sides sum
    the same bf16 words near-exactly and round once to f32 at the end;
  * dd: 1e-13 of sum|x|: both carry ~2^-48 per merge level;
  * f64 input against ``math.fsum``: 1e-12 relative, the example's gate.

No test here turns on ``jax_enable_x64``: f64 data reaches the reference
as the two f32 planes its ``dd_call`` takes.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import dispatch as jd
from repro.core import precision as jp
from repro.core import reduction as jr
from repro.kernels import mma_compensated as jmc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as td
from repro_torch.core import integration as ti
from repro_torch.core import precision as tp
from repro_torch.core import reduction as tr
from repro_torch.examples import integrate
from repro_torch.kernels import mma_compensated as tmc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

M = 16
EC_RTOL = 1e-7
DD_RTOL = 1e-13
GEOMETRIES = [(1, 32), (2, 128)]


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _data(n: int, dist: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return rng.uniform(size=n)
    return rng.normal(size=n)


def _abs_sum(x: np.ndarray, square: bool = False) -> float:
    x = np.asarray(x, np.float64)
    return float(np.sum(np.abs(x * x if square else x)))


def _value(out) -> float:
    """An engine result (scalar or dd pair) as one f64 value."""
    if isinstance(out, torch.Tensor):
        return tp.dd_value(out)
    return jp.dd_value(out)


def _close(got, want, scale: float, rtol: float):
    got, want = _value(got), _value(want)
    assert abs(got - want) <= rtol * scale + 1e-300, (got, want, scale)


# ------------------------------------------------ B4: ec_plain vs ec_call


@pytest.mark.parametrize("dist", ["uniform", "normal"])
@pytest.mark.parametrize("split_words", [2, 3])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("chain,block_rows", GEOMETRIES)
def test_ec_plain_matches_pallas(dist, split_words, square, chain,
                                 block_rows):
    tile = chain * block_rows
    x = _data(3 * tile * M, dist, seed=split_words).astype(np.float32)
    got = tmc.ec_plain(torch.from_numpy(x).reshape(-1, M), chain=chain,
                       block_rows=block_rows, split_words=split_words,
                       square=square)
    want = jmc.ec_call(jnp.asarray(x).reshape(-1, M), chain=chain,
                       block_rows=block_rows, split_words=split_words,
                       interpret=True, square=square)[0, 0]
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, _abs_sum(x, square), EC_RTOL)


# ------------------------------------------------ B5: dd_plain vs dd_call


@pytest.mark.parametrize("dist", ["uniform", "normal"])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("chain,block_rows", GEOMETRIES)
def test_dd_plain_matches_pallas_on_f32(dist, square, chain, block_rows):
    tile = chain * block_rows
    x = _data(2 * tile * M + 5 * M, dist, seed=7).astype(np.float32)
    xt = torch.from_numpy(x)
    got = tmc.dd_plain(tops._to_tiles(xt, tile, M), chain=chain,
                       block_rows=block_rows, square=square)
    hi = jops._to_tiles(jnp.asarray(x), tile, M)
    want = jmc.dd_call(hi, jnp.zeros_like(hi), chain=chain,
                       block_rows=block_rows, interpret=True,
                       square=square)[:, 0]
    assert got.shape == (2,) and got.dtype == torch.float32
    _close(got, want, _abs_sum(x, square), DD_RTOL)


@pytest.mark.parametrize("square", [False, True])
def test_dd_plain_splits_f64_like_the_reference_planes(square):
    """f64 input: the port splits it in place (as B5 does in registers);
    the reference takes the same split as two f32 planes."""
    chain, block_rows = 2, 32
    tile = chain * block_rows
    x = _data(3 * tile * M, "normal", seed=3) * np.exp2(
        np.random.default_rng(4).integers(-8, 8, 3 * tile * M))
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    got = tmc.dd_plain(torch.from_numpy(x).reshape(-1, M), chain=chain,
                       block_rows=block_rows, square=square)
    want = jmc.dd_call(jnp.asarray(hi).reshape(-1, M),
                       jnp.asarray(lo).reshape(-1, M), chain=chain,
                       block_rows=block_rows, interpret=True,
                       square=square)[:, 0]
    _close(got, want, _abs_sum(x, square), DD_RTOL)


# ------------------------------------- f64 input against math.fsum


@pytest.mark.parametrize("method", ["mma_dd", "pallas_dd"])
@pytest.mark.parametrize("op", ["reduce_sum", "squared_sum"])
@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_f64_input_meets_fsum(method, op, dist, fresh_registries):
    x = _data(40_009, dist, seed=11) * 3.7
    want = math.fsum(x * x) if op == "squared_sum" else math.fsum(x)
    out = getattr(ti, op)(torch.from_numpy(x), method=method,
                          precision=tp.F64_EQUIVALENT)
    assert out.shape == (2,) and out.dtype == torch.float32
    got = tp.dd_value(out)
    assert abs(got - want) <= 1e-12 * abs(want), (got, want)


# ------------------------------------------------------- the core twins


@pytest.mark.parametrize("split_words", [2, 3])
@pytest.mark.parametrize("chain", [1, 2, 4])
@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_tc_reduce_ec_matches_reference(split_words, chain, dist):
    x = _data(20_011, dist, seed=chain).astype(np.float32)
    got = tr.tc_reduce_ec(torch.from_numpy(x), split_words=split_words,
                          chain=chain, m=M)
    want = jr.tc_reduce_ec(jnp.asarray(x), split_words=split_words,
                           chain=chain, m=M)
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, _abs_sum(x), EC_RTOL)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("n", [1, 1000, 20_011])
def test_tc_reduce_dd_matches_reference(square, n):
    x = _data(n, "normal", seed=n).astype(np.float32)
    got = tr.tc_reduce_dd(torch.from_numpy(x), square=square)
    want = jr.tc_reduce_dd(jnp.asarray(x), square=square)
    assert got.shape == (2,)
    _close(got, want, _abs_sum(x, square), DD_RTOL)


def test_dd_merge_tree_is_the_reference_bit_for_bit():
    """The port adds each pair of high words as a + b; the reference
    through a pair ones-contraction that rounds once.  Both are fl(a+b),
    so the whole tree agrees bit for bit."""
    rng = np.random.default_rng(5)
    hi = (rng.normal(size=999) * np.exp2(rng.integers(-20, 20, 999))
          ).astype(np.float32)
    lo = (hi * rng.uniform(-2 ** -25, 2 ** -25, 999)).astype(np.float32)
    got = tr._dd_merge_tree(torch.from_numpy(hi), torch.from_numpy(lo))
    want = jr._dd_merge_tree(jnp.asarray(hi), jnp.asarray(lo))
    assert [float(g) for g in got] == [float(w) for w in want]


def test_ref_oracles_match_reference():
    x = _data(5_000, "uniform", seed=2).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for words in (2, 3):
        for square in (False, True):
            _close(tref.ec_reduce_ref(xt, split_words=words, square=square),
                   jref.ec_reduce_ref(xj, split_words=words, square=square),
                   _abs_sum(x, square), EC_RTOL)
    for square in (False, True):
        _close(tref.dd_reduce_ref(xt, square=square),
               jref.dd_reduce_ref(xj, square=square),
               _abs_sum(x, square), DD_RTOL)


# ----------------------------------------------- the ops wrappers


@pytest.mark.parametrize("n", [1, 4_097, 20_011])
@pytest.mark.parametrize("split_words", [2, 3])
@pytest.mark.parametrize("square", [False, True])
def test_mma_ec_wrappers_match_reference(n, split_words, square):
    x = _data(n, "uniform", seed=n).astype(np.float32)
    fn = "mma_ec_squared_sum" if square else "mma_ec_reduce"
    kw = dict(split_words=split_words, chain=2, block_rows=32, m=M)
    got = getattr(tops, fn)(torch.from_numpy(x), **kw)
    want = getattr(jops, fn)(jnp.asarray(x), interpret=True, **kw)
    assert got.device.type == "cpu" and got.dim() == 0
    _close(got, want, _abs_sum(x, square), EC_RTOL)


@pytest.mark.parametrize("n", [1, 4_097, 20_011])
@pytest.mark.parametrize("square", [False, True])
def test_mma_dd_wrappers_match_reference(n, square):
    x = _data(n, "normal", seed=n).astype(np.float32)
    fn = "mma_dd_squared_sum" if square else "mma_dd_reduce"
    kw = dict(chain=2, block_rows=32, m=M)
    got = getattr(tops, fn)(torch.from_numpy(x), **kw)
    want = getattr(jops, fn)(jnp.asarray(x), interpret=True, **kw)
    assert got.shape == (2,) and got.device.type == "cpu"
    _close(got, want, _abs_sum(x, square), DD_RTOL)


def test_wrappers_resolve_auto_geometry_per_engine(fresh_registries):
    x = torch.from_numpy(_data(3_000, "uniform").astype(np.float32))
    tops.mma_ec_reduce(x, chain="auto", block_rows="auto")
    tops.mma_dd_squared_sum(x, chain="auto", block_rows="auto")
    assert [k for k, _ in tat.default_registry().items()] == [
        "reduce_sum|4096|float32|cpu|pallas_ec",
        "squared_sum|4096|float32|cpu|pallas_dd"]


def test_cpu_runs_do_not_count_launches_and_kernels_refuse_cpu():
    tmc.reset_launches()
    x = torch.ones(5_000)
    assert float(tops.mma_ec_reduce(x)) == 5000.0
    assert tops.mma_dd_squared_sum(2 * x).tolist() == [20000.0, 0.0]
    assert tmc.LAUNCHES == {"b4_ec": 0, "b5_dd": 0}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmc.ec_cuda(x, chain=2, block_rows=32, split_words=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmc.dd_cuda(x, chain=2, block_rows=32)


# ------------------------------------------- dispatch: the refusals


@pytest.mark.parametrize("op", ["reduce_sum", "squared_sum"])
def test_dd_refusals_name_the_reason(op):
    x = torch.ones(4_096)
    xj = jnp.ones((4_096,), jnp.float32)
    for eng in ("mma_dd", "pallas_dd"):
        with pytest.raises(ValueError, match="hi, lo"):
            getattr(ti, op)(x, method=eng)
    for eng in ("mma", "mma_chained", "pallas", "vpu", "mma_ec",
                "pallas_ec"):
        with pytest.raises(ValueError, match="accum_dtype"):
            getattr(ti, op)(x, method=eng, precision=tp.F64_EQUIVALENT)
    ctx = td.build_context(op, x, policy=tp.F64_EQUIVALENT)
    jctx = jd.build_context(op, xj, policy=jp.F64_EQUIVALENT)
    assert td.legal_engines(td.op_spec(op), ctx) \
        == jd.legal_engines(jd.op_spec(op), jctx) == ("mma_dd", "pallas_dd")


@pytest.mark.parametrize("op", ["reduce_sum", "squared_sum"])
def test_split_word_policy_is_a_capability_predicate(op):
    x = torch.ones(4_096)
    xj = jnp.ones((4_096,), jnp.float32)
    pol = tp.MmaPolicy(split_words=2)
    for bad in ("vpu", "mma", "mma_chained", "pallas"):
        with pytest.raises(ValueError, match="split_words"):
            getattr(ti, op)(x, method=bad, precision=pol)
    with pytest.raises(ValueError, match="split_words=3"):
        getattr(ti, op)(x, method="mma_dd",
                        precision=tp.MmaPolicy(split_words=3,
                                               accum_dtype=torch.float64))
    ctx = td.build_context(op, x, policy=pol)
    jctx = jd.build_context(op, xj, policy=jp.MmaPolicy(split_words=2))
    assert td.legal_engines(td.op_spec(op), ctx) \
        == jd.legal_engines(jd.op_spec(op), jctx) == ("mma_ec", "pallas_ec")
    got = getattr(ti, op)(x, method="pallas_ec",
                          precision=tp.MmaPolicy(split_words=3))
    assert float(got) == 4096.0


# --------------------------------------------- auto under the budgets


def test_f64_budget_auto_resolves_a_dd_engine(fresh_registries):
    n = 1 << 16
    assert tat.model_percent_error(
        tat.ReductionPlan(method="mma_ec", split_words=3), n,
        torch.float32) > 1e-10
    assert tat.model_percent_error(
        tat.ReductionPlan(method="mma_dd"), n, torch.float32) <= 1e-10
    x = tp.uniform_input(n, seed=5).astype(np.float32)
    out = ti.reduce_sum(torch.from_numpy(x), method="auto",
                        precision=tp.F64_EQUIVALENT)
    assert out.shape == (2,)
    key = tat.plan_key("reduce_sum", n, torch.float32, "cpu",
                       policy=tp.F64_EQUIVALENT)
    plan = tat.default_registry().get(key)
    assert plan is not None and plan.method in ("mma_dd", "pallas_dd")
    assert plan.error_pct is not None and plan.error_pct <= 1e-10
    assert tp.percent_error(tp.dd_value(out),
                            x.astype(np.float64)) <= 1e-10


def test_ec_budget_auto_resolves_three_words(fresh_registries):
    n = 1 << 16
    pol = tp.MmaPolicy(error_budget_pct=1e-4)
    for method in ("mma", "vpu", "pallas"):
        assert tat.model_percent_error(tat.ReductionPlan(method=method), n,
                                       torch.float32) > 1e-4
    x = tp.uniform_input(n, seed=5).astype(np.float32)
    got = ti.reduce_sum(torch.from_numpy(x), method="auto", precision=pol)
    plan = tat.default_registry().get(
        tat.plan_key("reduce_sum", n, torch.float32, "cpu", policy=pol))
    assert plan.method in ("mma_ec", "pallas_ec") and plan.split_words == 3
    assert tp.percent_error(float(got), x.astype(np.float64)) <= 1e-4


# ------------------------------------------- autotune: sweep and model


def test_split_words_sweep_and_policy_pin():
    cands = list(tat.candidate_plans(1 << 20, torch.float32,
                                     engine=("mma_ec", "pallas_ec")))
    for method in ("mma_ec", "pallas_ec"):
        words = {c.split_words for c in cands if c.method == method}
        assert words == set(tat.SPLIT_WORDS) == {2, 3}
    assert len([c for c in cands if c.method == "mma_ec"]) \
        == 2 * len(tat.CHAINS)
    pinned = list(tat.candidate_plans(
        1 << 20, torch.float32, policy=tp.MmaPolicy(split_words=3)))
    assert pinned and {(c.method in ("mma_ec", "pallas_ec"),
                        c.split_words) for c in pinned} == {(True, 3)}
    f64 = list(tat.candidate_plans(1 << 20, torch.float32,
                                   policy=tp.F64_EQUIVALENT))
    assert {c.method for c in f64} == {"mma_dd", "pallas_dd"}
    assert "mma_dd" not in {c.method for c in
                            tat.candidate_plans(1 << 20, torch.float32)}


@pytest.mark.parametrize("method", ["mma_ec", "pallas_ec", "mma_dd",
                                    "pallas_dd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_error_model_is_the_reference_for_the_tier(method, dtype):
    for n in (1000, 1 << 20, 1 << 28):
        for words in (2, 3):
            tplan = tat.ReductionPlan(method=method, split_words=words)
            jplan = jat.ReductionPlan(method=method, split_words=words)
            assert tat.model_percent_error(tplan, n, getattr(torch, dtype)) \
                == jat.model_percent_error(jplan, n, getattr(jnp, dtype))


def test_cost_model_prefers_the_kernels_for_the_tier():
    for n in (1 << 20, 1 << 24, 1 << 28):
        for words in (2, 3):
            kern = tat.ReductionPlan(method="pallas_ec", chain=4,
                                     split_words=words)
            core = tat.ReductionPlan(method="mma_ec", chain=4,
                                     split_words=words)
            assert tat.model_cost(kern, n, torch.float32) \
                < tat.model_cost(core, n, torch.float32)
        assert tat.model_cost(tat.ReductionPlan(method="pallas_dd", chain=4),
                              n, torch.float64) \
            < tat.model_cost(tat.ReductionPlan(method="mma_dd"), n,
                             torch.float64)
        # The tier costs more than the plain kernel it extends.
        assert tat.model_cost(tat.ReductionPlan(method="pallas_ec", chain=4),
                              n, torch.float32) \
            > tat.model_cost(tat.ReductionPlan(method="pallas", chain=4), n,
                             torch.float32)


# ------------------------------------------------ the integration example


@pytest.mark.parametrize("method", ["auto", "pallas_dd"])
def test_integrate_example_on_the_cpu(method, fresh_registries, capsys):
    assert integrate.main(["--device", "cpu", "--method", method]) == 0
    out = capsys.readouterr().out
    assert "ACCURACY GATE: PASS" in out
    got = integrate.run("cpu", method)
    for errs in got["errors"].values():
        assert errs[f"dd:{method}"] <= integrate.GATE_REL
        assert errs["mma"] > integrate.GATE_REL
        assert errs["mma_ec"] > integrate.GATE_REL


def test_integrate_example_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert integrate.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
