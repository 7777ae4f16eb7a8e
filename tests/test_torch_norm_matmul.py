"""The port's ``norm_matmul`` op and kernel B8's plain version against the
JAX package, on the CPU.

  * every engine against its oracle and against ``repro.core.dispatch``
    on the reference's full-surface problem (``tests/test_dispatch.py``:
    d = 40, gate, bias, silu) and on the norm-only form, under that
    file's tolerances (f32: 1e-4 relative and 1e-4 * sqrt(n) absolute;
    bf16: 2e-2 and 2e-2 * sqrt(n));
  * the reference's NM_GATES (``scripts/check_error_budget.py``,
    Frobenius percent error against an f64 oracle) for the port's
    engines, and the bit contract ``unfused_mma == the two-op path``;
  * the capability predicate: ``fused_pallas`` with ``w`` given refuses,
    naming kernel B10, and the stay-trainable resolver takes
    ``unfused_mma`` (as it does for an fp16 input, which B8 does not
    serve);
  * B8's plain version ``rmsnorm_plain`` against the reference's
    ``mma_rmsnorm`` run as ``tests/test_kernels.py`` runs it on the CPU
    (interpret mode), under that file's tolerances;
  * the cost model's picks for the op, in the norm-only form and with
    the projection that ``w`` adds.
"""

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import dispatch as jd
from repro.core.precision import MmaPolicy as JPolicy
from repro.kernels import mma_rmsnorm as j_mma_rmsnorm
from repro.kernels import ref as jref
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as td
from repro_torch.core import precision as tp
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import layers as TL

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import check_error_budget as gates  # noqa: E402

mrn = importlib.import_module("repro_torch.kernels.mma_rmsnorm")


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _tol(dtype: str, n: int):
    scale = float(np.sqrt(n))
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2 * scale)
    return dict(rtol=1e-4, atol=1e-4 * scale)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(t, np.float64)


def _problem(dtype: str = "float32", norm_only: bool = False, seed: int = 0):
    """tests/test_dispatch.py's full-surface problem, as (jax, torch)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32)
    x = t(6, 40)
    kw = {"w": t(40, 24), "scale": t(40) * 0.1, "w_gate": t(40, 24),
          "bias": t(24)}
    if norm_only:
        kw = {"scale": kw["scale"]}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = tp.as_dtype(dtype)
    jkw = {k: jnp.asarray(v).astype(jdt) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v).to(tdt) for k, v in kw.items()}
    if norm_only:
        jkw["w"] = tkw["w"] = None
    else:
        jkw["act"] = tkw["act"] = "silu"
    return (jnp.asarray(x).astype(jdt), jkw), (torch.from_numpy(x).to(tdt),
                                               tkw)


@pytest.mark.parametrize("norm_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_engine_matches_oracle_and_reference(dtype, norm_only,
                                                   fresh_registries):
    (jx, jkw), (tx, tkw) = _problem(dtype, norm_only)
    spec = td.op_spec("norm_matmul")
    want = _np(spec.reference(tx, **tkw))
    n = want.size
    np.testing.assert_allclose(
        want, _np(jd.op_spec("norm_matmul").reference(jx, **jkw)),
        **_tol(dtype, n))
    spellings = spec.engine_names() + tuple(spec.aliases) + ("auto",)
    for method in spellings:
        if not norm_only and spec.engine(method) is spec.engine(
                "fused_pallas"):
            with pytest.raises(ValueError, match="B10"):
                td.dispatch("norm_matmul", tx, method=method, **tkw)
            continue
        got = td.dispatch("norm_matmul", tx, method=method, **tkw)
        assert got.dtype == tx.dtype and got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, err_msg=method,
                                   **_tol(dtype, n))
        if method != "auto":
            ref = jd.dispatch("norm_matmul", jx, method=method, **jkw)
            np.testing.assert_allclose(_np(got), _np(ref),
                                       err_msg=f"{method} vs the JAX "
                                               f"package", **_tol(dtype, n))


@pytest.mark.parametrize("seed", gates.SEEDS)
def test_reference_nm_gates_hold_for_the_port_engines(seed):
    x32, s32, w32 = gates.nm_problem(seed)
    want64 = gates.nm_oracle(x32, s32, w32)
    kw = {"w": torch.from_numpy(w32), "scale": torch.from_numpy(s32),
          "eps": gates.NM_EPS}
    checked = []
    for label, plan, ceiling in gates.NM_GATES:
        if plan.method == "fused_pallas":
            continue        # the fused projection is kernel B10
        got = td.execute("norm_matmul", torch.from_numpy(x32),
                         tat.ReductionPlan(method=plan.method), **kw)
        err = gates.nm_percent_error(_np(got), want64)
        assert err <= ceiling, (label, err, ceiling)
        checked.append(label)
    assert checked == ["nm_unfused_mma", "nm_vpu"]
    # The norm-only form, B8's plain version included, against the f64
    # norm of the cast input at the same ceilings.
    norm64 = gates.nm_oracle(x32, s32, np.eye(gates.NM_D, dtype=np.float32))
    kw["w"] = None
    for label, plan, ceiling in gates.NM_GATES:
        got = td.execute("norm_matmul", torch.from_numpy(x32),
                         tat.ReductionPlan(method=plan.method), **kw)
        err = gates.nm_percent_error(_np(got), norm64)
        assert err <= ceiling, (label, err, ceiling)


def _two_op(x32, s32, w32):
    """The port's literal two-op path, written as nm_two_op writes it:
    the statistic through the 'mma' reduce engine, then the matmul in
    the input dtype."""
    xf = torch.from_numpy(x32)
    ms = td.execute("reduce_sum", xf * xf, tat.ReductionPlan(method="mma"),
                    axis=(1,))[..., None] / gates.NM_D
    rstd = torch.rsqrt(ms + gates.NM_EPS)
    xh = (xf * rstd * (1.0 + torch.from_numpy(s32))).to(torch.float32)
    return xh if w32 is None else xh @ torch.from_numpy(w32)


@pytest.mark.parametrize("seed", gates.SEEDS)
def test_unfused_mma_is_bit_identical_to_the_two_op_path(seed):
    x32, s32, w32 = gates.nm_problem(seed)
    for w in (w32, None):
        got = td.execute("norm_matmul", torch.from_numpy(x32),
                         tat.ReductionPlan(method="unfused_mma"),
                         w=None if w is None else torch.from_numpy(w),
                         scale=torch.from_numpy(s32), eps=gates.NM_EPS)
        assert torch.equal(got, _two_op(x32, s32, w))
    # ... and the norm-only form is layers.rmsnorm(method='mma').
    norm = TL.rmsnorm({"scale": torch.from_numpy(s32)},
                      torch.from_numpy(x32), eps=gates.NM_EPS, method="mma")
    assert torch.equal(norm, _two_op(x32, s32, None))


def test_fused_pallas_refuses_w_given_and_resolves_unfused(
        fresh_registries):
    (_, _), (tx, tkw) = _problem()
    with pytest.raises(ValueError, match="B10"):
        td.dispatch("norm_matmul", tx, method="fused_pallas", **tkw)
    with pytest.raises(ValueError, match="B10"):
        td.dispatch("norm_matmul", tx, method="pallas", **tkw)
    assert not td.supported_method("norm_matmul", tx, "fused_pallas", **tkw)
    assert td.resolve_method("norm_matmul", tx, "fused_pallas",
                             fallback="unfused_mma", **tkw) == "unfused_mma"
    td.dispatch("norm_matmul", tx, method="auto", **tkw)
    keys = [k for k, _ in tat.default_registry().items()]
    assert keys == ["norm_matmul|256|float32|cpu|unfused_mma+vpu"
                    "|form:d=40,dout=24,gate=1"], keys
    # The norm-only form: B8 serves any d_model, and only f32 / bf16.
    wide = torch.ones(2, 7168)
    assert td.supported_method("norm_matmul", wide, "fused_pallas", w=None,
                               scale=torch.zeros(7168))
    assert not td.supported_method("norm_matmul", wide.half(),
                                   "fused_pallas", w=None,
                                   scale=torch.zeros(7168))


def test_fp16_fused_pallas_falls_back_to_unfused(fresh_registries):
    """B8 serves f32 and bf16 only: an fp16 call that asks for
    fused_pallas resolves to unfused_mma through the stay-trainable
    resolver (rmsnorm and norm_matmul), and dispatch itself refuses."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    s = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(np.float32))
    xh = x.half()
    assert td.resolve_method("norm_matmul", xh, "fused_pallas",
                             fallback="unfused_mma", w=None,
                             scale=s) == "unfused_mma"
    with pytest.raises(ValueError, match="fused_pallas"):
        td.dispatch("norm_matmul", xh, method="fused_pallas", w=None,
                    scale=s)
    got = TL.rmsnorm({"scale": s}, xh, method="fused_pallas")
    want = td.execute("norm_matmul", xh,
                      tat.ReductionPlan(method="unfused_mma"), w=None,
                      scale=s)
    assert got.dtype == torch.float16 and torch.equal(got, want)


def test_norm_matmul_auto_error_budget(fresh_registries):
    """The tight half of tests/test_dispatch.py's test: a 1e-4 % budget
    that no engine meets falls back to the most accurate engine, the
    full-f32 unfused two-op path.  The loose half (0.5 % admits the
    fused kernel with w given) waits for kernel B10: until then
    fused_pallas refuses w, and 0.5 % resolves to an unfused engine."""
    (jx, jkw), (tx, tkw) = _problem()
    want = _np(td.op_spec("norm_matmul").reference(tx, **tkw))
    for budget in (0.5, 1e-4):
        got = td.dispatch("norm_matmul", tx, method="auto",
                          precision=tp.MmaPolicy(error_budget_pct=budget),
                          **tkw)
        np.testing.assert_allclose(_np(got), want, **_tol("float32",
                                                          want.size))
    plans = dict(tat.default_registry().items())
    tight = {p.method for k, p in plans.items() if ".b0.0001|" in k}
    loose = {p.method for k, p in plans.items() if ".b0.5|" in k}
    assert tight == {"unfused_mma"}, plans
    assert loose <= {"unfused_mma", "vpu"}, plans
    # The reference agrees on the tight half.
    jd.dispatch("norm_matmul", jx, method="auto",
                precision=JPolicy(error_budget_pct=1e-4), **jkw)
    assert {p.method for k, p in jat.default_registry().items()
            if k.endswith("b0.0001")} == {"unfused_mma"}


def test_cost_model_picks_b8_for_the_norm_only_form():
    n = 65536 * 2304            # Gemma-2 2B prefill, 16 x 4096 tokens
    for dtype in (torch.float32, torch.bfloat16):
        plan = tat.autotune(n, dtype, op="norm_matmul")
        assert plan.method == "fused_pallas", (dtype, plan)
        # Without B8 the two unfused engines move the same bytes; the
        # first, unfused_mma, wins the tie, as in the reference.
        restricted = tat.autotune(n, dtype, op="norm_matmul",
                                  engine=("unfused_mma", "vpu"))
        assert restricted.method == "unfused_mma", (dtype, restricted)
    # B8 squares in exact bf16 words: 24 bits, as the f32 engines.
    for method in ("fused_pallas", "unfused_mma", "vpu"):
        assert tat._multiplicand_bits(tat.ReductionPlan(method=method),
                                      torch.float32, "norm_matmul") == 24
    x, kw = tat._measure_problem("norm_matmul", 1 << 14, torch.float32, 0,
                                 "cpu")
    assert x.shape == (7, 2304) and kw["w"] is None


@pytest.mark.parametrize("gate", [0, 1])
def test_cost_model_prices_the_projection_with_w_given(gate,
                                                       fresh_registries):
    """With w given the projection's flops dominate: in bf16 unfused_mma
    multiplies on the tensor cores and vpu in f32 on the CUDA cores, so
    auto resolves to unfused_mma (the reference's order); in f32 the
    two tie and unfused_mma, the first, wins.  fused_pallas cannot serve
    the form (kernel B10)."""
    d, dout = 2304, 9216        # Gemma-2 2B's MLP (gemma2_2b.py:17)
    n = 4096 * d
    form = (("d", d), ("dout", dout), ("gate", gate))
    for dtype in (torch.float32, torch.bfloat16):
        cost = {m: tat.model_cost(tat.ReductionPlan(method=m), n, dtype,
                                  op="norm_matmul", form=form)
                for m in ("fused_pallas", "unfused_mma", "vpu")}
        assert cost["fused_pallas"] == float("inf")
        if dtype == torch.bfloat16:
            assert cost["vpu"] > 5 * cost["unfused_mma"], cost
        else:
            assert cost["vpu"] == cost["unfused_mma"], cost
    # Through dispatch: the call's form keys the plan.
    rng = np.random.default_rng(gate)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    kw = {"w": w.bfloat16(), "scale": torch.zeros(64)}
    if gate:
        kw.update(w_gate=w.bfloat16(), act="gelu")
    plan = td.auto_plan("norm_matmul", x.bfloat16(), **kw)
    assert plan.method == "unfused_mma", plan
    assert tat.default_registry().items()[0][0] == (
        f"norm_matmul|512|bfloat16|cpu|unfused_mma+vpu"
        f"|form:d=64,dout=32,gate={gate}")
    assert td.auto_plan("norm_matmul", x.bfloat16(), w=None,
                        scale=kw["scale"]).method == "fused_pallas"
    # The measured problem has the call's form.
    mx, mkw = tat._measure_problem("norm_matmul", 1 << 14, torch.bfloat16,
                                   0, "cpu", form)
    assert mx.shape == (7, d) and mkw["w"].shape == (d, dout)
    assert mx.dtype == mkw["w"].dtype == torch.bfloat16
    assert ("w_gate" in mkw) == bool(gate)


@pytest.mark.parametrize("rows,d", [(8, 128), (64, 512), (129, 384),
                                    (1, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_the_reference_kernel(rows, d, dtype):
    # tests/test_kernels.py's shapes, inputs and tolerances.
    rng = np.random.default_rng(rows * d)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    w = (rng.normal(size=d) * 0.1).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = tp.as_dtype(dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = ops.mma_rmsnorm(tx, tw)
    assert got.dtype == tdt and got.shape == (rows, d)
    want = j_mma_rmsnorm(jnp.asarray(x).astype(jdt),
                         jnp.asarray(w).astype(jdt))
    np.testing.assert_allclose(
        _np(got), np.asarray(want, np.float64),
        atol=5e-2 if dtype == "bfloat16" else 1e-5, rtol=1e-2)
    np.testing.assert_allclose(_np(got), _np(tref.rmsnorm_ref(tx, tw)),
                               atol=5e-2 if dtype == "bfloat16" else 1e-5,
                               rtol=1e-2)
    np.testing.assert_allclose(
        _np(tref.rmsnorm_ref(tx, tw)),
        np.asarray(jref.rmsnorm_ref(jnp.asarray(x).astype(jdt),
                                    jnp.asarray(w).astype(jdt)), np.float64),
        atol=5e-2 if dtype == "bfloat16" else 1e-5, rtol=1e-2)


def test_rmsnorm_plain_leading_dims_and_offset():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    got = ops.mma_rmsnorm(torch.from_numpy(x), torch.zeros(256),
                          weight_offset=1.0)
    want = j_mma_rmsnorm(jnp.asarray(x), jnp.zeros((256,), jnp.float32),
                         weight_offset=1.0)
    assert got.shape == (2, 3, 256)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [1, 17, 40, 7168])
def test_rmsnorm_plain_statistic_is_the_sum_of_squares(d):
    """Any d >= 1 (ragged tiles, more tiles than warps): the row sums
    equal the f64 sum of the f32 squares to a few f32 roundings, and a
    bf16 row's squares (two exact words) likewise."""
    x = np.random.default_rng(d).uniform(0.5, 1.0, size=(5, d)).astype(
        np.float32)
    for dt in (torch.float32, torch.bfloat16):
        tx = torch.from_numpy(x).to(dt)
        sq = tx.to(torch.float64) ** 2
        want = sq.sum(dim=1)
        got = mrn.row_sums_plain(tx).to(torch.float64)
        assert torch.all((got - want).abs() <= 2.0 ** -20 * want), dt
