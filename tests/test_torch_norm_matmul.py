"""The port's ``norm_matmul`` op and the plain versions of kernels B8
and B10 against the JAX package, on the CPU.

  * every engine against its oracle and against ``repro.core.dispatch``
    on the reference's full-surface problem (``tests/test_dispatch.py``:
    d = 40, gate, bias, silu) and on the norm-only form, under that
    file's tolerances (f32: 1e-4 relative and 1e-4 * sqrt(n) absolute;
    bf16: 2e-2 and 2e-2 * sqrt(n));
  * the reference's NM_GATES (``scripts/check_error_budget.py``,
    Frobenius percent error against an f64 oracle) for all three
    engines, and the bit contract ``unfused_mma == the two-op path``;
  * the capability predicate: ``fused_pallas`` with ``w`` given takes
    f32 and bf16 weights at any d (kernel B10), refuses an fp16 weight
    naming B10, and the stay-trainable resolver then takes
    ``unfused_mma`` (as it does for an fp16 input, which B8 and B10 do
    not serve);
  * B8's plain version ``rmsnorm_plain`` against the reference's
    ``mma_rmsnorm`` run as ``tests/test_kernels.py`` runs it on the CPU
    (interpret mode), under that file's tolerances, and B10's plain
    version ``norm_matmul_plain`` against the reference's
    ``mma_norm_matmul`` in interpret mode (tolerance below);
  * the cost model's picks for the op, in the norm-only form and with
    the projection that ``w`` adds.
"""

import dataclasses
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
from repro.kernels.mma_norm_matmul import mma_norm_matmul as j_mma_nm
from repro.kernels import ref as jref
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as td
from repro_torch.core import precision as tp
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import layers as TL

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import check_error_budget as gates  # noqa: E402

mrn = importlib.import_module("repro_torch.kernels.mma_rmsnorm")
mnm = importlib.import_module("repro_torch.kernels.mma_norm_matmul")


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
        got = td.execute("norm_matmul", torch.from_numpy(x32),
                         tat.ReductionPlan(method=plan.method), **kw)
        err = gates.nm_percent_error(_np(got), want64)
        assert err <= ceiling, (label, err, ceiling)
        checked.append(label)
    assert checked == ["nm_fused_pallas", "nm_unfused_mma", "nm_vpu"]
    # ... and through dispatch's explicit spelling, B10's plain version.
    got = td.dispatch("norm_matmul", torch.from_numpy(x32),
                      method="fused_pallas", **kw)
    assert gates.nm_percent_error(_np(got), want64) <= 5e-3
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
    """With w given fused_pallas is kernel B10: it takes f32 and bf16
    weights, beside an x of either dtype, at any d (the reference's
    512-lane VMEM cap is a TPU fact); it refuses a weight it does not
    take, naming B10, and the stay-trainable resolver then takes
    unfused_mma."""
    (_, _), (tx, tkw) = _problem()
    for x in (tx, tx.bfloat16()):
        for wdt in (torch.float32, torch.bfloat16):
            kw = dict(tkw, w=tkw["w"].to(wdt), w_gate=tkw["w_gate"].to(wdt))
            assert td.supported_method("norm_matmul", x, "fused_pallas",
                                       **kw)
            assert td.resolve_method("norm_matmul", x, "pallas",
                                     fallback="unfused_mma",
                                     **kw) == "pallas"
    wide = torch.ones(2, 7168)
    assert td.supported_method("norm_matmul", wide, "fused_pallas",
                               w=torch.ones(7168, 16),
                               scale=torch.zeros(7168))
    half = dict(tkw, w=tkw["w"].half())
    for spelling in ("fused_pallas", "pallas"):
        with pytest.raises(ValueError, match="B10"):
            td.dispatch("norm_matmul", tx, method=spelling, **half)
    assert not td.supported_method("norm_matmul", tx, "fused_pallas",
                                   **half)
    assert td.resolve_method("norm_matmul", tx, "fused_pallas",
                             fallback="unfused_mma", **half) == "unfused_mma"
    # ... an fp16 policy casts the weights to what B10 does not take.
    assert not td.supported_method(
        "norm_matmul", tx, "fused_pallas",
        precision=tp.MmaPolicy(input_dtype=torch.float16), **tkw)
    # The index limits: an (rows x dout) grid past 2^31 blocks.
    huge = td.build_context("norm_matmul", torch.empty(0), extras=(
        ("d_model", 64), ("d_out", 2 ** 30), ("has_gate", True),
        ("w_dtypes", ("float32",))))
    huge = dataclasses.replace(huge, shape=(1 << 20, 64))
    assert "B10" in td._nm_fused_predicate(huge)
    td.dispatch("norm_matmul", tx, method="auto", **tkw)
    keys = [k for k, _ in tat.default_registry().items()]
    assert keys == ["norm_matmul|256|float32|cpu|form:d=40,dout=24,"
                    "gate=1"], keys
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
    """tests/test_dispatch.py's test: a 0.5 % budget admits the fused
    kernel with w given (B10) and picks it as the cheaper plan (it
    moves the fewest bytes at this size), while a 1e-4 % budget that no
    engine meets falls back to the most accurate engine, the full-f32
    unfused two-op path (24 bits against B10's 21)."""
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
    assert loose == {"fused_pallas"}, plans
    # The reference agrees on both halves.
    for budget in (0.5, 1e-4):
        jd.dispatch("norm_matmul", jx, method="auto",
                    precision=JPolicy(error_budget_pct=budget), **jkw)
    jplans = dict(jat.default_registry().items())
    assert {p.method for k, p in jplans.items()
            if k.endswith("b0.0001")} == {"unfused_mma"}
    assert {p.method for k, p in jplans.items()
            if k.endswith("b0.5")} == {"fused_pallas"}


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
    # The unfused engines carry f32's 24 bits; fused_pallas 21, what
    # B10's 3xTF32 products keep (B8's exact bf16 words would keep 24).
    for method, bits in (("fused_pallas", 21), ("unfused_mma", 24),
                         ("vpu", 24)):
        assert tat._multiplicand_bits(tat.ReductionPlan(method=method),
                                      torch.float32, "norm_matmul") == bits
    x, kw = tat._measure_problem("norm_matmul", 1 << 14, torch.float32, 0,
                                 "cpu")
    assert x.shape == (7, 2304) and kw["w"] is None


@pytest.mark.parametrize("gate", [0, 1])
def test_cost_model_prices_the_projection_with_w_given(gate,
                                                       fresh_registries):
    """With w given the projection's flops dominate: in bf16 unfused_mma
    multiplies on the tensor cores and vpu in f32 on the CUDA cores, so
    auto resolves to unfused_mma (the reference's order); in f32 the
    two tie on the card and differ by their host time per call.
    fused_pallas (kernel B10) is priced: its passes' bytes (x and its
    words where the form splits x, the weights and an f32 weight's words,
    the output, each word written and read once) at its fitted byte
    rate, its flops at the fitted rate of its form (x's and the weights'
    dtypes), and its host time, so an f32 weight beside bf16 rows is
    priced at that form's rate and bytes."""
    d, dout = 2304, 9216        # Gemma-2 2B's MLP (gemma2_2b.py:17)
    n = 4096 * d
    form = (("d", d), ("dout", dout), ("gate", gate))
    for dtype in (torch.float32, torch.bfloat16):
        cost = {m: tat.model_cost(tat.ReductionPlan(method=m), n, dtype,
                                  op="norm_matmul", form=form)
                for m in ("fused_pallas", "unfused_mma", "vpu")}
        flops = 2.0 * n * dout * (1 + gate)
        name = tp.dtype_name(dtype)
        rate = tat._B10_FLOPS_PER_US[f"{name}/{name}"]
        assert flops / rate < cost["fused_pallas"] < float("inf"), cost
        if dtype == torch.bfloat16:
            assert cost["vpu"] > 5 * cost["unfused_mma"], cost
        else:
            host = tat._NM_HOST_US
            assert cost["unfused_mma"] - cost["vpu"] == pytest.approx(
                host["unfused_mma"] - host["vpu"]), cost
    mixed = form + (("w_dtype", "float32"),)
    for f, w_dtype, w_item in ((form, "bfloat16", 2), (mixed, "float32", 4)):
        # bf16 rows: two words of x with bf16 weights; x itself beside f32
        # weights, whose two words the weight pass makes.
        x_side, w_side = (2 + 8, 2) if w_item == 2 else (2 + 2, 4 + 8)
        assert mnm.walk(d, torch.bfloat16, tp.as_dtype(w_dtype)).fold_w \
            == (w_item == 4)
        nbytes = n * x_side + (1 + gate) * d * dout * w_side \
            + n / d * dout * 2
        rate = tat._B10_FLOPS_PER_US[f"bfloat16/{w_dtype}"]
        want = nbytes / tat._B10_BYTES_PER_US \
            + 2.0 * n * dout * (1 + gate) / rate \
            + tat._NM_HOST_US["fused_pallas"]
        got = tat.model_cost(tat.ReductionPlan(method="fused_pallas"), n,
                             torch.bfloat16, op="norm_matmul", form=f)
        assert got == pytest.approx(want), (f, got, want)
    # Through dispatch: the call's form keys the plan.  At this toy size
    # B10, which moves the fewest bytes, is the pick; a weight of
    # another dtype than x's keys plans of its own.
    rng = np.random.default_rng(gate)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    kw = {"w": w.bfloat16(), "scale": torch.zeros(64)}
    if gate:
        kw.update(w_gate=w.bfloat16(), act="gelu")
    mixed_kw = {k: (v.float() if k in ("w", "w_gate") else v)
                for k, v in kw.items()}
    for call in (kw, mixed_kw):
        plan = td.auto_plan("norm_matmul", x.bfloat16(), **call)
        assert plan.method == "fused_pallas", plan
    keys = [k for k, _ in tat.default_registry().items()]
    form_tag = f"|form:d=64,dout=32,gate={gate}"
    assert keys == [f"norm_matmul|512|bfloat16|cpu{form_tag}{suffix}"
                    for suffix in ("", ",w_dtype=float32")], keys
    assert td.auto_plan("norm_matmul", x.bfloat16(), w=None,
                        scale=kw["scale"]).method == "fused_pallas"
    # The measured problem has the call's form.
    mx, mkw = tat._measure_problem("norm_matmul", 1 << 14, torch.bfloat16,
                                   0, "cpu", form)
    assert mx.shape == (7, d) and mkw["w"].shape == (d, dout)
    assert mx.dtype == mkw["w"].dtype == torch.bfloat16
    assert ("w_gate" in mkw) == bool(gate)
    mx, mkw = tat._measure_problem("norm_matmul", 1 << 14, torch.bfloat16,
                                   0, "cpu", mixed)
    assert mx.dtype == torch.bfloat16 and mkw["w"].dtype == torch.float32


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


# B8's walk for each d and dtype, (cluster, chunks a warp, resident
# chunks), worked out by hand from csrc/mma_rmsnorm.cu's walk(): a chunk
# is 128 bytes of a row (32 f32 / 64 bf16 columns), a warp takes at
# least 2 chunks, a cluster at most 8 blocks of 8 warps, a warp holds at
# most 12 chunks.
B8_WALKS = {
    (1, torch.float32): (1, 2, 2),
    (1, torch.bfloat16): (1, 2, 2),
    (17, torch.float32): (1, 2, 2),
    (17, torch.bfloat16): (1, 2, 2),
    (40, torch.float32): (1, 2, 2),
    (40, torch.bfloat16): (1, 2, 2),
    (2304, torch.float32): (5, 2, 2),
    (2304, torch.bfloat16): (3, 2, 2),
    (4096, torch.float32): (8, 2, 2),
    (4096, torch.bfloat16): (4, 2, 2),
    (7168, torch.float32): (7, 4, 4),
    (7168, torch.bfloat16): (7, 2, 2),
}


def test_rmsnorm_walk_matches_the_cuda_source():
    """The Python walk uses the .cu's constants and gives the walk the
    .cu's rule gives for d in {1, 17, 40, 2304, 4096, 7168}."""
    import re
    src = open(os.path.join(os.path.dirname(mrn.__file__), "csrc",
                            "mma_rmsnorm.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             src).group(1).replace("32 * kWarps", "256"))
    assert const("kWarps") == mrn.WARPS
    assert const("kChunkBytes") == mrn.CHUNK_BYTES
    assert const("kChunkMin") == mrn.CHUNK_MIN
    assert const("kClusterMax") == mrn.CLUSTER_MAX
    assert const("kChunkResident") == mrn.CHUNK_RESIDENT
    assert re.search(r"constexpr int kChunkStride = 17 \* kChunkBytes;", src)
    assert mrn.CHUNK_STRIDE == 17 * mrn.CHUNK_BYTES
    for (d, dt), want in B8_WALKS.items():
        assert mrn.walk(d, dt) == want, (d, dt)
    # Every walk fits a block's 227 KB of shared memory, and a cluster is
    # never more than the portable 8 blocks, at any d.
    for d in (1, 2304, 7169, 12288, 24576, 24577, 1 << 20, 2 ** 31 - 1):
        for dt in (torch.float32, torch.bfloat16):
            cluster, chunks, resident = mrn.walk(d, dt)
            assert 1 <= cluster <= mrn.CLUSTER_MAX
            assert resident == min(chunks, mrn.CHUNK_RESIDENT)
            cols = mrn.CHUNK_BYTES // (4 if dt == torch.float32 else 2)
            assert cluster * mrn.WARPS * chunks * cols >= d
            assert (cluster - 1) * mrn.WARPS * chunks * cols < d
            assert mrn.smem_bytes(d, dt) <= 232448


@pytest.mark.parametrize("d", [17, 2304, 7169, 24577])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plain_adds_in_the_walks_order(d, dtype):
    """row_sums_plain is the tiles' sums added as the kernel adds them:
    per warp its consecutive tiles from 0, then warp order, then cluster
    rank order, in f32 (here one row, added one scalar at a time)."""
    x = np.random.default_rng(d).normal(size=(3, d)).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    tiles = mrn.tile_sums_plain(tx).numpy()
    cluster, chunks, _ = mrn.walk(d, dtype)
    per_warp = chunks * mrn.CHUNK_BYTES // (16 * tx.element_size())
    got = mrn.row_sums_plain(tx).numpy()
    for r in range(3):
        total = np.float32(0)
        for c in range(cluster):
            block = np.float32(0)
            for w in range(mrn.WARPS):
                acc = np.float32(0)
                first = (c * mrn.WARPS + w) * per_warp
                for k in range(first, min(first + per_warp, tiles.shape[1])):
                    acc = np.float32(acc + tiles[r, k])
                block = acc if w == 0 else np.float32(block + acc)
            total = block if c == 0 else np.float32(total + block)
        assert got[r] == total, (r, got[r], total)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plain_row_bits_do_not_depend_on_rows(dtype):
    """The walk is a function of d and the dtype: a row of rmsnorm_plain
    has the same bits in calls of 1, 17 and 4099 rows."""
    d = 2304
    rng = np.random.default_rng(4099)
    x = torch.from_numpy(rng.normal(size=(4099, d)).astype(np.float32))
    x = x.to(dtype)
    w = torch.from_numpy((rng.normal(size=d) * 0.1).astype(np.float32))
    full = mrn.rmsnorm_plain(x, w, weight_offset=1.0)
    for n in (1, 17):
        part = mrn.rmsnorm_plain(x[:n], w, weight_offset=1.0)
        assert torch.equal(part, full[:n]), n
    assert torch.equal(mrn.rmsnorm_plain(x[4090:], w, weight_offset=1.0),
                       full[4090:])


# ------------------------------------------------------------ B10 plain

# B10's plain version against the reference's fused kernel run in
# interpret mode on the CPU (its dispatch predicate refuses d > 512 on
# the TPU; the kernel itself runs at any d).  Both multiply
# x * (1 + scale) by the weights with f32 accumulation: the reference in
# f32, the port in bf16 words (about 2^-22 relative per product with f32
# x, kernels.mma_norm_matmul.walk) and another order of adds.  f32 output: the Frobenius distance between
# the two within 2^-17 of the output's norm (seen: 3e-7 relative).
# bf16 output: every element within one bf16 ulp (2^-7 relative at
# most) plus 1e-5, since the f32 values before the rounding differ by
# far less than an ulp, and a rounding boundary may fall between them.
# Against the f64 oracle of the cast inputs: f32 within NM_GATES' 5e-3
# % (seen: 2.6e-5 %), bf16 within 5e-3 % plus the output's unit
# roundoff, 100 * 2^-8 % (seen: 0.18 %).
NM_CASES = [(64, 256, 128, None, False), (37, 200, 100, "silu", True),
            (37, 200, 100, "gelu", True), (37, 200, 100, "gelu", False)]
NM_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
             ("bfloat16", "float32"), ("float32", "bfloat16")]


def _nm_inputs(rows, d, dout, act, bias, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    s = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (rng.standard_normal((d, dout)) / np.sqrt(d)).astype(np.float32)
    wg = (rng.standard_normal((d, dout)) / np.sqrt(d)).astype(np.float32) \
        if act else None
    b = rng.standard_normal(dout).astype(np.float32) if bias else None
    return x, s, w, wg, b


def _nm_oracle(x, s, w, wg, b, act):
    """f64 rmsnorm(x) @ w of the cast inputs, with the gate pair."""
    x64 = torch.as_tensor(x).double()
    ms = torch.mean(x64 * x64, dim=-1, keepdim=True)
    xh = x64 / torch.sqrt(ms + 1e-6) * (1.0 + torch.as_tensor(s).double())
    up = xh @ torch.as_tensor(w).double()
    if b is not None:
        up = up + torch.as_tensor(b).double()
    if wg is not None:
        up = mnm.apply_act(xh @ torch.as_tensor(wg).double(), act) * up
    return up


@pytest.mark.parametrize("x_dtype,w_dtype", NM_DTYPES)
@pytest.mark.parametrize("rows,d,dout,act,bias", NM_CASES)
def test_norm_matmul_plain_matches_the_reference_kernel(rows, d, dout, act,
                                                       bias, x_dtype,
                                                       w_dtype):
    x, s, w, wg, b = _nm_inputs(rows, d, dout, act, bias, rows * d)
    jx, jw = (jnp.asarray(x).astype(x_dtype), jnp.asarray(w).astype(w_dtype))
    tx = torch.from_numpy(x).to(tp.as_dtype(x_dtype))
    tw = torch.from_numpy(w).to(tp.as_dtype(w_dtype))
    twg = None if wg is None else torch.from_numpy(wg).to(tw.dtype)
    tb = None if b is None else torch.from_numpy(b)
    got = ops.mma_norm_matmul(tx, torch.from_numpy(s), tw, w_gate=twg,
                              bias=tb, act=act)
    assert got.dtype == tx.dtype and got.shape == (rows, dout)
    want = j_mma_nm(jx, jnp.asarray(s), jw,
                    w_gate=None if wg is None
                    else jnp.asarray(wg).astype(w_dtype),
                    bias=None if b is None else jnp.asarray(b), act=act,
                    interpret=True)
    want = np.asarray(want, np.float64)
    if x_dtype == "float32":
        assert np.linalg.norm(_np(got) - want) \
            <= 2.0 ** -17 * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7, atol=1e-5)
    # Both against the f64 oracle of the cast inputs, within NM_GATES.
    oracle = _nm_oracle(tx, s, tw, twg, tb, act).numpy()
    ceiling = 5e-3 + (100.0 * 2.0 ** -8 if x_dtype == "bfloat16" else 0.0)
    for out in (_np(got), want):
        assert gates.nm_percent_error(out, oracle) <= ceiling
    # ... and the plain oracle of kernels.ref.
    ref = tref.norm_matmul_ref(tx, torch.from_numpy(s), tw, w_gate=twg,
                               bias=tb, act=act)
    assert gates.nm_percent_error(_np(ref), oracle) <= ceiling


def test_norm_matmul_plain_decomposition():
    """The TF32 words keep 22 bits (hi has 11 significant bits, ties
    round away from zero), the statistic is the sum of squares to a few
    f32 roundings at any d, and leading dims pass through ops."""
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0e-5])
    hi, lo = mnm.tf32_words(v)
    assert hi.tolist()[:3] == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                               1.0 + 2.0 ** -10]
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = mnm.tf32_words(x)
    assert torch.all((hi.double() + lo.double() - x.double()).abs()
                     <= 2.0 ** -22 * x.double().abs())
    for d in (1, 17, 40, 7168):
        xs = np.random.default_rng(d).uniform(0.5, 1.0, size=(5, d))
        for dt in (torch.float32, torch.bfloat16):
            tx = torch.from_numpy(xs.astype(np.float32)).to(dt)
            want = (tx.double() ** 2).sum(dim=1)
            got = mnm.row_sums_plain(tx).double()
            assert torch.all((got - want).abs() <= 2.0 ** -20 * want), dt
    x3, s, w, wg, _ = _nm_inputs(6, 40, 24, "silu", False, 3)
    tx3 = torch.from_numpy(x3).reshape(2, 3, 40)
    got = ops.mma_norm_matmul(tx3, torch.from_numpy(s), torch.from_numpy(w),
                              w_gate=torch.from_numpy(wg), act="silu")
    flat = mnm.norm_matmul_plain(torch.from_numpy(x3), torch.from_numpy(s),
                                 torch.from_numpy(w),
                                 w_gate=torch.from_numpy(wg), act="silu")
    assert got.shape == (2, 3, 24) and torch.equal(got.reshape(6, 24), flat)


B10_FORMS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


def test_b10_walk_is_a_function_of_d_and_the_dtypes():
    """B10's k-walk takes d and the two dtypes and nothing else (no row
    count): the step, the words of each side, where 1 + scale goes, the
    products (the smaller first) and the statistic's runs, which are
    B8's."""
    import inspect
    assert list(inspect.signature(mnm.walk).parameters) == [
        "d", "x_dtype", "w_dtype"]
    f32, bf16 = torch.float32, torch.bfloat16
    want = {(f32, f32): (3, 3, False, [(0, 2), (1, 1), (2, 0), (0, 1),
                                       (1, 0), (0, 0)]),
            (f32, bf16): (3, 1, False, [(2, 0), (1, 0), (0, 0)]),
            (bf16, f32): (1, 2, True, [(0, 1), (0, 0)]),
            (bf16, bf16): (2, 1, False, [(1, 0), (0, 0)])}
    for d in (1, 33, 2304, 2305, 7168):
        for (xdt, wdt), (a_words, b_words, fold_w, pairs) in want.items():
            wk = mnm.walk(d, xdt, wdt)
            assert (wk.step, wk.a_words, wk.b_words, wk.fold_w) == (
                64, a_words, b_words, fold_w)
            assert mnm.products(wk) == pairs
            assert (wk.ranks, wk.chunks) == mrn.walk(d, xdt)[:2]


def test_b10_walk_matches_the_cuda_source():
    """The Python walk is the .cu's Form and stat_walk: the same rules
    for the step, the words and the levels, and B8's constants for the
    statistic."""
    import re
    src = open(os.path.join(os.path.dirname(mnm.__file__), "csrc",
                            "mma_norm_matmul.cu")).read()
    for rule in (r"kFoldW = XDT == kBF16 && WDT == kF32;",
                 r"kFF = XDT == kF32 && WDT == kF32;",
                 r"kAWords = kFoldW \? 1 : \(XDT == kF32 \? 3 : 2\);",
                 r"kBWords = kFF \? 3 : \(kFoldW \? 2 : 1\);",
                 r"kLevels = XDT == kF32 \? 3 : 2;"):
        assert re.search(rule, src), rule
    for name, value in (("kStep", mnm.STEP),
                        ("kStatWarps", mrn.WARPS),
                        ("kChunkBytes", mrn.CHUNK_BYTES),
                        ("kChunkMin", mrn.CHUNK_MIN),
                        ("kClusterMax", mrn.CLUSTER_MAX),
                        ("kBM", mnm.BLOCK_ROWS), ("kBN", mnm.BLOCK_COLS),
                        ("kGroup", mnm.GROUP)):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert got and int(got.group(1)) == value, name


@pytest.mark.parametrize("x_dtype,w_dtype", B10_FORMS)
def test_b10_forms_keep_the_bits_the_cost_model_credits(x_dtype, w_dtype):
    """Every form keeps at least the bits the error model credits B10
    with (``engine_bits``, capped by x's dtype): 21 or more wherever x
    is f32, whatever the weights' dtype, and 16 where x is bf16, as its
    contract says."""
    wk = mnm.walk(2304, x_dtype, w_dtype)
    bits = mnm.product_bits(wk)
    assert bits >= (21 if x_dtype == torch.float32 else 16), (wk, bits)
    form = (("d", 2304), ("dout", 9216), ("gate", 1))
    if w_dtype != x_dtype:
        form += (("w_dtype", tp.dtype_name(w_dtype)),)
    credited = tat._multiplicand_bits(
        tat.ReductionPlan(method="fused_pallas"), x_dtype,
        op="norm_matmul", form=form)
    assert credited <= bits, (credited, bits)


@pytest.mark.parametrize("x_dtype,w_dtype", B10_FORMS)
def test_norm_matmul_plain_row_bits_do_not_depend_on_rows(x_dtype, w_dtype):
    """The walk is a function of d and the dtypes: rows 0..16 of
    norm_matmul_plain have the same bits in calls of 17 and 300 rows, in
    every form (d ragged against both steps, both projections and a
    bias).  The gate goes in without an activation: torch's CPU silu and
    gelu take a vector or a scalar path by an element's place in the
    tensor, so their last bit may differ between the two calls; the
    kernel's activations are its own."""
    x, s, w, wg, b = _nm_inputs(300, 200, 24, "gelu", True, 300)
    tx = torch.from_numpy(x).to(x_dtype)
    tw, twg = (torch.from_numpy(m).to(w_dtype) for m in (w, wg))
    call = dict(w_gate=twg, bias=torch.from_numpy(b), act=None)
    full = mnm.norm_matmul_plain(tx, torch.from_numpy(s), tw, **call)
    part = mnm.norm_matmul_plain(tx[:17], torch.from_numpy(s), tw, **call)
    assert torch.equal(part, full[:17])
