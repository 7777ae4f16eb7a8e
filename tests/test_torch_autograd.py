"""The port under autograd: no call reaches a hand-written kernel, and the
f32 product carries gradients.

  * ``core.reduction._mm`` / ``_bmm`` are one ``torch.autograd.Function``:
    on the ``meta`` device a bf16 product that requires grad gets its
    ``grad_fn`` (on CUDA the ``out_dtype`` overload it runs has no
    derivative of its own); on the CPU its gradients match the f64
    products of the operands within one unit roundoff of the operand
    dtype plus K 2^-24 of sum|terms| (an f32 sum of K products);
  * every op with a kernel engine (``pallas``, ``pallas_ec``,
    ``pallas_dd``, ``fused_pallas``) raises, naming the op and "no
    backward", when the kernel is asked for explicitly on an input that
    requires grad, through ``dispatch``, ``execute`` and
    ``resolve_method`` alike; ``auto`` resolves to a differentiable
    engine for such a call, and its memoised plan does not cross
    between calls with and without grad;
  * where the reference falls back (an engine that cannot serve the
    call's shape or dtype), the port still falls back under grad:
    ``layers.rmsnorm(method='pallas')``, an fp16 ``fused_pallas``;
  * a train step under the ``fused_pallas`` spellings, or under
    ``reduce_method='pallas'`` (whose loss mean is a kernel), raises the
    refusal in the forward pass, as the reference's train step cannot
    differentiate its ``pallas_call``.

CPU only; the card's counterparts are in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.configs.base import TrainConfig
from repro_torch.core import autotune, dispatch, reduction
from repro_torch.core import precision as P
from repro_torch.launch import train as trainlib
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as TZ

KERNEL_SPELLINGS = {"reduce_method": "fused_pallas",
                    "norm_matmul_method": "fused_pallas",
                    "attn_method": "fused_pallas"}


@pytest.fixture()
def fresh(fresh_plan_registry):
    autotune.reset_default_registry()
    yield
    autotune.reset_default_registry()


def _rand(*shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(dtype)


def _problem(op: str):
    """(x, op kwargs, the tensors that take grad) for one op."""
    if op == "attention":
        qg = _rand(1, 5, 2, 2, 16)
        k, v = _rand(1, 7, 2, 16, seed=1), _rand(1, 7, 2, 16, seed=2)
        return qg, dict(k=k, v=v, qpos=torch.arange(2, 7), causal=True)
    if op == "norm_matmul":
        return _rand(6, 32), dict(w=_rand(32, 24, seed=1),
                                  scale=_rand(32, seed=2) * 0.1)
    if op == "masked_mean":
        return _rand(300), dict(mask=torch.ones(300))
    if op == "segment_sum":
        return _rand(300), dict(segment_ids=torch.arange(300) % 7,
                                num_segments=7)
    if op in ("scan", "masked_cumsum"):
        return _rand(300), {}
    return _rand(300), {}


def _kernel_cases():
    for op in dispatch.ops():
        for eng in dispatch.op_spec(op).engines:
            if eng.kernel:
                yield op, eng.name


KERNEL_CASES = list(_kernel_cases())


def _policy(engine: str):
    return P.F64_EQUIVALENT if engine.endswith("_dd") else None


def test_every_kernel_engine_is_marked():
    assert sorted(KERNEL_CASES) == sorted(
        [(op, e) for op in ("reduce_sum", "squared_sum")
         for e in ("pallas", "pallas_ec", "pallas_dd")]
        + [("masked_mean", "pallas"), ("scan", "pallas"),
           ("masked_cumsum", "pallas"), ("segment_sum", "pallas"),
           ("attention", "fused_pallas"), ("norm_matmul", "fused_pallas")])


@pytest.mark.parametrize("op,engine", KERNEL_CASES)
def test_explicit_kernel_under_grad_raises(op, engine, fresh):
    x, kw = _problem(op)
    x.requires_grad_(True)
    pol = _policy(engine)
    with pytest.raises(ValueError, match=f"op '{op}'.*no backward"):
        dispatch.dispatch(op, x, method=engine, precision=pol, **kw)
    with pytest.raises(ValueError, match="no backward"):
        dispatch.resolve_method(op, x, engine, precision=pol, **kw)
    with pytest.raises(ValueError, match="no backward"):
        dispatch.execute(op, x, autotune.ReductionPlan(method=engine),
                         **kw, **({} if pol is None else {"policy": pol}))
    # a weight, key or mask that requires grad counts as well
    others = [t for t in kw.values() if isinstance(t, torch.Tensor)
              and t.is_floating_point()]
    if others:
        x.requires_grad_(False)
        others[0].requires_grad_(True)
        with pytest.raises(ValueError, match="no backward"):
            dispatch.dispatch(op, x, method=engine, precision=pol, **kw)
    # without grad the kernel engine serves the call (its plain version
    # on the CPU)
    with torch.no_grad():
        dispatch.dispatch(op, x, method=engine, precision=pol, **kw)


@pytest.mark.parametrize("op", sorted({op for op, _ in KERNEL_CASES}))
def test_auto_under_grad_takes_a_differentiable_engine(op, fresh):
    x, kw = _problem(op)
    kernels = {e.name for e in dispatch.op_spec(op).engines if e.kernel}
    with torch.no_grad():
        free = dispatch.auto_plan(op, x, **kw).method
    x.requires_grad_(True)
    plan = dispatch.auto_plan(op, x, **kw)
    assert plan.method not in kernels, (op, plan)
    out = dispatch.dispatch(op, x, method="auto", **kw)
    assert out.grad_fn is not None
    # the memo keeps the two contexts apart, in either order
    with torch.no_grad():
        assert dispatch.auto_plan(op, x, **kw).method == free
    assert dispatch.auto_plan(op, x, **kw).method == plan.method


def test_auto_memo_keeps_grad_apart_after_a_kernel_plan(fresh):
    """A plan chosen without grad that names a kernel never serves a call
    under grad."""
    x = _rand(1 << 16)
    with torch.no_grad():
        assert dispatch.auto_plan("squared_sum", x).method == "pallas"
    x.requires_grad_(True)
    out = dispatch.dispatch("squared_sum", x, method="auto")
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out, x)
    torch.testing.assert_close(g, 2 * x.detach(), rtol=1e-6, atol=0)


def test_stay_trainable_fallbacks_hold_under_grad():
    x = _rand(4, 32).requires_grad_(True)
    params = {"scale": torch.zeros(32)}
    # 'pallas' cannot serve the per-row statistic: vpu, as in the reference
    y = L.rmsnorm(params, x, method="pallas")
    want = L.rmsnorm(params, x, method="vpu")
    assert torch.equal(y, want) and y.grad_fn is not None
    # B8 and B9 do not serve fp16: the unfused engines, under grad too
    xh = x.detach().to(torch.float16).requires_grad_(True)
    assert L.rmsnorm(params, xh, method="fused_pallas").grad_fn is not None
    qg = _rand(1, 3, 1, 2, 16, dtype=torch.float16).requires_grad_(True)
    k = _rand(1, 3, 1, 16, seed=1, dtype=torch.float16)
    assert dispatch.resolve_method(
        "attention", qg, "fused_pallas", k=k, v=k,
        qpos=torch.arange(3)) == "vpu"
    # an unknown spelling still raises its own error
    with pytest.raises(ValueError, match="unknown"):
        dispatch.dispatch("reduce_sum", x, method="nope")


def test_meta_bf16_product_gets_the_function_grad_fn():
    a = torch.empty(8, 16, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    b = torch.empty(16, 4, dtype=torch.bfloat16, device="meta")
    out = reduction._mm(a, b)
    assert out.dtype == torch.float32
    assert isinstance(out.grad_fn, reduction._F32Product._backward_cls)
    out3 = reduction._bmm(a[None], b[None])
    assert isinstance(out3.grad_fn, reduction._F32Product._backward_cls)
    # without grad the product is the plain overload: no Function node
    assert reduction._mm(a.detach(), b).grad_fn is None


@pytest.mark.parametrize("dtype,unit", [(torch.float32, 2.0 ** -24),
                                        (torch.bfloat16, 2.0 ** -8),
                                        (torch.float16, 2.0 ** -11)])
@pytest.mark.parametrize("form", ["mm", "bmm"])
def test_f32_product_backward_on_the_cpu(dtype, unit, form):
    shapes = ((24, 64), (64, 20)) if form == "mm" else \
        ((3, 10, 64), (3, 64, 12))
    a = _rand(*shapes[0], seed=1, dtype=dtype).requires_grad_(True)
    b = _rand(*shapes[1], seed=2, dtype=dtype).requires_grad_(True)
    out = (reduction._mm if form == "mm" else reduction._bmm)(a, b)
    assert out.dtype == torch.float32
    up = _rand(*out.shape, seed=3)
    ga, gb = torch.autograd.grad(out, (a, b), up)
    ad, bd, ud = a.double(), b.double(), up.double()
    for got, want, terms in (
            (ga, ud @ bd.transpose(-1, -2),
             ud.abs() @ bd.abs().transpose(-1, -2)),
            (gb, ad.transpose(-1, -2) @ ud,
             ad.abs().transpose(-1, -2) @ ud.abs())):
        assert got.dtype == dtype
        err = (got.double() - want).abs()
        k = up.shape[-1] if got is ga else up.shape[-2]
        assert bool(torch.all(err <= unit * want.abs()
                              + (1 + unit) * k * 2.0 ** -24 * terms))


def _smoke_step(**cfg_kw):
    cfg = dataclasses.replace(TR.get_config("gemma2-2b", smoke=True),
                              **cfg_kw)
    step, make_init = trainlib.make_train_step(
        TZ.build(cfg), TrainConfig(total_steps=4, warmup_steps=1),
        device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 8),
                                     generator=gen),
             "mask": torch.ones((2, 8))}
    return step, make_init(0), batch


@pytest.mark.parametrize("spelling", [
    KERNEL_SPELLINGS, {"reduce_method": "pallas"},
    {"norm_matmul_method": "fused_pallas"}, {"attn_method": "fused_pallas"}])
def test_train_step_under_kernel_spellings_raises(spelling, monkeypatch):
    step, state, batch = _smoke_step(**spelling)
    called = []
    grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **k: called.append(1) or grad(*a, **k))
    before = [p.clone() for p in trainlib._leaves(state.params)]
    with pytest.raises(ValueError, match="no backward"):
        step(state, batch)
    assert not called                      # raised before any backward
    assert all(torch.equal(a, b) for a, b in
               zip(before, trainlib._leaves(state.params)))


def test_train_step_under_auto_trains():
    step, state, batch = _smoke_step(reduce_method="auto",
                                     attn_method="auto",
                                     norm_matmul_method="auto")
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
