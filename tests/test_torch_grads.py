"""Gradients of the port's ``Model.loss`` against ``jax.grad`` of the
reference's, on the CPU, for the ten archs at SMOKE size with
``compute_dtype`` f32, with the reference's parameters carried across
(``models.param.from_numpy``) and one numpy batch of 2 x 16 from a seed.

Tolerance: each leaf's ‖g_port - g_ref‖ <= 1e-4 ‖g_ref‖ (both packages
round the same f32 steps, some in another order); a leaf the loss does
not reach (Seamless's cross-attention, whose output the reference's
``selfcross`` block drops) has a zero reference gradient and a port
gradient of None, read as 0.  The loss itself within 1e-5 relative.

Also, in the port: ``tc_linear_recurrence``'s gradients (its local solve
recomputed in the backward pass) against the reference's within 1e-5 of
each gradient's largest magnitude.  The bf16 defaults, the remat
policies and the chunked CE are in ``tests/test_torch_grads_bf16.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import scan as JS
from repro.models import model_zoo as JZ
from repro_torch.configs import registry as TR
from repro_torch.core import scan as TS
from repro_torch.core.integration import _leaves
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP

ARCHS = tuple(TR.list_archs())
F32_RTOL = 1e-4
LOSS_RTOL = 1e-5


def batch_np(cfg, b=2, s=16, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "mask": np.ones((b, s), np.float32)}
    if cfg.vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["src_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def reference(arch: str, f32: bool):
    """(cfg kwargs, jax params as numpy, batch, loss, grad leaves)."""
    kw = {"compute_dtype": jnp.float32} if f32 else {}
    jcfg = dataclasses.replace(JR.get_config(arch, smoke=True), **kw)
    jm = JZ.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    bt = batch_np(jcfg)
    (loss, _), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in bt.items()})
    return (jax.tree_util.tree_map(np.asarray, jp), bt, float(loss),
            [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(g)])


def port_grads(arch: str, f32: bool, **cfg_kw):
    """(loss, grad leaves as f64 numpy) of the port on the reference's
    params and batch."""
    jp, bt, _, _ = reference(arch, f32)
    kw = {"compute_dtype": torch.float32} if f32 else {}
    cfg = dataclasses.replace(TR.get_config(arch, smoke=True), **kw,
                              **cfg_kw)
    params = TP.from_numpy(jp, device="cpu")
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TZ.build(cfg).loss(params, {k: torch.from_numpy(v)
                                          for k, v in bt.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [
        np.zeros(p.shape) if g is None else g.double().numpy()
        for p, g in zip(leaves, grads)]


def leaf_gaps(got: list, want: list) -> list:
    """Each leaf's ‖got - want‖ / ‖want‖ (the absolute gap where want
    is 0)."""
    assert len(got) == len(want)
    out = []
    for a, b in zip(got, want):
        assert a.shape == b.shape
        n = np.linalg.norm(b)
        gap = np.linalg.norm(a - b)
        out.append(gap / n if n > 0 else gap)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_gradients_match_jax_grad(arch):
    _, _, want_loss, want = reference(arch, True)
    loss, got = port_grads(arch, True)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    gaps = leaf_gaps(got, want)
    assert max(gaps) <= F32_RTOL, (arch, max(gaps))


def test_unreached_leaves_are_zero_in_both_packages():
    """Seamless's selfcross block drops its cross-attention output in
    both packages: those leaves' gradients are exactly 0."""
    _, _, _, want = reference("seamless-m4t-large-v2", True)
    _, got = port_grads("seamless-m4t-large-v2", True)
    zero = [i for i, w in enumerate(want) if not np.any(w)]
    assert zero and all(not np.any(got[i]) for i in zero)


@pytest.mark.parametrize("chunk,s", [(16, 37), (8, 16)])
def test_linear_recurrence_gradients_match_the_reference(chunk, s):
    rng = np.random.default_rng(5)
    b, w = 2, 6
    log_a = -np.abs(rng.normal(size=(b, s, w))).astype(np.float32) * 0.3
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    wh = rng.normal(size=(b, s, w)).astype(np.float32)
    wf = rng.normal(size=(b, w)).astype(np.float32)

    def jloss(la, bx, h):
        hs, hf = JS.tc_linear_recurrence(la, bx, h, chunk=chunk)
        return jnp.sum(hs * wh) + jnp.sum(hf * wf)
    want = jax.grad(jloss, argnums=(0, 1, 2))(log_a, x, h0)

    ts = [torch.from_numpy(v).requires_grad_(True) for v in (log_a, x, h0)]
    hs, hf = TS.tc_linear_recurrence(*ts, chunk=chunk)
    loss = torch.sum(hs * torch.from_numpy(wh)) \
        + torch.sum(hf * torch.from_numpy(wf))
    got = torch.autograd.grad(loss, ts)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                   atol=1e-5 * np.max(np.abs(w_)))


def test_linear_recurrence_recomputes_its_local_solve(monkeypatch):
    """Under autograd the local solve runs again in the backward pass
    (``torch.utils.checkpoint``), as ``jax.checkpoint`` in the
    reference."""
    calls = []
    solve = TS._local_solve
    monkeypatch.setattr(TS, "_local_solve",
                        lambda *a: calls.append(1) or solve(*a))
    la = (-torch.rand(1, 32, 4)).requires_grad_(True)
    x = torch.randn(1, 32, 4)
    hs, _ = TS.tc_linear_recurrence(la, x, torch.zeros(1, 4), chunk=16)
    assert len(calls) == 1
    hs.sum().backward()
    assert len(calls) == 2 and la.grad is not None
    with torch.no_grad():
        TS.tc_linear_recurrence(la, x, torch.zeros(1, 4), chunk=16)
    assert len(calls) == 3
