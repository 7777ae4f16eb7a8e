"""Rematerialisation and the chunked CE under autograd, in the port, on
the CPU (the counterparts of ``tests/test_perf_variants.py``'s remat
tests and ``tests/test_chunked_ce.py``'s gradients).

  * ``cfg.remat`` none / full / dots / dots_tagged: the same loss bit for
    bit and the same gradients within the reference's test tolerance
    (rtol 1e-4, atol 1e-5), for Gemma-2 2B (dense), DeepSeek-V3 (MLA,
    MoE, MTP), RecurrentGemma (RG-LRU's recurrence, itself recomputed)
    and RWKV-6;
  * the policies really recompute: under ``full`` every block runs again
    in the backward pass, and the products ``dots`` saves (``aten.mm``)
    are not run again there, while ``full`` runs them again;
    ``dots_tagged`` saves the named tensors (``models.remat.TAGGED``);
  * the chunked CE's gradients against the full CE's: f32 activations
    within 1e-4 of each leaf's norm, bf16 within the reference test's
    rtol 5e-2, atol 5e-3; each vocab chunk is recomputed in the backward
    pass; a masked position takes no gradient.

Parameters come from the port's ``init`` (seed 0); batches from numpy.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry as TR
from repro_torch.core.integration import _leaves
from repro_torch.models import model_zoo as TZ
from repro_torch.models import remat as RM
from repro_torch.models import transformer as T

REMAT_ARCHS = ("gemma2-2b", "deepseek-v3-671b", "recurrentgemma-2b",
               "rwkv6-7b")


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)),
            "labels": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)),
            "mask": torch.ones((b, s))}


def _loss_grads(cfg, params, batch):
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = TZ.build(cfg).loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_the_same_loss_and_grads(arch):
    base = TR.get_config(arch, smoke=True)
    params = TZ.build(base).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(base)
    l0, g0 = _loss_grads(dataclasses.replace(base, remat="none"), params,
                         batch)
    for policy in ("full", "dots", "dots_tagged"):
        l1, g1 = _loss_grads(dataclasses.replace(base, remat=policy),
                             params, batch)
        assert torch.equal(l0, l1), (policy, l0, l1)
        for a, b in zip(g0, g1):
            np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=policy)


class _Count(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops, self.n = ops, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(policy: str, monkeypatch) -> tuple:
    """(block_apply calls in the forward pass, in the backward pass,
    aten.mm and checkpoint_name ops run in the backward pass) for one
    Gemma-2 2B SMOKE loss under ``policy``."""
    cfg = dataclasses.replace(TR.get_config("gemma2-2b", smoke=True),
                              remat=policy)
    params = TZ.build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    calls = []
    block = T.block_apply
    monkeypatch.setattr(T, "block_apply",
                        lambda *a, **k: calls.append(1) or block(*a, **k))
    loss, _ = TZ.build(cfg).loss(params, _batch(cfg))
    fwd = len(calls)
    mm = _Count({torch.ops.aten.mm.default})
    named = _Count({torch.ops.repro_torch.checkpoint_name.default})
    with mm, named:
        torch.autograd.grad(loss, leaves, allow_unused=True)
    return fwd, len(calls) - fwd, mm.n, named.n


def test_remat_policies_recompute_what_they_say(monkeypatch):
    layers = TR.get_config("gemma2-2b", smoke=True).num_layers
    none = _backward_counts("none", monkeypatch)
    full = _backward_counts("full", monkeypatch)
    dots = _backward_counts("dots", monkeypatch)
    tagged = _backward_counts("dots_tagged", monkeypatch)
    assert none[:2] == (layers, 0)
    for got in (full, dots, tagged):
        assert got[:2] == (layers, layers)      # every block runs again
    # full runs the forward's products again; dots saved them
    assert full[2] > dots[2] == none[2] == tagged[2]
    # the named tensors are recomputed under dots, saved under dots_tagged
    assert dots[3] > 0 and tagged[3] == 0 and none[3] == 0


def test_checkpoint_name_is_the_identity_without_grad():
    x = torch.randn(3, 4)
    assert RM.checkpoint_name(x, "mixer_out") is x
    y = x.clone().requires_grad_(True)
    z = RM.checkpoint_name(y, "mixer_out")
    assert torch.equal(z, y) and z is not y
    (g,) = torch.autograd.grad(z.sum() * 2, y)
    assert torch.equal(g, torch.full_like(y, 2.0))
    with pytest.raises(ValueError, match="unknown remat policy"):
        RM.run("some", lambda: None)


@pytest.mark.parametrize("arch", ["gemma2-2b", "glm4-9b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ce_grads_match_the_full_ce(arch, dtype):
    """chunk 96 does not divide the vocabulary (512): a ragged last
    chunk."""
    base = dataclasses.replace(TR.get_config(arch, smoke=True),
                               compute_dtype=getattr(torch, dtype))
    params = TZ.build(base).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(base)
    l0, g0 = _loss_grads(base, params, batch)
    for chunk in (96, 128):
        l1, g1 = _loss_grads(dataclasses.replace(base, ce_vocab_chunk=chunk),
                             params, batch)
        assert abs(float(l0) - float(l1)) < 1e-4, (chunk, l0, l1)
        for a, b in zip(g0, g1):
            a, b = a.double().numpy(), b.double().numpy()
            if dtype == "float32":
                assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a) \
                    + 1e-12
            else:
                np.testing.assert_allclose(b, a, rtol=5e-2, atol=5e-3)


def test_chunked_ce_recomputes_each_chunk_and_ignores_masked(monkeypatch):
    cfg = dataclasses.replace(TR.get_config("gemma2-2b", smoke=True),
                              ce_vocab_chunk=128)
    params = TZ.build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    calls = []
    run = RM.run
    monkeypatch.setattr(RM, "run", lambda policy, fn, *a: run(
        policy, lambda *b: calls.append(policy) or fn(*b), *a))
    batch = _batch(cfg)
    _, g_full = _loss_grads(cfg, params, batch)
    chunks = cfg.vocab_size // 128
    # each chunk once forward, once more in the backward pass
    assert calls.count("full") == 2 * chunks
    # a masked position's label takes no gradient: corrupt it, same grads
    mask = torch.ones((2, 16))
    mask[:, 8:] = 0.0
    labels = batch["labels"].clone()
    labels[:, 8:] = 0
    _, g1 = _loss_grads(cfg, params, dict(batch, mask=mask))
    _, g2 = _loss_grads(cfg, params, dict(batch, mask=mask, labels=labels))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recompute_runs_under_the_forwards_sharding_context(policy):
    """On the card the autograd engine runs a backward, and so a remat's
    recompute, on a thread of its own, where the thread-local sharding
    context is empty; a step on this rank's blocks
    (``sharding.local_step``) must recompute under its forward's context
    (the MoE's all-to-alls).  A backward called from another thread
    stands in for the engine's here."""
    import threading
    from repro_torch.distributed import sharding as shd
    seen = []
    w = torch.randn(4, 4)

    def fn(x):
        seen.append(shd.batch_fold())
        return torch.sin(x) @ w

    mesh = object()
    x = torch.randn(4, 4, requires_grad=True)
    with shd.local_step(mesh, ("data",)):
        y = RM.run(policy, fn, x)
    assert shd.batch_fold() is None
    worker = threading.Thread(target=lambda: y.sum().backward())
    worker.start()
    worker.join()
    assert x.grad is not None
    assert seen == [(mesh, ("data",))] * 2
