"""Rematerialisation: ``cfg.remat`` as ``torch.utils.checkpoint`` — the
counterpart of the reference's ``jax.checkpoint`` policies and its
``checkpoint_name`` tags (``repro.models.transformer.run_stack``).

  * ``none``: nothing is recomputed;
  * ``full``: a layer group keeps only its inputs and is recomputed in
    the backward pass;
  * ``dots``: a selective checkpoint that saves the outputs of products
    without batch dims (``aten.mm``, its ``out_dtype`` overload and
    ``addmm``; ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``)
    and recomputes the rest;
  * ``dots_tagged``: ``dots`` plus the tensors named by
    ``checkpoint_name`` with one of ``TAGGED`` (the reference's
    ``save_only_these_names``).

A name is a custom op (``repro_torch::checkpoint_name``, a copy whose
derivative is the identity) that the selective policy reads; it is
applied only to tensors that require grad, so a forward pass without
autograd runs as before.  The policies change what is saved, never a
value: gradients are the same under all four (``tests/test_torch_grads.py``).
"""

from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint as tuc

from repro_torch.distributed import sharding as shd

POLICIES = ("none", "full", "dots", "dots_tagged")
TAGGED = ("mixer_out", "mlp_out", "moe_post_a2a", "moe_expert_out")


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _named_fake(x, name):
    return torch.empty_like(x)


def _named_backward(ctx, grad):
    return grad, None


_named.register_autograd(_named_backward)


def checkpoint_name(x, name: str):
    """Tag ``x`` for the ``dots_tagged`` policy (the identity unless x
    takes part in autograd)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _named(x, name)
    return x


_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
                  torch.ops.aten.addmm.default)


def _policy(names, ctx, op, *args, **kwargs):
    if op in _NO_BATCH_DOTS:
        return tuc.CheckpointPolicy.MUST_SAVE
    if op is torch.ops.repro_torch.checkpoint_name.default \
            and args[1] in names:
        return tuc.CheckpointPolicy.MUST_SAVE
    return tuc.CheckpointPolicy.PREFER_RECOMPUTE


def run(policy: str, fn, *args):
    """``fn(*args)`` under the remat ``policy``; without autograd (or
    under ``none``) the plain call."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} "
                         f"(accepted: {POLICIES})")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy in ("dots", "dots_tagged"):
        names = TAGGED if policy == "dots_tagged" else ()
        kw["context_fn"] = functools.partial(
            tuc.create_selective_checkpoint_contexts,
            functools.partial(_policy, names))
    # the recompute runs where the backward runs (on the card, the
    # autograd engine's own thread) under the forward's sharding context:
    # a step on this rank's blocks (``sharding.local_step``) recomputes
    # the same collectives
    context = shd.current_context()

    def call(*a):
        with shd.installed(context):
            return fn(*a)
    return tuc.checkpoint(call, *args, **kw)
