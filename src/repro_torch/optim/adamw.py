"""AdamW from scratch — the counterpart of ``repro.optim.adamw``, formula
for formula:

  * f32 math for every update, the moments stored in ``moment_dtype``
    (bf16 moments halve the optimizer's memory);
  * global-norm gradient clipping through the paper's MMA reduction
    engine (``distributed.tc_collectives.tc_global_norm``: one
    ``squared_sum`` a leaf, the leaf scalars summed in f32, one sqrt);
  * ``state_axes``: the moments take the parameters' logical axes.

The state is nested dicts of tensors on the parameters' device.  Over
a mesh of ranks (``launch.train``'s sharded state) the parameters,
gradients and moments are ``DTensor``s of each rank's blocks, a moment
laid out as its parameter (the ZeRO-sharded moments of the reference's
``state_axes``): the clip's norm folds each leaf over the mesh axes it
is split over, and the update runs on each rank's local blocks.
``update`` writes the new parameters, moments and count into the given
tensors, leaf by leaf (the memory a jitted step's donated buffers would
reuse: a Gemma-2 2B step holds parameters, gradients and two moments,
~42 GB in f32), and clips each gradient leaf as it reaches it, so the
step holds no clipped copy of the tree; the bits are the reference
formula's, op for op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.integration import _leaves
from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.distributed.sharding import local
from repro_torch.models.param import _map


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    count: torch.Tensor


def _device(tree):
    leaves = _leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def init(params, *, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return AdamWState(
        m=_map(zeros, params), v=_map(zeros, params),
        count=torch.zeros((), dtype=torch.int32, device=_device(params)))


def state_axes(param_axes) -> AdamWState:
    """Logical axes for the optimizer state (mirrors the params)."""
    return AdamWState(m=param_axes, v=param_axes, count=())


def _clip_scale(norm, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def _clipped(g, scale) -> torch.Tensor:
    return (g.to(ACCUM_DTYPE) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float, *, method: str = "mma"):
    """Returns (clipped grads, pre-clip norm).  The norm is the paper's
    MMA-encoded reduction (``tc_collectives.tc_global_norm``), one
    ``squared_sum`` dispatch a leaf: under ``method='pallas'`` each leaf
    is one launch of kernel B1 (``square=True``), the gradient-norm
    hot-spot the paper's kernel names.  An engine a leaf cannot serve
    resolves to the ``mma`` contraction: training survives every
    ``reduce_method`` spelling."""
    from repro_torch.distributed import tc_collectives
    with torch.no_grad():
        norm = tc_collectives.tc_global_norm(grads, method=method)
        scale = _clip_scale(norm, max_norm)
        return _map(lambda g: _clipped(g, scale), grads), norm


def _step_leaf(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, c1,
               c2) -> None:
    """One leaf's step, written into p, m and v: f32 math, each op the
    formula's (``m' = b1 m + (1 - b1) g``, ``v' = b2 v + (1 - b2) g g``,
    ``p' = p - lr (m'/c1 / (sqrt(v'/c2) + eps) + wd p)``), with the
    temporaries reused in place."""
    gf = g.to(ACCUM_DTYPE)
    m_new = beta1 * m.to(ACCUM_DTYPE)
    m_new += (1 - beta1) * gf
    v_new = beta2 * v.to(ACCUM_DTYPE)
    v_new += (1 - beta2) * gf * gf
    del gf
    m.copy_(m_new)
    v.copy_(v_new)
    step = m_new.div_(c1)
    step /= v_new.div_(c2).sqrt_().add_(eps)
    del v_new
    pf = p.to(ACCUM_DTYPE)
    step += weight_decay * pf
    p.copy_(pf - lr * step)


def update(grads, state: AdamWState, params, *, lr, beta1=0.9, beta2=0.95,
           eps=1e-8, weight_decay=0.1,
           grad_clip: Optional[float] = 1.0, reduce_method: str = "mma",
           mesh=None):
    """One AdamW step, written into ``params``' and ``state``'s tensors
    (the count too).  Over ``mesh`` the leaves are DTensors and the
    clip's norm is taken over the mesh.  Returns (params, state,
    metrics)."""
    from repro_torch.distributed import tc_collectives
    metrics = {}
    with torch.no_grad():
        scale = None
        if grad_clip is not None:
            gnorm = tc_collectives.tc_global_norm(grads, mesh=mesh,
                                                  method=reduce_method)
            scale = _clip_scale(gnorm, grad_clip)
            metrics["grad_norm"] = gnorm
        count = state.count + 1
        t = count.to(ACCUM_DTYPE)
        c1 = 1.0 - torch.pow(torch.full_like(t, beta1), t)
        c2 = 1.0 - torch.pow(torch.full_like(t, beta2), t)
        lr = torch.as_tensor(lr, dtype=ACCUM_DTYPE, device=t.device)
        for leaves in zip(*(_leaves(tree) for tree in
                            (params, grads, state.m, state.v))):
            p, g, m, v = (local(x) for x in leaves)
            if scale is not None:
                g = _clipped(g, scale)
            _step_leaf(p, g, m, v, lr=lr, beta1=beta1, beta2=beta2,
                       eps=eps, weight_decay=weight_decay, c1=c1, c2=c2)
        state.count.copy_(count)
    return params, state, metrics


def cosine_schedule(step, *, base_lr, warmup_steps, total_steps,
                    min_ratio=0.1):
    s = torch.as_tensor(step).to(ACCUM_DTYPE)
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                             * prog))
    return base_lr * torch.where(s < warmup_steps, warm, cos)
