"""Framework hooks: the reduce family's entry points — the counterpart
of ``repro.core.integration`` for this slice.

Each hook is a thin wrapper over ONE dispatch path,
``repro_torch.core.dispatch.dispatch(op, x, method=..., **op_kwargs)``.
``method`` is ``'auto'`` (the autotuner's plan for this op, size, dtype
and device, over the legal engines), ``'mma'`` (one ones-contraction;
the default), ``'mma_chained'`` (the paper-structured core),
``'pallas'`` (the hand-written Hopper kernels) or ``'vpu'`` (the
classic f32 baseline).  An engine the op does not declare, or one whose
predicates reject the call, raises ``ValueError`` naming the reason.

Inputs follow the device rule of ``dispatch.as_tensor``: a tensor runs
on its own device, anything else on the card.  Results are f32 tensors
on the input's device.
"""

from __future__ import annotations

import math
from typing import Literal, Optional

import torch

from repro_torch.core import dispatch
from repro_torch.core.precision import ACCUM_DTYPE

Method = Literal["auto", "mma", "mma_chained", "pallas", "vpu"]


def _norm_axes(axis, ndim: int) -> Optional[tuple]:
    """Normalise ``axis`` to a sorted tuple of non-negative ints, or
    None for a full reduction.  Out-of-range and duplicate axes raise;
    an empty tuple stays empty (reduce over no axes)."""
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if not -ndim <= a < ndim:
            raise ValueError(
                f"axis {a} is out of bounds for an ndim-{ndim} input")
    axes = tuple(sorted(a % ndim for a in axes))
    if len(set(axes)) != len(axes):
        raise ValueError(f"duplicate reduction axes: {axis!r}")
    return None if axes and len(axes) == ndim else axes


def _keepdims(out, axes: Optional[tuple], ndim: int, keepdims: bool):
    if not keepdims:
        return out
    if axes is None:
        return out.reshape((1,) * ndim)
    for a in axes:
        out = out.unsqueeze(a)
    return out


def reduce_sum(x, *, axis=None, keepdims: bool = False,
               method: Method = "mma", chain: int = 4,
               precision=None, objective=None,
               bucket: str = "pow2") -> torch.Tensor:
    """Sum over ``axis`` (None = all elements), f32.

    >>> float(reduce_sum(torch.ones(2, 8)))
    16.0
    >>> reduce_sum(torch.ones(2, 8), axis=-1).tolist()
    [8.0, 8.0]
    >>> tuple(reduce_sum(torch.ones(2, 8), axis=0, keepdims=True).shape)
    (1, 8)
    """
    x = dispatch.as_tensor(x)
    axes = _norm_axes(axis, x.ndim)
    if axes == ():                  # reduce over no axes
        return x.to(ACCUM_DTYPE)
    out = dispatch.dispatch("reduce_sum", x, method=method, chain=chain,
                            precision=precision, objective=objective,
                            bucket=bucket, axis=axes)
    return _keepdims(out, axes, x.ndim, keepdims)


def reduce_mean(x, *, axis=None, keepdims: bool = False,
                method: Method = "mma", precision=None,
                objective=None) -> torch.Tensor:
    """Mean over ``axis`` (None = all elements), f32.

    >>> reduce_mean(torch.ones(4, 8), axis=1).tolist()
    [1.0, 1.0, 1.0, 1.0]
    """
    x = dispatch.as_tensor(x)
    axes = _norm_axes(axis, x.ndim)
    count = x.numel() if axes is None \
        else math.prod(x.shape[a] for a in axes)
    return reduce_sum(x, axis=axis, keepdims=keepdims, method=method,
                      precision=precision, objective=objective) / count


def masked_mean(values, mask, *, method: Method = "mma",
                chain: int = 4, precision=None) -> torch.Tensor:
    """Mean of values where mask == 1 — the token-loss reduction.  The
    all-masked denominator is floored at 1, so it yields 0.

    >>> v = torch.tensor([1.0, 2.0, 30.0, 40.0])
    >>> float(masked_mean(v, torch.tensor([1.0, 1.0, 0.0, 0.0])))
    1.5
    >>> float(masked_mean(v, torch.zeros(4)))
    0.0
    """
    values = dispatch.as_tensor(values)
    mask = torch.as_tensor(mask, dtype=values.dtype, device=values.device)
    return dispatch.dispatch("masked_mean", values, method=method,
                             chain=chain, precision=precision, mask=mask)


def squared_sum(x, *, axis=None, keepdims: bool = False,
                method: Method = "mma", chain: int = 4,
                precision=None, objective=None,
                bucket: str = "pow2") -> torch.Tensor:
    """sum(x^2) over ``axis`` (None = all) — grad-norm building block.
    ``'pallas'`` squares in the input dtype inside kernel B1."""
    x = dispatch.as_tensor(x)
    axes = _norm_axes(axis, x.ndim)
    if axes == ():                  # reduce over no axes
        xf = x.to(ACCUM_DTYPE)
        return xf * xf
    out = dispatch.dispatch("squared_sum", x, method=method,
                            chain=chain, precision=precision,
                            objective=objective, bucket=bucket,
                            axis=axes)
    return _keepdims(out, axes, x.ndim, keepdims)


def _leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _leaves(item)]
    return [tree]


def global_norm(tree, *, method: Method = "mma",
                precision=None) -> torch.Tensor:
    """L2 norm over nested dicts, lists and tuples of tensors (gradient
    clipping / monitoring); 'auto' tunes per leaf."""
    total = sum(squared_sum(leaf, method=method, precision=precision)
                for leaf in _leaves(tree))
    return torch.sqrt(total)


def expert_counts(router_probs_onehot, *, method: Method = "mma",
                  precision=None) -> torch.Tensor:
    """Tokens per expert from a (tokens, experts) one-hot/weight matrix:
    counts = [1]_{1 x T} x onehot, one ones-MMA.  Only the contraction
    and vpu engines serve it; any other ``method`` raises."""
    return dispatch.dispatch("expert_counts", router_probs_onehot,
                             method=method, precision=precision)
