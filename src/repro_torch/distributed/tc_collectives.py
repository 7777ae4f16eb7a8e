"""The chained-MMA collectives, one card's part — the counterpart of
``repro.distributed.tc_collectives``.

The reference keeps the paper's one-f32-partial-per-block contract one
level up: each device reduces its shard with the chained-MMA engines to
one f32 scalar, and a psum tree folds the devices' scalars.  On one card
there is nothing to fold, and the reference itself degrades every entry
point to the plain dispatch path there, bit for bit:

``tc_psum``        the sum (``reduce_sum``) or sum of squares
                   (``squared_sum``) of every element: an f32 scalar;
``tc_all_reduce``  ``tc_psum`` leaf by leaf over a tree;
``tc_global_norm`` the tree's L2 norm: one ``squared_sum`` a leaf, the
                   leaf scalars added in f32, one sqrt — what gradient
                   clipping and the trainer's ``param_norm`` call.

A spelling that names an engine the call cannot serve resolves to the
``mma`` contraction (``_local_reduce``, the reference's stay-trainable
fallback); an unknown spelling raises.  A mesh of more than one device
is ROADMAP item 14 (distributed) and raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import autotune, dispatch
from repro_torch.core import precision as precision_mod
from repro_torch.core.integration import _leaves
from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.models.param import _map

# Ops whose per-device partial is one f32 scalar: the collective
# contract.
_SCALAR_OPS = ("reduce_sum", "squared_sum")


def _one_card(mesh) -> None:
    if autotune.mesh_signature(mesh):
        raise NotImplementedError(
            f"repro_torch runs on one card: a collective over the mesh "
            f"{autotune.mesh_signature(mesh)!r} is ROADMAP item 14 "
            f"(distributed)")


def _local_reduce(op: str, x, method: str, precision=None):
    """Plain dispatch with the stay-trainable resolve: an engine the call
    cannot serve maps to ``mma`` (unknown spellings still raise).
    ``chain=4`` is the hooks' explicit-engine default, as in the
    reference."""
    if dispatch.known_method(op, method):
        method = dispatch.resolve_method(op, x, method, fallback="mma",
                                         precision=precision)
    return dispatch.dispatch(op, x, method=method, chain=4,
                             precision=precision)


def tc_psum(x, *, mesh=None, method: str = "auto",
            op: str = "reduce_sum", precision=None) -> torch.Tensor:
    """The reduction of every element of ``x``: one f32 scalar.  (The
    reference's ``via`` and ``bucket`` pick how a mesh folds the
    devices' partials; they come with ROADMAP item 14.)"""
    if op not in _SCALAR_OPS:
        raise ValueError(
            f"tc_psum serves the scalar reduce ops {_SCALAR_OPS}, "
            f"not {op!r} (its per-device partial must be one f32 "
            f"scalar)")
    _one_card(mesh)
    return _local_reduce(op, dispatch.as_tensor(x), method,
                         precision=precision_mod.as_policy(precision))


def tc_all_reduce(tree, *, mesh=None, method: str = "auto",
                  op: str = "reduce_sum", precision=None):
    """Leaf-wise ``tc_psum`` over a tree: every leaf becomes one f32
    scalar, each under its own plan."""
    return _map(lambda leaf: tc_psum(leaf, mesh=mesh, method=method,
                                     op=op, precision=precision), tree)


def tc_global_norm(tree, *, mesh=None, method: str = "auto",
                   precision=None) -> torch.Tensor:
    """The L2 norm of a tree: sqrt of the f32 sum of the leaves'
    ``tc_psum(op='squared_sum')``, added in leaf order."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=ACCUM_DTYPE)
    parts = [tc_psum(leaf, mesh=mesh, method=method, op="squared_sum",
                     precision=precision) for leaf in leaves]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return torch.sqrt(total)
