"""The chained-MMA collectives — the counterpart of
``repro.distributed.tc_collectives``: the paper's design taken one level
up.

The paper's chain of R MMAs keeps one f32 partial a block until a final
combine.  A hierarchical all-reduce has that shape over ranks: each rank
reduces its shard with the chained-MMA engines to one f32 scalar, and a
fast-before-slow tree (``distributed.collectives.mesh_psum``) folds the
ranks' scalars.

``tc_psum``        the sum (``reduce_sum``) or sum of squares
                   (``squared_sum``) of every element on every rank: one
                   f32 scalar, the same on every rank;
``tc_all_reduce``  ``tc_psum`` leaf by leaf over a tree;
``tc_global_norm`` the tree's L2 norm: one ``squared_sum`` a leaf, the
                   leaf scalars added in f32, one sqrt — what gradient
                   clipping and the trainer's ``param_norm`` call.

What a rank passes stands for the reference's global array.  A tensor
every rank holds whole (drawn from the same seed) is the global array
itself; a ``torch.distributed.tensor.DTensor`` (``sharding.
NamedSharding.distribute``, or ``DTensor.from_local``) is sharded, and
its local block is what this rank contributes.

``via`` is kept for the reference's signature; both values run one
body, the explicit collective.  A whole tensor is cut by ``P(axes)`` over
the mesh axes its leading dimension splits over (``shardable_axes``); a
DTensor keeps its own layout and folds over the axes it is sharded over.
The rank's partial runs under the plan of the sub-mesh of those axes
(``dispatch.local_plan``: ``|mesh:data4`` for a leaf split over ``data``
alone), cast by the policy, as one f32 scalar, and ``mesh_psum`` folds
it.  Inside, every engine is legal, the kernels (``pallas``) too: the
shard is a local tensor.  The reference's ``'gspmd'`` hands the global
reduction to XLA's partitioner inside a pjit-traced step, so that a
shard_map in-spec does not force re-layouts there; eager PyTorch has no
partitioner and no such re-layout, so the two vias could differ only in
how they fail.

Both vias give the reference's values.  With no mesh, a one-rank mesh, a
0-d or empty input, or a leaf that splits over no axis, every entry point
is plain dispatch, bit for bit.  A mesh given as a signature string or a
tuple of (name, size) names a geometry, not ranks: over more than one
rank it raises.
"""

from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.core import autotune, dispatch
from repro_torch.core import precision as precision_mod
from repro_torch.core.integration import _leaves
from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import mesh_psum
from repro_torch.models.param import _map

# Ops whose per-rank partial is one f32 scalar: the collective contract.
_SCALAR_OPS = ("reduce_sum", "squared_sum")


def _ambient_mesh(mesh):
    mesh = mesh if mesh is not None else shd.current_mesh()
    if autotune.mesh_device_count(mesh) > 1 \
            and not isinstance(mesh, compat.Mesh):
        raise ValueError(
            f"a collective over the mesh {autotune.mesh_signature(mesh)!r} "
            f"needs a live mesh of that shape (compat.make_mesh over the "
            f"ranks of a process group), not a signature")
    return mesh


def shardable_axes(mesh, dim: int) -> tuple:
    """Mesh axis names (mesh order, greedy) over which a leading
    dimension of ``dim`` splits evenly: the axes the collective shards
    and folds over.  Axes left out stay replicated and are not folded
    (a sum over them would multiply by their size)."""
    if mesh is None:
        return ()
    chosen = []
    rem = int(dim)
    for name, size in mesh.shape.items():
        if size > 1 and rem % size == 0:
            chosen.append(str(name))
            rem //= size
    return tuple(chosen)


def _sharded_axes(x) -> tuple:
    """The mesh axes a DTensor is not replicated over, in mesh order."""
    names = x.device_mesh.mesh_dim_names
    return tuple(a for a, p in zip(names, x.placements)
                 if not p.is_replicate())


def _local_reduce(op: str, x, method: str, precision=None):
    """Plain dispatch with the stay-trainable resolve: an engine the
    call cannot serve maps to ``mma`` (unknown spellings still raise).
    ``chain=4`` is the hooks' explicit-engine default and the
    shard_map path's, as in the reference."""
    if dispatch.known_method(op, method):
        method = dispatch.resolve_method(op, x, method, fallback="mma",
                                         precision=precision)
    return dispatch.dispatch(op, x, method=method, chain=4,
                             precision=precision)


def tc_psum(x, *, mesh=None, method: str = "auto",
            op: str = "reduce_sum", via: str = "shard_map",
            precision=None, bucket: str = "pow2") -> torch.Tensor:
    """The reduction of every element of ``x`` over every rank of the
    mesh (default: the ambient one): one f32 scalar on every rank.

    ``precision`` is the per-rank ``MmaPolicy`` (it keys the partial's
    plan and casts the shard); ``bucket`` is the plan key's shape bucket
    policy (``autotune.bucket_cap``).  ``via`` is ``'shard_map'`` or
    ``'gspmd'``, one body (see the module docstring)."""
    if op not in _SCALAR_OPS:
        raise ValueError(
            f"tc_psum serves the scalar reduce ops {_SCALAR_OPS}, "
            f"not {op!r} (its per-device partial must be one f32 "
            f"scalar)")
    if via not in ("shard_map", "gspmd"):
        raise ValueError(f"unknown via: {via!r} "
                         f"(accepted: 'shard_map', 'gspmd')")
    mesh = _ambient_mesh(mesh)
    policy = precision_mod.as_policy(precision)
    sharded = shd.is_dtensor(x)
    if sharded:
        names, local = _sharded_axes(x), x.to_local()
    else:
        x = dispatch.as_tensor(x)
        names, local = (), x
    if autotune.mesh_device_count(mesh) <= 1:
        if names:
            raise ValueError(
                f"a DTensor sharded over {names} is reduced over its "
                f"mesh: pass it as mesh= (or install it by axis_rules)")
        return _local_reduce(op, local, method, precision=policy)
    if x.ndim == 0 or x.numel() == 0:
        return _local_reduce(op, local, method, precision=policy)
    if not sharded:
        names = shardable_axes(mesh, x.shape[0])
    if not names:
        return _local_reduce(op, local, method, precision=policy)
    # The plan is keyed (and tuned) by the axes actually sharded over: a
    # leaf split over data but not model holds an n/4 shard on a 4 x 2
    # mesh, not n/8, and must not share the whole mesh's plan.
    sub_mesh = tuple((a, int(mesh.shape[a])) for a in names)
    plan = dispatch.local_plan(op, x.numel(), x.dtype, method,
                               mesh=sub_mesh, precision=policy,
                               bucket=bucket, backend=local.device.type)
    run_kwargs = {} if policy is None else {"policy": policy}

    def body(xl):
        xl = dispatch._cast_in(xl, policy, dispatch.op_spec(op),
                               plan.method)
        partial = dispatch.execute(op, xl, plan, **run_kwargs)
        return mesh_psum(partial.to(ACCUM_DTYPE), names, mesh=mesh)

    if sharded:
        return body(local)
    return compat.shard_map(body, mesh=mesh, in_specs=(shd.P(names),),
                            out_specs=shd.P())(x)


def psum_scalar(x, axes, *, mesh, method: str = "auto") -> torch.Tensor:
    """``tc_psum`` of one scalar a rank over ``axes`` of ``mesh``: each
    rank's value is its block of a vector split over those axes (a
    DTensor), so the result is the sum along them, one f32 scalar, the
    same on every rank of a line."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    placements = tuple(Shard(0) if a in axes else Replicate()
                       for a in mesh.axis_names)
    dt = DTensor.from_local(x.detach().reshape(1), mesh.device_mesh,
                            placements, run_check=False)
    return tc_psum(dt, mesh=mesh, method=method)


def tc_all_reduce(tree, *, mesh=None, method: str = "auto",
                  op: str = "reduce_sum", via: str = "shard_map",
                  precision=None, bucket: str = "pow2"):
    """Leaf-wise ``tc_psum`` over a tree: every leaf becomes one f32
    scalar, each under its own plan."""
    return _map(lambda leaf: tc_psum(leaf, mesh=mesh, method=method, op=op,
                                     via=via, precision=precision,
                                     bucket=bucket), tree)


def tc_global_norm(tree, *, mesh=None, method: str = "auto",
                   via: str = "shard_map", precision=None) -> torch.Tensor:
    """The L2 norm of a tree over the mesh: sqrt of the f32 sum of the
    leaves' ``tc_psum(op='squared_sum')``, added in leaf order."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=ACCUM_DTYPE)
    parts = [tc_psum(leaf, mesh=mesh, method=method, op="squared_sum",
                     via=via, precision=precision) for leaf in leaves]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return torch.sqrt(total)
