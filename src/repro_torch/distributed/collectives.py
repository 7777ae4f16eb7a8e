"""Distributed-optimization utilities — the counterpart of
``repro.distributed.collectives``.

``hierarchical_psum``   reduce over the data axis first, then across the
                        slow pod axis;
``mesh_psum``           the same fast-before-slow tree for any axis
                        subset: the one combine the mesh collectives
                        (``repro_torch.distributed.tc_collectives``) and
                        the compressed all-reduce below share;
``compressed_psum``     int8-quantised all-reduce with error feedback
                        (4x fewer bytes than f32), and
``compressed_grad_allreduce`` its leaf-wise form over a gradient tree;
``all_to_all``          the tiled all-to-all of expert parallelism
                        (``models.moe``), over an axis or a tuple of axes;
``reduce_from`` / ``copy_to`` / ``gather_from`` / ``scatter_to``
                        the conjugate collectives of a tensor-parallel
                        region over ``model``;
``mesh_max``            the elementwise max over axes, with no gradient
                        (the vocabulary-parallel cross-entropy's shift).

Each axis is one ``torch.distributed.all_reduce`` (``all_to_all_single``
for the all-to-all) over the process group of this rank's line along it
(``compat.Mesh.get_group``).  The reference names axes that
``shard_map`` binds for ``lax.psum``; a rank of the port finds them in a
mesh: the one passed as ``mesh=``, else the ambient one
(``sharding.axis_rules``).

The last five are ``torch.autograd.Function``s whose backward is the
reference's transpose under ``shard_map(check_vma=False)``, where every
rank of a ``model`` line holds the same rows and computes the whole
gradient of what it holds: ``reduce_from`` (forward all_reduce) passes
its cotangent through, ``copy_to`` (forward identity) sums it,
``gather_from`` (forward tiled all_gather) keeps this rank's slice of it
and ``scatter_to`` (forward this rank's slice) gathers it.
``torch.distributed.nn.functional.all_reduce`` and ``all_gather`` sum
their cotangents instead, which counts the ``model`` ranks' identical
cotangents once a rank.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.integration import _leaves, _tree_like
from repro_torch.distributed import sharding as shd

# The slow (data-centre network) mesh axes; every other axis is fast.
# The fold order below and the autotuner's combine cost
# (``repro_torch.core.autotune.combine_model_cost``) both read it.
SLOW_AXES = ("pod",)

# Fast axes combine before the slow pod hop.
_FAST_BEFORE_SLOW = ("data", "model") + SLOW_AXES


def hierarchical_psum(x, *, fast_axis: str = "data",
                      slow_axis: str = "pod", mesh=None):
    """psum over data then pod."""
    return mesh_psum(x, (fast_axis, slow_axis), mesh=mesh)


def _live_mesh(mesh, what: str = "mesh_psum"):
    mesh = mesh if mesh is not None else shd.current_mesh()
    if mesh is None or not hasattr(mesh, "get_group"):
        raise ValueError(
            f"{what} needs a live mesh (compat.make_mesh), passed as "
            f"mesh= or installed by sharding.axis_rules; got {mesh!r}")
    return mesh


def mesh_psum(x, axes, *, mesh=None):
    """The sum of ``x`` over the ranks of ``axes`` (a name or a tuple of
    names), one axis at a time, fast axes before the slow pod axis;
    unknown names count as fast.  Returns a new tensor."""
    import torch.distributed as dist
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if not names:
        return x
    mesh = _live_mesh(mesh)
    order = {a: i for i, a in enumerate(_FAST_BEFORE_SLOW)}
    x = x.clone()
    for a in sorted(names, key=lambda a: order.get(a, 1)):
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def mesh_max(x, axes, *, mesh=None):
    """The elementwise max of ``x`` over the ranks of ``axes`` (a name or
    a tuple of names), one ``all_reduce(MAX)`` an axis; a new tensor
    with no gradient.  Under gloo a CUDA tensor goes through the host
    (``_staged``)."""
    import torch.distributed as dist
    names = _names(axes)
    out = x.detach().clone()
    if not names:
        return out
    mesh = _live_mesh(mesh, "mesh_max")
    dev = out.device
    if _staged(out, mesh.get_group(names[0]), "all_reduce MAX"):
        out = out.cpu()
    for a in names:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return out.to(dev)


def _quantise_int8(x):
    """Symmetric per-tensor int8 quantisation. Returns (q, scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x, axis, error, *, mesh=None):
    """int8 all-reduce with error feedback.

    Returns (reduced f32 value, new error-feedback residual).  The
    residual re-enters the next step's gradient, so the quantisation
    noise is unbiased over time (EF-SGD)."""
    xf = x.to(torch.float32) + error
    q, scale = _quantise_int8(xf)
    new_error = xf - q.to(torch.float32) * scale
    # The int8 codes go over the wire as int32 (no overflow), then one
    # scalar psum for the scales: both through the fast-before-slow tree.
    total = mesh_psum(q.to(torch.int32), axis,
                      mesh=mesh).to(torch.float32)
    scale_sum = mesh_psum(scale, axis, mesh=mesh)
    # The rank count is the mesh's, not a collective's (the reference's
    # psum(1) is folded to a constant).
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = math.prod(int(_live_mesh(mesh).shape[a]) for a in names) \
        if names else 1
    # Each rank used its own scale; rebuild with the mean scale (exact
    # when the ranks share a dynamic range; the feedback absorbs the
    # rest).
    return total * (scale_sum / n), new_error


def compressed_grad_allreduce(grads, errors, mesh, axes=("pod", "data")):
    """``compressed_psum`` leaf by leaf over the batch axes of ``mesh``;
    every rank holds its own whole gradient tree.  Returns (reduced
    tree, residual tree)."""
    from repro_torch import compat
    names = tuple(a for a in axes if a in mesh.shape)
    if not names:
        return grads, errors

    def body(g, e):
        outs = [compressed_psum(gl, names, el, mesh=mesh)
                for gl, el in zip(_leaves(g), _leaves(e))]
        return (_tree_like(g, [o[0] for o in outs]),
                _tree_like(e, [o[1] for o in outs]))

    return compat.shard_map(body, mesh=mesh, in_specs=(shd.P(), shd.P()),
                            out_specs=(shd.P(), shd.P()))(grads, errors)


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _staged(x, group, what: str):
    """Whether ``x`` goes through the host for a collective over
    ``group``: gloo carries ``all_to_all`` on CPU tensors only (a CUDA
    tensor is copied to the host and back, and ``mesh_max`` stages its
    tensor the same way); NCCL takes CUDA tensors
    directly, and so does the ``fake`` backend of the dry run
    (``launch.dryrun``), which moves nothing."""
    import torch.distributed as dist
    backend = str(dist.get_backend(group))
    if x.device.type == "cpu" or "nccl" in backend or backend == "fake":
        return False
    if "gloo" in backend and x.device.type == "cuda":
        return True
    raise RuntimeError(f"{what}: the {backend} backend carries no "
                       f"{x.device.type} tensor and cannot stage it "
                       f"through the host")


def _exchange(t, names: tuple, mesh):
    """Dims 0..m-1 of ``t`` are the blocks for the ranks along ``names``
    (m of them, in order); each axis in turn sends block j of its dim to
    the rank at coordinate j and puts what rank j sent at j.  After the
    m exchanges index (s_1, ..., s_m) holds what the rank at those
    coordinates had for this rank."""
    import torch.distributed as dist
    dev = t.device
    group0 = mesh.get_group(names[0])
    if _staged(t, group0, "all_to_all"):
        t = t.cpu()
    for k, a in enumerate(names):
        group = mesh.get_group(a)
        if dist.get_rank(group) != mesh.coordinate[a]:
            raise RuntimeError(
                f"all_to_all over {a!r}: this rank is rank "
                f"{dist.get_rank(group)} of the axis's group but sits at "
                f"coordinate {mesh.coordinate[a]}")
        send = t.movedim(k, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        t = recv.movedim(0, k)
    return t.to(dev)


def _all_to_all(x, names: tuple, split_dim: int, concat_dim: int, mesh):
    sizes = [int(mesh.shape[a]) for a in names]
    n = math.prod(sizes)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all over {names}: dimension {split_dim} "
                         f"of {tuple(x.shape)} does not split into {n} "
                         f"blocks")
    if n == 1:
        return x.clone()
    # the blocks of split_dim lead, one dim a named axis, major first
    t = x.movedim(split_dim, 0)
    t = t.reshape(*sizes, t.shape[0] // n, *t.shape[1:])
    t = _exchange(t, names, mesh)
    # (sources, split_dim's block, the other dims) -> the sources
    # concatenated along concat_dim, in rank order
    t = t.reshape(n, *t.shape[len(sizes):]).movedim(1, split_dim + 1)
    shape = list(x.shape)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return t.movedim(0, concat_dim).reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, split_dim, concat_dim, mesh):
        ctx.args = (names, split_dim, concat_dim, mesh)
        return _all_to_all(x, names, split_dim, concat_dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        names, split_dim, concat_dim, mesh = ctx.args
        return (_all_to_all(grad, names, concat_dim, split_dim, mesh),
                None, None, None, None)


def all_to_all(x, axes, split_dim: int, concat_dim: int, *, mesh=None):
    """``lax.all_to_all(x, axes, split_dim, concat_dim, tiled=True)``:
    ``split_dim`` cut into one equal block a rank along ``axes`` (a name
    or a tuple of names, the first major), block j sent to rank j, and
    the blocks received concatenated along ``concat_dim`` in rank order.
    The backward is the reverse all-to-all.  Over a tuple of axes it is
    one exchange an axis.  Under gloo a CUDA tensor goes through the
    host."""
    mesh = _live_mesh(mesh, "all_to_all")
    return _AllToAll.apply(x, _names(axes), split_dim % x.ndim,
                           concat_dim % x.ndim, mesh)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return mesh_psum(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return mesh_psum(grad.contiguous(), ctx.axes, mesh=ctx.mesh), \
            None, None


def reduce_from(x, axes, *, mesh=None):
    """The sum of ``x`` over ``axes`` (``mesh_psum``); backward the
    identity: every rank along ``axes`` gets the same cotangent and
    keeps it."""
    return _ReduceFrom.apply(x, _names(axes),
                             _live_mesh(mesh, "reduce_from"))


def copy_to(x, axes, *, mesh=None):
    """``x`` itself; backward the sum of the cotangents over ``axes``:
    each rank along them used ``x`` on its own part of the work."""
    return _CopyTo.apply(x, _names(axes), _live_mesh(mesh, "copy_to"))


def _dim_spec(axes, dim: int):
    return shd.P(*(None,) * dim, _names(axes))


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return shd.gather_shard(x, spec, mesh)

    @staticmethod
    def backward(ctx, grad):
        return shd.local_shard(grad, ctx.spec, ctx.mesh).contiguous(), \
            None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return shd.local_shard(x, spec, mesh).clone()

    @staticmethod
    def backward(ctx, grad):
        return shd.gather_shard(grad.contiguous(), ctx.spec, ctx.mesh), \
            None, None


def gather_from(x, axes, dim: int, *, mesh=None):
    """The ranks' blocks along ``axes`` put side by side on ``dim``
    (``lax.all_gather(x, axes, axis=dim, tiled=True)``; the blocks keep
    their bits, ``sharding.gather_shard``); backward this rank's slice
    of the cotangent, with no sum."""
    return _GatherFrom.apply(x, _dim_spec(axes, dim % x.ndim),
                             _live_mesh(mesh, "gather_from"))


def scatter_to(x, axes, dim: int, *, mesh=None):
    """This rank's slice of ``dim`` along ``axes`` (the reference's
    ``dynamic_slice`` at ``axis_index``); backward the ranks' slices of
    the cotangent gathered, so that every rank holds all of it."""
    return _ScatterTo.apply(x, _dim_spec(axes, dim % x.ndim),
                            _live_mesh(mesh, "scatter_to"))
