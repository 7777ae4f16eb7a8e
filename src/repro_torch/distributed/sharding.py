"""Logical-axis sharding — the counterpart of
``repro.distributed.sharding``: MaxText-style rules mapping logical
tensor axes ("embed", "heads", "experts", ...) onto mesh axes ("pod",
"data", "model"), with the same divisibility fallback.

Models annotate parameters and activations with logical axes.  A context
carries (mesh, rules); with no mesh every constraint is the identity.

The reference holds one global ``jax.Array`` and lets ``NamedSharding``
place it.  In the port each rank is a process that holds only its shard:
``NamedSharding.shard`` cuts a tensor every rank holds whole (the global
array) to this rank's block, and ``NamedSharding.distribute`` wraps that
block in a ``torch.distributed.tensor.DTensor`` (made with
``DTensor.from_local``, which communicates nothing), the form in which a
sharded tensor reaches the collectives.  A dimension split over several
mesh axes takes them major to minor in the order the spec names them, as
the reference's ``PartitionSpec`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Optional, Sequence

import torch

# Logical axis -> preference-ordered candidate mesh axes (the reference's
# table, copied).  The first candidate that (a) exists in the mesh and
# (b) divides the dimension wins.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "seq_sp": ("data",),
    "seq_mp": ("model",),
    # params
    "vocab": ("model",),
    "embed": ("data",),
    "embed_no_fsdp": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("data",),
    "expert_mlp": ("model",),
    "experts_2d": ("data", "model"),
    "q_lora": ("model",),
    "kv_lora": (),
    "lru": ("model",),
    "layers": (),
    "conv": (),
    "stats": (),
}


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis name, or a
    tuple of names (split over their product, the first the major one).
    A tuple, as the reference's ``jax.sharding.PartitionSpec`` is;
    dimensions past its length are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """The mesh axes a spec splits over, in the order it names them."""
    return tuple(a for entry in spec for a in _names(entry))


def _block(mesh, names: tuple) -> tuple:
    """(this rank's block index, block count) of a dimension split over
    ``names``: row-major over their coordinates, the first name major."""
    coord = mesh.coordinate
    if coord is None:
        raise ValueError(f"this rank is not in the mesh {mesh.shape}")
    idx, count = 0, 1
    for a in names:
        idx = idx * mesh.shape[a] + coord[a]
        count *= mesh.shape[a]
    return idx, count


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole (a view)."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{x.ndim}-d tensor it cuts")
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        idx, count = _block(mesh, names)
        if x.shape[dim] % count:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split over {names} ({count} blocks)")
        size = x.shape[dim] // count
        x = x.narrow(dim, idx * size, size)
    return x


def gather_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The inverse of ``local_shard``: every rank's block put back in
    place.  Each rank writes its block into the additive identity of the
    whole shape (-0.0 for a float, so that -0.0 + -0.0 keeps its sign;
    0 for an integer) and one ``all_reduce`` a named axis adds the
    blocks: a block meets only that identity, so every bit is kept.
    ``all_reduce`` is the one collective the layer asks of its
    backend."""
    import torch.distributed as dist
    identity = -0.0 if x.dtype.is_floating_point else 0
    for dim, entry in reversed(list(enumerate(spec))):
        names = _names(entry)
        if not names:
            continue
        idx, count = _block(mesh, names)
        shape = list(x.shape)
        shape[dim] *= count
        full = torch.full(shape, identity, dtype=x.dtype, device=x.device)
        full.narrow(dim, idx * x.shape[dim], x.shape[dim]).copy_(x)
        for a in names:
            dist.all_reduce(full, group=mesh.get_group(a))
        x = full
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``, which every rank holds whole."""
        return local_shard(x, self.spec, self.mesh)

    def placements(self) -> tuple:
        """The ``DTensor`` placements of the spec, one per mesh axis."""
        from torch.distributed.tensor import Replicate, Shard
        out = {a: Replicate() for a in self.mesh.axis_names}
        for dim, entry in enumerate(self.spec):
            names = _names(entry)
            order = [self.mesh.axis_names.index(a) for a in names]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {entry} names its axes out of mesh order "
                    f"{self.mesh.axis_names}: a DTensor splits a "
                    f"dimension major to minor in mesh order")
            for a in names:
                out[a] = Shard(dim)
        return tuple(out[a] for a in self.mesh.axis_names)

    def distribute(self, x: torch.Tensor, *, copy: bool = True):
        """A ``DTensor`` of the global ``x`` holding this rank's block
        (a copy by default, so ``x`` can be freed)."""
        local = self.shard(x)
        return self.wrap(local.clone() if copy else local.contiguous())

    def wrap(self, block: torch.Tensor):
        """A ``DTensor`` whose local tensor is ``block``, this rank's
        block (no copy, no communication)."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(block, self.mesh.device_mesh,
                                  self.placements(), run_check=False)


class _DeviceMeshView:
    """What this module reads of a mesh (axis names and sizes, this
    rank's coordinate, an axis's process group), over a DTensor's
    ``DeviceMesh``."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names,
                              (int(s) for s in device_mesh.mesh.shape)))
        coord = device_mesh.get_coordinate()
        self.coordinate = None if coord is None \
            else dict(zip(self.axis_names, coord))

    def get_group(self, axis: str):
        return self.device_mesh.get_group(axis)


def is_dtensor(x) -> bool:
    # No DTensor exists before torch.distributed.tensor is imported, so
    # a call without one does not pay for that import.
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def dtensor_sharding(x) -> NamedSharding:
    """The layout of a DTensor as a ``NamedSharding``: a dimension
    sharded over several mesh axes takes them in mesh order, as
    ``NamedSharding.placements`` lays them out."""
    view = _DeviceMeshView(x.device_mesh)
    parts: list = [[] for _ in range(x.ndim)]
    for axis, p in zip(view.axis_names, x.placements):
        if p.is_shard():
            parts[p.dim].append(axis)
        elif not p.is_replicate():
            raise ValueError(f"a DTensor placed {tuple(x.placements)} holds "
                             f"partial sums, not blocks of a tensor")
    return NamedSharding(view, P(*(
        None if not n else n[0] if len(n) == 1 else tuple(n)
        for n in parts)))


def local(x):
    """This rank's block of a DTensor (its local tensor itself, so a
    write into it is a write into the DTensor); any other tensor as it
    is."""
    if not is_dtensor(x):
        return x
    with torch.no_grad():
        return x.to_local()


def whole(x):
    """The global tensor of a DTensor, every rank's block put back by
    ``gather_shard`` (a collective over the DTensor's mesh: every rank
    of it must call); any other tensor as it is."""
    if not is_dtensor(x):
        return x
    s = dtensor_sharding(x)
    return gather_shard(local(x), s.spec, s.mesh)


def is_first_rank(mesh) -> bool:
    """True on the rank at coordinate 0 of every axis of ``mesh`` (a
    ``compat.Mesh`` or a DTensor's ``DeviceMesh``)."""
    coord = mesh.get_coordinate() if hasattr(mesh, "get_coordinate") \
        else None if mesh.coordinate is None \
        else list(mesh.coordinate.values())
    return coord is not None and not any(coord)


def mesh_barrier(mesh) -> None:
    """Return only once every rank of ``mesh`` (a ``compat.Mesh`` or a
    ``DeviceMesh``) has called: one ``all_reduce`` over each axis in
    turn, so that what any rank did before the call reaches every rank
    through the lines of the axes."""
    import torch.distributed as dist
    dm = getattr(mesh, "device_mesh", mesh)
    token = torch.zeros(1, device=dm.device_type)
    for axis in dm.mesh_dim_names:
        dist.all_reduce(token, group=dm.get_group(axis))


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)
        self.fold: Optional[tuple] = None
        self.model: Optional[str] = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[dict] = None):
    """Install (mesh, rules) for code executed inside."""
    old_mesh, old_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old_mesh, old_rules


def current_mesh():
    """The installed mesh, or None."""
    return _CTX.mesh


@contextlib.contextmanager
def local_step(mesh, batch_axes: Sequence[str],
               model_axis: Optional[str] = None):
    """Run a model on this rank's blocks: no mesh is installed inside
    (``constrain`` is the identity and ``dispatch`` keeps its one-card
    plans: every tensor is local), and a token mean (``models.
    transformer.token_mean``) divides this rank's masked sum by the
    count over every rank along ``batch_axes`` of ``mesh``, the axes
    that split the batch's rows.  ``model_axis`` names the mesh axis the
    model's products split over (``model_share``): the train step passes
    ``model``, a server nothing, so that it runs whole weights."""
    old = (_CTX.mesh, _CTX.fold, _CTX.model)
    _CTX.mesh = None
    _CTX.fold = (mesh, tuple(batch_axes))
    _CTX.model = model_axis
    try:
        yield
    finally:
        _CTX.mesh, _CTX.fold, _CTX.model = old


def batch_fold() -> Optional[tuple]:
    """(mesh, batch axes) inside ``local_step``, else None."""
    return _CTX.fold


def model_axis() -> Optional[str]:
    """The mesh axis the model's products split over inside a train
    step's ``local_step``, else None."""
    return _CTX.model


@dataclasses.dataclass(frozen=True)
class ModelShare:
    """This rank's share of a dimension split over the model axis: block
    ``index`` of ``count`` along ``axis`` of ``mesh``."""
    mesh: object
    axis: str
    index: int
    count: int

    def start(self, size: int) -> int:
        """The first index of this rank's block of ``size`` values."""
        return self.index * size


def model_share(local: int, whole: Optional[int]) -> Optional[ModelShare]:
    """Whether a tensor-parallel body holds a dimension of ``whole``
    values as this rank's block (``local`` of them) over the model axis:
    its ``ModelShare``, or None where the body holds it whole (no model
    axis, or one the rules did not split the dimension over: then it runs
    whole, with no collective).  A body reached inside a train step
    without the whole size, or with a block of another size, raises:
    nothing runs a block as if it were the whole."""
    axis = _CTX.model
    if axis is None:
        return None
    if whole is None:
        raise ValueError(
            "a tensor-parallel body inside a train step needs the whole "
            "size of the dimension it may hold as a block")
    if local == whole:
        return None
    mesh = _CTX.fold[0]
    count = int(mesh.shape[axis])
    if local * count != whole:
        raise ValueError(
            f"a dimension of {whole} over the {axis} axis ({count} ranks) "
            f"arrives as {local} values, neither whole nor a block")
    return ModelShare(mesh, axis, int(mesh.coordinate[axis]), count)


def current_context() -> tuple:
    """This thread's (mesh, rules, batch fold, model axis), for
    ``installed``."""
    return _CTX.mesh, _CTX.rules, _CTX.fold, _CTX.model


@contextlib.contextmanager
def installed(context: tuple):
    """Run under a context that ``current_context`` took, in any thread:
    the autograd engine runs a CUDA backward, and so a remat's
    recompute, on a thread of its own, where the context is empty."""
    old = current_context()
    _CTX.mesh, _CTX.rules, _CTX.fold, _CTX.model = context
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.fold, _CTX.model = old


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             mesh=None, rules: Optional[dict] = None) -> PartitionSpec:
    """PartitionSpec for a concrete shape given logical axis names.

    A mesh axis is used at most once per spec and only when it divides
    the dimension; multi-candidate rules take every candidate that fits
    (batch -> ('pod', 'data'))."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return P()
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical_axes)} differ in length")
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            parts.append(None)
            continue
        chosen: list[str] = []
        remaining = dim
        for ax in rules.get(name, ()):
            if ax in used or ax not in mesh.shape:
                continue
            if remaining % mesh.shape[ax] == 0:
                chosen.append(ax)
                used.add(ax)
                remaining //= mesh.shape[ax]
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    return P(*parts)


def sharding_for(shape, logical_axes, mesh=None, rules=None):
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, spec_for(shape, logical_axes, mesh, rules))


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Lay ``x`` out by its logical axes over the installed mesh: the
    identity without one.  As the reference's ``with_sharding_constraint``
    it is an annotation that changes no value: a tensor this rank holds
    whole comes back as it is (every rank computes it whole, and the
    layers mix it with other whole tensors); a ``DTensor`` is checked
    against the spec and returned as it is."""
    mesh = _CTX.mesh
    if mesh is None or not is_dtensor(x):
        return x
    sharding = NamedSharding(mesh, spec_for(x.shape, logical_axes, mesh))
    if tuple(x.placements) != sharding.placements():
        raise ValueError(
            f"a DTensor placed {tuple(x.placements)} does not meet "
            f"the spec {sharding.spec} of axes {tuple(logical_axes)}")
    return x


def batch_rows(mesh, rows: int) -> tuple:
    """(axes, start, stop): the mesh axes that split a batch of ``rows``
    rows and this rank's rows of it.  The axes follow ``spec_for``'s rule
    for the logical axis ``batch`` (``pod``, then ``data``, each where it
    divides what is left); where none divides, the batch is replicated:
    axes () and every row, as the reference lays out a batch of 1."""
    axes = spec_axes(spec_for((rows,), ("batch",), mesh, DEFAULT_RULES))
    if not axes:
        return (), 0, rows
    idx, count = _block(mesh, axes)
    size = rows // count
    return axes, idx * size, (idx + 1) * size


def _tree_map2(fn, tree, other):
    """``fn(leaf, other's subtree at the leaf)`` over ``tree``'s nested
    dicts, lists and tuples (``other`` mirrors it down to the leaves)."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, tree[k], other[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map2(fn, t, o) for t, o in zip(tree, other))
    return fn(tree, other)


def tree_shardings(shape_tree, axes_tree, mesh=None, rules=None):
    """(tree of leaves with ``.shape``, tree of axis tuples) -> tree of
    ``NamedSharding`` (of None without a mesh)."""
    mesh = mesh or _CTX.mesh
    return _tree_map2(
        lambda leaf, axes: sharding_for(leaf.shape, axes, mesh, rules),
        shape_tree, axes_tree)


def data_axis_names(mesh=None) -> tuple[str, ...]:
    """Mesh axes that carry the batch (for psum of grads / metrics)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
