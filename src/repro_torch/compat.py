"""Meshes of ranks and ``shard_map`` — the counterpart of
``repro.compat``.

The reference's mesh is a grid of the devices one JAX process drives,
and ``shard_map`` hands each device its block of a global array.  In the
port each rank is a process of a live ``torch.distributed`` process
group: ``make_mesh`` lays the group's ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, and ``shard_map`` runs a function on this rank's blocks.  The
process-group backend is the caller's (``nccl`` with one card a rank,
``gloo`` for several ranks on one card or on the CPU); nothing here
picks one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.distributed import sharding as shd


def _need_group(what: str) -> None:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs a live torch.distributed process group: start "
            f"the ranks with repro_torch.launch.mesh.run_ranks, or call "
            f"torch.distributed.init_process_group first")


class Mesh:
    """A named grid of ranks: ``devices`` is the array of global ranks
    (shaped by the axes), ``shape`` maps each axis name to its size in
    mesh order (the reference's ``Mesh.shape``), ``device_mesh`` is the
    ``DeviceMesh`` over them.  Every rank of the world builds the mesh
    (its process groups are made collectively); on a rank outside it
    ``coordinate`` is None."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device: str):
        import torch
        from torch.distributed.device_mesh import DeviceMesh
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device_mesh = DeviceMesh(device, torch.as_tensor(self.devices),
                                      mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.coordinate: Optional[dict] = None if coord is None \
            else dict(zip(self.axis_names, coord))

    def get_group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.ravel().tolist()})"


def make_mesh(axis_shapes, axis_names, *, ranks=None, device=None) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names`` over ``ranks``
    (default: every rank of the live process group, whose size must be
    the product of the shape), for tensors on ``device`` (the card unless
    the caller names the CPU)."""
    import torch.distributed as dist
    from repro_torch.core.dispatch import default_device
    _need_group("make_mesh")
    shape = tuple(int(s) for s in axis_shapes)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names "
                         f"{tuple(axis_names)} differ in length")
    if ranks is None:
        if dist.get_world_size() != int(np.prod(shape)):
            raise ValueError(
                f"a mesh {shape} needs {int(np.prod(shape))} ranks; the "
                f"process group has {dist.get_world_size()}")
        ranks = range(dist.get_world_size())
    ranks = np.asarray(list(ranks), dtype=np.int64)
    if ranks.size != int(np.prod(shape)):
        raise ValueError(f"a mesh {shape} needs {int(np.prod(shape))} "
                         f"ranks, given {ranks.size}")
    device = str(default_device(device))
    return Mesh(ranks.reshape(shape), axis_names, device.split(":")[0])


def _map_specs(fn, arg, spec):
    """``fn(tensor, spec)`` over an argument tree: a spec (a tuple such
    as ``P``, or None) covers the whole subtree it meets; a dict, list or
    tuple of specs mirrors the argument's structure."""
    import torch
    if isinstance(arg, torch.Tensor):
        return fn(arg, tuple(spec or ()))
    prefix = spec is None or isinstance(spec, shd.PartitionSpec)
    if isinstance(arg, dict):
        return {k: _map_specs(fn, arg[k], spec if prefix else spec[k])
                for k in sorted(arg)}
    if isinstance(arg, (list, tuple)):
        return type(arg)(_map_specs(fn, a, spec if prefix else s)
                         for a, s in zip(arg, spec if not prefix
                                         else [spec] * len(arg)))
    return arg


def shard_map(f, *, mesh, in_specs=None, out_specs=None, check_vma=False):
    """``f`` over this rank's blocks (``mesh=None``: ``f`` itself).

    The callable cuts each argument, a tensor every rank holds whole, by
    its spec in ``in_specs``, calls ``f`` on the blocks, and gives back
    each result laid out by ``out_specs``: a result under ``P()`` as it
    is (replicated, as the reference's ``out_specs=P()`` promises), a
    sharded one gathered whole.  ``check_vma`` is the reference's
    replication check, which the reference's callers switch off and the
    port does not run."""
    if mesh is None:
        return f
    _need_group("shard_map")
    if not isinstance(mesh, Mesh):
        raise TypeError(f"shard_map over {mesh!r}: pass a compat.Mesh")
    if mesh.coordinate is None:
        raise ValueError(f"this rank is not in {mesh}")

    def call(*args):
        specs = in_specs if isinstance(in_specs, tuple) and \
            not isinstance(in_specs, shd.PartitionSpec) \
            else (in_specs,) * len(args)
        blocks = [_map_specs(lambda x, s: shd.local_shard(x, s, mesh), a, s)
                  for a, s in zip(args, specs)]
        out = f(*blocks)
        if out_specs is None:
            return out
        return _map_specs(lambda x, s: shd.gather_shard(x, s, mesh), out,
                          out_specs)

    return call
