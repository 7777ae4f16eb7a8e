"""The one-card counterpart of ``repro.compat``.

The reference routes ``shard_map`` and ``make_mesh`` through version
shims for its JAX installs.  The port runs on one card: ``shard_map``
with no mesh is the plain call, and a mesh is refused until ROADMAP item
14 (distributed) brings ``torch.distributed`` meshes.
"""

from __future__ import annotations

from repro_torch.distributed.sharding import _refuse_mesh


def shard_map(f, *, mesh, in_specs=None, out_specs=None, check_vma=False):
    """``f`` itself on one card (``mesh=None``); a mesh is refused."""
    _refuse_mesh(mesh)
    return f


def make_mesh(axis_shapes, axis_names):
    """Refused: the port has no device mesh before ROADMAP item 14."""
    raise NotImplementedError(
        f"repro_torch runs on one card: a mesh {tuple(axis_shapes)} over "
        f"{tuple(axis_names)} is ROADMAP item 14 (distributed)")
