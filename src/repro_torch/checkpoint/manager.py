"""Atomic, async checkpointing — the counterpart of
``repro.checkpoint.manager``, in its on-disk layout:

    <dir>/step_<N>/
        manifest.json      (step, each leaf's key, shape and dtype)
        arrays.npz         (the leaves, keyed by tree path)
    <dir>/LATEST           (atomic pointer file)

A leaf's key is its tree path joined by ``/``: a dict key as it is, a
list index as its number, a dataclass field as ``.<name>`` (JAX's
``GetAttrKey`` spelling), so a ``launch.train.TrainState`` and the
reference's write the same keys (``.params/embed/table``,
``.opt/.m/...``, ``.opt/.count``, ``.step``).

numpy has no bf16 and the card's machine has no ``ml_dtypes``: a bf16
leaf is stored as its raw 16-bit words (numpy ``V2``, the bytes the
reference's ``np.asarray`` of a bf16 array writes) and the manifest says
``bfloat16``.  ``restore`` reads such a leaf, from either package, back
to the same bits.  (The reference cannot restore a bf16 leaf, its own
included: numpy finds no cast from ``V2``.)

Guarantees, as in the reference: a checkpoint becomes visible only after
its directory is written and ``LATEST`` is renamed over it; leaves are
stored whole (logical shapes); ``AsyncSaver.save_async`` copies the tree
to host memory synchronously and writes on a background thread.

A state sharded over a mesh of ranks holds its leaves as ``DTensor``s
(``launch.train``).  Every rank of the mesh calls ``save``: each such
leaf is gathered whole (``sharding.gather_shard``, every bit kept, the
sign of a zero too), the mesh's first rank writes, and ``save`` returns
on every rank once the checkpoint is visible.  ``restore`` cuts each
stored leaf by its template's own layout: the template may lie on
another mesh than the one that saved (the reference's elastic
re-shard).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.precision import as_dtype
from repro_torch.distributed import sharding as shd
from repro_torch.models.param import ShapeDtype

_SEP = "/"


def _flatten(tree, prefix=()) -> list:
    """[(path, leaf)] in the reference's order: dict keys sorted, list
    items and dataclass fields in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, item in enumerate(tree)
                for kv in _flatten(item, prefix + (str(i),))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) \
            and not isinstance(tree, ShapeDtype):
        return [kv for f in dataclasses.fields(tree)
                for kv in _flatten(getattr(tree, f.name),
                                   prefix + ("." + f.name,))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(tree, leaves: dict, prefix=()):
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, leaves, prefix + (str(i),))
                          for i, item in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) \
            and not isinstance(tree, ShapeDtype):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves,
                               prefix + ("." + f.name,))
            for f in dataclasses.fields(tree)})
    return leaves[_SEP.join(prefix)]


def _to_host(leaf) -> tuple:
    """(numpy array as stored, manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)  # a snapshot, also on the CPU
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array
        return a.view("V2"), "bfloat16"
    return a, str(a.dtype)


def _device_mesh(leaves: list):
    """The mesh of the first DTensor leaf, or None."""
    for _, leaf in leaves:
        if shd.is_dtensor(leaf):
            return leaf.device_mesh
    return None


def _snapshot(tree) -> tuple:
    """(the mesh of a sharded tree or None, [(key, host array, dtype
    name)], or None for that list on a rank of the mesh that does not
    write).  A DTensor leaf is gathered whole by every rank of its
    mesh."""
    leaves = _flatten(tree)
    mesh = _device_mesh(leaves)
    writer = mesh is None or shd.is_first_rank(mesh)
    snap = []
    for key, leaf in leaves:
        leaf = shd.whole(leaf)
        if writer:
            snap.append((key, *_to_host(leaf)))
    return mesh, snap if writer else None


def _write(directory: str, step: int, snap: list) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, a, _ in snap})
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                       for k, a, dt in snap},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    mesh, snap = _snapshot(tree)
    path = os.path.join(directory, f"step_{step:08d}")
    if snap is not None:
        path = _write(directory, step, snap)
    if mesh is not None:
        shd.mesh_barrier(mesh)
    return path


class AsyncSaver:
    """Snapshot-to-host synchronously, write asynchronously."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save_async(self, directory: str, step: int, tree: Any):
        self.wait()
        _, snap = _snapshot(tree)
        if snap is None:                # a rank of the mesh that does
            return                      # not write

        def run():
            try:
                _write(directory, step, snap)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[-1])


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    a = np.array(a, order="C")              # a copy, 0-d kept 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore(directory: str, template: Any,
            step: Optional[int] = None) -> tuple[Any, int]:
    """Restore into ``template``: a tensor leaf is written in place and
    returned (its dtype and device; no second copy of the state on the
    device), a DTensor leaf's local block by its layout; a ``ShapeDtype``
    or a ``meta`` tensor gives a new tensor of its dtype on the CPU.
    Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    data = np.load(os.path.join(path, "arrays.npz"))
    out = {}
    for key, leaf in _flatten(template):
        with torch.no_grad():
            out[key] = _restore_leaf(leaf, data[key],
                                     manifest[key]["dtype"])
    return _unflatten(template, out), step


def _restore_leaf(leaf, stored: np.ndarray, dtype_name: str):
    host = _from_host(stored, dtype_name)
    if shd.is_dtensor(leaf):
        shd.local(leaf).copy_(shd.dtensor_sharding(leaf).shard(host))
        return leaf
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.copy_(host)
    return host.to(as_dtype(leaf.dtype))


def cleanup(directory: str, keep: int = 3):
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
