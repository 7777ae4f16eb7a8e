"""Fault tolerance and elasticity — the counterpart of
``repro.distributed.fault_tolerance``.

The reference's recovery contract:

  1. every ``save_every`` steps a step-atomic checkpoint of the train
     state (``checkpoint.manager``, the reference's layout);
  2. on the loss of ranks, ``remesh`` folds the survivors into the
     largest valid (data, model) mesh: the model axis is kept (its
     degree is a property of the program), data is the elastic axis;
  3. the data pipeline is stateless in the step
     (``data.pipeline.SyntheticLMData.batch_at``), so a restored step
     continues with the same batches: resumed == uninterrupted, bit for
     bit;
  4. ``reassign`` is the deterministic shard -> worker map after a
     re-mesh (the reference's numpy ``SeedSequence``, the same bits);
  5. ``replan_after_remesh`` (``TrainSupervisor.on_remesh``) drops
     autotuned plans keyed to a mesh geometry other than the new one,
     so the next ``method='auto'`` call tunes the survivors' shards.

A device of the reference is a rank of the port: ``remesh`` lays out
ranks of the live process group, and every rank of the world builds the
mesh (``torch.distributed.new_group`` is collective); ranks left out of
it idle.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.checkpoint import manager as ckpt

log = logging.getLogger(__name__)


def _remesh_layout(ranks: Sequence[int], model_parallel: int,
                   pod_size: Optional[int]) -> tuple:
    """(array of ranks shaped by the axes, axis names) of the largest
    mesh over ``ranks`` with a model axis of ``model_parallel``."""
    ranks = list(ranks)
    n = len(ranks) - len(ranks) % model_parallel
    ranks = ranks[:n]
    if n == 0:
        raise RuntimeError("no usable devices for remesh")
    data = n // model_parallel
    # A pod smaller than (or not a multiple of) the model group cannot
    # hold a whole model group: the pod axis is dropped.
    if pod_size and pod_size % model_parallel == 0 and \
            data % (pod_size // model_parallel) == 0 and \
            n % pod_size == 0:
        arr = np.array(ranks).reshape(n // pod_size,
                                      pod_size // model_parallel,
                                      model_parallel)
        return arr, ("pod", "data", "model")
    return np.array(ranks).reshape(data, model_parallel), ("data", "model")


def remesh(devices: Optional[Sequence[int]] = None, *, model_parallel: int,
           pod_size: Optional[int] = None, device=None):
    """The largest mesh over the surviving ranks ``devices`` (default:
    every rank of the world) with a fixed model axis.

    data' = floor(n / model); a ragged survivor count truncates to whole
    model groups.  If ``pod_size`` tiles the survivors, a leading 'pod'
    axis is kept; degenerate pod geometries fall back to the flat
    (data, model) mesh.  Every rank of the world must call it."""
    import torch.distributed as dist
    from repro_torch import compat
    if devices is None:
        devices = range(dist.get_world_size())
    arr, names = _remesh_layout(devices, model_parallel, pod_size)
    return compat.make_mesh(arr.shape, names, ranks=arr.ravel(),
                            device=device)


def replan_after_remesh(mesh, *, registry=None) -> tuple:
    """Invalidate autotuned plans keyed to any mesh geometry other than
    ``mesh``'s (a mesh, a signature string or a tuple of (name, size);
    None or a one-rank mesh: every ``|mesh:`` plan) — call it with the
    mesh ``remesh`` returned.  Plans for the new signature are kept.
    Returns the invalidated keys."""
    from repro_torch.core import autotune
    reg = registry if registry is not None else \
        autotune.default_registry()
    keep = autotune.mesh_signature(mesh)
    dead: list = []
    for sig in reg.mesh_signatures():
        if sig != keep:
            dead.extend(reg.invalidate_mesh(sig))
    if dead:
        log.info("remesh to %s invalidated %d stale mesh plan(s)",
                 keep or "<single-device>", len(dead))
    return tuple(dead)


def reassign(step: int, num_workers: int, num_shards: int) -> np.ndarray:
    """Deterministic shard -> worker assignment for a step and topology
    (the reference's draw, bit for bit)."""
    rng = np.random.default_rng(np.random.SeedSequence([step,
                                                        num_workers]))
    return rng.permutation(num_shards) % num_workers


@dataclasses.dataclass
class TrainSupervisor:
    """Checkpoint / restart harness around a step function."""
    ckpt_dir: str
    save_every: int = 50
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        self._saver = ckpt.AsyncSaver()

    def restore_or_init(self, init_fn: Callable[[], object]):
        """Return (state, start_step), resumed if a checkpoint exists.
        The restored leaves are written into a freshly initialised state
        (its dtypes, its devices), so the state is held once."""
        step = ckpt.latest_step(self.ckpt_dir)
        state = init_fn()
        if step is None:
            return state, 0
        state, step = ckpt.restore(self.ckpt_dir, state, step)
        log.info("restored checkpoint at step %d", step)
        return state, step

    def maybe_save(self, step: int, state) -> None:
        if step % self.save_every:
            return
        if self.async_save:
            self._saver.save_async(self.ckpt_dir, step, state)
        else:
            ckpt.save(self.ckpt_dir, step, state)
        ckpt.cleanup(self.ckpt_dir, keep=self.keep)

    def finalize(self, step: int, state) -> None:
        self._saver.wait()
        ckpt.save(self.ckpt_dir, step, state)
        ckpt.cleanup(self.ckpt_dir, keep=self.keep)

    def on_remesh(self, mesh, *, registry=None) -> tuple:
        """The replan hook: after (re)building the mesh, drop autotuned
        plans tuned for any other mesh geometry."""
        return replan_after_remesh(mesh, registry=registry)
