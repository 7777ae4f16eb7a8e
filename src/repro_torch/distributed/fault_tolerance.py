"""Checkpoint / restart around the training loop, one card's part — the
counterpart of ``repro.distributed.fault_tolerance``.

The reference's recovery contract, as far as one card reaches:

  1. every ``save_every`` steps a step-atomic checkpoint of the train
     state (``checkpoint.manager``, the reference's layout);
  2. the data pipeline is stateless in the step
     (``data.pipeline.SyntheticLMData.batch_at``), so a restored step
     continues with the same batches: resumed == uninterrupted, bit for
     bit;
  3. ``reassign`` is the deterministic shard -> worker map after a
     re-mesh (the reference's numpy ``SeedSequence``, the same bits);
  4. ``replan_after_remesh`` drops autotuned plans keyed to a mesh
     geometry other than the new one.

``remesh`` (folding surviving devices into a new mesh) is ROADMAP item
14: on one card there is no mesh to fold, and a mesh of more than one
device raises there.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np

from repro_torch.checkpoint import manager as ckpt

log = logging.getLogger(__name__)


def replan_after_remesh(mesh, *, registry=None) -> tuple:
    """Invalidate autotuned plans keyed to any mesh geometry other than
    ``mesh``'s (None or a one-device mesh: every ``|mesh:`` plan).
    Returns the invalidated keys."""
    from repro_torch.core import autotune
    reg = registry if registry is not None else \
        autotune.default_registry()
    keep = autotune.mesh_signature(mesh)
    if keep:
        raise NotImplementedError(
            f"repro_torch runs on one card: a remesh onto {keep!r} is "
            f"ROADMAP item 14 (distributed)")
    dead: list = []
    for sig in reg.mesh_signatures():
        dead.extend(reg.invalidate_mesh(sig))
    if dead:
        log.info("remesh to <single-device> invalidated %d stale mesh "
                 "plan(s)", len(dead))
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
