"""Training: the train state and step, and the CLI driver — the
counterpart of ``repro.launch.train``.

``make_train_step`` builds the step for a model: gradients of
``Model.loss`` by ``torch.autograd`` (a loop over microbatches in place
of the reference's ``lax.scan``: grads summed in f32, then divided by
k), global-norm clipping through the paper's MMA reduction, AdamW
written into the state's own tensors (the reference's jit donates them),
and the post-step parameter norm on the same reduction.  ``run`` is the
end-to-end loop: the synthetic pipeline, the checkpoint / restart
supervisor, metrics.

Everything runs on one card (``device``, the card unless the CPU is
asked for); ``data_parallel`` / ``model_parallel`` > 1 is ROADMAP item
14b (the model over a mesh) and raises.

    python -m repro_torch.launch.train --arch gemma2-2b --steps 20
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any, Optional

import torch

from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.core.dispatch import default_device
from repro_torch.core.integration import _leaves, _tree_like
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed import tc_collectives
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.distributed.sharding import _refuse_mesh
from repro_torch.models import model_zoo
from repro_torch.models.param import axes_tree
from repro_torch.optim import adamw

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor


def batch_axes(batch_like) -> dict:
    """Logical axes for a batch tree (leading dim = global batch)."""
    return {k: ("batch",) + (None,) * (len(v.shape) - 1)
            for k, v in batch_like.items()}


def state_logical_axes(model) -> TrainState:
    paxes = axes_tree(model.specs)
    return TrainState(params=paxes, opt=adamw.state_axes(paxes), step=())


def _split_microbatches(batch, k: int) -> list:
    """(B, ...) -> k microbatches of B/k rows, microbatch i holding rows
    i, i + k, i + 2k, ... (the reference's strided split)."""
    def one(v):
        b = v.shape[0]
        return v.reshape(b // k, k, *v.shape[1:]).movedim(1, 0)
    split = {key: one(v) for key, v in batch.items()}
    return [{key: v[i] for key, v in split.items()} for i in range(k)]


def _no_mesh(data_parallel: int = 1, model_parallel: int = 1) -> None:
    if data_parallel * model_parallel > 1:
        raise NotImplementedError(
            f"data_parallel={data_parallel}, model_parallel="
            f"{model_parallel} is ROADMAP item 14b (distributed: the "
            f"model over a mesh)")


def make_train_step(model, tconf: TrainConfig, mesh=None, *, device=None):
    """Returns (train_step, make_init_state).

    ``train_step(state, batch) -> (state, metrics)``: the state's
    parameters, moments and count are updated in place and returned in
    a new ``TrainState``.  ``make_init_state(seed)`` draws the
    parameters on ``device`` (the card by default) from ``seed`` (an int
    or a ``torch.Generator`` on that device).
    """
    _refuse_mesh(mesh)
    cfg = model.cfg

    def lr_at(step):
        return adamw.cosine_schedule(
            step, base_lr=tconf.learning_rate,
            warmup_steps=tconf.warmup_steps, total_steps=tconf.total_steps)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grad_tree = loss_and_grads(
            model, state.params, batch, microbatches=tconf.microbatches)
        with torch.no_grad():
            lr = lr_at(state.step)
            new_params, new_opt, om = adamw.update(
                grad_tree, state.opt, state.params, lr=lr,
                beta1=tconf.beta1, beta2=tconf.beta2, eps=tconf.eps,
                weight_decay=tconf.weight_decay, grad_clip=tconf.grad_clip,
                reduce_method=cfg.reduce_method)
            del grad_tree
            # the post-step parameter norm, on the grad norm's reduction
            pnorm = tc_collectives.tc_global_norm(
                new_params, method=cfg.reduce_method)
            new_step = state.step + 1
        metrics = dict(metrics, **om, lr=lr, loss=loss, param_norm=pnorm)
        return TrainState(new_params, new_opt, new_step), metrics

    def make_init_state(seed) -> TrainState:
        dev = torch.device(default_device(device))
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        params = model.init(gen, device=dev)
        return TrainState(
            params=params,
            opt=adamw.init(params, moment_dtype=tconf.moment_dtype),
            step=torch.zeros((), dtype=torch.int32, device=dev))

    return train_step, make_init_state


def _grads(model, leaves, params, batch):
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a parameter the loss does not reach has gradient 0 (jax.grad's)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def loss_and_grads(model, params, batch, *, microbatches: int = 1):
    """(loss, metrics, gradient tree) of ``model.loss`` at ``params``
    (whose leaves are made to require grad).  Over k > 1 microbatches the
    gradients are summed in f32 and divided by k, the loss averaged and
    the metrics the last microbatch's, as the reference's scan does."""
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    k = microbatches
    if k == 1:
        loss, metrics, grads = _grads(model, leaves, params, batch)
        return loss, metrics, _tree_like(params, grads)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    loss = 0.0
    for mb in _split_microbatches(batch, k):
        lmb, metrics, grads = _grads(model, leaves, params, mb)
        for acc, g in zip(g_acc, grads):
            acc.add_(g)
        loss = loss + lmb
        del grads
    return loss / k, metrics, _tree_like(params, [g / k for g in g_acc])


def jit_train_step(model, tconf: TrainConfig, mesh, sample_batch_shapes, *,
                   device=None):
    """The reference's entry point, with its return shape: (train_step,
    make_init_state, the state's logical axes, the batch's).  Nothing is
    compiled: the step runs eagerly; one card holds every leaf whole."""
    train_step, make_init_state = make_train_step(model, tconf, mesh,
                                                  device=device)
    return (train_step, make_init_state, state_logical_axes(model),
            batch_axes(sample_batch_shapes))


def run(arch: str, *, steps: int = 200, smoke: bool = True,
        shape: str = "train_4k", ckpt_dir: Optional[str] = None,
        data_parallel: int = 1, model_parallel: int = 1,
        batch_override: Optional[int] = None,
        seq_override: Optional[int] = None,
        microbatches: int = 1, log_every: int = 10,
        save_every: int = 100, seed: int = 0,
        plan_store: Optional[str] = None, device=None):
    """End-to-end training driver on ``device`` (default: the card).
    ``plan_store`` binds the autotune registry to a shared plan-store
    file, merged at the start and saved at the end.  Returns (state,
    history), history the logged (step, loss) pairs."""
    from repro_torch.configs import registry
    _no_mesh(data_parallel, model_parallel)
    device = default_device(device)
    cfg = registry.get_config(arch, smoke=smoke)
    shape_cfg = SHAPES[shape]
    if batch_override or seq_override:
        shape_cfg = dataclasses.replace(
            shape_cfg, global_batch=batch_override or shape_cfg.global_batch,
            seq_len=seq_override or shape_cfg.seq_len)
    tconf = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1),
                        microbatches=microbatches, seed=seed)
    if plan_store:
        from repro_torch.core import autotune
        autotune.bind_default_registry(plan_store)
    model = model_zoo.build(cfg)
    data = SyntheticLMData(cfg, shape_cfg, seed=seed, device=device)
    step_fn, make_init_state = make_train_step(model, tconf, device=device)

    def init_fn():
        return make_init_state(seed)

    sup = TrainSupervisor(ckpt_dir, save_every=save_every) \
        if ckpt_dir else None
    if sup:
        # drop plans keyed to another mesh geometry (the replan hook)
        sup.on_remesh(None)
        state, start = sup.restore_or_init(init_fn)
    else:
        state, start = init_fn(), 0

    t0 = time.time()
    history = []
    for step_i, batch in zip(range(start, steps), data.iter(start)):
        state, metrics = step_fn(state, batch)
        if step_i % log_every == 0 or step_i == steps - 1:
            loss = float(metrics["loss"])
            history.append((step_i, loss))
            log.info("step %5d loss %.4f (%.2fs)", step_i, loss,
                     time.time() - t0)
            print(f"step {step_i:5d} loss {loss:.4f} "
                  f"grad_norm {float(metrics.get('grad_norm', 0)):.3f}")
        if sup:
            sup.maybe_save(step_i + 1, state)
    if sup:
        sup.finalize(steps, state)
    if plan_store:
        autotune.default_registry().save(plan_store)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke-size)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--plan-store", default=None,
                    help="shared autotune plan-store JSON (merged at "
                         "startup, saved at exit)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda | cpu)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run(args.arch, steps=args.steps, smoke=not args.full,
        batch_override=args.batch, seq_override=args.seq,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        data_parallel=args.data_parallel,
        model_parallel=args.model_parallel,
        plan_store=args.plan_store, device=args.device)


if __name__ == "__main__":
    main()
