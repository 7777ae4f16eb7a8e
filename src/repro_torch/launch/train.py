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

Without a mesh everything runs on one card (``device``, the card unless
the CPU is asked for).  Over a mesh of ranks (``compat.Mesh``; every
rank a process of a live ``torch.distributed`` group) the step is the
reference's SPMD step, run as each rank's share of it with explicit
collectives:

  * the state's leaves are ``DTensor``s of this rank's blocks, laid out
    by ``state_shardings`` (the logical rules; a moment as its
    parameter, so the AdamW state is ZeRO-sharded);
  * the batch is this rank's rows: the leading dimension splits over the
    mesh's batch axes (``sharding.data_axis_names``: ``pod``, ``data``);
  * the model runs on plain local tensors with no mesh installed
    (``sharding.local_step``): each parameter leaf is gathered once a
    step and handed to the model through ``_Gathered``, whose backward
    sums its gradient over the batch axes and cuts it back to this
    rank's block, a microbatch at a time; the loss's token mean divides
    by the count over every rank's rows;
  * the products split over ``model`` as the reference's rules split
    them: a leaf that a tensor-parallel body reads (``model_blocks``:
    the attention's heads, the gated MLP's width, the embedding's and
    the head's vocabulary) and whose spec names ``model`` is gathered
    over its other axes only and stays this rank's block over
    ``model``; the bodies (``models.layers``, ``models.attention``,
    ``models.transformer``'s logits and cross-entropy) run on those
    blocks with ``collectives.copy_to`` / ``reduce_from``.  Every other
    leaf is gathered whole;
  * the expert leaves of an MoE layer (``wi_gate``, ``wi_up``, ``wo``)
    are never gathered: ``models.moe``'s expert-parallel body takes this
    rank's blocks, laid out by ``state_shardings`` as its specs, and
    their gradients are complete over the axes its all-to-alls span, so
    they are summed over the other batch axes (``pod``) alone;
  * the clip's norm and ``param_norm`` are ``tc_global_norm`` over the
    mesh, each leaf folded over the axes it is split over.

Every arch trains over a mesh (ROADMAP item 14b(i) and (ii)),
``launch.serve`` serves from the same sharded state over one (14b(iii)),
and ``launch.dryrun`` runs this step on fake tensors for rank 0 of a
production mesh (14b(iv)).

    python -m repro_torch.launch.train --arch gemma2-2b --steps 20
    python -m repro_torch.launch.train --arch gemma2-2b --steps 20 \
        --data-parallel 2 --model-parallel 2 --backend gloo
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import logging
import time
from typing import Any, Optional

import torch

from repro_torch import compat
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.core import autotune
from repro_torch.core.dispatch import default_device
from repro_torch.core.integration import _leaves, _tree_like
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tc_collectives
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.models import model_zoo
from repro_torch.models.param import ShapeDtype, _map, _materialise, axes_tree
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


def _state_shapes(model, tconf: TrainConfig) -> TrainState:
    """The state's shapes and dtypes (the reference's ``eval_shape`` of
    ``make_init_state``)."""
    params = model.param_shapes()
    moments = _map(lambda s: ShapeDtype(s.shape, tconf.moment_dtype),
                   params)
    scalar = ShapeDtype((), torch.int32)
    return TrainState(params=params,
                      opt=adamw.AdamWState(m=moments, v=moments,
                                           count=scalar),
                      step=scalar)


def state_shardings(model, mesh, state_shapes: TrainState) -> TrainState:
    """The state's ``NamedSharding``s over ``mesh`` by the logical rules
    (leaves of None without a mesh)."""
    axes = state_logical_axes(model)

    def tree(shapes, ax):
        return shd.tree_shardings(shapes, ax, mesh)

    def scalar(shape):
        return shd.sharding_for(shape.shape, (), mesh)

    return TrainState(
        params=tree(state_shapes.params, axes.params),
        opt=adamw.AdamWState(m=tree(state_shapes.opt.m, axes.opt.m),
                             v=tree(state_shapes.opt.v, axes.opt.v),
                             count=scalar(state_shapes.opt.count)),
        step=scalar(state_shapes.step))


def _split_microbatches(batch, k: int) -> list:
    """(B, ...) -> k microbatches of B/k rows, microbatch i holding rows
    i, i + k, i + 2k, ... (the reference's strided split)."""
    def one(v):
        b = v.shape[0]
        return v.reshape(b // k, k, *v.shape[1:]).movedim(1, 0)
    split = {key: one(v) for key, v in batch.items()}
    return [{key: v[i] for key, v in split.items()} for i in range(k)]


def live_mesh(mesh, what: str = "a train step"):
    """``mesh`` when it has more than one rank, else None (a one-rank
    mesh is one card).  A mesh of several ranks must be a live
    ``compat.Mesh`` holding this rank."""
    if autotune.mesh_device_count(mesh) <= 1:
        return None
    if not isinstance(mesh, compat.Mesh):
        raise TypeError(f"{what} over {mesh!r}: pass a compat.Mesh "
                        f"of live ranks (launch.mesh.make_local_mesh)")
    if mesh.coordinate is None:
        raise ValueError(f"this rank is not in {mesh}")
    return mesh


def make_train_step(model, tconf: TrainConfig, mesh=None, *, device=None):
    """Returns (train_step, make_init_state).

    ``train_step(state, batch) -> (state, metrics)``: the state's
    parameters, moments and count are updated in place and returned in
    a new ``TrainState``.  ``make_init_state(seed)`` draws the
    parameters on ``device`` (the card by default) from ``seed`` (an int
    or a ``torch.Generator`` on that device).

    Over a mesh of several ranks the state is sharded (see the module
    docstring) and ``batch`` is this rank's rows; every rank draws the
    same tree leaf by leaf and keeps its blocks, so that, gathered, the
    state is the one-card state bit for bit.
    """
    cfg = model.cfg
    mesh = live_mesh(mesh)
    shardings = None if mesh is None else state_shardings(
        model, mesh, _state_shapes(model, tconf))
    if mesh is not None and cfg.moe is not None:
        _check_expert_specs(model, mesh, shardings.params)

    def lr_at(step):
        return adamw.cosine_schedule(
            step, base_lr=tconf.learning_rate,
            warmup_steps=tconf.warmup_steps, total_steps=tconf.total_steps)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, metrics, grad_tree = loss_and_grads(
            model, state.params, batch, microbatches=tconf.microbatches,
            mesh=mesh)
        with torch.no_grad():
            lr = lr_at(state.step)
            new_params, new_opt, om = adamw.update(
                grad_tree, state.opt, state.params, lr=lr,
                beta1=tconf.beta1, beta2=tconf.beta2, eps=tconf.eps,
                weight_decay=tconf.weight_decay, grad_clip=tconf.grad_clip,
                reduce_method=cfg.reduce_method, mesh=mesh)
            del grad_tree
            # the post-step parameter norm, on the grad norm's reduction
            pnorm = tc_collectives.tc_global_norm(
                new_params, mesh=mesh, method=cfg.reduce_method)
            new_step = state.step + 1
        metrics = dict(metrics, **om, lr=lr, loss=loss, param_norm=pnorm)
        return TrainState(new_params, new_opt, new_step), metrics

    def make_init_state(seed) -> TrainState:
        dev = torch.device(default_device(device))
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        count = torch.zeros((), dtype=torch.int32, device=dev)
        if mesh is None:
            params = model.init(gen, device=dev)
            return TrainState(
                params=params,
                opt=adamw.init(params, moment_dtype=tconf.moment_dtype),
                step=count)
        # ``model.init``'s draws, leaf by leaf, each cut to its block
        params = shd._tree_map2(
            lambda p, s: s.distribute(_materialise(p, gen, dev)),
            model.specs, shardings.params)
        opt = adamw.init(_map(shd.local, params),
                         moment_dtype=tconf.moment_dtype)

        def wrap(tree, sh):
            return shd._tree_map2(lambda x, s: s.wrap(x), tree, sh)
        return TrainState(
            params=params,
            opt=adamw.AdamWState(m=wrap(opt.m, shardings.opt.m),
                                 v=wrap(opt.v, shardings.opt.v),
                                 count=opt.count),
            step=count)

    return train_step, make_init_state


class _Gathered(torch.autograd.Function):
    """A parameter leaf where the model uses it: whole, or this rank's
    block over ``model`` for a tensor-parallel body.  Forward: the leaf
    gathered from every rank's block over the axes of ``spec``
    (``sharding.gather_shard``, once a step: ``whole``).  Backward: its
    gradient summed over the axes that split the batch (their ranks saw
    other rows), never over ``model``, whose ranks saw the same rows (a
    sum there would count their gradients twice; a tensor-parallel
    body's own ``copy_to`` completes what it holds whole), then this
    rank's block of it."""

    @staticmethod
    def forward(ctx, block, whole, spec, mesh, batch_axes):
        ctx.spec, ctx.mesh, ctx.batch_axes = spec, mesh, batch_axes
        return whole.view_as(whole)

    @staticmethod
    def backward(ctx, grad):
        # The ranks along the batch axes share this rank's block over the
        # other axes, so the gradient is cut to that block before the sum
        # (less to add and to move), and to the batch axes' block after.
        before, after = _split_spec(ctx.spec, ctx.batch_axes)
        part = shd.local_shard(grad, before, ctx.mesh).contiguous()
        total = collectives.mesh_psum(part, ctx.batch_axes, mesh=ctx.mesh)
        return (shd.local_shard(total, after, ctx.mesh).clone(), None,
                None, None, None)


def expert_leaves(model) -> list:
    """For each parameter leaf, in ``_leaves`` order: the key of an
    expert leaf that ``models.moe``'s body takes as its block
    (``wi_gate``, ``wi_up``, ``wo``), else ""."""
    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        return key if any(a in ("experts", "experts_2d")
                          for a in tree.axes) else ""
    return _leaves(walk(model.specs, ""))


def _tp_leaf(node: dict, path: tuple, key: str) -> bool:
    """Whether the leaf ``key`` of ``node`` (a dict of the spec tree at
    ``path``) is read by a tensor-parallel body: ``models.attention.
    attention``'s (``attn_specs``), the gated MLP's (``layers.
    mlp_specs``), the embedding table, the untied head."""
    keys = set(node)
    if {"wq", "wk", "wv", "wo"} <= keys:
        return True
    if keys == {"wi_gate", "wi_up", "wo"}:
        return not any(a in ("experts", "experts_2d")
                       for a in node["wi_gate"].axes)
    return (path, key) in ((("embed",), "table"), ((), "lm_head"))


def model_blocks(model) -> list:
    """For each parameter leaf, in ``_leaves`` order: whether a
    tensor-parallel body reads it as this rank's block over ``model``
    where the rules split it over ``model`` (``_tp_leaf``).  Every other
    leaf the rules split over ``model`` is gathered whole: MLA's leaves
    (``q_lora``, and the heads of its own body), RWKV-6's and RG-LRU's
    (ROADMAP item 14c(iii)); the expert leaves are the MoE body's blocks
    (``expert_leaves``)."""
    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else _tp_leaf(tree, path, k) for k, v in sorted(tree.items())}
    return _leaves(walk(model.specs, ()))


def _without_model(spec):
    """``spec`` less its ``model`` entry: the axes a tensor-parallel
    body's leaf is gathered over."""
    return shd.P(*(None if "model" in shd.spec_axes((e,)) else e
                   for e in spec))


def leaf_paths(tree) -> list:
    """Each leaf's path of dict keys joined by '/', in ``_leaves``
    order."""
    def walk(sub, path):
        if isinstance(sub, dict):
            return {k: walk(sub[k], f"{path}/{k}" if path else k)
                    for k in sorted(sub)}
        return path
    return _leaves(walk(tree, ""))


def _check_expert_specs(model, mesh, param_shardings) -> None:
    """Every expert leaf laid out exactly as the MoE body takes it (the
    layers' stacking dims unsplit); raises naming the leaf, its shape
    and both specs otherwise."""
    from repro_torch.models import moe
    want = moe.block_specs(model.cfg, dict(mesh.shape))
    shapes = _leaves(model.param_shapes())
    paths = leaf_paths(model.specs)
    for kind, s, shape, path in zip(expert_leaves(model),
                                    _leaves(param_shardings), shapes, paths):
        if not kind:
            continue
        lead = len(shape.shape) - len(want[kind])
        expect = shd.P(*(None,) * lead, *want[kind])
        if tuple(s.spec) != tuple(expect):
            raise ValueError(
                f"{model.cfg.name} over {mesh}: the expert leaf {path} of "
                f"shape {tuple(shape.shape)} is laid out {s.spec} by the "
                f"logical rules, and the MoE body takes it as {expect}")


# Gathers of each parameter leaf by the mesh step, by path (``leaf_paths``
# of the parameter tree): an expert leaf is never gathered.
GATHERED: collections.Counter = collections.Counter()
# The mesh axes each leaf's last gather spanned and the bytes it gave,
# by path: a tensor-parallel body's block over model is gathered over
# its other axes only.
GATHERED_OVER: dict = {}


def _split_spec(spec, batch_axes) -> tuple:
    """(spec, spec): a leaf's dimensions split over no batch axis, and
    those split over batch axes alone.  A dimension split over both is
    cut after the sum (its blocks interleave the two)."""
    before, after = [], []
    for entry in spec:
        names = shd.spec_axes((entry,))
        batch = [a for a in names if a in batch_axes]
        early = names and not batch
        before.append(entry if early else None)
        after.append(None if early else entry)
    return shd.P(*before), shd.P(*after)


def _grads(model, leaves, params, batch):
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a parameter the loss does not reach has gradient 0 (jax.grad's)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def loss_and_grads(model, params, batch, *, microbatches: int = 1,
                   mesh=None):
    """(loss, metrics, gradient tree) of ``model.loss`` at ``params``
    (whose leaves are made to require grad).  Over k > 1 microbatches the
    gradients are summed in f32 and divided by k, the loss averaged and
    the metrics the last microbatch's, as the reference's scan does.

    Over a mesh ``params`` are DTensors of this rank's blocks and
    ``batch`` this rank's rows; the gradients come back as DTensors laid
    out as their parameters, and the loss and metrics (token means: the
    ranks' shares) are folded over the batch axes."""
    mesh = live_mesh(mesh)
    k = microbatches
    if mesh is None:
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        def grads_of(mb):
            return _grads(model, leaves, params, mb)
    else:
        grads_of, leaves = _mesh_grads(model, params, mesh, batch, k)
    if k == 1:
        loss, metrics, grads = grads_of(batch)
    else:
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = 0.0
        for mb in _split_microbatches(batch, k):
            lmb, metrics, grads = grads_of(mb)
            for acc, g in zip(g_acc, grads):
                acc.add_(g)
            loss = loss + lmb
            del grads
        loss, grads = loss / k, [g / k for g in g_acc]
    if mesh is not None:
        grads = [shd.dtensor_sharding(p).wrap(g)
                 for g, p in zip(grads, _leaves(params))]
    return loss, metrics, _tree_like(params, grads)


def _mesh_grads(model, params, mesh, batch, k: int):
    """(one microbatch's (loss, metrics, this rank's gradient blocks),
    the blocks) of a sharded ``params`` tree."""
    axes = shd.data_axis_names(mesh)
    rows = next(iter(batch.values())).shape[0]
    if rows % k:
        raise ValueError(
            f"this rank's {rows} rows do not split into {k} microbatches: "
            f"the strided split of the global batch keeps each rank's "
            f"rows only when (global batch / batch ranks) % k == 0")
    dtensors = _leaves(params)
    paths = leaf_paths(params)
    blocks = [shd.local(p).detach().requires_grad_(True) for p in dtensors]
    experts = expert_leaves(model)
    # the products split over model where its axis has several ranks; a
    # tensor-parallel body's leaf split over model keeps its block there
    tp_axis = "model" if mesh.shape.get("model", 1) > 1 else None
    specs = []
    for p, tp in zip(dtensors, model_blocks(model)):
        spec = shd.dtensor_sharding(p).spec
        if tp and tp_axis and tp_axis in shd.spec_axes(spec):
            spec = _without_model(spec)
        specs.append(spec)
    # every other leaf gathered once a step, for all k microbatches; an
    # expert leaf reaches the MoE body as its block
    wholes = []
    for b, spec, kind, path in zip(blocks, specs, experts, paths):
        if kind:
            wholes.append(None)
            continue
        w = shd.gather_shard(b.detach(), spec, mesh)
        GATHERED[path] += 1
        GATHERED_OVER[path] = (shd.spec_axes(spec),
                               w.numel() * w.element_size())
        wholes.append(w)
    # the all-to-alls span data (and model): an expert block's gradient
    # is summed over the other batch axes
    expert_axes = tuple(a for a in axes if a not in ("data", "model"))
    method = model.cfg.reduce_method

    def fold(v):
        return tc_collectives.psum_scalar(v, axes, mesh=mesh, method=method)

    def grads_of(mb):
        with shd.local_step(mesh, axes, tp_axis):
            whole = _tree_like(params, [
                b if kind else _Gathered.apply(b, w, spec, mesh, axes)
                for b, w, spec, kind in zip(blocks, wholes, specs,
                                            experts)])
            loss, metrics, grads = _grads(model, blocks, whole, mb)
        grads = [collectives.mesh_psum(g, expert_axes, mesh=mesh)
                 if kind and expert_axes else g
                 for g, kind in zip(grads, experts)]
        return fold(loss), {n: fold(v) for n, v in metrics.items()}, grads

    return grads_of, blocks


def jit_train_step(model, tconf: TrainConfig, mesh, sample_batch_shapes, *,
                   device=None):
    """The reference's entry point, with its return shape: (train_step,
    make_init_state, the state's shardings, the batch's).  Nothing is
    compiled: the step runs eagerly.  Without a mesh of several ranks the
    shardings are None and one card holds every leaf whole; over one,
    the batch's leading dimension must split over every batch axis."""
    train_step, make_init_state = make_train_step(model, tconf, mesh,
                                                  device=device)
    mesh = live_mesh(mesh)
    s_shard = state_shardings(model, mesh, _state_shapes(model, tconf))
    b_axes = batch_axes(sample_batch_shapes)
    b_shard = {key: shd.sharding_for(v.shape, b_axes[key], mesh)
               for key, v in sample_batch_shapes.items()}
    want = shd.data_axis_names(mesh)
    for key, s in b_shard.items():
        if s is not None and shd.spec_axes(s.spec[:1]) != want:
            raise ValueError(
                f"batch leaf {key!r} of {sample_batch_shapes[key].shape[0]} "
                f"rows does not split over the batch axes {want} of {mesh}")
    return train_step, make_init_state, s_shard, b_shard


def run(arch: str, *, steps: int = 200, smoke: bool = True,
        shape: str = "train_4k", ckpt_dir: Optional[str] = None,
        data_parallel: int = 1, model_parallel: int = 1,
        batch_override: Optional[int] = None,
        seq_override: Optional[int] = None,
        microbatches: int = 1, log_every: int = 10,
        save_every: int = 100, seed: int = 0,
        plan_store: Optional[str] = None, device=None):
    """End-to-end training driver on ``device`` (default: the card).
    With ``data_parallel * model_parallel`` > 1 it runs on a (data,
    model) mesh over the live process group, whose every rank calls it
    (``main`` starts them); the first rank of the mesh prints.
    ``plan_store`` binds the autotune registry to a shared plan-store
    file, merged at the start and saved at the end.  Returns (state,
    history), history the logged (step, loss) pairs."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_local_mesh
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
        autotune.bind_default_registry(plan_store)
    mesh = make_local_mesh(data_parallel, model_parallel, device=device) \
        if data_parallel * model_parallel > 1 else None
    model = model_zoo.build(cfg)
    data_shard = None if mesh is None else \
        shd.NamedSharding(mesh, shd.P(("data",)))
    data = SyntheticLMData(cfg, shape_cfg, seed=seed, sharding=data_shard,
                           device=device)
    step_fn, make_init_state, _, _ = jit_train_step(
        model, tconf, mesh, model.input_specs(shape_cfg), device=device)
    lead = mesh is None or shd.is_first_rank(mesh)

    def init_fn():
        return make_init_state(seed)

    sup = TrainSupervisor(ckpt_dir, save_every=save_every) \
        if ckpt_dir else None
    if sup:
        # drop plans keyed to another mesh geometry (the replan hook)
        sup.on_remesh(mesh)
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
            if lead:
                log.info("step %5d loss %.4f (%.2fs)", step_i, loss,
                         time.time() - t0)
                print(f"step {step_i:5d} loss {loss:.4f} grad_norm "
                      f"{float(metrics.get('grad_norm', 0)):.3f}")
        if sup:
            sup.maybe_save(step_i + 1, state)
    if sup:
        sup.finalize(steps, state)
    if plan_store and lead:
        autotune.default_registry().save(plan_store)
    return state, history


def _run_rank(kwargs: dict) -> list:
    """One rank of the CLI's mesh: each rank takes a card of its own
    where there are several (rank modulo the cards)."""
    if str(kwargs["device"]).startswith("cuda"):
        import torch.distributed as dist
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    logging.basicConfig(level=logging.INFO)
    return run(**kwargs)[1]


def main(argv=None) -> list:
    """The CLI; returns the logged (step, loss) pairs (the first
    rank's over a mesh)."""
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
    ap.add_argument("--backend", default="gloo",
                    help="the ranks' process-group backend over a mesh "
                         "(gloo | nccl; nccl takes one card a rank, gloo "
                         "also several ranks on one card)")
    ap.add_argument("--timeout", type=float, default=86400.0,
                    help="seconds after which a mesh's ranks are killed")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    kwargs = dict(arch=args.arch, steps=args.steps, smoke=not args.full,
                  batch_override=args.batch, seq_override=args.seq,
                  microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                  data_parallel=args.data_parallel,
                  model_parallel=args.model_parallel,
                  plan_store=args.plan_store, device=args.device)
    world = args.data_parallel * args.model_parallel
    if world == 1:
        return run(**kwargs)[1]
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_run_rank, world, backend=args.backend,
                     args=(kwargs,), timeout=args.timeout)


if __name__ == "__main__":
    main()
