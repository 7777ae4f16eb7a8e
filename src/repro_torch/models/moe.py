"""Mixture-of-Experts with expert parallelism — the counterpart of
``repro.models.moe``.

Sort-based capacity dispatch into an (E, C, D) buffer, the expert FFN as
batched matmuls, and a weighted combine back to token order.  Routing
statistics (tokens per expert for the load-balance loss) use the paper's
ones-MMA encoding (``integration.expert_counts``), and the dispatch's
per-expert buffer offsets are an exclusive prefix scan over the counts
run as a triangular MMA (``integration.cumsum`` under
``EXACT_OFFSETS``).

Over a mesh of ranks the body is the reference's shard body, with the
collectives of ``distributed.collectives`` (autograd functions whose
backward keeps one card's gradients):

  * layout B ``etp``: tokens split over the batch axes and the same on
    every ``model`` rank, experts over ``data``, each expert's ffn over
    ``model``; the buffer goes home by an ``all_to_all`` over ``data``,
    ``copy_to`` over ``model`` before the ffn slice and ``reduce_from``
    in place of the reference's ``psum`` after it, then the reverse
    ``all_to_all``;
  * layout A ``ep2d``: each ``model`` rank takes its slice of the
    sequence (``scatter_to``), experts over the merged ``("data",
    "model")`` axes at full width (no sum), the output gathered along
    the sequence (``gather_from``); the router, used on this rank's
    slice only, goes through ``copy_to``.

``moe_block`` takes that body two ways: (a) on this rank's rows and
blocks (``sharding.local_step``), in a train step and in a server over a
mesh: x is this rank's rows, the expert leaves arrive as this rank's
blocks, and the aux loss returned is this rank's share of the
reference's mean (the step adds the ranks' shares; a server drops it);
a batch whose rows do not split over every batch axis is refused there
before any collective, as the reference's ``shard_map`` refuses it; (b)
under an installed mesh (``sharding.axis_rules``) on whole tensors,
through ``compat.shard_map`` with the reference's specs, forward only
(``launch.dryrun`` runs (a), inside the train and serving steps).  The
capacity comes from the local token count, as in the reference, so a
mesh drops other tokens than one card once it binds.
The dispatch buffer and the experts' output carry the reference's
``checkpoint_name`` tags (``models.remat``), which
``remat='dots_tagged'`` saves.

Three scatters of the reference change form:
  * the counts are a ``scatter_add_`` of ones (exact; its shape, unlike
    ``torch.bincount``'s, does not depend on the ids' values);
  * a dropped token's slot ``E * C`` lies past the buffer, where the
    reference's ``mode="drop"`` scatter drops it and torch would raise,
    so the buffer has a spare row that is cut off;
  * the combine sums each token's k contributions in a fixed order
    (back in (T, k) token order through the inverse of the sort, then
    over k), where ``index_add_`` on the card would add in no fixed
    order and change a token's bits from run to run.

DeepSeek-V3: sigmoid router, top-8 of 256 + 1 shared expert, routed
scaling.  Arctic: softmax top-2 of 128 + parallel dense-residual MLP.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.core import integration as ci
from repro_torch.core.precision import EXACT_OFFSETS
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import remat as RM
from repro_torch.models.param import Param


def moe_specs(cfg):
    d, mc = cfg.d_model, cfg.moe
    e, f = mc.num_experts, mc.d_ff_expert
    # layout B "etp": EP over data, expert-ffn TP over model (tokens
    # model-replicated); layout A "ep2d": EP over the merged (data,
    # model) axis, the sequence split over model, no ffn sum.
    ax = ("experts_2d", None, None) if cfg.moe_layout == "ep2d" \
        else ("experts", None, "expert_mlp")
    ax_o = ("experts_2d", None, None) if cfg.moe_layout == "ep2d" \
        else ("experts", "expert_mlp", None)
    specs = {
        "router": Param((d, e), ("embed_no_fsdp", None), scale=0.02,
                        init="normal"),
        "wi_gate": Param((e, d, f), ax),
        "wi_up": Param((e, d, f), ax),
        "wo": Param((e, f, d), ax_o),
    }
    if mc.num_shared_experts:
        specs["shared"] = L.mlp_specs(d, mc.d_ff_expert
                                      * mc.num_shared_experts)
    if mc.dense_residual:
        specs["dense"] = L.mlp_specs(d, cfg.d_ff)
    return specs


def _route(cfg, router_w, x_flat):
    """(T, D) -> top-k expert ids (T,k), weights (T,k), probs (T,E)."""
    mc = cfg.moe
    logits = L.dense(x_flat.to(torch.float32), router_w.to(torch.float32))
    if mc.router == "sigmoid":           # deepseek-v3
        scores = torch.sigmoid(logits)
        w, ids = torch.topk(scores, mc.top_k, dim=-1)
        w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
        w = w * mc.routed_scaling
        probs = scores / torch.clamp(torch.sum(scores, -1, keepdim=True),
                                     min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = torch.topk(probs, mc.top_k, dim=-1)
    return ids, w, probs


def _aux_loss(cfg, probs, ids):
    """Load-balance loss (Switch-style): E * <f, p>.

    f (fraction of tokens to each expert) comes from the one-hot
    assignment through ``expert_counts``, which declares only the
    contraction and vpu engines: any other ``reduce_method`` spelling
    maps to the MMA row reduction instead of failing the forward pass."""
    from repro_torch.core import dispatch
    e = cfg.moe.num_experts
    onehot = F.one_hot(ids[:, 0], e).to(torch.float32)
    method = dispatch.resolve_method("expert_counts", onehot,
                                     cfg.reduce_method, fallback="mma")
    counts = ci.expert_counts(onehot, method=method)         # (E,)
    f = counts / torch.clamp(torch.sum(counts), min=1.0)
    p = torch.mean(probs, dim=0)
    return e * torch.sum(f * p)


def _slots(ids, e: int, cap: int):
    """The sort-based capacity dispatch of (T, k) expert ids: returns
    (order, slot, keep, counts, starts) — the stable sort of the flat
    ids, each sorted entry's buffer slot (``e * cap``, past the buffer,
    when its expert is full), whether it is kept, and the tokens per
    expert with their exclusive prefix."""
    flat_e = ids.reshape(-1)                       # (T*k,)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # the tokens per expert: a scatter of ones (exact), whose shape,
    # unlike bincount's, does not depend on the ids' values
    ones = torch.ones_like(flat_e, dtype=torch.int64)
    counts = torch.zeros(e, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, flat_e.long(), ones)
    # Per-expert buffer offsets = exclusive prefix of the counts, a
    # triangular ones-MMA scan under EXACT_OFFSETS (f32 multiplicands
    # pinned past TF32, exact below 2^24); the int path beyond.
    if n < 2**24:
        starts = torch.round(ci.cumsum(
            counts, inclusive=False, method="mma", chain=1,
            precision=EXACT_OFFSETS)).long()
    else:
        starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=ids.device) - starts[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, e * cap)
    return order, slot, keep, counts, starts


def _dispatch_combine(cfg, params, x_flat, ep_size: int = 1, ep_axis=None,
                      tp_axis=None, *, mesh=None):
    """The local shard body: returns (out_flat, aux_loss) of this rank's
    tokens.  ``ep_axis`` (a name or a tuple) carries the all-to-alls,
    ``tp_axis`` the ffn slices' sum; both None on one card."""
    mc = cfg.moe
    t, d = x_flat.shape
    e, k = mc.num_experts, mc.top_k
    cap = max(8, int(math.ceil(mc.capacity_factor * t * k / e)))
    dt = x_flat.dtype
    dev = x_flat.device

    ids, w, probs = _route(cfg, params["router"], x_flat)
    aux = _aux_loss(cfg, probs, ids)

    # ---- sort-based capacity dispatch -> (E*C, D) buffer and a spare row
    order, slot, keep, _, _ = _slots(ids, e, cap)
    token_of = order // k
    # Kept slots are distinct, so the reference's scatter-add is a copy
    # (out of place: autograd carries the tokens' gradients back).
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=dev) \
        .index_copy(0, slot, x_flat[token_of])[:e * cap].view(e, cap, d)

    # ---- EP all-to-all: experts go home, (E/ep, ep*C, D)
    if ep_axis is not None and ep_size > 1:
        buf = coll.all_to_all(buf, ep_axis, 0, 1, mesh=mesh)
    buf = RM.checkpoint_name(buf, "moe_post_a2a")
    if tp_axis is not None:
        # each ffn slice gives the tokens a part of their gradient
        buf = coll.copy_to(buf, tp_axis, mesh=mesh)

    # ---- expert FFN (over an ffn slice: partial, summed over tp_axis)
    gate = torch.bmm(buf, params["wi_gate"].to(dt))
    up = torch.bmm(buf, params["wi_up"].to(dt))
    act = F.silu(gate) * up if cfg.act == "silu" else \
        F.gelu(gate, approximate="tanh") * up
    out = torch.bmm(act, params["wo"].to(dt))
    if tp_axis is not None:
        out = coll.reduce_from(out, tp_axis, mesh=mesh)

    # ---- return tokens to their senders, (E, C, D)
    if ep_axis is not None and ep_size > 1:
        out = coll.all_to_all(out, ep_axis, 1, 0, mesh=mesh)
    out = RM.checkpoint_name(out, "moe_expert_out").reshape(e * cap, d)

    # ---- weighted combine back to token order, in a fixed order; a
    # dropped entry's weight is 0
    w_flat = w.reshape(-1)[order].to(dt) * keep.to(dt)
    contrib = out[torch.clamp(slot, max=e * cap - 1)] * w_flat[:, None]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(t * k, device=dev)
    contrib = contrib[inverse].view(t, k, d)            # token order
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y, aux


def _ep2d_body(cfg, d, ep_axes, mesh_shape, *, mesh, aux_fold):
    """Layout A body: the sequence split over 'model', EP over the
    merged ``ep_axes``, the full-width expert ffn (no sum).  The aux
    loss is the mean over 'model' of each slice's, then ``aux_fold``."""
    msz = mesh_shape.get("model", 1)
    ep_size = math.prod(mesh_shape.get(a, 1) for a in ep_axes)

    def body(router, wg, wu, wo, xl):
        p = {"router": coll.copy_to(router, "model", mesh=mesh),
             "wi_gate": wg, "wi_up": wu, "wo": wo}
        b, s, _ = xl.shape
        xs = coll.scatter_to(xl, "model", 1, mesh=mesh)
        y, aux = _dispatch_combine(cfg, p, xs.reshape(-1, d), ep_size,
                                   ep_axes, None, mesh=mesh)
        # restore the full sequence on every model peer
        y = coll.gather_from(y.reshape(b, s // msz, d), "model", 1,
                             mesh=mesh)
        aux = coll.reduce_from(aux, "model", mesh=mesh) / msz
        return y, aux_fold(aux)

    return body


def _etp_body(cfg, d, mesh_shape, *, mesh, aux_fold):
    """Layout B body: EP over 'data', the expert ffn over 'model'."""
    ep_axis = "data" if "data" in mesh_shape else None
    tp_axis = "model" if "model" in mesh_shape else None
    ep_size = mesh_shape.get("data", 1)

    def body(router, wg, wu, wo, xl):
        p = {"router": router, "wi_gate": wg, "wi_up": wu, "wo": wo}
        y, aux = _dispatch_combine(cfg, p, xl.reshape(-1, d), ep_size,
                                   ep_axis, tp_axis, mesh=mesh)
        return y.reshape(xl.shape), aux_fold(aux)

    return body


def use_ep2d(cfg, mesh_shape: dict, seq_len: int) -> bool:
    """The reference's layout test: ep2d needs ``moe_layout == "ep2d"``,
    the experts split over data x model and the sequence over model;
    else etp."""
    dm = mesh_shape.get("data", 1) * mesh_shape.get("model", 1)
    return (cfg.moe_layout == "ep2d"
            and cfg.moe.num_experts % dm == 0
            and seq_len % mesh_shape.get("model", 1) == 0)


def block_specs(cfg, mesh_shape: dict, seq_len: Optional[int] = None) -> dict:
    """The body's specs of the expert leaves (``wi_gate``, ``wi_up``,
    ``wo``) over a mesh of ``mesh_shape``: the reference's in_specs.
    ``seq_len`` None takes the layout the config asks for where the
    experts split.  Raises, naming the shapes, where etp's split does
    not divide: the experts over data, the ffn over model."""
    seq_len = mesh_shape.get("model", 1) if seq_len is None else seq_len
    if use_ep2d(cfg, mesh_shape, seq_len):
        w = shd.P(("data", "model"), None, None)
        return {"wi_gate": w, "wi_up": w, "wo": w}
    mc = cfg.moe
    data, model = mesh_shape.get("data", 1), mesh_shape.get("model", 1)
    if mc.num_experts % data or mc.d_ff_expert % model:
        raise ValueError(
            f"{cfg.name}'s experts (E {mc.num_experts}, ffn "
            f"{mc.d_ff_expert}) over the mesh {dict(mesh_shape)}: the etp "
            f"layout splits the experts over data ({data}) and the ffn over "
            f"model ({model}), which must divide them")
    w = shd.P("data", None, "model")
    return {"wi_gate": w, "wi_up": w, "wo": shd.P("data", "model", None)}


def _block_shape(shape, spec, mesh_shape) -> tuple:
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in shd.spec_axes((entry,)):
            out[dim] //= mesh_shape[a]
    return tuple(out)


def _moe_over_mesh(params, cfg, x, mesh, batch_axes, local: bool):
    """The shard body over ``mesh``: entry (a) on this rank's rows and
    blocks when ``local``, else entry (b) through ``shard_map``."""
    b, s, d = x.shape
    shape = dict(mesh.shape)
    specs = block_specs(cfg, shape, s)
    n_batch = math.prod(shape[a] for a in batch_axes)
    if local:
        # a rank's share of the mean over the batch ranks
        def aux_fold(aux):
            return aux / n_batch
    else:
        def aux_fold(aux):
            return coll.mesh_psum(aux, batch_axes, mesh=mesh) / n_batch
    if use_ep2d(cfg, shape, s):
        body = _ep2d_body(cfg, d, ("data", "model"), shape, mesh=mesh,
                          aux_fold=aux_fold)
    else:
        body = _etp_body(cfg, d, shape, mesh=mesh, aux_fold=aux_fold)
    args = (params["router"], params["wi_gate"], params["wi_up"],
            params["wo"])
    if local:
        for key, leaf in zip(("wi_gate", "wi_up", "wo"), args[1:]):
            want = _block_shape(
                (cfg.moe.num_experts,) + ((d, cfg.moe.d_ff_expert)
                                          if key != "wo" else
                                          (cfg.moe.d_ff_expert, d)),
                specs[key], shape)
            if tuple(leaf.shape) != want:
                raise ValueError(
                    f"moe_block on this rank's blocks over the mesh {shape}: "
                    f"{key} arrives as {tuple(leaf.shape)}, the body's spec "
                    f"{specs[key]} takes blocks of {want}")
        return body(*args, x)
    P = shd.P
    return compat.shard_map(
        body, mesh=mesh,
        in_specs=(P(), specs["wi_gate"], specs["wi_up"], specs["wo"],
                  P(batch_axes, None, None)),
        out_specs=(P(batch_axes, None, None), P()))(*args, x)


def moe_block(params, cfg, x):
    """x: (B, S, D). Returns (out, aux_loss scalar).

    Over a mesh of several ranks the expert-parallel body runs: inside
    ``sharding.local_step`` on this rank's rows and expert blocks (aux
    is this rank's share), else under an installed mesh on whole
    tensors (aux is the reference's pmean)."""
    from repro_torch.core.autotune import mesh_device_count
    fold = shd.batch_fold()
    mesh = shd.current_mesh()
    b, s, d = x.shape
    if fold is not None and mesh_device_count(fold[0]) > 1:
        want = shd.data_axis_names(fold[0])
        if tuple(fold[1]) != want:
            # every rank takes this branch on the same batch, so every
            # rank raises, before the body's first all-to-all
            n = b * math.prod(fold[0].shape[a] for a in fold[1])
            raise ValueError(
                f"moe_block over the mesh {dict(fold[0].shape)}: the "
                f"batch's {n} rows do not divide over the batch axes "
                f"{want}; the expert-parallel body takes each rank's own "
                f"rows (the reference's shard_map refuses the same batch)")
        out, aux = _moe_over_mesh(params, cfg, x, fold[0], tuple(fold[1]),
                                  local=True)
    elif mesh is not None and mesh_device_count(mesh) > 1:
        out, aux = _moe_over_mesh(params, cfg, x, mesh,
                                  shd.data_axis_names(mesh), local=False)
    else:
        y, aux = _dispatch_combine(cfg, params, x.reshape(-1, d))
        out = y.reshape(b, s, d)
    # shared experts (deepseek) / dense residual (arctic): plain MLPs,
    # outside the expert-parallel region.
    mc = cfg.moe
    if mc.num_shared_experts:
        out = out + L.mlp(params["shared"], x, act=cfg.act,
                          d_ff=mc.d_ff_expert * mc.num_shared_experts)
    if mc.dense_residual:
        out = out + L.mlp(params["dense"], x, act=cfg.act, d_ff=cfg.d_ff)
    return out, aux.to(torch.float32)
