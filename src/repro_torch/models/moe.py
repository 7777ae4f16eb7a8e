"""Mixture-of-Experts, the one-card part — the counterpart of
``repro.models.moe``.

Sort-based capacity dispatch into an (E, C, D) buffer, the expert FFN as
batched matmuls, and a weighted combine back to token order.  Routing
statistics (tokens per expert for the load-balance loss) use the paper's
ones-MMA encoding (``integration.expert_counts``), and the dispatch's
per-expert buffer offsets are an exclusive prefix scan over the counts
run as a triangular MMA (``integration.cumsum`` under
``EXACT_OFFSETS``).

The reference's mesh branch (expert parallelism over a ``shard_map``
with all-to-alls) waits for ROADMAP item 14b(ii): with a mesh present
``moe_block`` raises.  The dispatch buffer and the experts' output carry
the reference's ``checkpoint_name`` tags (``models.remat``), which
``remat='dots_tagged'`` saves.

Three scatters of the reference change form:
  * the counts are ``torch.bincount`` (exact);
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

import torch
import torch.nn.functional as F

from repro_torch.core import integration as ci
from repro_torch.core.precision import EXACT_OFFSETS
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import remat as RM
from repro_torch.models.param import Param


def moe_specs(cfg):
    d, mc = cfg.d_model, cfg.moe
    e, f = mc.num_experts, mc.d_ff_expert
    # layout B "etp": EP over data, expert-ffn TP over model; layout A
    # "ep2d": EP over the merged (data, model) axis.  The axes name the
    # layout for the mesh; one card holds every expert either way.
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
    counts = torch.bincount(flat_e, minlength=e)
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


def _dispatch_combine(cfg, params, x_flat):
    """One card's body: returns (out_flat, aux_loss)."""
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
        .index_copy(0, slot, x_flat[token_of])
    buf = RM.checkpoint_name(buf[:e * cap].view(e, cap, d), "moe_post_a2a")

    # ---- expert FFN
    gate = torch.bmm(buf, params["wi_gate"].to(dt))
    up = torch.bmm(buf, params["wi_up"].to(dt))
    act = F.silu(gate) * up if cfg.act == "silu" else \
        F.gelu(gate, approximate="tanh") * up
    out = RM.checkpoint_name(torch.bmm(act, params["wo"].to(dt)),
                             "moe_expert_out").reshape(e * cap, d)

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


def moe_block(params, cfg, x):
    """x: (B, S, D). Returns (out, aux_loss scalar)."""
    if shd.current_mesh() is not None:
        raise NotImplementedError(
            "moe_block over a mesh (expert parallelism) is ROADMAP item "
            "14b(ii) (distributed: the model over a mesh)")
    b, s, d = x.shape
    y, aux = _dispatch_combine(cfg, params, x.reshape(-1, d))
    out = y.reshape(b, s, d)
    # shared experts (deepseek) / dense residual (arctic): plain MLPs.
    if cfg.moe.num_shared_experts:
        out = out + L.mlp(params["shared"], x, act=cfg.act)
    if cfg.moe.dense_residual:
        out = out + L.mlp(params["dense"], x, act=cfg.act)
    return out, aux.to(torch.float32)
