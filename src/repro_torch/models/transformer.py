"""Model composition: layer descriptors -> stacks -> full LMs — the
counterpart of ``repro.models.transformer``.

Every architecture is a sequence of *stacks*; a stack is a layer group
(e.g. Gemma-3's [local x5, global]) repeated R times over parameters and
caches that carry a leading repeats axis.  The reference runs a stack
with ``lax.scan``; here it is a loop over that axis.  Layer r reads the
views ``leaf[r]`` of the stacked parameters and caches, so the attention
caches, which ``models.attention`` and ``models.mla`` write in place,
are written in layer r's own slice; every other leaf of the new cache
(each layer's own ``idx``, recurrent states, cross-attention keys) is
stacked from the layers' outputs, as the reference's scan stacks them.

Layer kinds: global / local (self-attn), cross (gated cross-attn,
vision), selfcross (self+cross, enc-dec decoder), rwkv, rglru.
MLP kinds: dense / moe / chanmix.

``cfg.remat`` chooses what a backward pass recomputes: each layer group
of a stack runs under ``models.remat.run`` (``torch.utils.checkpoint``
with the reference's policies), and the mixer and MLP outputs carry the
reference's ``checkpoint_name`` tags.  Caches are written in place, so a
pass with caches (prefill, decode) is never recomputed.

Inside a train step over a mesh whose rules split the vocabulary over
``model`` the logits are this rank's block of the vocabulary
(``layers.unembed``) and the cross-entropy is vocabulary-parallel: its
f32 logsumexp shifts by the max over the ranks (``collectives.mesh_max``,
no gradient), sums the block's exponentials on the port's reduction path
and the ranks' sums through ``layers.reduce_out``, and the label's logit
comes from the rank that holds it; no tensor has the whole vocabulary.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import integration as ci
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import remat as RM
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.param import Param, _map, stack_specs


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    kind: str          # global | local | cross | selfcross | rwkv | rglru
    mlp: str           # dense | moe | chanmix


@dataclasses.dataclass(frozen=True)
class StackPlan:
    descs: tuple[LayerDesc, ...]
    repeats: int
    start: int         # absolute index of first layer (debug/logging)


def layer_descs(cfg) -> tuple[LayerDesc, ...]:
    out = []
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "rwkv":
            mlp = "chanmix"
        elif cfg.moe is not None and i >= cfg.moe.first_dense_layers:
            mlp = "moe"
        else:
            mlp = "dense"
        out.append(LayerDesc(kind, mlp))
    return tuple(out)


def plan_stacks(cfg) -> tuple[StackPlan, ...]:
    """Segment depth into maximal repeated groups (+ tails)."""
    descs = layer_descs(cfg)
    n = len(descs)
    if not cfg.scan_layers:   # fully unrolled: one plan a layer
        return tuple(StackPlan((d,), 1, i) for i, d in enumerate(descs))
    p = len(cfg.pattern)
    # segment boundaries where the mlp-kind regime changes (deepseek's
    # first-dense-layers prefix)
    bounds = [0] + [i for i in range(1, n)
                    if descs[i].mlp != descs[i - 1].mlp] + [n]
    plans = []
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        seg = descs[s0:s1]
        g = len(seg) // p
        if g > 0:
            plans.append(StackPlan(tuple(seg[:p]), g, s0))
        tail = seg[g * p:]
        if tail:
            plans.append(StackPlan(tuple(tail), 1, s0 + g * p))
    return tuple(plans)


# ------------------------------------------------------------- blocks


def block_specs(cfg, desc: LayerDesc):
    d = cfg.d_model
    nt = cfg.norm_type
    s = {"pre_norm": L.norm_specs(d, nt)}
    if desc.kind in ("global", "local"):
        s["attn"] = MLA.mla_specs(cfg) if cfg.mla else A.attn_specs(cfg)
    elif desc.kind == "cross":
        s["attn"] = A.attn_specs(cfg, kv_input_dim=d)
        s["gate_attn"] = Param((1,), (None,), "zeros")
        s["gate_mlp"] = Param((1,), (None,), "zeros")
    elif desc.kind == "selfcross":
        s["attn"] = A.attn_specs(cfg)
        s["cross_norm"] = L.norm_specs(d, nt)
        s["cross"] = A.attn_specs(cfg, kv_input_dim=d)
    elif desc.kind == "rwkv":
        s["attn"] = RW.timemix_specs(cfg)
    elif desc.kind == "rglru":
        s["attn"] = RG.rglru_specs(cfg)
    else:
        raise ValueError(desc.kind)
    if cfg.norm_style == "sandwich":
        s["post_attn_norm"] = L.norm_specs(d, nt)
        s["pre_mlp_norm"] = L.norm_specs(d, nt)
        s["post_mlp_norm"] = L.norm_specs(d, nt)
    else:
        s["mlp_norm"] = L.norm_specs(d, nt)
    if desc.mlp == "dense":
        s["mlp"] = L.mlp_specs(d, cfg.d_ff)
    elif desc.mlp == "moe":
        s["mlp"] = MOE.moe_specs(cfg)
    elif desc.mlp == "chanmix":
        s["mlp"] = RW.chanmix_specs(cfg)
    return s


def _cross_cache(cfg, batch, memory_len, dtype, device):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, memory_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, memory_len, kv, hd), dtype=dtype,
                             device=device)}


def init_block_cache(cfg, desc: LayerDesc, batch: int, capacity: int,
                     memory_len: int = 0, dtype=torch.bfloat16,
                     device=None):
    """Decode-state for one layer on ``device`` (default: the card)."""
    from repro_torch.core.dispatch import default_device
    device = default_device(device)
    if desc.kind in ("global", "local"):
        if cfg.mla:
            return MLA.make_cache(cfg, batch, capacity, dtype=dtype,
                                  device=device)
        if desc.kind == "local":
            capacity = min(capacity, cfg.window)  # ring buffer == window
        return A.make_cache(cfg, batch, capacity, dtype=dtype,
                            device=device)
    if desc.kind == "cross":
        return _cross_cache(cfg, batch, memory_len, dtype, device)
    if desc.kind == "selfcross":
        return {"self": A.make_cache(cfg, batch, capacity, dtype=dtype,
                                     device=device),
                "cross": _cross_cache(cfg, batch, memory_len, dtype,
                                      device)}
    if desc.kind == "rwkv":
        return RW.make_state(cfg, batch, dtype=dtype, device=device)
    if desc.kind == "rglru":
        return RG.make_state(cfg, batch, dtype=dtype, device=device)
    raise ValueError(desc.kind)


def _norm(p, x, cfg):
    return L.apply_norm(p, x, kind=cfg.norm_type,
                        method=cfg.reduce_method,
                        fast_apply=getattr(cfg, "fast_norm", False))


def block_apply(params, cfg, desc: LayerDesc, x, cache, *, positions,
                memory=None, decode=False, causal=True):
    """Returns (x, new_cache, aux_loss)."""
    sandwich = cfg.norm_style == "sandwich"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(params["pre_norm"], x, cfg)
    new_cache = cache

    if desc.kind in ("global", "local"):
        if cfg.mla:
            out, new_cache = MLA.mla_attention(
                params["attn"], cfg, h, positions=positions, cache=cache,
                decode=decode)
        else:
            out, new_cache = A.attention(
                params["attn"], cfg, h, positions=positions,
                kind=desc.kind, cache=cache, decode=decode, causal=causal)
    elif desc.kind == "cross":
        out, new_cache = A.attention(
            params["attn"], cfg, h, positions=positions, kind="cross",
            cache=cache, memory=memory, decode=decode)
        out = out * torch.tanh(params["gate_attn"].to(out.dtype))
    elif desc.kind == "selfcross":
        out, self_c = A.attention(
            params["attn"], cfg, h, positions=positions, kind="global",
            cache=None if cache is None else cache["self"], decode=decode)
        x = x + (_norm(params["post_attn_norm"], out, cfg)
                 if sandwich else out)
        h = _norm(params["cross_norm"], x, cfg)
        out, cross_c = A.attention(
            params["cross"], cfg, h, positions=positions, kind="cross",
            cache=None if cache is None else cache["cross"],
            memory=memory, decode=decode)
        if cache is not None:
            new_cache = {"self": self_c, "cross": cross_c}
    elif desc.kind == "rwkv":
        state = cache if cache is not None else RW.make_state(
            cfg, x.shape[0], device=x.device)
        out, new_state = RW.time_mix(params["attn"], cfg, h, state)
        new_cache = new_state if cache is not None else None
    elif desc.kind == "rglru":
        state = cache if cache is not None else RG.make_state(
            cfg, x.shape[0], device=x.device)
        out, new_state = RG.rglru_apply(params["attn"], cfg, h, state)
        new_cache = new_state if cache is not None else None
    else:
        raise ValueError(desc.kind)

    if desc.kind != "selfcross":
        if sandwich:
            out = _norm(params["post_attn_norm"], out, cfg)
        # named so that remat="dots_tagged" saves it
        out = RM.checkpoint_name(out, "mixer_out")
        x = x + out

    norm_key = "pre_mlp_norm" if sandwich else "mlp_norm"
    nm_method = getattr(cfg, "norm_matmul_method", "")
    if (desc.mlp == "dense" and nm_method
            and cfg.norm_type == "rmsnorm"):
        # Fused norm->matmul boundary: one `norm_matmul` dispatch
        # replaces rmsnorm + the up/gate projections (kernel B10 under
        # 'fused_pallas').
        out = L.fused_mlp(
            params[norm_key], params["mlp"], x, act=cfg.act,
            method=nm_method,
            precision=getattr(cfg, "norm_matmul_precision", None),
            objective=getattr(cfg, "norm_matmul_slo_ms", None),
            bf16_out=getattr(cfg, "bf16_activation_ar", False),
            d_ff=cfg.d_ff)
    elif desc.mlp == "dense":
        h = _norm(params[norm_key], x, cfg)
        out = L.mlp(params["mlp"], h, act=cfg.act,
                    bf16_out=getattr(cfg, "bf16_activation_ar", False),
                    d_ff=cfg.d_ff)
    else:
        h = _norm(params[norm_key], x, cfg)
    if desc.mlp == "moe":
        out, aux = MOE.moe_block(params["mlp"], cfg, h)
    elif desc.mlp == "chanmix":
        state = new_cache if new_cache is not None else RW.make_state(
            cfg, x.shape[0], device=x.device)
        out, state = RW.channel_mix(params["mlp"], cfg, h, state)
        if new_cache is not None:
            new_cache = state
    if desc.kind == "cross":
        out = out * torch.tanh(params["gate_mlp"].to(out.dtype))
    if sandwich:
        out = _norm(params["post_mlp_norm"], out, cfg)
    out = RM.checkpoint_name(out, "mlp_out")
    return x + out, new_cache, aux


# ------------------------------------------------------------- stacks


def stack_param_specs(cfg, plan: StackPlan):
    group = {f"L{i}": block_specs(cfg, d) for i, d in enumerate(plan.descs)}
    return stack_specs(group, plan.repeats)


def init_stack_cache(cfg, plan: StackPlan, batch, capacity, memory_len,
                     dtype=torch.bfloat16, device=None):
    group = {f"L{i}": init_block_cache(cfg, d, batch, capacity, memory_len,
                                       dtype, device)
             for i, d in enumerate(plan.descs)}
    return _map(lambda leaf: leaf[None].expand(
        (plan.repeats,) + tuple(leaf.shape)).clone(), group)


def _restack(stacked, views: list, news: list):
    """The stack's new cache from each layer's view and new cache: a
    leaf every layer wrote in place (its new tensor is its view) keeps
    the stacked tensor; any other is stacked from the layers' new
    tensors."""
    if isinstance(stacked, dict):
        return {k: _restack(stacked[k], [v[k] for v in views],
                            [n[k] for n in news]) for k in stacked}
    if all(n is v for n, v in zip(news, views)):
        return stacked
    return torch.stack(news)


def run_stack(params, cfg, plan: StackPlan, x, cache, aux, *, positions,
              memory=None, decode=False, causal=True):
    """Run the stack's groups in order. Returns (x, new_cache, aux).
    Without caches each group runs under ``cfg.remat``."""
    if cache is None:
        def group(x, aux, gp):
            for i, desc in enumerate(plan.descs):
                x, _, a = block_apply(
                    gp[f"L{i}"], cfg, desc, x, None, positions=positions,
                    memory=memory, decode=decode, causal=causal)
                aux = aux + a
            return x, aux
        for r in range(plan.repeats):
            x, aux = RM.run(cfg.remat, group, x, aux,
                            _map(lambda leaf: leaf[r], params))
        return x, None, aux
    views, news = [], []
    for r in range(plan.repeats):
        gp = _map(lambda leaf: leaf[r], params)
        gc = _map(lambda leaf: leaf[r], cache)
        new_gc = {}
        for i, desc in enumerate(plan.descs):
            x, new_gc[f"L{i}"], a = block_apply(
                gp[f"L{i}"], cfg, desc, x, gc[f"L{i}"], positions=positions,
                memory=memory, decode=decode, causal=causal)
            aux = aux + a
        views.append(gc)
        news.append(new_gc)
    return x, _restack(cache, views, news), aux


# ------------------------------------------------------------- full LM


def backbone_specs(cfg):
    return {
        "stacks": {f"S{i}": stack_param_specs(cfg, p)
                   for i, p in enumerate(plan_stacks(cfg))},
        "final_norm": L.norm_specs(cfg.d_model, cfg.norm_type),
    }


def decoder_specs(cfg):
    specs = {"embed": L.embed_specs(cfg.vocab_size, cfg.d_model),
             **backbone_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = Param((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"))
    if cfg.mtp:
        specs["mtp"] = {
            "proj": Param((2 * cfg.d_model, cfg.d_model),
                          ("embed", None)),
            "block": block_specs(cfg, LayerDesc("global", "dense")),
            "norm": L.norm_specs(cfg.d_model, cfg.norm_type),
        }
    return specs


def decoder_forward(params, cfg, tokens, *, positions=None, caches=None,
                    memory=None, decode=False, causal=True,
                    inputs_embeds=None):
    """tokens (B,S) -> (hidden (B,S,D), new_caches, aux)."""
    if inputs_embeds is not None:
        x = inputs_embeds.to(cfg.compute_dtype)
    else:
        x = L.embed_lookup(
            params["embed"], tokens, scale=cfg.embed_scale,
            d=cfg.d_model, compute_dtype=cfg.compute_dtype,
            cast_table=getattr(cfg, "bf16_activation_ar", False),
            onehot=getattr(cfg, "onehot_embed", False),
            vocab=cfg.vocab_size)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {} if caches is not None else None
    for i, plan in enumerate(plan_stacks(cfg)):
        key = f"S{i}"
        c = None if caches is None else caches[key]
        x, nc, aux = run_stack(params["stacks"][key], cfg, plan, x, c, aux,
                               positions=positions, memory=memory,
                               decode=decode, causal=causal)
        if new_caches is not None:
            new_caches[key] = nc
    x = _norm(params["final_norm"], x, cfg)
    return x, new_caches, aux


def logits_from_hidden(params, cfg, x):
    """The vocabulary logits of ``x`` (this rank's block of them in a
    train step's tensor-parallel body)."""
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, softcap=cfg.final_softcap,
                         vocab=cfg.vocab_size)
    share = shd.model_share(params["lm_head"].shape[-1], cfg.vocab_size)
    logits = L.column(x, params["lm_head"].to(x.dtype), share)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.final_softcap)
    return logits


def _map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, tree[k], path + (k,)) for k in tree}
    return fn(path, tree)


def init_decoder_cache(cfg, batch: int, capacity: int, memory_len: int = 0,
                       dtype=torch.bfloat16, start_index: int = 0,
                       device=None):
    """Every stack's caches on ``device`` (default: the card; ``"meta"``
    gives shapes and dtypes without allocating), each layer's ``idx`` at
    ``start_index``."""
    caches = {f"S{i}": init_stack_cache(cfg, plan, batch, capacity,
                                        memory_len, dtype, device)
              for i, plan in enumerate(plan_stacks(cfg))}
    return _map_path(lambda path, leaf: torch.full_like(leaf, start_index)
                     if path[-1] == "idx" else leaf, caches)


_CACHE_LEAF_AXES = {
    "k": ("batch", None, "kv_heads", "head_dim"),
    "v": ("batch", None, "kv_heads", "head_dim"),
    "ckv": ("batch", None, "kv_lora"),
    "krope": ("batch", None, None),
    "idx": (),
    "wkv": ("batch", "heads", None, None),
    "x_tm": ("batch", None),
    "x_cm": ("batch", None),
    "h": ("batch", "lru"),
    "conv": ("batch", None, "lru"),
}


def cache_logical_axes(caches):
    """Logical-axes tree matching a cache tree (keyed on leaf name; a
    leading 'layers' axis is added for stacked leaves)."""
    def one(path, leaf):
        base = _CACHE_LEAF_AXES[path[-1]]
        return ("layers",) * (len(leaf.shape) - len(base)) + base
    return _map_path(one, caches)


# ------------------------------------------------------------- losses


def token_mean(values, mask, *, method="mma"):
    """The mean of ``values`` where ``mask`` is 1: ``integration.
    masked_mean``.  Inside a step on this rank's rows of a batch split
    over ranks (``sharding.local_step``) a rank's mean over its own rows
    is not the global mean once the ranks' token counts differ: its
    share is its masked sum over the count of every rank's rows
    (``tc_psum`` over the batch axes, one f32 scalar), so the ranks'
    shares, and their gradients, add up to the global mean's."""
    fold = shd.batch_fold()
    if fold is None:
        return ci.masked_mean(values, mask, method=method)
    from repro_torch.distributed.tc_collectives import psum_scalar
    mesh, axes = fold
    mask = torch.as_tensor(mask, dtype=values.dtype, device=values.device)
    part = ci.reduce_sum(values * mask, method=method)
    with torch.no_grad():
        count = psum_scalar(ci.reduce_sum(mask, method=method), axes,
                            mesh=mesh, method=method)
    return part / torch.clamp(count, min=1.0)


def _row_sums(x, method):
    """Each row's sum of ``x`` (..., n) -> (...) f32 on the port's
    reduction path (``integration.reduce_sum`` over the last axis; an
    engine that cannot serve a per-row sum falls back to ``vpu``, as
    ``layers.rmsnorm``'s statistic does)."""
    from repro_torch.core import dispatch
    method = dispatch.resolve_method("reduce_sum", x, method,
                                     fallback="vpu", axis=(x.ndim - 1,))
    return ci.reduce_sum(x, axis=-1, method=method)


def _label_logit(lf, labels, share):
    """Each row's logit of its label, from the rank whose block of the
    vocabulary holds it (0 on the others), summed over the ranks."""
    local = labels.long() - share.start(lf.shape[-1])
    inside = (local >= 0) & (local < lf.shape[-1])
    got = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
    return L.reduce_out(torch.where(inside, got[..., 0], 0.0), share)


def _lse_over(m, s, share):
    """The logsumexp over the ranks' blocks from each block's shift ``m``
    and sum ``s`` of exp(logit - m): shifted by the max over the ranks
    (no gradient), the sums added with one."""
    top = coll.mesh_max(m, share.axis, mesh=share.mesh)
    total = L.reduce_out(s * torch.exp(m - top), share)
    return top + torch.log(total)


def cross_entropy(logits, labels, mask, *, reduce_method="mma",
                  vocab=None):
    """Token CE with f32 logsumexp; reduction via the MMA engine.
    ``vocab``, the whole vocabulary, tells a train step's
    vocabulary-parallel body that ``logits`` are this rank's block."""
    lf = logits.to(torch.float32)
    share = shd.model_share(lf.shape[-1], vocab)
    if share is None:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    else:
        m = torch.amax(lf, dim=-1).detach()
        s = _row_sums(torch.exp(lf - m[..., None]), reduce_method)
        lse = _lse_over(m, s, share)
        ll = _label_logit(lf, labels, share)
    return token_mean(lse - ll, mask, method=reduce_method)


def chunked_cross_entropy(params, cfg, hidden, labels, mask,
                          *, chunk: int):
    """CE without materialising (B, S, V) logits: a loop over vocab
    chunks with an online logsumexp (the flash-attention trick applied
    to the loss), each chunk's logits recomputed in the backward pass
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    its scan body).  The last chunk is the ragged rest of the
    vocabulary, where the reference zero-pads the table and masks.  In a
    train step's vocabulary-parallel body the loop walks this rank's
    block of the table, and the blocks' running sums are combined over
    the ranks as ``cross_entropy`` combines them."""
    if cfg.tie_embeddings:
        w = params["embed"]["table"]          # (V, D)
    else:
        w = params["lm_head"].T               # (V, D)
    v = w.shape[0]
    share = shd.model_share(v, cfg.vocab_size)
    x = hidden.to(cfg.compute_dtype)
    v0 = 0 if share is None else share.start(v)
    cap = cfg.final_softcap
    labels = labels.long()
    b, s = labels.shape
    dev = x.device
    m_run = torch.full((b, s), -2.0e38, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, s), dtype=torch.float32, device=dev)
    ll = torch.zeros((b, s), dtype=torch.float32, device=dev)
    def body(m_run, l_run, ll, wc, start):
        logits = (x @ wc.T.to(x.dtype) if share is None
                  else L.column(x, wc.T.to(x.dtype), share)
                  ).to(torch.float32)
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        vocab_ids = start + torch.arange(wc.shape[0], device=dev)
        m_new = torch.maximum(m_run, torch.amax(logits, dim=-1))
        l_run = l_run * torch.exp(m_run - m_new) \
            + torch.sum(torch.exp(logits - m_new[..., None]), dim=-1)
        hit = vocab_ids[None, None, :] == labels[..., None]
        ll = ll + torch.sum(torch.where(hit, logits, 0.0), dim=-1)
        return m_new, l_run, ll

    for start in range(0, v, chunk):
        m_run, l_run, ll = RM.run("full", body, m_run, l_run, ll,
                                  w[start:start + chunk], v0 + start)
    if share is None:
        lse = m_run + torch.log(torch.clamp(l_run, min=1e-37))
    else:
        lse = _lse_over(m_run, l_run, share)
        ll = L.reduce_out(ll, share)
    return token_mean(lse - ll, mask, method=cfg.reduce_method)
