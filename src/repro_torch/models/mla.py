"""Multi-head Latent Attention (DeepSeek-V2/V3) — the counterpart of
``repro.models.mla``.

Two execution forms, selected per phase:
  * prefill — "expanded": the compressed KV latent c_kv is up-projected
    to per-head K/V and attended through the ``attention`` op
    (``models.attention._registry_attn``; in bf16 at DeepSeek-V3's head
    dims 192 / 128 that is kernel B9's wgmma form);
  * decode — "absorbed": W_uk is folded into the query and W_uv into the
    output so attention runs directly against the cached latent
    (B, S, kv_lora + rope), as plain products.

Cache layout: {"ckv": (B, cap, kv_lora), "krope": (B, cap, rope), "idx"}.
As in ``models.attention``, the cache's tensors are written in place and
the returned dict holds them with ``idx`` advanced.  The absorbed form's
score and context products accumulate and return f32 as the reference's
``preferred_element_type=ACCUM_DTYPE`` einsums do, through
``core.reduction._bmm``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.reduction import _bmm
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.param import Param

NEG_INF = -2.0e38


def mla_specs(cfg):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": Param((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": Param((m.q_lora_rank,), ("q_lora",), "zeros"),
        "wq_b": Param((m.q_lora_rank, H, qk), ("q_lora", "heads", "head_dim")),
        "wkv_a": Param((d, m.kv_lora_rank + m.qk_rope_dim),
                       ("embed", "kv_lora")),
        "kv_norm": Param((m.kv_lora_rank,), ("kv_lora",), "zeros"),
        "wk_b": Param((m.kv_lora_rank, H, m.qk_nope_dim),
                      ("kv_lora", "heads", "head_dim")),
        "wv_b": Param((m.kv_lora_rank, H, m.v_head_dim),
                      ("kv_lora", "heads", "head_dim")),
        "wo": Param((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def make_cache(cfg, batch: int, capacity: int, *, dtype=torch.bfloat16,
               device=None):
    """An empty latent cache on ``device`` (default: the card, raising
    without one)."""
    from repro_torch.core.dispatch import default_device
    device = default_device(device)
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, capacity, m.qk_rope_dim), dtype=dtype,
                             device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_axes():
    return {"ckv": ("batch", None, "kv_lora"),
            "krope": ("batch", None, None), "idx": ()}


def _rms(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def _pos_b(positions, shape):
    """(B, S) positions from a shared (S,) or per-row (B, S) vector."""
    if positions.ndim == 2:
        return positions
    return positions[None, :].expand(shape)


def _heads(x, w, dt):
    """einsum('bsr,rhk->bshk', x, w.astype(dt))."""
    B, S, _ = x.shape
    return (x @ w.to(dt).reshape(w.shape[0], -1)).view(B, S, *w.shape[1:])


def _project_q(params, cfg, x, positions):
    m = cfg.mla
    H = cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    dt = x.dtype
    nm_method = getattr(cfg, "norm_matmul_method", "")
    if nm_method:
        # The query chain as ONE `norm_matmul` dispatch: q_norm and the
        # wq_b up-projection (kernel B10 under 'fused_pallas').
        qa = x @ params["wq_a"].to(dt)
        qa = constrain(qa, ("batch", None, "q_lora"))
        q = L.norm_matmul(
            {"scale": params["q_norm"]}, qa,
            params["wq_b"].reshape(m.q_lora_rank, H * qk).to(dt),
            method=nm_method,
            precision=getattr(cfg, "norm_matmul_precision", None),
            objective=getattr(cfg, "norm_matmul_slo_ms", None),
        ).reshape(*x.shape[:2], H, qk)
    else:
        ql = _rms(x @ params["wq_a"].to(dt), params["q_norm"])
        ql = constrain(ql, ("batch", None, "q_lora"))
        q = _heads(ql, params["wq_b"], dt)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    pos_b = _pos_b(positions, x.shape[:2])
    q_rope = L.apply_rope(q_rope, pos_b, theta=cfg.rope_theta)
    return q_nope, q_rope


def _latent_kv(params, cfg, x, positions):
    """c_kv (B,S,r) latent + shared rotary key (B,S,rope)."""
    m = cfg.mla
    dt = x.dtype
    kv = x @ params["wkv_a"].to(dt)
    ckv, kr = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    ckv = _rms(ckv, params["kv_norm"])
    pos_b = _pos_b(positions, x.shape[:2])
    kr = L.apply_rope(kr[:, :, None, :], pos_b, theta=cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _write_cache(cache, ckv_new, kr_new, *, per_row, positions):
    """Write this step's latents into the cache in place, as the
    reference's functional update writes them; returns the cache with
    ``idx`` advanced."""
    ckv, krope = cache["ckv"], cache["krope"]
    B, Sq = ckv_new.shape[:2]
    cap = ckv.shape[1]
    idx = torch.as_tensor(cache["idx"], device=ckv.device)
    ckv_new, kr_new = ckv_new.to(ckv.dtype), kr_new.to(krope.dtype)
    if per_row:
        # Continuous batching: each slot writes its own absolute
        # position; a position past the cache writes nothing (the
        # reference's one-hot hits no slot).
        pos_now = positions[:, 0]
        rows = torch.arange(B, device=ckv.device)
        slot = torch.clamp(pos_now, max=cap - 1).long()
        hit = (pos_now < cap)[:, None]
        ckv[rows, slot] = torch.where(hit, ckv_new[:, 0], ckv[rows, slot])
        krope[rows, slot] = torch.where(hit, kr_new[:, 0],
                                        krope[rows, slot])
    else:
        # dynamic_update_slice clamps the start so the update fits.
        start = torch.clamp(idx, min=0, max=cap - Sq).long()
        slots = start + torch.arange(Sq, device=ckv.device)
        ckv.index_copy_(1, slots, ckv_new)
        krope.index_copy_(1, slots, kr_new)
    return dict(cache, ckv=ckv, krope=krope, idx=idx + Sq)


def _absorbed(params, q_nope, q_rope, cache, positions, *, per_row,
              scale):
    """Decode against the latent cache: (B, Sq, H, v_head_dim) in dt."""
    dt = q_nope.dtype
    B, Sq, H, _ = q_nope.shape
    ckv, kr = cache["ckv"].to(dt), cache["krope"].to(dt)
    C, r = ckv.shape[1], ckv.shape[2]
    kv_len = cache["idx"]                 # already includes this step
    # q_eff[h] = q_nope[h] @ W_uk[h]^T : (B,Sq,H,r)
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_b"].to(dt))

    def rows(t):                          # (B,Sq,H,n) -> (B, H*Sq, n)
        return t.permute(0, 2, 1, 3).reshape(B, H * Sq, t.shape[-1])

    s = _bmm(rows(q_eff), ckv.transpose(1, 2)) \
        + _bmm(rows(q_rope), kr.transpose(1, 2))
    s = s.view(B, H, Sq, C) * scale
    kpos = torch.arange(C, device=s.device)
    if per_row:
        # Slot c of a (non-ring) latent cache holds position c, so
        # per-row causality kpos <= pos is the exact validity mask.
        valid = (kpos[None, None, :] <= positions[:, :, None])[:, None]
    else:
        valid = ((kpos[None, :] <= positions[:, None])
                 & (kpos < kv_len)[None])[None, None]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dt)
    ctx = _bmm(p.reshape(B, H * Sq, C), ckv).to(dt)
    ctx = ctx.view(B, H, Sq, r).transpose(1, 2)          # (B, Sq, H, r)
    return torch.einsum("bshr,rhk->bshk", ctx, params["wv_b"].to(dt))


def mla_attention(params, cfg, x, *, positions, cache=None,
                  decode: bool = False):
    """Returns (out, new_cache); a cache is updated in place."""
    m = cfg.mla
    dt = x.dtype
    B, Sq, _ = x.shape
    H = cfg.num_heads
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    positions = torch.as_tensor(positions, device=x.device)

    per_row = positions.ndim == 2
    if per_row and not decode and Sq != 1:
        raise ValueError(
            "per-row (B, Sq) positions require decode with Sq == 1 "
            "(per-slot prefill is admitted one request at a time)")

    q_nope, q_rope = _project_q(params, cfg, x, positions)
    ckv_new, kr_new = _latent_kv(params, cfg, x, positions)

    new_cache = cache
    if cache is not None:
        new_cache = _write_cache(cache, ckv_new, kr_new, per_row=per_row,
                                 positions=positions)

    if decode:
        o = _absorbed(params, q_nope, q_rope, new_cache, positions,
                      per_row=per_row, scale=scale)
    else:
        # Expanded form: per-head K/V from the latent, through the
        # attention op.
        from repro_torch.models.attention import _registry_attn
        k_nope = _heads(ckv_new, params["wk_b"], dt)
        v = _heads(ckv_new, params["wv_b"], dt)
        k = torch.cat(
            [k_nope, kr_new[:, :, None, :].expand(B, Sq, H, m.qk_rope_dim)],
            dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        q = constrain(q, ("batch", None, "heads", "head_dim"))
        k = constrain(k, ("batch", None, "heads", "head_dim"))
        qg = q.reshape(B, Sq, H, 1, -1)
        # MLA never softcaps its expanded-form logits, so pin cap=None
        # rather than inheriting cfg.attn_softcap.
        o = _registry_attn(cfg, qg, k, v, qpos=positions, causal=True,
                           window=None, kv_len=None, scale=scale,
                           decode=False, cap=None)
        o = o.reshape(B, Sq, H, m.v_head_dim)

    wo = params["wo"].reshape(H * m.v_head_dim, -1).to(dt)
    out = o.reshape(B, Sq, H * m.v_head_dim).to(dt) @ wo
    return constrain(out, ("batch", None, None)), new_cache
