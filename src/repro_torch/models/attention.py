"""Attention: GQA/MHA with RoPE, QK-norm, soft-capping, sliding-window
(local) masking, cross-attention, KV caches, and a KV-chunked
online-softmax (flash-style) path for long sequences — the counterpart
of ``repro.models.attention``.

Layouts are the reference's: q (B, S, H, hd); k/v (B, S, KV, hd); grouped
queries qg (B, S, KV, G, hd).  Caches are fixed-capacity ring buffers
written at position ``idx`` (decode writes one step).  Unlike the
reference's functional update, a cache's tensors are written in place (a
32k-slot cache of Gemma-2 2B at 128 slots is 8.6 GB a tensor): the
returned cache dict holds the same tensors with ``idx`` advanced.

The f32-accumulator pin.  The reference's ``jnp.einsum(...,
preferred_element_type=ACCUM_DTYPE)`` returns f32 for bf16 operands;
``torch.einsum`` on bf16 returns bf16, which would round the scores.
Both products here (q.k and p.v) therefore go through ``_qk`` / ``_pv``,
one ``core.reduction._bmm`` per KV head: ``torch.bmm(...,
out_dtype=float32)`` for 16-bit operands on CUDA, f32 operands otherwise
(a bf16 cache beside f32 queries is widened one head at a time).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.core.reduction import _bmm
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.param import Param

NEG_INF = -2.0e38


def attn_specs(cfg, *, kv_input_dim: Optional[int] = None):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_in = kv_input_dim or d
    specs = {
        "wq": Param((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": Param((kv_in, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Param((kv_in, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Param((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = Param((H, hd), ("heads", "head_dim"), "zeros")
        specs["bk"] = Param((KV, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = Param((KV, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.use_qk_norm:
        specs["q_norm"] = Param((hd,), ("head_dim",), "zeros")
        specs["k_norm"] = Param((hd,), ("head_dim",), "zeros")
    return specs


def _head_rmsnorm(x, scale, eps=1e-6):
    xf = x.to(ACCUM_DTYPE)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * (1.0 + scale.to(ACCUM_DTYPE))
    return y.to(x.dtype)


def make_cache(cfg, batch: int, capacity: int, *, kv_input_dim=None,
               dtype=torch.bfloat16, device=None):
    """An empty cache on ``device`` (default: the card, raising without
    one)."""
    from repro_torch.core.dispatch import default_device
    device = default_device(device)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, capacity, KV, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, KV, hd), dtype=dtype,
                         device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_axes():
    return {"k": ("batch", None, "kv_heads", "head_dim"),
            "v": ("batch", None, "kv_heads", "head_dim"),
            "idx": ()}


def _mask(qpos, kpos, *, causal: bool, window: Optional[int],
          kv_len=None):
    """(..., Sq, C) boolean validity mask from position vectors.

    ``qpos`` (Sq,) yields a batch-shared (Sq, C) mask; (B, Sq) yields
    a per-row (B, Sq, C) mask — the continuous-batching decode case,
    where every slot sits at its own absolute position.  ``kv_len``
    may likewise be a scalar or (B,) per-row valid-slot count.
    """
    q = torch.as_tensor(qpos, device=kpos.device)[..., :, None]
    m = torch.ones(q.shape[:-1] + kpos.shape, dtype=torch.bool,
                   device=kpos.device)
    if causal:
        m = m & (kpos <= q)
    if window is not None:
        m = m & (kpos > q - window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=kpos.device)
        m = m & (kpos < (kl[:, None, None] if kl.ndim else kl))
    return m


def _expand_mask(m):
    """Broadcast a ``_mask`` result over the (KV, G) score dims:
    (Sq, C) -> (1,1,1,Sq,C); (B, Sq, C) -> (B,1,1,Sq,C)."""
    return m[:, None, None] if m.ndim == 3 else m[None, None, None]


def _qk(qg, k):
    """einsum('bqkgh,bckh->bkgqc') accumulated and returned in f32:
    qg (B, Sq, KV, G, hd), k (B, Sk, KV, hd) -> (B, KV, G, Sq, Sk)."""
    B, Sq, KV, G, hd = qg.shape
    heads = [_bmm(qg[:, :, h].transpose(1, 2).reshape(B, G * Sq, hd),
                  k[:, :, h].transpose(1, 2)) for h in range(KV)]
    return torch.stack(heads, 1).view(B, KV, G, Sq, -1)


def _pv(p, v):
    """einsum('bkgqc,bckh->bkgqh') accumulated and returned in f32:
    p (B, KV, G, Sq, Sk), v (B, Sk, KV, hd_v) -> (B, KV, G, Sq, hd_v)."""
    B, KV, G, Sq, Sk = p.shape
    heads = [_bmm(p[:, h].reshape(B, G * Sq, Sk), v[:, :, h])
             for h in range(KV)]
    return torch.stack(heads, 1).view(B, KV, G, Sq, -1)


def _direct_attn(qg, k, v, *, qpos, kpos, causal, window, kv_len,
                 scale, cap):
    """Unchunked attention: qg (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd).

    All-masked semantics: a query row whose mask admits no key yields
    exactly zero output (softmax over an all-``NEG_INF`` row would
    otherwise degenerate to a uniform average of ``v``).  Every engine of
    the ``attention`` op shares this convention.
    """
    s = L.softcap(_qk(qg, k) * scale, cap)
    m = _expand_mask(_mask(qpos, kpos, causal=causal, window=window,
                           kv_len=kv_len))
    s = torch.where(m, s, NEG_INF)
    p = torch.where(m, torch.softmax(s, dim=-1), 0.0)
    o = _pv(p.to(v.dtype), v)
    return o.permute(0, 3, 1, 2, 4).to(v.dtype)


def _chunked_attn(qg, k, v, *, qpos, causal, window, scale, cap,
                  chunk: int):
    """Online-softmax over KV chunks (flash-style; the reference's
    ``jax.lax.scan`` over chunks is this loop).  The last chunk is the
    ragged rest of the keys, where the reference zero-pads and masks."""
    B, Sq, KV, G, hd = qg.shape
    hd_v = v.shape[-1]          # may differ from hd (MLA: 192 vs 128)
    Sk = k.shape[1]
    dev = qg.device
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=ACCUM_DTYPE, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=ACCUM_DTYPE, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd_v), dtype=ACCUM_DTYPE, device=dev)
    for c0 in range(0, Sk, chunk):
        k_i, v_i = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kp_i = torch.arange(c0, c0 + k_i.shape[1], device=dev)
        s = L.softcap(_qk(qg, k_i) * scale, cap)
        valid = _expand_mask(_mask(qpos, kp_i, causal=causal,
                                   window=window, kv_len=Sk))
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # Masked entries are zeroed exactly: exp(NEG_INF - m) == 1 when
        # the whole row so far is masked (m == NEG_INF, finite).
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _pv(p.to(v_i.dtype), v_i)
        m = m_new
    # A fully-masked query row has l == 0 exactly: emit exactly zero.
    ln = l[..., None]
    o = torch.where(ln > 0.0, acc / torch.where(ln > 0.0, ln, 1.0), 0.0)
    return o.permute(0, 3, 1, 2, 4).to(v.dtype)      # (B,Sq,KV,G,hd)


def _banded_local_attn(qg, k, v, *, window: int, scale, cap):
    """Exact sliding-window attention computing only the block-diagonal
    band (q block i attends kv blocks i-1, i with w == window), instead
    of all S x S scores + mask.  Requires Sq == Sk divisible by window
    (callers pad)."""
    B, S, KV, G, hd = qg.shape
    hd_v = v.shape[-1]
    w = window
    nb = S // w
    qb = qg.reshape(B * nb, w, KV, G, hd)
    kb = k.reshape(B, nb, w, KV, hd)
    vb = v.reshape(B, nb, w, KV, hd_v)
    # kv pair for block i = [block i-1 ; block i]
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2).reshape(B * nb, 2 * w, KV, hd)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2).reshape(B * nb, 2 * w, KV, hd_v)
    s = L.softcap(_qk(qb, k2) * scale, cap)        # (B nb, KV, G, w, 2w)
    # positions within the band: query t_q (0..w), key c (0..2w) offset -w
    dev = qg.device
    tq = torch.arange(w, device=dev)[:, None]
    tc = torch.arange(2 * w, device=dev)[None, :] - w
    valid = (tc <= tq) & (tc > tq - w)      # causal + window
    # block 0 has no predecessor: mask the phantom prefix keys
    first = (torch.arange(nb, device=dev) == 0)[:, None, None]
    valid = valid[None] & ~(first & (tc < 0)[None])    # (nb, w, 2w)
    valid = valid.repeat(B, 1, 1)[:, None, None]       # (B nb, 1, 1, w, 2w)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _pv(p.to(v2.dtype), v2)                        # (B nb, KV, G, w, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, KV, G, hd_v).to(v.dtype)


_CFG_CAP = object()   # sentinel: take the softcap from the config


def _registry_attn(cfg, qg, k, v, *, qpos, causal, window, kv_len,
                   scale, decode, cap=_CFG_CAP):
    """Route one attention problem through the TC-op registry.

    ``cfg.attn_method`` picks the engine: the empty default keeps the
    legacy size heuristic (direct oracle for decode/small problems,
    KV-chunked online softmax for long prefill) but spells it as
    explicit registry engines; ``'auto'`` hands the choice to the
    autotuner under ``cfg.attn_precision`` and ``cfg.attn_slo_ms``; any
    engine/alias name requests that engine, falling back to the ``vpu``
    oracle when its capability predicates refuse the call (the
    stay-trainable policy — ``core.dispatch.resolve_method``).
    """
    from repro_torch.core import dispatch
    Sq = qg.shape[1]
    method = getattr(cfg, "attn_method", "") or ""
    if not method:
        small = decode or Sq * k.shape[1] <= cfg.attn_chunk ** 2
        method = "vpu" if small else "unfused_mma"
    pol = getattr(cfg, "attn_precision", None)
    if cap is _CFG_CAP:
        cap = cfg.attn_softcap
    kw = dict(k=k, v=v, qpos=qpos, causal=causal, window=window,
              kv_len=kv_len, scale=scale, cap=cap,
              chunk=cfg.attn_chunk)
    if method != "auto":
        method = dispatch.resolve_method("attention", qg, method,
                                         fallback="vpu", precision=pol,
                                         **kw)
    return dispatch.dispatch("attention", qg, method=method,
                             precision=pol,
                             objective=getattr(cfg, "attn_slo_ms", None),
                             **kw)


def _project(x, w, dt):
    """einsum('bsd,dhk->bshk', x, w.astype(dt))."""
    B, S, _ = x.shape
    return (x @ w.to(dt).reshape(w.shape[0], -1)).view(B, S, *w.shape[1:])


def _write_cache(cache, k, v, *, per_row, decode, pos_now):
    """Write this step's k / v into the cache's tensors in place, as the
    reference's functional update writes them; returns (the cache with
    ``idx`` advanced, kv_len for the attention that follows)."""
    ck, cv = cache["k"], cache["v"]
    B, Sq = k.shape[:2]
    cap = ck.shape[1]
    idx = torch.as_tensor(cache["idx"], device=ck.device)
    k, v = k.to(ck.dtype), v.to(cv.dtype)
    # Ring-buffer invariant: token t lives at slot t % cap.  Local layers
    # allocate cap == window, so the ring itself enforces the sliding
    # window during decode (no positional mask).
    if decode and per_row:
        # Continuous batching: every slot writes its own ring position
        # pos % cap and masks its own valid-slot count.
        widx = torch.fmod(pos_now, cap).long()
        rows = torch.arange(B, device=ck.device)
        ck[rows, widx] = k[:, 0]
        cv[rows, widx] = v[:, 0]
        kv_len = torch.clamp(pos_now + 1, max=cap)       # (B,)
    elif decode:
        # dynamic_update_slice clamps the start so the update fits.
        start = torch.clamp(torch.fmod(idx, cap), max=cap - Sq)
        slots = start.long() + torch.arange(Sq, device=ck.device)
        ck.index_copy_(1, slots, k)
        cv.index_copy_(1, slots, v)
        kv_len = torch.clamp(idx + Sq, max=cap)          # valid slot count
    else:  # prefill from position 0
        if Sq >= cap:
            ck.copy_(torch.roll(k[:, Sq - cap:], Sq % cap, dims=1))
            cv.copy_(torch.roll(v[:, Sq - cap:], Sq % cap, dims=1))
        else:
            ck[:, :Sq] = k
            cv[:, :Sq] = v
        kv_len = None
    return dict(cache, k=ck, v=cv, idx=idx + Sq), kv_len


def attention(params, cfg, x, *, positions, kind: str = "global",
              cache=None, memory=None, causal: bool = True,
              decode: bool = False):
    """Self- or cross-attention.

    positions: (Sq,) int absolute positions of the query tokens (decode
    passes the single current index), or (B, Sq) *per-row* positions —
    the continuous-batching decode form, where each batch slot serves a
    different request at its own absolute position (requires ``decode``
    with Sq == 1).  Positions are non-negative.  Returns (out,
    new_cache); a cache is updated in place.
    """
    dt = x.dtype
    B, Sq, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    window = cfg.window if kind == "local" else None
    theta = cfg.rope_theta
    if kind == "local" and cfg.rope_theta_local is not None:
        theta = cfg.rope_theta_local
    positions = torch.as_tensor(positions, device=x.device)
    per_row = positions.ndim == 2
    if per_row and not (decode or kind == "cross") and Sq != 1:
        raise ValueError(
            "per-row (B, Sq) positions require decode with Sq == 1 "
            "(per-slot prefill is admitted one request at a time)")

    q = _project(x, params["wq"], dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
    if cfg.use_qk_norm:
        q = _head_rmsnorm(q, params["q_norm"])
    pos_b = positions if per_row else positions[None, :].expand(B, Sq)
    if kind != "cross":
        q = L.apply_rope(q, pos_b, theta=theta, fraction=cfg.rope_fraction)
    if getattr(cfg, "attn_seq_shard", False) and not decode \
            and kind != "cross":
        q = constrain(q, ("batch", "seq_mp", "heads", "head_dim"))
    else:
        q = constrain(q, ("batch", None, "heads", "head_dim"))

    new_cache = cache
    if kind == "cross":
        # keys/values from encoder/vision memory; cached once at prefill.
        if cache is not None and "k" in cache and decode:
            k, v = cache["k"], cache["v"]
        else:
            src = memory.to(dt)
            k = _project(src, params["wk"], dt)
            v = _project(src, params["wv"], dt)
            if cfg.qkv_bias:
                k = k + params["bk"].to(dt)
                v = v + params["bv"].to(dt)
            if cfg.use_qk_norm:
                k = _head_rmsnorm(k, params["k_norm"])
            if cache is not None:
                new_cache = dict(cache, k=k, v=v)
        kv_len, causal, window = k.shape[1], False, None
    else:
        k = _project(x, params["wk"], dt)
        v = _project(x, params["wv"], dt)
        if cfg.qkv_bias:
            k = k + params["bk"].to(dt)
            v = v + params["bv"].to(dt)
        if cfg.use_qk_norm:
            k = _head_rmsnorm(k, params["k_norm"])
        k = L.apply_rope(k, pos_b, theta=theta, fraction=cfg.rope_fraction)
        kv_len = None
        if cache is not None:
            new_cache, kv_len = _write_cache(cache, k, v, per_row=per_row,
                                             decode=decode,
                                             pos_now=pos_b[:, 0])
            if decode:
                k, v = new_cache["k"], new_cache["v"]
                causal, window = False, None         # ring handles both

    qg = q.reshape(B, Sq, KV, G, hd)
    scale = 1.0 / math.sqrt(hd)
    banded = (kind == "local" and getattr(cfg, "local_banded", False)
              and not decode and causal and window is not None
              and Sq == k.shape[1] and Sq % window == 0
              and Sq // window >= 2)
    if banded:
        o = _banded_local_attn(qg, k, v, window=window, scale=scale,
                               cap=cfg.attn_softcap)
    else:
        o = _registry_attn(cfg, qg, k, v, qpos=positions, causal=causal,
                           window=window, kv_len=kv_len, scale=scale,
                           decode=decode)
    o = o.reshape(B, Sq, H * hd)
    wo = params["wo"].reshape(H * hd, d)
    ct = torch.promote_types(o.dtype, dt)
    out = o.to(ct) @ wo.to(dt).to(ct)
    if getattr(cfg, "bf16_activation_ar", False):
        # the reference asks its output dot for a dt-typed result (a
        # 2-byte tensor-parallel all-reduce)
        out = out.to(dt)
    return constrain(out, ("batch", None, None)), new_cache
