"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent per-channel decay, plus squared-ReLU channel-mix — the
counterpart of ``repro.models.rwkv6``.

Per head (size hs), state S in R^{hs x hs}:
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(decay_base + LoRA(x-shifted))) — the data-dependent
decay that distinguishes Finch from RWKV-5.

The WKV recurrence runs as a loop over time (``_wkv_scan``; the
reference's ``lax.scan``) or chunk-parallel (``_wkv_chunked``, with
``cfg.rwkv_chunk``); decode is a single state update.  The state is the
"KV cache" of this family: O(1) in sequence length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan import tc_cumprod
from repro_torch.distributed.sharding import constrain
from repro_torch.models.param import Param

MIX_NAMES = ("w", "k", "v", "r", "g")


def timemix_specs(cfg):
    d = cfg.d_model
    r = cfg.rwkv
    n = d // r.head_size
    return {
        "maa_x": Param((d,), (None,), "zeros"),
        "maa_base": Param((5, d), (None, None), "zeros"),
        "maa_w1": Param((d, 5 * r.lora_mix), ("embed", None)),
        "maa_w2": Param((5, r.lora_mix, d), (None, None, "embed")),
        "decay_base": Param((d,), (None,), "normal", scale=1.0),
        "decay_w1": Param((d, r.lora_decay), ("embed", None)),
        "decay_w2": Param((r.lora_decay, d), (None, "embed")),
        "bonus": Param((n, r.head_size), ("heads", None), "normal",
                       scale=0.1),
        "wr": Param((d, d), ("embed", "heads")),
        "wk": Param((d, d), ("embed", "heads")),
        "wv": Param((d, d), ("embed", "heads")),
        "wg": Param((d, d), ("embed", "heads")),
        "wo": Param((d, d), ("heads", "embed")),
        "ln_x_scale": Param((d,), (None,), "ones"),
        "ln_x_bias": Param((d,), (None,), "zeros"),
    }


def chanmix_specs(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "maa_k": Param((d,), (None,), "zeros"),
        "maa_r": Param((d,), (None,), "zeros"),
        "wk": Param((d, ff), ("embed", "mlp")),
        "wv": Param((ff, d), ("mlp", "embed")),
        "wr": Param((d, d), ("embed", None)),
    }


def make_state(cfg, batch: int, dtype=torch.float32, device=None):
    """An empty state on ``device`` (default: the card, raising without
    one)."""
    from repro_torch.core.dispatch import default_device
    device = default_device(device)
    d = cfg.d_model
    r = cfg.rwkv
    n = d // r.head_size
    return {
        "wkv": torch.zeros((batch, n, r.head_size, r.head_size),
                           dtype=torch.float32, device=device),
        # last input (time-mix), last input (channel-mix)
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def state_axes():
    return {"wkv": ("batch", "heads", None, None),
            "x_tm": ("batch", None), "x_cm": ("batch", None)}


def _shifted(x, x_prev_last):
    """token shift: concat(prev_tail, x[:-1]) along time."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(params, x, xx):
    """Finch data-dependent lerp for the 5 mix streams."""
    base = x + xx * params["maa_x"].to(x.dtype)
    lora = torch.tanh(base @ params["maa_w1"].to(x.dtype))
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, -1)
    mods = torch.einsum("bsfr,frd->fbsd", lora,
                        params["maa_w2"].to(x.dtype))
    mixes = params["maa_base"].to(x.dtype)  # (5, d)
    # xw, xk, xv, xr, xg
    return [x + xx * (mixes[i] + mods[i]) for i in range(5)]


def _wkv_scan(r, k, v, w, u, state0):
    """r,k,v,w: (B, S, N, hs); u: (N, hs); state0: (B, N, hs, hs) f32."""
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    S, ys = state0, []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,N,hs,hs)
        ys.append(torch.einsum("bni,bnij->bnj", rf[:, t],
                               S + u[None, :, :, None] * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S                          # (B,S,N,hs)


def _wkv_chunked(r, k, v, w, u, state0, *, chunk: int = 32):
    """Chunk-parallel WKV: the length-S sequential recurrence becomes

      1. intra-chunk prefix (from zero state) for ALL chunks in parallel
         (a ``chunk``-step loop over (B, n_chunks, N, hs, hs) tensors);
      2. a length-S/chunk loop propagating chunk boundary states
         S_out = diag(prod w) S_in + S_local;
      3. one batched einsum adding each token's cross-chunk term
         r_t · (prefix-decay_t ⊙ S_in[chunk(t)]).

    The step-3 prefix decays are a log-space triangular-MMA scan
    (``core.scan.tc_cumprod``) sized to the chunk axis."""
    B, S, N, hs = r.shape
    c = chunk
    assert S % c == 0, (S, c)
    nc = S // c
    rf, kf, vf, wf = (t.to(torch.float32).reshape(B, nc, c, N, hs)
                      for t in (r, k, v, w))

    # 1. intra-chunk (parallel over chunks)
    s_loc = torch.zeros((B, nc, N, hs, hs), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(c):
        kv = kf[:, :, t, :, :, None] * vf[:, :, t, :, None, :]
        ys.append(torch.einsum("bcni,bcnij->bcnj", rf[:, :, t],
                               s_loc + u[None, None, :, :, None] * kv))
        s_loc = wf[:, :, t, :, :, None] * s_loc + kv
    y_intra = torch.stack(ys, dim=2)                 # (B, nc, c, N, hs)

    # 2. boundary-state loop over chunks (emit each incoming state)
    d_chunk = torch.prod(wf, dim=2)                  # (B, nc, N, hs)
    s_run, s_in = state0, []
    for i in range(nc):
        s_in.append(s_run)
        s_run = d_chunk[:, i, :, :, None] * s_run + s_loc[:, i]
    s_in = torch.stack(s_in, dim=1)                  # (B, nc, N, hs, hs)

    # 3. cross-chunk contribution via exclusive prefix decays
    pref = tc_cumprod(wf, axis=2, inclusive=False, chain=1,
                      m=max(8, min(128, c)))
    y_cross = torch.einsum("bcsni,bcnij->bcsnj", rf * pref, s_in)
    y = (y_intra + y_cross).reshape(B, S, N, hs)
    return y, s_run


def _group_norm(y, scale, bias, n_heads, eps=1e-5):
    """Per-head LayerNorm over head_size (RWKV's ln_x)."""
    b, s, d = y.shape
    yh = y.reshape(b, s, n_heads, -1).to(torch.float32)
    mu = torch.mean(yh, dim=-1, keepdim=True)
    var = torch.var(yh, dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return yh.reshape(b, s, d) * scale.to(torch.float32) \
        + bias.to(torch.float32)


def time_mix(params, cfg, x, state):
    """x: (B,S,D). state: see make_state. Returns (out, new_state)."""
    dt = x.dtype
    b, s, d = x.shape
    n = d // cfg.rwkv.head_size

    x_prev = _shifted(x, state["x_tm"].to(dt))
    xx = x_prev - x
    xw, xk, xv, xr, xg = _ddlerp(params, x, xx)

    decay_mod = torch.tanh(xw @ params["decay_w1"].to(dt)) \
        @ params["decay_w2"].to(dt)
    logw = -torch.exp(torch.clamp(
        params["decay_base"].to(torch.float32)
        + decay_mod.to(torch.float32), -10.0, 8.0))
    w = torch.exp(logw)                                      # (B,S,D) in (0,1)

    r = (xr @ params["wr"].to(dt)).reshape(b, s, n, -1)
    k = (xk @ params["wk"].to(dt)).reshape(b, s, n, -1)
    v = (xv @ params["wv"].to(dt)).reshape(b, s, n, -1)
    g = F.silu(xg @ params["wg"].to(dt))
    wh = w.reshape(b, s, n, -1)
    u = params["bonus"].to(torch.float32)

    chunk = getattr(cfg, "rwkv_chunk", 0)
    if chunk and s % chunk == 0 and s > chunk:
        y, new_wkv = _wkv_chunked(r, k, v, wh, u, state["wkv"], chunk=chunk)
    else:
        y, new_wkv = _wkv_scan(r, k, v, wh, u, state["wkv"])
    y = _group_norm(y.reshape(b, s, d), params["ln_x_scale"],
                    params["ln_x_bias"], n)
    out = (y.to(dt) * g) @ params["wo"].to(dt)
    new_state = dict(state, wkv=new_wkv, x_tm=x[:, -1, :])
    return constrain(out, ("batch", None, None)), new_state


def channel_mix(params, cfg, x, state):
    dt = x.dtype
    x_prev = _shifted(x, state["x_cm"].to(dt))
    xx = x_prev - x
    xk = x + xx * params["maa_k"].to(dt)
    xr = x + xx * params["maa_r"].to(dt)
    h = torch.square(F.relu(xk @ params["wk"].to(dt)))
    h = constrain(h, ("batch", "seq", "mlp"))
    out = torch.sigmoid(xr @ params["wr"].to(dt)) \
        * (h @ params["wv"].to(dt))
    return out, dict(state, x_cm=x[:, -1, :])
