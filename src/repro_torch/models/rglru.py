"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) —
the counterpart of ``repro.models.rglru``.

    r_t = sigmoid(W_a u_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The diagonal linear recurrence is ``core.scan.tc_linear_recurrence``:
chunks of the sequence densified into per-channel lower-triangular decay
matrices and solved as batched contractions.  A causal depthwise conv
(width 4) precedes the recurrence; the gated GeLU branch multiplies the
recurrence output (Griffin's gated block).

Decode state: {"h": (B, lru), "conv": (B, conv_width-1, lru)} — O(1) in
sequence length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan import tc_linear_recurrence
from repro_torch.distributed.sharding import constrain
from repro_torch.models.param import Param


def rglru_specs(cfg):
    d = cfg.d_model
    g = cfg.rglru
    w = g.lru_width
    return {
        "wx": Param((d, w), ("embed", "lru")),
        "wy": Param((d, w), ("embed", "lru")),
        "conv_w": Param((g.conv_width, w), ("conv", "lru"), "normal",
                        scale=0.1),
        "conv_b": Param((w,), ("lru",), "zeros"),
        "wa": Param((w, w), ("lru", None)),
        "ba": Param((w,), ("lru",), "zeros"),
        "wi": Param((w, w), ("lru", None)),
        "bi": Param((w,), ("lru",), "zeros"),
        "lam": Param((w,), ("lru",), "normal", scale=1.0),
        "wo": Param((w, d), ("lru", "embed")),
    }


def make_state(cfg, batch: int, dtype=torch.float32, device=None):
    """An empty state on ``device`` (default: the card, raising without
    one)."""
    from repro_torch.core.dispatch import default_device
    device = default_device(device)
    g = cfg.rglru
    return {
        "h": torch.zeros((batch, g.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, g.conv_width - 1, g.lru_width),
                            dtype=dtype, device=device),
    }


def state_axes():
    return {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}


def _causal_conv(u, conv_w, conv_b, tail):
    """Depthwise causal conv, width W; ``tail`` is the (B, W-1, lru)
    carry-in from previous steps (zeros at sequence start)."""
    wlen = conv_w.shape[0]
    full = torch.cat([tail.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    for i in range(wlen):
        out = out + full[:, i:i + u.shape[1], :] \
            * conv_w[wlen - 1 - i].to(u.dtype)
    new_tail = full[:, full.shape[1] - (wlen - 1):, :]
    return out + conv_b.to(u.dtype), new_tail


def rglru_apply(params, cfg, x, state):
    """x: (B, S, D). Returns (out, new_state)."""
    dt = x.dtype
    g = cfg.rglru
    s = x.shape[1]

    y_gate = F.gelu(x @ params["wy"].to(dt), approximate="tanh")
    u = x @ params["wx"].to(dt)
    u = constrain(u, ("batch", "seq", "lru"))
    u, new_tail = _causal_conv(u, params["conv_w"], params["conv_b"],
                               state["conv"])

    uf = u.to(torch.float32)
    r = torch.sigmoid(uf @ params["wa"].to(torch.float32)
                      + params["ba"].to(torch.float32))
    i = torch.sigmoid(uf @ params["wi"].to(torch.float32)
                      + params["bi"].to(torch.float32))
    log_a = -g.power * F.softplus(params["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)

    # h_t = a_t h_{t-1} + b_t — chunked triangular-MMA linear
    # recurrence, seeded with the carry-in state.
    h, h_last = tc_linear_recurrence(log_a, gated_in, state["h"],
                                     chunk=min(16, max(s, 1)))
    out = (h.to(dt) * y_gate) @ params["wo"].to(dt)
    new_state = {"h": h_last, "conv": new_tail}
    return constrain(out, ("batch", None, None)), new_state
