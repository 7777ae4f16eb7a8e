"""Shared model layers: norms (MMA-reduction statistics), MLPs, embeddings,
RoPE, softcapping — the counterpart of ``repro.models.layers``.

Layouts at these functions are the reference's: activations (B, S, D),
attention inputs to RoPE (B, S, H, D), weights (d_in, d_out).  Parameters
are nested dicts of tensors (``models.param``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import integration as ci
from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.core.reduction import pad_rows
from repro_torch.distributed.sharding import constrain
from repro_torch.models.param import Param

# ---------------------------------------------------------------- norms


def rmsnorm_specs(d: int):
    return {"scale": Param((d,), ("embed_no_fsdp",), "zeros")}


def rmsnorm(params, x, *, eps: float = 1e-6, method: str = "mma",
            fast_apply: bool = False, precision=None):
    """RMSNorm with (1 + scale) weighting (gemma convention, scale init 0).

    The mean-of-squares row statistic is an axis-aware batched reduction
    on the TC-op registry path (``integration.reduce_sum(axis=-1)``):
    under ``method='mma'`` the 'mma' engine's last-dim ones-contraction
    (``tc_reduce_lastdim``), ``method='vpu'`` the classic baseline.  An
    engine that cannot serve the per-row statistic (the flatten-only
    'pallas' / 'mma_chained', or an unknown spelling) falls back to the
    baseline: a model must stay trainable under every reduce_method
    ablation.

    ``fast_apply``: the statistic stays f32, but the normalisation
    multiply runs in the input dtype.  ``precision`` threads an
    ``MmaPolicy`` to the row-statistic reduction.

    The ``norm_matmul`` op's own spellings ('fused_pallas',
    'unfused_mma') resolve through its norm-only form (``w=None``):
    'fused_pallas' is kernel B8, which serves f32 and bf16; an fp16
    input falls back to 'unfused_mma'.  ``fast_apply`` does not apply
    there.
    """
    from repro_torch.core import dispatch
    if (method != "auto"
            and dispatch.known_method("norm_matmul", method)
            and not dispatch.known_method("reduce_sum", method)):
        kw = dict(w=None, scale=params["scale"], eps=eps)
        m = dispatch.resolve_method("norm_matmul", x, method,
                                    fallback="unfused_mma",
                                    precision=precision, **kw)
        return dispatch.dispatch("norm_matmul", x, method=m,
                                 precision=precision, **kw)
    d = x.shape[-1]
    xf = x.to(ACCUM_DTYPE)
    method = dispatch.resolve_method("reduce_sum", xf, method,
                                     fallback="vpu", precision=precision,
                                     axis=(x.ndim - 1,))
    ms = ci.reduce_sum(xf * xf, axis=-1, keepdims=True,
                       method=method, precision=precision) / d
    rstd = torch.rsqrt(ms + eps)
    scale = params["scale"].to(ACCUM_DTYPE)
    if fast_apply:
        w = (1.0 + scale).to(x.dtype)
        return x * rstd.to(x.dtype) * w
    y = xf * rstd
    out = y * (1.0 + scale)
    return out.to(x.dtype)


def layernorm_specs(d: int):
    return {"scale": Param((d,), ("embed_no_fsdp",), "ones"),
            "bias": Param((d,), ("embed_no_fsdp",), "zeros")}


def layernorm(params, x, *, eps: float = 1e-5):
    xf = x.to(ACCUM_DTYPE)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    out = y * params["scale"].to(ACCUM_DTYPE) \
        + params["bias"].to(ACCUM_DTYPE)
    return out.to(x.dtype)


def norm_specs(d: int, kind: str = "rmsnorm"):
    return layernorm_specs(d) if kind == "layernorm" else rmsnorm_specs(d)


def apply_norm(params, x, *, kind: str = "rmsnorm",
               method: str = "mma", fast_apply: bool = False,
               precision=None):
    if kind == "layernorm":
        return layernorm(params, x)
    return rmsnorm(params, x, method=method, fast_apply=fast_apply,
                   precision=precision)


def norm_matmul(params, x, w, *, w_gate=None, bias=None, act=None,
                eps: float = 1e-6, method: str = "auto",
                precision=None, objective=None, bucket: str = "pow2"):
    """``rmsnorm(x) @ w`` through the ``norm_matmul`` TC-op.

    ``params`` is an rmsnorm param dict (``rmsnorm_specs``); ``w`` the
    following projection (d, dout) — with ``w_gate`` / ``act`` the MLP
    up/gate pair, with ``bias`` an affine projection.  ``method``:
    'unfused_mma' is the two-op path (bit-identical to
    ``rmsnorm(method='mma')`` + the x.dtype matmul), 'vpu' the all-f32
    baseline, 'fused_pallas' the fused kernel (the norm-only form is B8;
    with ``w`` given it waits for B10), 'auto' the autotuner's plan
    under the policy's error budget and the ``objective``.  A spelling
    the capability predicates refuse for this call falls back to
    'unfused_mma': the forward pass never fails on it ('fused_pallas'
    with ``w`` given, or on an fp16 input, which B8 does not serve).
    """
    from repro_torch.core import dispatch
    kw = dict(w=w, scale=params["scale"], w_gate=w_gate, bias=bias,
              act=act, eps=eps)
    method = dispatch.resolve_method("norm_matmul", x, method,
                                     fallback="unfused_mma",
                                     precision=precision, **kw)
    return dispatch.dispatch("norm_matmul", x, method=method,
                             precision=precision, objective=objective,
                             bucket=bucket, **kw)


# ---------------------------------------------------------------- MLP


def mlp_specs(d: int, d_ff: int):
    return {
        "wi_gate": Param((d, d_ff), ("embed", "mlp")),
        "wi_up": Param((d, d_ff), ("embed", "mlp")),
        "wo": Param((d_ff, d), ("mlp", "embed")),
    }


def _act(gate, act: str):
    if act == "silu":
        return F.silu(gate)
    if act == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(act)


def dense(x, w):
    """``x @ w`` for (..., d) x and a (d, n) w, x's leading dims taken as
    rows and sent to the matrix library padded
    (``core.reduction.pad_rows``): a row's bits do not depend on the
    rows beside it, so a decode step's slots get the bits of one request
    alone."""
    x2d = x.reshape(-1, x.shape[-1])
    out = pad_rows(x2d) @ w
    return out[:x2d.shape[0]].reshape(*x.shape[:-1], w.shape[-1])


def _down(h, wo, dt):
    # bf16_out in the reference asks its dot for a dt-typed result (a
    # 2-byte tensor-parallel all-reduce); torch's matmul in dt returns
    # dt either way, so both spellings run this one product.
    return dense(h, wo.to(dt))


def mlp(params, x, *, act: str = "silu", bf16_out: bool = False):
    """Gated MLP (SiLU/GeLU-GLU)."""
    dt = x.dtype
    gate = dense(x, params["wi_gate"].to(dt))
    up = dense(x, params["wi_up"].to(dt))
    gate = constrain(gate, ("batch", "seq", "mlp"))
    return _down(_act(gate, act) * up, params["wo"], dt)


def fused_mlp(norm_params, mlp_params, x, *, act: str = "silu",
              method: str = "auto", precision=None, objective=None,
              bf16_out: bool = False, eps: float = 1e-6,
              bucket: str = "pow2"):
    """Pre-norm gated MLP with the norm in the up/gate projections:
    ``norm_matmul`` computes ``act(rmsnorm(x) @ wi_gate) * (rmsnorm(x)
    @ wi_up)`` in one dispatch, then the down projection runs as in
    ``mlp``.  Drop-in for ``mlp(p, rmsnorm(n, x))``."""
    h = norm_matmul(norm_params, x, mlp_params["wi_up"],
                    w_gate=mlp_params["wi_gate"], act=act, eps=eps,
                    method=method, precision=precision,
                    objective=objective, bucket=bucket)
    h = constrain(h, ("batch", "seq", "mlp"))
    return _down(h, mlp_params["wo"], x.dtype)


# ---------------------------------------------------------------- embeds


def embed_specs(vocab: int, d: int):
    # sigma = 1/sqrt(d): unit-variance logits under a tied unembedding.
    return {"table": Param((vocab, d), ("vocab", "embed"), "embed",
                           scale=d ** -0.5)}


def embed_lookup(params, tokens, *, scale: bool, d: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cast_table: bool = False, onehot: bool = False):
    table = params["table"]
    tokens = torch.as_tensor(tokens, device=table.device)
    if cast_table or onehot:
        table = table.to(compute_dtype)
    if onehot:
        # The paper's encoding applied to the gather: a one-hot MMA
        # against the table.
        oh = F.one_hot(tokens.long(), table.shape[0]).to(compute_dtype)
        oh = constrain(oh, ("batch", None, "vocab"))
        x = torch.matmul(oh, table)
    else:
        x = table[tokens.long()].to(compute_dtype)
    if scale:
        root = torch.sqrt(torch.tensor(float(d), dtype=ACCUM_DTYPE))
        x = x * root.to(device=x.device, dtype=compute_dtype)
    return constrain(x, ("batch", "seq", None))


def unembed(params, x, *, softcap=None):
    """Project to vocab logits (tied table or separate head)."""
    logits = dense(x, params["table"].T.to(x.dtype))
    if softcap is not None:
        logits = softcap * torch.tanh(logits.to(ACCUM_DTYPE) / softcap)
    return logits


# ---------------------------------------------------------------- RoPE


def rope_angles(positions, dim: int, theta: float):
    """positions: (...,) int -> cos, sin of shape (..., dim // 2), f32."""
    half = dim // 2
    positions = torch.as_tensor(positions)
    expo = -torch.arange(0, half, dtype=ACCUM_DTYPE,
                         device=positions.device) / half
    # theta made on the host and copied (as the constructor does), so a
    # dry run's fake step makes nothing on the card on any thread
    freq = torch.pow(torch.tensor(theta, dtype=ACCUM_DTYPE)
                     .to(positions.device), expo)
    ang = positions[..., None].to(ACCUM_DTYPE) * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, *, theta: float, fraction: float = 1.0):
    """x: (B, S, H, D).  Rotates the first ``fraction`` of D."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rope_angles(torch.as_tensor(positions, device=x.device),
                           rot, theta)                  # (B, S, rot // 2)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < d else out


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
