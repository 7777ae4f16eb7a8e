"""Shared model layers: norms (MMA-reduction statistics), MLPs, embeddings,
RoPE, softcapping — the counterpart of ``repro.models.layers``.

Layouts at these functions are the reference's: activations (B, S, D),
attention inputs to RoPE (B, S, H, D), weights (d_in, d_out).  Parameters
are nested dicts of tensors (``models.param``).

Inside a train step over a mesh (``sharding.local_step`` with a model
axis) the gated MLP, the embedding and the logits run the reference's
tensor-parallel layout over ``model`` where the rules split their
weights (``sharding.model_share``; the callers pass the whole width): the
MLP's ``wi_gate`` / ``wi_up`` are column blocks (``column``: the input
enters through ``copy_in``) and ``wo`` a row block whose partial products
leave through ``reduce_out`` (``row_parallel``); the embedding table and the head are row blocks of the
vocabulary, a lookup sums the ranks' rows (each rank's zero outside its
own) and ``unembed`` gives this rank's block of the logits.  GSPMD
partitions the reference's products the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import integration as ci
from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.core.reduction import _mm, pad_rows
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import constrain, model_share
from repro_torch.models.param import Param

_HALF = (torch.bfloat16, torch.float16)

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


def copy_in(x, share):
    """``x`` entering a tensor-parallel body over ``share``'s axis
    (``collectives.copy_to``: the ranks' cotangents are summed, each rank
    having used ``x`` for its own block); ``x`` itself without one.
    Every tensor a body holds whole and reads for its block goes through
    it (an input, a norm's scale, a weight that stays whole): without it
    that tensor's gradient is one rank's part and differs across the
    ranks."""
    if share is None:
        return x
    return coll.copy_to(x, share.axis, mesh=share.mesh)


class _Column(torch.autograd.Function):
    """``dense(x.to(w.dtype), w)`` for an f32 ``x`` of 16-bit values:
    forward the compute dtype's product, as one card's; backward x's
    gradient accumulated and returned in f32, w's in its dtype."""

    @staticmethod
    def forward(ctx, x, w):
        xd = x.to(w.dtype)
        ctx.save_for_backward(xd, w)
        return dense(xd, w)

    @staticmethod
    def backward(ctx, g):
        xd, w = ctx.saved_tensors
        g2d = g.reshape(-1, g.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _mm(g2d, w.T).reshape(*g.shape[:-1], w.shape[0])
        if ctx.needs_input_grad[1]:
            gw = xd.reshape(-1, xd.shape[-1]).T @ g2d
        return gx, gw


def column(x, w, share):
    """``x @ w`` for a whole ``x`` and a (d, n) ``w`` in x's dtype, under
    a ``share`` this rank's column block of it.  There ``x`` enters
    through ``copy_in`` for this product alone, a 16-bit ``x`` widened to
    f32 (exactly): the ranks' partial gradients of ``x`` are summed in
    f32 and rounded to x's dtype once, and the products' gradients are
    then added as one card adds them (each product's gradient rounded,
    then their sum)."""
    if share is None:
        return dense(x, w)
    if x.dtype in _HALF:
        return _Column.apply(copy_in(x.to(ACCUM_DTYPE), share), w)
    return dense(copy_in(x, share), w)


def reduce_out(x, share):
    """The sum of the ranks' partial ``x`` over ``share``'s axis
    (``collectives.reduce_from``); ``x`` itself without one."""
    if share is None:
        return x
    return coll.reduce_from(x, share.axis, mesh=share.mesh)


def row_parallel(h, w, dt, share, *, narrow: bool = False):
    """``h @ w.astype(dt)`` for (..., k) ``h``; under a ``share``, ``w``
    is this rank's row block and ``h`` its columns, and the ranks'
    partial products are summed.  A partial is accumulated in f32 and
    the partials summed in f32, then rounded to ``dt`` once, as one
    card's product rounds its f32 accumulator; ``narrow`` asks for the
    reference's ``preferred_element_type=dt`` dot, whose partials are
    ``dt`` and summed in ``dt`` (its 2-byte all-reduce)."""
    if share is None or narrow:
        return reduce_out(dense(h, w.to(dt)), share)
    h2d = h.reshape(-1, h.shape[-1])
    part = _mm(pad_rows(h2d), w.to(dt))[:h2d.shape[0]]
    out = reduce_out(part, share).to(dt)
    return out.reshape(*h.shape[:-1], w.shape[-1])


def _down(h, wo, dt, share=None, bf16_out: bool = False):
    # bf16_out in the reference asks its dot for a dt-typed result (a
    # 2-byte tensor-parallel all-reduce); torch's matmul in dt returns
    # dt either way, so on one card both spellings run this one product.
    return row_parallel(h, wo, dt, share, narrow=bf16_out)


def mlp(params, x, *, act: str = "silu", bf16_out: bool = False,
        d_ff=None):
    """Gated MLP (SiLU/GeLU-GLU).  ``d_ff``, the whole hidden width,
    tells a train step's tensor-parallel body whether ``wi_gate`` is a
    column block (``sharding.model_share``)."""
    dt = x.dtype
    share = model_share(params["wi_gate"].shape[-1], d_ff)
    gate = column(x, params["wi_gate"].to(dt), share)
    up = column(x, params["wi_up"].to(dt), share)
    gate = constrain(gate, ("batch", "seq", "mlp"))
    return _down(_act(gate, act) * up, params["wo"], dt, share, bf16_out)


def fused_mlp(norm_params, mlp_params, x, *, act: str = "silu",
              method: str = "auto", precision=None, objective=None,
              bf16_out: bool = False, eps: float = 1e-6,
              bucket: str = "pow2", d_ff=None):
    """Pre-norm gated MLP with the norm in the up/gate projections:
    ``norm_matmul`` computes ``act(rmsnorm(x) @ wi_gate) * (rmsnorm(x)
    @ wi_up)`` in one dispatch, then the down projection runs as in
    ``mlp``.  Drop-in for ``mlp(p, rmsnorm(n, x))``.  In a
    tensor-parallel body the norm's scale, read for this rank's
    columns, enters through ``copy_in`` beside ``x``."""
    share = model_share(mlp_params["wi_gate"].shape[-1], d_ff)
    if share is not None:
        x = copy_in(x, share)
        norm_params = dict(norm_params,
                           scale=copy_in(norm_params["scale"], share))
    h = norm_matmul(norm_params, x, mlp_params["wi_up"],
                    w_gate=mlp_params["wi_gate"], act=act, eps=eps,
                    method=method, precision=precision,
                    objective=objective, bucket=bucket)
    h = constrain(h, ("batch", "seq", "mlp"))
    return _down(h, mlp_params["wo"], x.dtype, share, bf16_out)


# ---------------------------------------------------------------- embeds


def embed_specs(vocab: int, d: int):
    # sigma = 1/sqrt(d): unit-variance logits under a tied unembedding.
    return {"table": Param((vocab, d), ("vocab", "embed"), "embed",
                           scale=d ** -0.5)}


def embed_lookup(params, tokens, *, scale: bool, d: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cast_table: bool = False, onehot: bool = False,
                 vocab=None):
    """The embedding rows of ``tokens``.  ``vocab``, the whole
    vocabulary, tells a train step's tensor-parallel body whether the
    table is this rank's row block: a token outside it gives a zero row,
    and the ranks' rows are summed (one rank holds each token's)."""
    table = params["table"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    share = model_share(table.shape[0], vocab)
    inside = None
    if share is not None:
        tokens = tokens - share.start(table.shape[0])
        inside = (tokens >= 0) & (tokens < table.shape[0])
        tokens = torch.where(inside, tokens, 0)
    if cast_table or onehot:
        table = table.to(compute_dtype)
    if onehot:
        # The paper's encoding applied to the gather: a one-hot MMA
        # against the table.
        oh = F.one_hot(tokens, table.shape[0]).to(compute_dtype)
        if inside is not None:
            oh = oh * inside[..., None].to(compute_dtype)
        oh = constrain(oh, ("batch", None, "vocab"))
        x = torch.matmul(oh, table)
    else:
        x = table[tokens].to(compute_dtype)
        if inside is not None:
            x = torch.where(inside[..., None], x, 0.0)
    x = reduce_out(x, share)
    if scale:
        root = torch.sqrt(torch.tensor(float(d), dtype=ACCUM_DTYPE))
        x = x * root.to(device=x.device, dtype=compute_dtype)
    return constrain(x, ("batch", "seq", None))


def unembed(params, x, *, softcap=None, vocab=None):
    """Project to vocab logits (tied table or separate head).  In a
    train step's tensor-parallel body (the table a row block of
    ``vocab``) these are this rank's block of the logits, the softcap
    applied to the block."""
    share = model_share(params["table"].shape[0], vocab)
    logits = column(x, params["table"].T.to(x.dtype), share)
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
