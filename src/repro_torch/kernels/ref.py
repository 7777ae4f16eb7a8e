"""Plain-PyTorch oracles for the reduction, prefix-scan, segmented-sum,
RMSNorm, fused RMSNorm -> matmul and attention kernels — the counterpart of
``repro.kernels.ref`` for those kernels.

Each oracle states the *semantics* a kernel must have (including the
f32 accumulation), not its implementation.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import (ACCUM_DTYPE, compensated_sum,
                                        split_f32_words)


def reduce_ref(x) -> torch.Tensor:
    """f32-accumulated sum of all elements (any shape, any float dtype)."""
    return torch.sum(x, dtype=ACCUM_DTYPE)


def partials_ref(x2d, *, chain: int, block_rows: int) -> torch.Tensor:
    """Per-tile f32 partial sums of the recurrence variant:
    x2d (G*chain*block_rows, m) -> (G, 1) f32."""
    rows, m = x2d.shape
    g = rows // (chain * block_rows)
    return torch.sum(x2d.reshape(g, -1), dim=1, keepdim=True,
                     dtype=ACCUM_DTYPE)


def squared_sum_ref(x) -> torch.Tensor:
    """f32-accumulated sum of squares (grad-norm building block)."""
    xf = x.to(ACCUM_DTYPE)
    return torch.sum(xf * xf)


def ec_reduce_ref(x, *, split_words: int = 2,
                  square: bool = False) -> torch.Tensor:
    """Compensated split-bf16 sum: the semantics of the ``mma_ec`` /
    ``pallas_ec`` engines without the MMA structure — split into bf16
    words, then a pairwise-TwoSum compensated tree over every word
    value."""
    xf = x.to(ACCUM_DTYPE)
    if square:
        xf = xf * xf
    parts = split_f32_words(xf, split_words)
    return compensated_sum(torch.cat(
        [p.reshape(-1).to(ACCUM_DTYPE) for p in parts]))


def dd_reduce_ref(x, *, square: bool = False) -> torch.Tensor:
    """Double-double sum: the semantics of the ``mma_dd`` /
    ``pallas_dd`` engines without the tile structure — elementwise
    (hi, lo) pairs, dd-merged pairwise, as a shape-(2,) f32 pair."""
    from repro_torch.core.reduction import tc_reduce_dd
    return tc_reduce_dd(x, square=square)


def ec_scan_ref(x, *, split_words: int = 2,
                inclusive: bool = True) -> torch.Tensor:
    """f32 prefix sum of the word-split reconstruction over the last
    axis — the oracle of ``repro_torch.core.scan.tc_scan_ec``."""
    parts = split_f32_words(x.to(ACCUM_DTYPE), split_words)
    recon = sum(p.to(ACCUM_DTYPE) for p in parts)
    out = torch.cumsum(recon, dim=-1)
    if not inclusive:
        out = torch.nn.functional.pad(out[..., :-1], (1, 0))
    return out


def scan_ref(x, *, inclusive: bool = True) -> torch.Tensor:
    """f32 prefix sum of the flattened input, in the original shape."""
    flat = torch.cumsum(x.reshape(-1).to(ACCUM_DTYPE), dim=0)
    if not inclusive:
        flat = torch.nn.functional.pad(flat[:-1], (1, 0))
    return flat.reshape(x.shape)


def segment_sum_ref(values, segment_ids, num_segments: int) -> torch.Tensor:
    """f32 segmented sum (empty segments are 0); an id outside
    [0, num_segments) is dropped, as ``jax.ops.segment_sum`` drops it."""
    v = values.reshape(-1).to(ACCUM_DTYPE)
    ids = torch.as_tensor(segment_ids, device=v.device).reshape(-1)
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(int(num_segments), dtype=ACCUM_DTYPE, device=v.device)
    return out.index_add_(0, ids[keep].to(torch.int64), v[keep])


def rmsnorm_ref(x2d, weight, *, eps: float = 1e-6,
                weight_offset: float = 0.0) -> torch.Tensor:
    """RMSNorm over the last dim: f32 mean of squares, ``rsqrt``, the
    ``(weight + weight_offset)`` scale, cast to x's dtype."""
    xf = x2d.to(ACCUM_DTYPE)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    w = weight.to(ACCUM_DTYPE) + weight_offset
    return (xf * rstd * w).to(x2d.dtype)


def norm_matmul_ref(x2d, scale, w, *, w_gate=None, bias=None, act=None,
                    eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm(x) @ w`` with the gemma ``(1 + scale)`` weighting: f32
    mean of squares, the f32 projection of ``x * (1 + scale)`` scaled by
    ``rsqrt`` afterwards, ``+ bias``, ``act(g) * up`` with a gate; cast
    to x's dtype."""
    from repro_torch.kernels.mma_norm_matmul import apply_act
    xf = x2d.to(ACCUM_DTYPE)
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xs = xf * (1.0 + scale.to(ACCUM_DTYPE))
    up = (xs @ w.to(ACCUM_DTYPE)) * rstd
    if bias is not None:
        up = up + bias.to(ACCUM_DTYPE)
    if w_gate is not None:
        up = apply_act((xs @ w_gate.to(ACCUM_DTYPE)) * rstd, act) * up
    return up.to(x2d.dtype)


def attention_ref(qg, k, v, *, qpos, causal: bool = False, window=None,
                  kv_len=None, scale=None, cap=None) -> torch.Tensor:
    """Attention in f32, in the form of ``models.attention._direct_attn``
    on f32 operands: qg (B, Sq, KV, G, hd), k (B, Sk, KV, hd), v (B, Sk,
    KV, hd_v), qpos (Sq,) or per row (B, Sq), kv_len None, a scalar or
    (B,) -> (B, Sq, KV, G, hd_v) f32.  Scores ``scale q.k`` (default
    1 / sqrt(hd)) with the optional softcap, masked by causality, the
    window and kv_len, softmax over the keys; a row with no valid key is
    exactly 0."""
    qf, kf, vf = (t.to(ACCUM_DTYPE) for t in (qg, k, v))
    scale = qg.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqkgh,bckh->bkgqc", qf, kf) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    kpos = torch.arange(k.shape[1], device=qg.device)
    q = torch.as_tensor(qpos, device=qg.device)[..., :, None]
    valid = torch.ones(q.shape[:-1] + kpos.shape, dtype=torch.bool,
                       device=qg.device)
    if causal:
        valid = valid & (kpos <= q)
    if window is not None:
        valid = valid & (kpos > q - window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=qg.device)
        valid = valid & (kpos < (kl[:, None, None] if kl.ndim else kl))
    valid = valid[:, None, None] if valid.ndim == 3 else valid
    s = torch.where(valid, s, -2.0e38)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bkgqc,bckh->bqkgh", p, vf)
