"""Prefix scans, segmented sums and the linear recurrence as MMAs in
plain PyTorch — the counterpart of ``repro.core.scan``.

Multiplying a row tile by the upper-triangular one-matrix computes
every prefix of the tile in one MMA (Dakkak et al., "Accelerating
Reduction and Scan Using Tensor Core Units"):

    P = X x U_m,        U_m[i, j] = 1  iff  i <= j

Geometry, as in the reference: the scan axis is zero-padded to a
multiple of ``chain * m`` and viewed as groups of ``chain`` rows of
``m`` elements:

    x -> (..., G, chain, m)
    P       = X x U_m                  (per-row inclusive prefix MMA)
    c       = t x U'_chain             (intra-group carries: a strictly
                                        upper-triangular MMA over the
                                        chain's row totals t)
    g-carry = exclusive scan of the per-group totals (an f32 cumsum for
              ``variant='single_pass'``, recursive MMA levels for
              ``variant='recurrence'``)

These are plain contractions outside any kernel, so they go to torch's
matmul through ``core.reduction._mm`` (16-bit operands accumulate in
f32; f32 operands run in full f32, TF32 being off).  Every partial is
f32 and every public function returns f32.  The hand-written Hopper
kernel of the flat scan is B6 (``repro_torch.kernels.mma_scan``), that
of the segmented sum B7 (``repro_torch.kernels.mma_segment``).

Precision: the reference forwards ``precision`` to its einsums, where
the MXU would otherwise truncate f32 multiplicands to bf16.  The port's
plain matmuls always run in full f32, so integer prefixes stay exact
below 2^24 under every policy (``precision.EXACT_OFFSETS`` included);
the argument is accepted for the reference's signature and keys
nothing here.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.core.precision import (ACCUM_DTYPE, split_f32_words,
                                        two_sum)
from repro_torch.core.reduction import DEFAULT_M, Variant, _mm

# Floor for log-space inputs: a finite stand-in for log(0) whose exp
# underflows to 0 in f32, so the triangular MMA never sees an infinity.
_LOG_FLOOR = -1.0e4


def _triu_ones(k: int, dtype, *, strict: bool = False,
               device=None) -> torch.Tensor:
    """Upper-triangular one-matrix U_k (strictly upper when ``strict``).
    Right-multiplying a row tile by U_k gives its inclusive prefixes;
    the strict form gives exclusive ones."""
    return torch.triu(torch.ones(k, k, dtype=dtype, device=device),
                      diagonal=1 if strict else 0)


def _shift_exclusive(incl):
    """Inclusive -> exclusive along the last axis by shifting in a zero
    (a shift, not ``incl - x``, so log-space floors never give NaN)."""
    return torch.nn.functional.pad(incl[..., :-1], (1, 0))


def tc_scan(x, *, axis: int = -1, inclusive: bool = True,
            variant: Variant = "single_pass", chain: int | str = 4,
            m: int = DEFAULT_M, precision=None) -> torch.Tensor:
    """Prefix sum along ``axis`` via chained triangular MMAs. Returns
    f32 in x's shape.

    Only the scan axis is reshaped; every other axis is a batch axis.
    ``chain='auto'`` resolves the group length from the plan registry
    (op ``'scan'``, engine ``'mma_chained'``) for this (n, dtype,
    device).  ``variant='single_pass'`` combines the group totals with
    an f32 cumsum; ``'recurrence'`` re-feeds them to the triangular-MMA
    scan until one group remains.  ``inclusive=False`` gives the
    exclusive scan (leading zero).  ``precision`` (an ``MmaPolicy``)
    changes nothing: see the module docstring.
    """
    if chain == "auto":
        from repro_torch.core import autotune
        chain = autotune.get_plan(x.shape[axis], x.dtype, op="scan",
                                  engine="mma_chained",
                                  backend=x.device.type).chain
    return _tc_scan_impl(x, axis=axis, inclusive=inclusive,
                         variant=variant, chain=int(chain), m=m)


def _tc_scan_impl(x, *, axis: int, inclusive: bool, variant: str,
                  chain: int, m: int) -> torch.Tensor:
    if not x.is_floating_point():
        # Integer inputs (MoE expert counts) ride f32 multiplicands,
        # exact below 2^24.
        x = x.to(ACCUM_DTYPE)
    x = torch.movedim(x, axis, -1)
    s = x.shape[-1]
    lead = x.shape[:-1]
    per_group = chain * m
    g = int(math.ceil(max(s, 1) / per_group))
    padded = g * per_group
    if padded != s:
        x = torch.nn.functional.pad(x, (0, padded - s))

    # P = X x U_m: per-row inclusive prefix, one triangular MMA per row.
    u_m = _triu_ones(m, x.dtype, device=x.device)
    p = _mm(x.reshape(-1, m), u_m).reshape(*lead, g, chain, m)

    # Intra-group carries: strictly upper-triangular MMA over the row
    # totals.
    t = p[..., -1]                                  # (..., G, chain)
    u_c = _triu_ones(chain, ACCUM_DTYPE, strict=True, device=x.device)
    c = _mm(t.reshape(-1, chain), u_c).reshape(t.shape)

    # Exclusive carry across groups.
    gt = c[..., -1] + t[..., -1]                    # (..., G)
    if g == 1:
        gc = torch.zeros_like(gt)
    elif variant == "single_pass":
        gc = _shift_exclusive(torch.cumsum(gt, dim=-1))
    elif variant == "recurrence":
        gc = _tc_scan_impl(gt, axis=-1, inclusive=False,
                           variant="recurrence", chain=chain, m=m)
    else:
        raise ValueError(f"unknown variant: {variant!r}")

    out = p + c[..., None] + gc[..., None, None]
    out = out.reshape(*lead, padded)[..., :s]
    if not inclusive:
        out = _shift_exclusive(out)
    return torch.movedim(out, -1, axis)


def tc_scan_ec(x, *, axis: int = -1, inclusive: bool = True,
               split_words: int = 2, chain: int | str = 2,
               m: int = DEFAULT_M) -> torch.Tensor:
    """Error-compensated prefix sum: split-bf16 triangular-MMA scans
    whose per-word f32 prefixes recombine through TwoSum. Returns f32.

    The input splits into ``split_words`` bf16 words
    (``precision.split_f32_words``; 3 words rebuild f32 exactly), each
    word runs one chained triangular-MMA scan with f32 accumulators, and
    a TwoSum cascade folds the per-position word prefixes, so the
    recombination adds no first-order rounding.  ``chain='auto'``
    resolves from the plan registry (op ``'scan'``, engine
    ``'mma_ec'``).
    """
    if chain == "auto":
        from repro_torch.core import autotune
        chain = autotune.get_plan(x.shape[axis], x.dtype, op="scan",
                                  engine="mma_ec",
                                  backend=x.device.type).chain
    words = split_f32_words(x, int(split_words))
    scans = [_tc_scan_impl(w, axis=axis, inclusive=inclusive,
                           variant="single_pass", chain=int(chain), m=m)
             for w in words]
    out = scans[0]
    err = torch.zeros_like(out)
    for nxt in scans[1:]:
        out, e = two_sum(out, nxt)
        err = err + e
    return out + err


def tc_cumprod(x, *, axis: int = -1, inclusive: bool = True,
               variant: Variant = "single_pass", chain: int | str = 4,
               m: int = DEFAULT_M) -> torch.Tensor:
    """Cumulative product of non-negative ``x`` via a log-space tc_scan:
    ``exp(scan(log x))``.  Exact zeros floor ``log x`` at a finite
    constant whose exp underflows to 0, so the MMA never sees an
    infinity.  Returns f32."""
    logs = torch.clamp(torch.log(x.to(ACCUM_DTYPE)), min=_LOG_FLOOR)
    return torch.exp(tc_scan(logs, axis=axis, inclusive=inclusive,
                             variant=variant, chain=chain, m=m))


def _local_solve(ca, bf):
    """A chunk's states from zero: ``h_local = L x b`` with the lower
    triangular ``L[t, s] = exp(ca_t - ca_s)`` (s <= t) a channel."""
    c = ca.shape[2]
    diff = ca[:, :, :, None, :] - ca[:, :, None, :, :]
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=ca.device))
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  _LOG_FLOOR))
    return torch.einsum("bntsw,bnsw->bntw", l_mat, bf)


def tc_linear_recurrence(log_a, b, h0, *, chunk: int = 16):
    """First-order linear recurrence ``h_t = a_t h_{t-1} + b_t`` as
    chunked triangular MMAs.  Returns ``(h, h_final)`` in f32: the
    (B, S, W) states and the (B, W) final state.

    ``log_a`` and ``b`` are (B, S, W) per-channel log-decays
    (``a_t = exp(log_a_t)``, ``log_a <= 0``) and inputs, ``h0`` the
    (B, W) initial state.  Within a chunk of ``c`` steps the recurrence
    is densified into the per-channel lower-triangular decay matrix
    ``L[t, s] = exp(ca_t - ca_s)`` for s <= t, ``ca`` the chunk's
    triangular-MMA scan of ``log_a``, and solved as one batched
    contraction ``h_local = L x b``; the chunk-boundary states follow a
    Python loop over the S / c chunks.  Under autograd the (B, nc, c, c,
    W) matrix ``L`` is recomputed in the backward pass rather than saved
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    of its local solve), so the MMA form does not multiply a training
    step's memory by the chunk.
    """
    bsz, s, w = log_a.shape
    c = int(chunk)
    la = torch.clamp(log_a.to(ACCUM_DTYPE), min=_LOG_FLOOR)
    bf = b.to(ACCUM_DTYPE)
    nc = int(math.ceil(max(s, 1) / c))
    pad = nc * c - s
    if pad:
        # a = 1, b = 0 padding: the state is constant through the tail.
        la = torch.nn.functional.pad(la, (0, 0, 0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
    la = la.reshape(bsz, nc, c, w)
    bf = bf.reshape(bsz, nc, c, w)

    # ca_t = sum_{u<=t} log a_u within the chunk; m = 16 for c >= 16
    # (the reference's own call resolves to the same tile).
    ca = tc_scan(la, axis=2, chain=1, m=min(DEFAULT_M, max(c, 8)))
    if torch.is_grad_enabled() and (ca.requires_grad or bf.requires_grad):
        h_local = torch.utils.checkpoint.checkpoint(
            _local_solve, ca, bf, use_reentrant=False)
    else:
        h_local = _local_solve(ca, bf)

    # Chunk-boundary carries: h_in_{k+1} = D_k h_in_k + local_last_k.
    decay = torch.exp(ca[:, :, -1, :])                # (B, nc, W)
    last = h_local[:, :, -1, :]                       # (B, nc, W)
    h = h0.to(ACCUM_DTYPE)
    incoming = []
    for k in range(nc):
        incoming.append(h)
        h = decay[:, k] * h + last[:, k]
    h_in = torch.stack(incoming, dim=1)               # (B, nc, W)

    # Each step adds its decayed view of the chunk's incoming state.
    out = h_local + torch.exp(ca) * h_in[:, :, None, :]
    return out.reshape(bsz, nc * c, w)[:, :s, :], h


# Bytes of the f32 one-hot mask one step of tc_segment_reduce builds.
# On the card the mask is a tensor in device memory that a Python loop
# streams: each step writes it (and its bool compare) and reads it back
# for the contraction, about 9 bytes per entry, so a 256 MiB mask keeps
# a step near 0.7 ms at 3.35 TB/s, far above the few tens of us of host
# time each step's five launches cost, while n = 2^28 at S = 128 takes
# 512 steps.  A smaller mask would make the loop's host time show; a
# larger one only holds more memory.  (The reference's 32 MiB was the
# TPU's VMEM-sized tile.)
_MASK_BUDGET = 256 * 2**20


def tc_segment_reduce(values, segment_ids, num_segments: int, *,
                      m: int = DEFAULT_M) -> torch.Tensor:
    """Segmented sum as MMAs against the one-hot segment matrix:
    ``out[s]`` = the sum of the values whose id is ``s``.  Returns
    (num_segments,) f32; empty segments are 0, and an id outside
    [0, num_segments), -1 included, matches no column.

    The one-hot E (E[i, s] = 1 iff segment_ids[i] == s) generalises the
    paper's all-ones matrix; for sorted ids it is block diagonal, and
    ``values^T x E`` is the ones-MMA of each block.  The mask is built
    in blocks of at most ``_MASK_BUDGET`` bytes, each contracted by
    ``core.reduction._mm`` (16-bit operands accumulate in f32, f32 runs
    in full f32 with TF32 off, so the contraction keeps every bit of the
    values).  Integer values are cast to f32.  ``m`` is accepted for the
    reference's signature; the contraction has no tile.
    """
    s = int(num_segments)
    flat = values.reshape(-1)
    if not flat.is_floating_point():
        flat = flat.to(ACCUM_DTYPE)
    ids = torch.as_tensor(segment_ids, device=flat.device).reshape(-1)
    n = flat.shape[0]
    if n == 0 or s == 0:
        return torch.zeros(s, dtype=ACCUM_DTYPE, device=flat.device)
    block = min(n, max(1, (_MASK_BUDGET // 4) // s))
    seg_iota = torch.arange(s, dtype=ids.dtype, device=flat.device)
    out = torch.zeros(s, dtype=ACCUM_DTYPE, device=flat.device)
    for start in range(0, n, block):
        v = flat[start:start + block]
        mask = (ids[start:start + block, None] == seg_iota[None, :]) \
            .to(v.dtype)
        out = out + _mm(v[None, :], mask)[0]
    return out
