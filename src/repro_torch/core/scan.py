"""Prefix scans as chained triangular MMAs in plain PyTorch — the
counterpart of the prefix-scan half of ``repro.core.scan``.

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
kernel of the flat scan is B6 (``repro_torch.kernels.mma_scan``).

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
