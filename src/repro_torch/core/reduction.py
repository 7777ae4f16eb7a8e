"""The paper's chained-MMA arithmetic reduction in plain PyTorch — the
counterpart of ``repro.core.reduction``.

``tc_reduce`` expresses every partial summation as a matrix multiply
against a ones matrix with f32 accumulation, the way the paper routes
it to tensor cores; the hand-written kernels live in
``repro_torch.kernels``.  These are plain large contractions outside any
kernel, so they go to torch's matmul family:

  * on CUDA, bf16/fp16 operands (both of one dtype) use the
    ``out_dtype=ACCUM_DTYPE`` overloads (``aten::mm.dtype`` /
    ``bmm.dtype``): plain ``torch.matmul`` would return bf16 and break
    the f32 contract;
  * on the CPU those overloads are not implemented, so both operands
    are cast to f32 first (the products of 16-bit values are exact in
    f32, so the contract is the same);
  * f32 operands run in full f32 (TF32 is off: ``core.precision``).

Shape convention: the input is flattened, zero-padded to a multiple of
``chain * m * m`` and viewed as groups of ``chain`` m x m matrices:

    X -> (G, chain, m, m)
    C_g = sum_r  [1]_{1 x m} x M_{g,r}        (chain of MMAs, f32 accum)
    s_g = C_g x [1]_{m x 1}                   (final transposed MMA)

followed by variant-specific combining of the per-group scalars s_g.

The compensated (``tc_reduce_ec``) and double-double (``tc_reduce_dd``)
twins are the cores of the ``mma_ec`` and ``mma_dd`` engines.  The dd
merge tree adds each pair of high words as ``a + b``, not through a
pair ones-contraction as the reference does (``repro.core.reduction.
_dd_merge_tree``): an eager f32 add rounds exactly once on every
device, which is all the TwoSum residual needs to be exact, whereas a
matmul library is free to reorder, split or fuse the two products.
"""

from __future__ import annotations

import math
from typing import Literal

import torch

from repro_torch.core.precision import (ACCUM_DTYPE, compensated_sum,
                                        dd_add, dd_from_any, fast_two_sum,
                                        split_f32_words, two_prod)

DEFAULT_M = 16  # the paper's wmma tile (the reference's TPU tile is 128)

Variant = Literal["single_pass", "recurrence", "split"]

_HALF = (torch.bfloat16, torch.float16)


def _mm(a, b) -> torch.Tensor:
    """``a @ b`` (2-D) accumulated and returned in f32."""
    if a.is_cuda and a.dtype in _HALF:
        return torch.mm(a, b, out_dtype=ACCUM_DTYPE)
    return torch.mm(a.to(ACCUM_DTYPE), b.to(ACCUM_DTYPE))


def _bmm(a, b) -> torch.Tensor:
    """Batched ``a @ b`` (3-D) accumulated and returned in f32; operands
    of two dtypes are both widened to f32 (exactly, as JAX promotes
    them)."""
    if a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype:
        return torch.bmm(a, b, out_dtype=ACCUM_DTYPE)
    return torch.bmm(a.to(ACCUM_DTYPE), b.to(ACCUM_DTYPE))


def _ones(n: int, like) -> torch.Tensor:
    return torch.ones(n, dtype=like.dtype, device=like.device)


def _as_groups(x, chain: int, m: int):
    """Flatten + zero-pad to (G, chain, m, m)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    per_group = chain * m * m
    g = int(math.ceil(max(n, 1) / per_group))
    padded = g * per_group
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    return flat.reshape(g, chain, m, m)


def _mma_chain(groups):
    """C_g = sum_r [1]_{1xm} x M_{g,r}; returns (G, m) f32 row sums."""
    g, chain, m, _ = groups.shape
    mats = groups.reshape(g * chain, m, m)
    ones_row = _ones(m, groups).reshape(1, 1, m).expand(g * chain, 1, m)
    prod = _bmm(ones_row, mats)                     # (G*chain, 1, m)
    # The chain accumulation C_r = [1] x M_r + C_{r-1}:
    return prod.reshape(g, chain, m).sum(dim=1)     # (G, m) f32


def _mma_collapse(acc):
    """s_g = C_g x [1]_{m x 1} (the final transposed MMA). (G, m) -> (G,)."""
    return _mm(acc, _ones(acc.shape[-1], acc).reshape(-1, 1))[:, 0]


def tc_reduce(x, *, variant: Variant = "single_pass",
              chain: int | str = 4, m: int = DEFAULT_M,
              mma_fraction: float = 0.5,
              keep_f32_partials: bool = True) -> torch.Tensor:
    """Arithmetic reduction R(X) via chained ones-MMAs. Returns an f32
    scalar tensor.

    ``variant`` is the paper's single-pass (§5.2: per-group scalars
    summed in f32), recurrence (§5.1/Alg. 1: per-group scalars re-fed
    as inputs until one group remains; ``keep_f32_partials=False``
    casts them back to the input dtype between levels, which brings
    back the fp16 overflow the paper reports) or split (§5.3:
    ``mma_fraction`` of the data by MMA chains, the rest by a plain
    f32 sum).  ``chain='auto'`` resolves R from the plan registry
    (engine ``'mma_chained'``) for this (n, dtype, device).
    """
    if chain == "auto":
        from repro_torch.core import autotune
        chain = autotune.get_plan(x.numel(), x.dtype, op="reduce_sum",
                                  engine="mma_chained",
                                  backend=x.device.type).chain
    chain = int(chain)
    in_dtype = x.dtype
    if variant == "split":
        flat = x.reshape(-1)
        n_mma = int(flat.shape[0] * mma_fraction)
        mma_part = tc_reduce(flat[:n_mma], variant="single_pass",
                             chain=chain, m=m)
        vpu_part = torch.sum(flat[n_mma:], dtype=ACCUM_DTYPE)
        return mma_part + vpu_part

    scalars = _mma_collapse(_mma_chain(_as_groups(x, chain, m)))
    if variant == "single_pass":
        # Block results combined on f32 accumulators (atomic-add analogue).
        return torch.sum(scalars)
    if variant == "recurrence":
        while scalars.shape[0] > 1:
            nxt = scalars if keep_f32_partials else scalars.to(in_dtype)
            scalars = _mma_collapse(_mma_chain(_as_groups(nxt, chain, m)))
        return scalars[0]
    raise ValueError(f"unknown variant: {variant!r}")


def tc_reduce_ec(x, *, split_words: int = 2, chain: int | str = 2,
                 m: int = DEFAULT_M) -> torch.Tensor:
    """Error-compensated reduction: split-bf16 MMA chains + TwoSum
    combine.  Returns an f32 scalar at (near) correctly-rounded
    accuracy.

    Each f32 value is split into ``split_words`` bf16 words
    (``precision.split_f32_words``: 3 words reconstruct f32 exactly, 2
    keep ~16 bits), one ones-MMA chain runs per word with f32
    accumulation as in ``tc_reduce``, and the (G, m) lane partials of
    every word are folded with the pairwise-TwoSum tree
    (``precision.compensated_sum``) in place of the final MMA.
    ``chain='auto'`` resolves R from the plan registry (engine
    ``'mma_ec'``).
    """
    if chain == "auto":
        from repro_torch.core import autotune
        chain = autotune.get_plan(x.numel(), x.dtype, op="reduce_sum",
                                  engine="mma_ec",
                                  backend=x.device.type).chain
    words = split_f32_words(x, int(split_words))
    lanes = [_mma_chain(_as_groups(w, int(chain), m)).reshape(-1)
             for w in words]
    return compensated_sum(torch.cat(lanes))


def _dd_merge_tree(hi, lo):
    """Pairwise double-double merge tree over the last axis: (..., k)
    (hi, lo) f32 pairs -> (...) pairs.  Each level dd-adds neighbours
    (``precision.dd_add``: TwoSum of the high words, both low words
    folded into the residual, FastTwoSum), so a level adds only
    O(eps32^2) relative error; an odd level is padded with (0, 0)."""
    hi = hi.to(ACCUM_DTYPE)
    lo = lo.to(ACCUM_DTYPE)
    if hi.shape[-1] == 0:
        z = torch.zeros(hi.shape[:-1], dtype=ACCUM_DTYPE, device=hi.device)
        return z, z.clone()
    while hi.shape[-1] > 1:
        if hi.shape[-1] % 2:
            hi = torch.nn.functional.pad(hi, (0, 1))
            lo = torch.nn.functional.pad(lo, (0, 1))
        hi, lo = dd_add(hi[..., 0::2], lo[..., 0::2],
                        hi[..., 1::2], lo[..., 1::2])
    return hi[..., 0], lo[..., 0]


def _dd_square(hi, lo):
    """Elementwise dd square: (hi + lo)^2 = TwoProd(hi, hi) + 2 hi lo +
    lo^2, renormalised (the reference's order of operations)."""
    p, e = two_prod(hi, hi)
    return fast_two_sum(p, e + (2.0 * hi * lo + lo * lo))


def tc_reduce_dd(x, *, square: bool = False) -> torch.Tensor:
    """Double-double reduction: a shape-(2,) f32 ``[hi, lo]`` pair whose
    exact sum is the f64-equivalent value of ``sum(x)`` (``sum(x*x)``
    with ``square=True``).  f64 input splits exactly into dd pairs on
    entry; collapse the pair with ``precision.dd_value``."""
    hi, lo = dd_from_any(x.reshape(-1))
    if square:
        hi, lo = _dd_square(hi, lo)
    h, low = _dd_merge_tree(hi, lo)
    return torch.stack([h, low])


def tc_contract(a, b) -> torch.Tensor:
    """Full contraction <a, b> as one f32-accumulated matmul: with
    ``b = ones_like(a)`` the plain sum, ``b = mask`` the masked
    numerator, ``b = a`` the squared sum."""
    return _mm(a.reshape(1, -1), b.reshape(-1, 1))[0, 0]


def tc_reduce_axes(x, axes: tuple, *, b=None) -> torch.Tensor:
    """Contraction over an axis subset: sum x*b over ``axes``, f32.

    The reduced axes become the contraction of one batched matmul and
    every other axis a batch axis; the output keeps the surviving axes
    in order (``torch.sum`` semantics, keepdims=False).  ``b=None``
    contracts against ones (the last-dim subset goes to
    ``tc_reduce_lastdim``); ``b=x`` gives the batched squared sum.
    """
    axes = tuple(sorted(axes))
    if b is None:
        if axes == (x.ndim - 1,):
            return tc_reduce_lastdim(x)
        b = torch.ones_like(x)
    if len(axes) == x.ndim:
        return tc_contract(x, b)
    batch = tuple(i for i in range(x.ndim) if i not in axes)
    out_shape = tuple(x.shape[i] for i in batch)
    k = math.prod(x.shape[i] for i in axes)
    rows = math.prod(out_shape)
    xa = x.permute(batch + axes).reshape(rows, 1, k)
    ba = b.permute(batch + axes).reshape(rows, k, 1)
    return _bmm(xa, ba).reshape(out_shape)


def tc_reduce_lastdim(x) -> torch.Tensor:
    """Ones-contraction over the last dim: (..., d) -> (...) f32 sums."""
    d = x.shape[-1]
    out = _mm(x.reshape(-1, d), _ones(d, x).reshape(d, 1))
    return out.reshape(x.shape[:-1])


def tc_reduce_rows(x2d, *, chain: int = 1, m: int = DEFAULT_M) -> torch.Tensor:
    """Row-wise MMA reduction: (rows, d) -> (rows,) f32 row sums (the
    columns zero-padded to a multiple of m, as in the reference)."""
    rows, d = x2d.shape
    pad = (-d) % m
    if pad:
        x2d = torch.nn.functional.pad(x2d, (0, pad))
    return _mm(x2d, _ones(x2d.shape[1], x2d).reshape(-1, 1))[:, 0]
