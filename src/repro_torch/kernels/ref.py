"""Plain-PyTorch oracles for the reduction kernels — the counterpart of
``repro.kernels.ref`` for this slice.

Each oracle states the *semantics* a kernel must have (including the
f32 accumulation), not its implementation.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import ACCUM_DTYPE


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
