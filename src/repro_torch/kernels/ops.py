"""Public wrappers for the reduction kernels — the counterpart of the
reduction half of ``repro.kernels.ops``.

They flatten, resolve ``'auto'`` geometry and pick the variant.  Where
the reference chose interpret mode off the TPU, the port chooses by the
tensor's device: a CUDA tensor launches the Hopper kernel (or the
kernel's wrapper raises), a CPU tensor runs the kernel's plain PyTorch
version on the reference's zero-padded ``(T, m)`` tiles.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import mma_reduce as _mr

M = _mr.M


def _to_tiles(x, tile_rows: int, m: int):
    """Flatten x, zero-pad to a multiple of tile_rows*m, view as (T, m)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    per_tile = tile_rows * m
    padded = int(math.ceil(max(n, 1) / per_tile)) * per_tile
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    return flat.reshape(padded // m, m)


def _resolve_auto(x, chain, block_rows, *, op: str,
                  engine: str = "pallas"):
    """Turn chain/block_rows='auto' into the registry's tuned ints, from
    a plan tuned for this engine on x's device."""
    if chain == "auto" or block_rows == "auto":
        from repro_torch.core import autotune
        plan = autotune.get_plan(x.numel(), x.dtype, op=op, engine=engine,
                                 backend=x.device.type)
        if chain == "auto":
            chain = plan.chain
        if block_rows == "auto":
            block_rows = plan.block_rows
    return int(chain), int(block_rows)


def _flat(x, m: int):
    """The kernels' input: flat, contiguous, 16-byte aligned, in a dtype
    they take (other floats are cast to f32, as the reference's JAX
    canonicalises them)."""
    if x.is_cuda and m != M:
        raise ValueError(f"the Hopper kernels use m={M}, got m={m}")
    if x.dtype not in _mr.DTYPES:
        x = x.to(torch.float32)
    flat = x.reshape(-1)
    if x.is_cuda and flat.data_ptr() % 16:
        flat = flat.clone()
    return flat


def _single_pass(flat, chain: int, block_rows: int, m: int,
                 square: bool = False):
    if flat.is_cuda:
        return _mr.single_pass_cuda(flat, chain=chain,
                                    block_rows=block_rows, square=square)
    return _mr.single_pass_plain(_to_tiles(flat, chain * block_rows, m),
                                 chain=chain, block_rows=block_rows,
                                 square=square)


def _partials(flat, chain: int, block_rows: int, m: int):
    if flat.is_cuda:
        return _mr.partials_cuda(flat, chain=chain, block_rows=block_rows)
    return _mr.partials_plain(_to_tiles(flat, chain * block_rows, m),
                              chain=chain, block_rows=block_rows)


def mma_reduce(x, *, variant: str = "single_pass", chain=4,
               block_rows=128, m: int = M,
               mma_fraction: float = 0.5) -> torch.Tensor:
    """Sum all elements of ``x`` via chained ones-MMAs. Returns an f32
    scalar tensor on x's device.

    ``chain``/``block_rows`` accept 'auto' (the plan registry's tuned
    geometry for the ``pallas`` engine); integers are the paper's R and
    B.  ``variant``:
      'single_pass'  one launch of B1 (paper §5.2).
      'recurrence'   B2 levels map n -> n/(chain*block_rows*m) f32
                     partials until one tile remains, which B1 sums
                     (paper §5.1 / Alg. 1).
      'split'        one launch of B3, ``mma_fraction`` of every
                     (block_rows, m) tile on the tensor cores (paper
                     §5.3; ignores ``chain``).
    Any other value raises ``ValueError``.
    """
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="reduce_sum")
    flat = _flat(x, m)
    if variant == "single_pass":
        return _single_pass(flat, chain, block_rows, m)
    if variant == "recurrence":
        while flat.numel() > chain * block_rows * m:
            flat = _partials(flat, chain, block_rows, m)
        return _single_pass(flat, chain, block_rows, m)
    if variant == "split":
        mma_rows = _mr.mma_rows_for(block_rows, mma_fraction)
        if flat.is_cuda:
            return _mr.split_cuda(flat, block_rows=block_rows,
                                  mma_rows=mma_rows)
        return _mr.split_plain(_to_tiles(flat, block_rows, m),
                               block_rows=block_rows, mma_rows=mma_rows)
    raise ValueError(f"unknown variant: {variant!r}")


def mma_squared_sum(x, *, chain=4, block_rows=128,
                    m: int = M) -> torch.Tensor:
    """sum(x^2) in one B1 launch: squares in the input dtype, chained
    ones-MMAs, f32 partials throughout.  ``chain``/``block_rows``
    accept 'auto'."""
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="squared_sum")
    return _single_pass(_flat(x, m), chain, block_rows, m, square=True)


def mma_reduce_partials(x, *, chain: int = 4, block_rows: int = 128,
                        m: int = M) -> torch.Tensor:
    """One recurrence level (B2): per-tile f32 partial sums, shape (G,)."""
    return _partials(_flat(x, m), int(chain), int(block_rows), m)
