"""Kernel B6: the chained triangular-MMA prefix scan on Hopper, beside
its plain PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_scan.cu`` (``sm_90a``, bound through ctypes
by ``kernels._build``).  ``scan_cuda`` replaces
``repro.kernels.mma_scan.mma_scan_kernel`` (launched by ``scan_call``).
Bound: bytes — the function reads its input once and writes f32 once,
and spends 32-48 tensor-core flops per element.  Design: the TPU carried
the running total across a sequential grid in VMEM; blocks on the H100
run in no order, so the kernel runs three launches, none of which waits
on another block: per-tile totals (and each 16 x 16 slab's carry inside
its tile), one block's exclusive scan of the tile totals, and a second
read of every tile that forms ``P = X x U_16`` on the tensor cores and
adds the row, slab and tile carries in f32 on the CUDA cores.  Two reads
and one write: at best 67 % of the bytes bound in f32; a single-pass
look-back scan is later work.  Deterministic, with no float atomics.

``scan_plain`` computes the same function in plain PyTorch, with the
kernel's decomposition of the reference's tile walk (``P = X x U_m``,
row carries ``L' t``, a running tile carry): the row carries split into
one exclusive scan over each slab's 16 rows and one over the tile's
slabs, and the tile carries are an exclusive f32 cumsum.  So kernel and
plain version differ only in the order of their f32 adds.  The wrapper
``kernels.ops.mma_scan`` uses it for CPU tensors, and only there.
``LAUNCHES`` counts the wrapper's launches, one per call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.core.reduction import _mm
from repro_torch.kernels import _build
from repro_torch.kernels.mma_reduce import (_DTYPES, M, _check,  # noqa: F401
                                            block_rows_ok)

LAUNCHES = {"b6_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _shift(incl):
    """Inclusive -> exclusive along the last axis (a leading zero)."""
    return torch.nn.functional.pad(incl[..., :-1], (1, 0))


def scan_plain(x, *, chain: int, block_rows: int,
               inclusive: bool = True) -> torch.Tensor:
    """B6's function in plain PyTorch: the f32 prefix sum of a flat
    tensor (exclusive when ``inclusive=False``), shape (n,)."""
    n = x.numel()
    tile = chain * block_rows * M
    groups = max(math.ceil(n / tile), 1)
    flat = torch.nn.functional.pad(x.reshape(-1), (0, groups * tile - n))
    u = torch.triu(torch.ones(M, M, dtype=flat.dtype, device=flat.device))
    # (tile, slab, row, column): slabs in link-then-warp order.
    p = _mm(flat.reshape(-1, M), u).reshape(groups, -1, M, M)
    rows = torch.cumsum(p[..., -1], dim=-1)            # (G, S, 16)
    slabs = _shift(torch.cumsum(rows[..., -1], dim=-1))
    tile_totals = slabs[:, -1] + rows[:, -1, -1]
    tiles = _shift(torch.cumsum(tile_totals, dim=-1))
    carry = slabs[..., None] + _shift(rows)
    out = (p + carry[..., None]) + tiles[:, None, None, None]
    out = out.reshape(-1)[:n]
    return out if inclusive else _shift(out)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_scan")
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.b6_scan.argtypes = [ptr, ll, i, i, i, i, ptr, ptr, ptr, ptr]
    lib.b6_scan.restype = i
    lib.mma_scan_error_string.argtypes = [i]
    lib.mma_scan_error_string.restype = ctypes.c_char_p
    return lib


def scan_cuda(x, *, chain: int, block_rows: int,
              inclusive: bool = True) -> torch.Tensor:
    """B6: the f32 prefix sum of a flat f32 / bf16 / fp16 CUDA tensor
    (exclusive when ``inclusive=False``).  Returns shape (n,) f32 on
    x's device; three launches on the current stream, each checked."""
    _check(x, block_rows, chain)
    groups = max(-(-x.numel() // (chain * block_rows * M)), 1)
    slab = torch.empty(groups * chain * block_rows // M, dtype=ACCUM_DTYPE,
                       device=x.device)
    tiles = torch.empty(groups, dtype=ACCUM_DTYPE, device=x.device)
    out = torch.empty(x.numel(), dtype=ACCUM_DTYPE, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.b6_scan(x.data_ptr(), x.numel(), _DTYPES[x.dtype], chain,
                         block_rows, int(not inclusive), slab.data_ptr(),
                         tiles.data_ptr(), out.data_ptr(), stream)
    if rc:
        msg = lib.mma_scan_error_string(rc).decode()
        raise RuntimeError(f"b6_scan launch failed: {msg} ({rc})")
    LAUNCHES["b6_scan"] += 1
    return out
