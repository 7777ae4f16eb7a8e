"""Kernel B8: fused RMSNorm whose row statistic is a ones-MMA on Hopper,
beside its plain PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_rmsnorm.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  ``rmsnorm_cuda`` replaces
``repro.kernels.mma_rmsnorm.mma_rmsnorm_kernel`` (launched by
``rmsnorm_call``).  Bound: bytes — x read once, out written once, d
weights; the statistic's MMAs cost 16 tensor-core flops per element and
bf16 word, under 2 % of the byte time.  Design: a block takes 16 rows
(one m16n8k16 row tile) and its warps split d into 16-column tiles; each
f32 square goes into the tensor cores as exact bf16 words (three for f32
input, two for bf16) against ones, every MMA from a zero accumulator,
and the warps' row sums meet in shared memory in a fixed order.  The
TPU held a whole row block in VMEM and read x once; a block here
re-reads its 16 rows from global memory (mostly L2) for the scaling
pass, since 16 rows of a wide model do not fit 227 KB of shared memory
(16 x 7168 f32 is 459 KB).  Ragged rows and columns are masked in the
kernel, so the wrapper pads and copies nothing.

``rmsnorm_plain`` computes the same function in plain PyTorch with the
kernel's decomposition: the same f32 squares and word split, each
16-column tile's word sums taken through f32 matmuls against ones,
``(hi + mid) + lo`` per tile, the tiles summed per warp in the kernel's
order and the warps' sums in warp order.  Kernel and plain version
differ only in the order of the adds inside one MMA and in ``rsqrt``'s
last bits.  The wrapper ``kernels.ops.mma_rmsnorm`` uses it for CPU
tensors, and only there.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import ACCUM_DTYPE, split_f32_words
from repro_torch.kernels import _build

LAUNCHES = {"b8_rmsnorm": 0}

# Columns per tile: the k of the m16n8k16 MMA (a block takes its m, 16
# rows).
TILE = 16
# Warps per block (csrc kWarps): warp w sums tiles w, w + WARPS, ...
WARPS = 8
# Input dtypes the kernel takes, with its dtype code.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def words_of(dtype: torch.dtype) -> int:
    """bf16 words that rebuild a square exactly: a bf16 value's square
    has at most 16 significant bits, an f32 square 24."""
    return 2 if dtype == torch.bfloat16 else 3


def tile_sums_plain(x2d: torch.Tensor) -> torch.Tensor:
    """Each 16-column tile's f32 sum of squares, (rows, tiles): the exact
    bf16 words of the f32 squares summed through f32 matmuls against
    ones, ``(hi + mid) + lo`` per tile (B8's and B10's statistic)."""
    rows, d = x2d.shape
    xf = x2d.to(ACCUM_DTYPE)
    sq = xf * xf
    tiles = -(-d // TILE)
    sq = torch.nn.functional.pad(sq, (0, tiles * TILE - d))
    ones = torch.ones(TILE, 1, dtype=ACCUM_DTYPE, device=x2d.device)
    tile_sum = None
    for word in split_f32_words(sq, words_of(x2d.dtype)):
        part = torch.matmul(word.to(ACCUM_DTYPE).reshape(rows, tiles, TILE),
                            ones)[..., 0]
        tile_sum = part if tile_sum is None else tile_sum + part
    return tile_sum


def row_sums_plain(x2d: torch.Tensor) -> torch.Tensor:
    """The kernel's statistic: f32 sum of squares per row, (rows,)."""
    tile_sum = tile_sums_plain(x2d)
    rows, tiles = tile_sum.shape
    # Warp w takes tiles w, w + WARPS, ... in order; then warp order.
    steps = -(-tiles // WARPS)
    tile_sum = torch.nn.functional.pad(tile_sum,
                                       (0, steps * WARPS - tiles))
    tile_sum = tile_sum.reshape(rows, steps, WARPS)
    per_warp = tile_sum[:, 0]
    for k in range(1, steps):
        per_warp = per_warp + tile_sum[:, k]
    total = per_warp[:, 0]
    for w in range(1, WARPS):
        total = total + per_warp[:, w]
    return total


def rmsnorm_plain(x2d: torch.Tensor, weight: torch.Tensor, *,
                  eps: float = 1e-6,
                  weight_offset: float = 0.0) -> torch.Tensor:
    """B8's function in plain PyTorch: x2d (rows, d) of any float dtype
    -> x2d.dtype."""
    d = x2d.shape[-1]
    ms = row_sums_plain(x2d) / d
    rstd = torch.rsqrt(ms + eps)[:, None]
    w = weight.to(ACCUM_DTYPE) + weight_offset
    return ((x2d.to(ACCUM_DTYPE) * rstd) * w).to(x2d.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_rmsnorm")
    ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
    lib.b8_rmsnorm.argtypes = [ptr, ptr, ptr, ll, i, i, f, f, ptr]
    lib.b8_rmsnorm.restype = i
    lib.mma_rmsnorm_error_string.argtypes = [i]
    lib.mma_rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_cuda(x2d: torch.Tensor, weight: torch.Tensor, *,
                 eps: float = 1e-6,
                 weight_offset: float = 0.0) -> torch.Tensor:
    """B8 on a contiguous (rows, d) f32 / bf16 CUDA tensor and d weights
    on the same card.  Returns a new tensor of x2d's dtype and shape;
    one launch, checked."""
    if not x2d.is_cuda or x2d.dtype not in _DTYPES:
        raise ValueError(f"B8 takes an f32 or bf16 CUDA tensor, got "
                         f"{x2d.dtype} on {x2d.device}")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"B8 takes a contiguous (rows, d) tensor, got "
                         f"shape {tuple(x2d.shape)}")
    rows, d = x2d.shape
    if weight.numel() != d or weight.device != x2d.device:
        raise ValueError(f"weight must hold d={d} values on {x2d.device}, "
                         f"got {weight.numel()} on {weight.device}")
    if d >= 2 ** 31:
        raise ValueError(f"d={d} is not below 2^31")
    out = torch.empty_like(x2d)
    if rows == 0 or d == 0:
        return out
    w = weight.reshape(-1).to(ACCUM_DTYPE).contiguous()
    lib = _lib()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.b8_rmsnorm(x2d.data_ptr(), w.data_ptr(), out.data_ptr(),
                            rows, d, _DTYPES[x2d.dtype], float(eps),
                            float(weight_offset), stream)
    if rc:
        msg = lib.mma_rmsnorm_error_string(rc).decode()
        raise RuntimeError(f"b8_rmsnorm launch failed: {msg} ({rc})")
    LAUNCHES["b8_rmsnorm"] += 1
    return out
