"""Kernel B8: fused RMSNorm whose row statistic is a ones-MMA on Hopper,
beside its plain PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_rmsnorm.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  ``rmsnorm_cuda`` replaces
``repro.kernels.mma_rmsnorm.mma_rmsnorm_kernel`` (launched by
``rmsnorm_call``).  Bound: bytes — x read once, out written once, d
weights; the statistic's MMAs cost 16 tensor-core flops per element and
bf16 word, under 2 % of the byte time.  Design: a row tile of 16 rows
(one m16n8k16 row tile) is split across the blocks of a thread-block
cluster; each block stages its slice of the 16 rows in shared memory by
16-byte ``cp.async`` and runs both passes from there, so x is read from
HBM once (the TPU held a whole row block in VMEM; 16 rows of d = 7168
f32 are 459 KB, twice what one block may hold).  Each f32 square goes
into the tensor cores as exact bf16 words (three for f32 input, two for
bf16) against ones, every MMA from a zero accumulator; the warps' row
sums meet in shared memory and the blocks' in distributed shared memory,
each in a fixed order.  ``walk`` gives that order: the cluster size and
the chunks (16 rows x 128 bytes) each warp takes, a function of d and
the dtype alone, so a row's bits do not depend on the batch.  Ragged
rows and columns are masked in the kernel, and an input whose base or
row pitch is not 16-byte aligned is loaded element by element in the
same order, so the wrapper pads and copies nothing.

``rmsnorm_plain`` computes the same function in plain PyTorch with the
kernel's decomposition: the same f32 squares and word split, each
16-column tile's word sums taken through f32 matmuls against ones,
``(hi + mid) + lo`` per tile, the tiles summed per warp in column order,
the warps' sums in warp order and the blocks' in cluster-rank order, as
``walk`` lays them out.  Kernel and plain version differ only in the
order of the adds inside one MMA and in ``rsqrt``'s last bits.  The
wrapper ``kernels.ops.mma_rmsnorm`` uses it for CPU tensors, and only
there.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import ACCUM_DTYPE, split_f32_words
from repro_torch.kernels import _build

LAUNCHES = {"b8_rmsnorm": 0}

# Columns per tile: the k of the m16n8k16 MMA (a row tile is its m, 16
# rows).  B10's statistic shares these tiles (``tile_sums_plain``).
TILE = 16
# The walk's constants (csrc kWarps, kChunkBytes, kChunkMin, kClusterMax,
# kChunkResident): warps a block; bytes of a row in one chunk (16 rows x
# 128 bytes, one L2 line a row); chunks a warp takes at least; blocks a
# cluster at most; chunks a warp holds in shared memory at most.
WARPS = 8
CHUNK_BYTES = 128
CHUNK_MIN = 2
CLUSTER_MAX = 8
CHUNK_RESIDENT = 12
# Shared memory of a chunk (csrc kChunkStride: each 16 x 16 tile followed
# by a padding row) and the block's static arrays (16 row sums a warp, the
# block's 16 sums and 16 rstd, f32).
CHUNK_STRIDE = 17 * CHUNK_BYTES
STATIC_SMEM = 4 * (WARPS * 16 + 16 + 16)
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


@functools.cache
def walk(d: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """B8's walk of a row of d columns (csrc ``walk``): ``(cluster,
    chunks, resident)``, the blocks that split a row tile, the chunks
    each warp takes (consecutive, 128 bytes of each of 16 rows) and those
    it holds in shared memory.  Rank c of a cluster takes chunks
    [c WARPS chunks, (c + 1) WARPS chunks), its warp w the w-th run of
    ``chunks``.  A function of d and the dtype alone, never of rows."""
    cols = CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()
    row_chunks = -(-d // cols)
    chunks = max(CHUNK_MIN, -(-row_chunks // (WARPS * CLUSTER_MAX)))
    cluster = -(-row_chunks // (WARPS * chunks))
    return cluster, chunks, min(chunks, CHUNK_RESIDENT)


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Shared memory of one B8 block for rows of d columns: the warps'
    resident chunks and the static arrays."""
    return WARPS * walk(d, dtype)[2] * CHUNK_STRIDE + STATIC_SMEM


def row_sums_plain(x2d: torch.Tensor) -> torch.Tensor:
    """The kernel's statistic: f32 sum of squares per row, (rows,), added
    as ``walk`` orders it: each warp's tiles in column order from 0, the
    warps of a block in warp order, the blocks in cluster-rank order."""
    tile_sum = tile_sums_plain(x2d)
    rows, tiles = tile_sum.shape
    cluster, chunks, _ = walk(x2d.shape[1], x2d.dtype)
    per_warp = chunks * CHUNK_BYTES // (
        TILE * torch.empty((), dtype=x2d.dtype).element_size())
    tile_sum = torch.nn.functional.pad(
        tile_sum, (0, cluster * WARPS * per_warp - tiles))
    tile_sum = tile_sum.reshape(rows, cluster, WARPS, per_warp)
    acc = torch.zeros_like(tile_sum[..., 0])
    for k in range(per_warp):
        acc = acc + tile_sum[..., k]
    block = acc[..., 0]
    for w in range(1, WARPS):
        block = block + acc[..., w]
    total = block[:, 0]
    for c in range(1, cluster):
        total = total + block[:, c]
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
    ip = ctypes.POINTER(ctypes.c_int)
    lib.b8_rmsnorm_walk.argtypes = [i, i, ip, ip, ip]
    lib.b8_rmsnorm_walk.restype = i
    lib.mma_rmsnorm_error_string.argtypes = [i]
    lib.mma_rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def cuda_walk(d: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """The walk the CUDA library takes for rows of d columns (to check
    ``walk`` against it on the card)."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.b8_rmsnorm_walk(d, _DTYPES[dtype], *map(ctypes.byref, vals))
    if rc:
        raise ValueError(f"b8_rmsnorm_walk refused d={d} {dtype}")
    return tuple(v.value for v in vals)


def rmsnorm_cuda(x2d: torch.Tensor, weight: torch.Tensor, *,
                 eps: float = 1e-6,
                 weight_offset: float = 0.0) -> torch.Tensor:
    """B8 on a contiguous (rows, d) f32 / bf16 CUDA tensor and d weights
    on the same card.  Returns a new tensor of x2d's dtype and shape;
    one launch, checked.  x2d is read where it lies, aligned or not.
    The host work per call is kept small: at a decode step it, not the
    card, sets the time."""
    dev = x2d.device
    code = _DTYPES.get(x2d.dtype)
    if code is None or dev.type != "cuda":
        raise ValueError(f"B8 takes an f32 or bf16 CUDA tensor, got "
                         f"{x2d.dtype} on {dev}")
    _build.need_memory("B8", x2d, weight)
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"B8 takes a contiguous (rows, d) tensor, got "
                         f"shape {tuple(x2d.shape)}")
    rows, d = x2d.shape
    if weight.numel() != d or weight.device != dev:
        raise ValueError(f"weight must hold d={d} values on {dev}, "
                         f"got {weight.numel()} on {weight.device}")
    if d >= 2 ** 31:
        raise ValueError(f"d={d} is not below 2^31")
    out = torch.empty_like(x2d)
    if rows == 0 or d == 0:
        return out
    w = weight
    if w.dtype != ACCUM_DTYPE or not w.is_contiguous():
        w = w.to(ACCUM_DTYPE).contiguous()
    if w.data_ptr() % 16:   # the weights' 16-byte loads (d f32 values)
        w = w.clone()
    lib = _lib()
    # The raw stream handle: torch.cuda.current_stream(dev).cuda_stream
    # builds a Stream object on every call.
    args = (x2d.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, code,
            float(eps), float(weight_offset),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = lib.b8_rmsnorm(*args)
    else:   # the launch goes to the host thread's current card
        with torch.cuda.device(dev):
            rc = lib.b8_rmsnorm(*args)
    if rc:
        msg = lib.mma_rmsnorm_error_string(rc).decode()
        raise RuntimeError(f"b8_rmsnorm launch failed: {msg} ({rc})")
    LAUNCHES["b8_rmsnorm"] += 1
    return out
