"""Kernels B1-B3: chained ones-MMA reductions on Hopper, each beside its
plain PyTorch version and a launch counter.

The CUDA sources are ``csrc/mma_reduce.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  What each kernel replaces, what bounds
it on the H100 and what its design does about that:

``single_pass_cuda`` (B1) replaces ``repro.kernels.mma_reduce.
mma_reduce_kernel`` (launched by ``single_pass_call``).  Bound: bytes —
each element is read once and a ones-MMA costs 16-32 flops per element,
far under the tensor cores' ~295 flops per byte.  Design: each warp
loads 16 bytes a lane straight from device memory into MMA fragments
(``mma.sync`` m16n8k16 for bf16/fp16; two TF32 words through m16n8k8
for f32), folds its chain in an f32 fragment, collapses in f32 with
warp shuffles, and each block ``atomicAdd``s its total into a zeroed
scalar (the paper's §5.2) in place of the TPU's sequential-grid VMEM
accumulator.  The tail is masked in the kernel, so no padded copy is
made.  The order of the atomics varies, so the last bits do too.

``partials_cuda`` (B2) replaces ``mma_partials_kernel``
(``partials_call``): the same chain per block, one f32 partial per
tile written to its slot — no atomics, deterministic, and the same
partial layout as the reference at the same (chain, block_rows, m).

``split_cuda`` (B3) replaces ``mma_split_kernel`` (``split_call``): the
first ``mma_rows`` rows of each ``block_rows``-row tile go through
ones-MMAs and the rest through CUDA-core f32 adds, in warps of the same
block side by side (the paper's §5.3).  ``mma_rows`` is rounded to the
16-row chain link, not the TPU's 8-row sublane.

The ``*_plain`` functions take the reference's zero-padded ``(T, m)``
tile array and compute the same function in plain PyTorch; the wrappers
in ``kernels.ops`` use them for tensors on the CPU, and only there.
``LAUNCHES`` counts the kernel launches, one per launch, by kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.kernels import _build

M = 16                 # the chain link: 16 x 16 tiles
MAX_BLOCK_ROWS = 512   # 2 * block_rows threads <= 1024 per block

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DTYPES = tuple(_DTYPES)

LAUNCHES = {"b1_single_pass": 0, "b2_partials": 0, "b3_split": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def block_rows_ok(block_rows: int) -> bool:
    """Whether the kernels take this ``block_rows``: a multiple of the
    16-row link, at most ``MAX_BLOCK_ROWS`` (one warp per 16 rows)."""
    return block_rows % M == 0 and M <= block_rows <= MAX_BLOCK_ROWS


def mma_rows_for(block_rows: int, mma_fraction: float) -> int:
    """B3's MMA share of a tile, rounded to whole 16-row links."""
    rows = int(round(mma_fraction * block_rows / M)) * M
    return max(0, min(block_rows, rows))


# ------------------------------------------------------ plain versions


def _tiles(x2d, tile_rows: int):
    rows, m = x2d.shape
    if rows % tile_rows:
        raise ValueError(f"{rows} rows are not a multiple of the "
                         f"{tile_rows}-row tile")
    return x2d.reshape(rows // tile_rows, tile_rows, m)


def partials_plain(x2d, *, chain: int, block_rows: int,
                   square: bool = False) -> torch.Tensor:
    """(G*chain*block_rows, m) -> (G,) f32 per-tile sums (B2's function;
    ``square=True`` squares in the input dtype first, as B1 does)."""
    t = _tiles(x2d, chain * block_rows)
    if square:
        t = t * t
    return torch.sum(t.reshape(t.shape[0], -1), dim=1, dtype=ACCUM_DTYPE)


def single_pass_plain(x2d, *, chain: int, block_rows: int,
                      square: bool = False) -> torch.Tensor:
    """(G*chain*block_rows, m) -> f32 scalar (B1's function)."""
    return torch.sum(partials_plain(x2d, chain=chain,
                                    block_rows=block_rows, square=square))


def split_plain(x2d, *, block_rows: int, mma_rows: int) -> torch.Tensor:
    """(G*block_rows, m) -> f32 scalar: the first ``mma_rows`` rows of
    every tile and the rest summed into two f32 accumulators, added at
    the end (B3's function)."""
    t = _tiles(x2d, block_rows)
    mma = torch.sum(t[:, :mma_rows], dtype=ACCUM_DTYPE)
    vpu = torch.sum(t[:, mma_rows:], dtype=ACCUM_DTYPE)
    return mma + vpu


# ------------------------------------------------------- CUDA kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_reduce")
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.b1_single_pass.argtypes = [ptr, ll, i, i, i, i, ptr, ptr]
    lib.b2_partials.argtypes = [ptr, ll, i, i, i, ptr, ptr]
    lib.b3_split.argtypes = [ptr, ll, i, i, i, ptr, ptr]
    for fn in (lib.b1_single_pass, lib.b2_partials, lib.b3_split):
        fn.restype = i
    lib.mma_reduce_error_string.argtypes = [i]
    lib.mma_reduce_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, block_rows: int, chain: int = 1) -> None:
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernel takes a CUDA tensor, got "
                         f"one on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not in {DTYPES}")
    if x.dim() != 1 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous 1-D tensor "
                         "aligned to 16 bytes")
    if not block_rows_ok(block_rows):
        raise ValueError(f"block_rows={block_rows} is not a multiple of "
                         f"{M} in [{M}, {MAX_BLOCK_ROWS}]")
    if chain < 1:
        raise ValueError(f"chain={chain} must be >= 1")


def _launch(name: str, fn, x, *args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), x.numel(), _DTYPES[x.dtype], *args, stream)
    if rc:
        msg = _lib().mma_reduce_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def single_pass_cuda(x, *, chain: int, block_rows: int,
                     square: bool = False) -> torch.Tensor:
    """B1: f32 sum (``square=True``: sum of squares) of a flat CUDA
    tensor.  Returns a 0-d f32 tensor on x's device."""
    _check(x, block_rows, chain)
    out = torch.zeros(1, dtype=ACCUM_DTYPE, device=x.device)
    _launch("b1_single_pass", _lib().b1_single_pass, x, chain,
            block_rows, int(square), out.data_ptr())
    return out[0]


def partials_cuda(x, *, chain: int, block_rows: int) -> torch.Tensor:
    """B2: one f32 partial per tile of ``chain * block_rows * 16``
    elements of a flat CUDA tensor.  Returns shape (G,)."""
    _check(x, block_rows, chain)
    tile = chain * block_rows * M
    out = torch.empty(max(-(-x.numel() // tile), 1), dtype=ACCUM_DTYPE,
                      device=x.device)
    _launch("b2_partials", _lib().b2_partials, x, chain, block_rows,
            out.data_ptr())
    return out


def split_cuda(x, *, block_rows: int, mma_rows: int) -> torch.Tensor:
    """B3: f32 sum of a flat CUDA tensor, the first ``mma_rows`` rows of
    each ``block_rows``-row tile through ones-MMAs, the rest through
    CUDA-core adds.  Returns a 0-d f32 tensor."""
    _check(x, block_rows)
    if mma_rows % M or not 0 <= mma_rows <= block_rows:
        raise ValueError(f"mma_rows={mma_rows} must be a multiple of {M} "
                         f"in [0, block_rows]")
    out = torch.zeros(1, dtype=ACCUM_DTYPE, device=x.device)
    _launch("b3_split", _lib().b3_split, x, block_rows, mma_rows,
            out.data_ptr())
    return out[0]
