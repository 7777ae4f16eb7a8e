"""Kernel B7: the segmented sum against an in-register one-hot on Hopper,
beside its plain PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_segment.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  ``segment_cuda`` replaces
``repro.kernels.mma_scan.mma_segment_sum_kernel`` (launched by
``segment_sum_call``).  Bound: bytes (ids and values read once, 6-8
bytes an element) up to S of about 128 segments in f32, tensor-core
flops (16 * S an element) above; the simple form here is bound by the
instructions it issues per group of 16 elements (loads, word split,
one-hot keys) and per 16-segment tile (packed compares, the MMA, the
adds).  Design: the TPU
folded each tile into a (1, S) VMEM accumulator on a sequential grid;
blocks on the H100 run in no order, so each warp keeps its own f32
slots per (word, segment) in shared memory, each block writes one
partial per segment, and a second launch sums the (G, S) partials per
column in a fixed order: deterministic, no float atomics.  The TPU's
mask budget, which clamped ``block_rows``, becomes the limit that 227 KB
of shared memory sets on those slots (``pass_segments``); a larger S
runs in passes of segments, each re-reading the input.

``segment_plain`` computes the same function in plain PyTorch with the
kernel's decomposition: the same three-word split of f32 values, the
same assignment of 256-element slabs to warps and blocks, per-warp word
sums combined as ``(hi + mid) + lo`` and added over a block's warps in
order, and the kernel's fixed-order column sum (32 strided runs, then a
butterfly).  Kernel and plain version differ only in the order of the
f32 adds inside a warp.  The wrapper ``kernels.ops.mma_segment_sum``
uses it for CPU tensors, and only there.  ``LAUNCHES`` counts the
wrapper's launches, one per call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.precision import ACCUM_DTYPE, split_f32_words
from repro_torch.kernels import _build
from repro_torch.kernels.mma_reduce import _DTYPES, M, _check

LAUNCHES = {"b7_segment_sum": 0}

# Elements a warp takes per step (16 groups of 16), and the blocks the
# grid holds per streaming multiprocessor.
SLAB = 16 * M
BLOCKS_PER_SM = 4
# Streaming multiprocessors of the H100 SXM: the grid the plain version
# assumes for a CPU tensor, so the CPU runs the card's decomposition.
H100_SMS = 132
# Shared memory one block may use on Hopper (227 KB, opt-in dynamic).
SMEM_PER_BLOCK = 232448
# Tiles of 16 segments one pass takes at most: the kernel keys its
# one-hot by tile in 16-bit floats, which hold integers exactly to 256.
MAX_PASS_TILES = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def words_of(dtype: torch.dtype) -> int:
    """bf16 words per value: three for f32, the value itself for 16 bits."""
    return 3 if dtype == torch.float32 else 1


def pass_segments(dtype: torch.dtype, block_rows: int) -> int:
    """Segments one pass of the kernel takes: whole 16-segment tiles
    whose per-warp f32 slots (warps x words x S) fit a block's shared
    memory, at most MAX_PASS_TILES of them.  A larger S runs in passes,
    each re-reading the input."""
    warps = block_rows // M
    tiles = SMEM_PER_BLOCK // (4 * warps * words_of(dtype)) // M
    return min(tiles, MAX_PASS_TILES) * M


def grid_blocks(n: int, block_rows: int, device) -> int:
    """Blocks of the kernel's grid: a few per SM, no more than the
    input's slabs fill."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else H100_SMS
    warps = block_rows // M
    return max(1, min(BLOCKS_PER_SM * sms, -(-n // (SLAB * warps))))


def _column_sums(partials: torch.Tensor) -> torch.Tensor:
    """The kernel's column sum of (G, S) partials: lane l of 32 adds rows
    l, l + 32, ... in order, then five butterfly steps (lane ^ 16, ^ 8,
    ... ^ 1); lane 0's value."""
    g, s = partials.shape
    rows = -(-g // 32) * 32
    runs = torch.nn.functional.pad(partials, (0, 0, 0, rows - g))
    runs = runs.reshape(rows // 32, 32, s)
    lanes = runs[0]
    for r in range(1, rows // 32):
        lanes = lanes + runs[r]
    idx = torch.arange(32, device=partials.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ o]
    return lanes[0]


def segment_plain(values, ids, num_segments: int, *, block_rows: int,
                  blocks: int) -> torch.Tensor:
    """B7's function in plain PyTorch: the f32 segmented sum of flat
    ``values`` (f32 / bf16 / fp16) by flat integer ``ids``, shape (S,);
    an id outside [0, S) adds nothing."""
    s = int(num_segments)
    n = values.numel()
    dev = values.device
    warps = block_rows // M
    if n == 0 or s == 0:
        return torch.zeros(s, dtype=ACCUM_DTYPE, device=dev)
    words = split_f32_words(values, 3) if values.dtype == torch.float32 \
        else [values]
    ids = ids.reshape(-1)
    valid = (ids >= 0) & (ids < s)
    slab = torch.arange(n, device=dev) // SLAB
    warp = slab % (blocks * warps)
    key = (warp * s + ids.to(torch.int64))[valid]
    slots = torch.zeros(len(words), blocks * warps * s, dtype=ACCUM_DTYPE,
                        device=dev)
    for w, word in enumerate(words):
        slots[w].index_add_(0, key, word.reshape(-1)[valid].to(ACCUM_DTYPE))
    per_warp = slots[0]
    for w in range(1, len(words)):
        per_warp = per_warp + slots[w]
    per_warp = per_warp.reshape(blocks, warps, s)
    partials = per_warp[:, 0]
    for w in range(1, warps):
        partials = partials + per_warp[:, w]
    return _column_sums(partials)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_segment")
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.b7_segment_sum.argtypes = [ptr, ptr, ll, i, i, i, i, ptr, ptr, ptr]
    lib.b7_segment_sum.restype = i
    lib.b7_pass_segments.argtypes = [i, i]
    lib.b7_pass_segments.restype = i
    lib.mma_segment_error_string.argtypes = [i]
    lib.mma_segment_error_string.restype = ctypes.c_char_p
    return lib


def segment_cuda(values, ids, num_segments: int, *, block_rows: int,
                 blocks: int | None = None) -> torch.Tensor:
    """B7: the f32 segmented sum of a flat f32 / bf16 / fp16 CUDA tensor
    by a flat int32 CUDA tensor of ids (16-byte aligned, contiguous, as
    many as values).  Returns shape (S,) f32 on values' device; one
    launch per pass of segments and one column sum, each checked."""
    _check(values, block_rows)
    s = int(num_segments)
    n = values.numel()
    if ids.device != values.device or ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32 on {values.device}, got "
                         f"{ids.dtype} on {ids.device}")
    if ids.dim() != 1 or ids.numel() != n or not ids.is_contiguous() \
            or ids.data_ptr() % 16:
        raise ValueError("ids must be a contiguous 1-D tensor aligned to "
                         "16 bytes, one id per value")
    if not 0 <= s < 2 ** 31:
        raise ValueError(f"num_segments={s} is not in [0, 2^31)")
    out = torch.zeros(s, dtype=ACCUM_DTYPE, device=values.device)
    if n == 0 or s == 0:
        return out
    if blocks is None:
        blocks = grid_blocks(n, block_rows, values.device)
    partials = torch.empty(blocks * s, dtype=ACCUM_DTYPE,
                           device=values.device)
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.b7_segment_sum(values.data_ptr(), ids.data_ptr(), n,
                                _DTYPES[values.dtype], s, block_rows,
                                blocks, partials.data_ptr(), out.data_ptr(),
                                stream)
    if rc:
        msg = lib.mma_segment_error_string(rc).decode()
        raise RuntimeError(f"b7_segment_sum launch failed: {msg} ({rc})")
    LAUNCHES["b7_segment_sum"] += 1
    return out


def passes(num_segments: int, dtype: torch.dtype, block_rows: int) -> int:
    """Reads of the input one call makes: one per pass of segments."""
    return max(1, math.ceil(int(num_segments)
                            / pass_segments(dtype, block_rows)))
