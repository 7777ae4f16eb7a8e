"""Kernel B7: the segmented sum against a factored in-register one-hot
on Hopper, beside its plain PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_segment.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  ``segment_cuda`` replaces
``repro.kernels.mma_scan.mma_segment_sum_kernel`` (launched by
``segment_sum_call``).  Bound: bytes (ids and values read once a pass,
6-8 bytes an element); the tensor cores take one MMA per group of 16
elements, bf16 word and block of 128 segments that the group's ids hit.
Design: the one-hot of ``u = id - base`` is the outer product of ``u
mod 16`` (the A operand, the same for every block) and ``u / 16`` (a
mask on the B operand's word columns), so one ``m16n8k16`` covers 128
segments; each warp streams 256-element steps through its own ring of
shared-memory stages filled by 1-D TMA copies.  The TPU folded each
tile into a (1, S) VMEM accumulator on a sequential grid; blocks on the
H100 run in no order, so each warp keeps its own f32 sums (registers up
to two blocks of segments, shared memory past that), each block writes
one partial per segment, and a second launch sums the (G, S) partials
per column in a fixed order: deterministic, no float atomics.  The
TPU's mask budget, which clamped ``block_rows``, becomes the limit that
227 KB of shared memory beside the rings sets on those sums
(``pass_segments``); a larger S runs in passes of segments, each
re-reading the input.

``segment_plain`` computes the same function in plain PyTorch with the
kernel's decomposition: the same assignment of 256-element steps to
warps and blocks, a warp's words folded per element (the three bf16
words of an f32 value rebuild it exactly, as they do inside the
kernel's MMA chain), per-warp sums added over a block's warps in order,
and the kernel's fixed-order column sum (32 strided runs, then a
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

from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.mma_reduce import _DTYPES, M, _check

LAUNCHES = {"b7_segment_sum": 0}

# Elements a warp takes per step (16 groups of 16), and the warps the
# grid holds per streaming multiprocessor (32 at the kernel's 64
# registers a thread).
SLAB = 16 * M
WARPS_PER_SM = 32
# Streaming multiprocessors of the H100 SXM: the grid the plain version
# assumes for a CPU tensor, so the CPU runs the card's decomposition.
H100_SMS = 132
# Shared memory one block may use on Hopper (227 KB, opt-in dynamic).
SMEM_PER_BLOCK = 232448
# The kernel's rings (csrc/mma_segment.cu kStages, kRingBytes): up to
# STAGES steps a warp, fewer (2 at least) where a block's rings would
# pass RING_BYTES; beside them each warp's operands of a step (per 4
# elements their packed ids and their values, f32 as three bf16 words).
STAGES = 2
RING_BYTES = 98304
# Segments one MMA covers, and the blocks of them one pass takes at most
# (the kernel's column keys stay positive normal floats up to there).
BLOCK_SEGMENTS = 128
MAX_PASS_BLOCKS = 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ring_bytes(dtype: torch.dtype, block_rows: int) -> int:
    """Shared-memory bytes of a block's rings, their mbarriers and its
    warps' operands (the kernel's ``ring_bytes``)."""
    warps = block_rows // M
    step = SLAB * (4 + torch.empty((), dtype=dtype).element_size())
    stages = min(max(RING_BYTES // (warps * step), 2), STAGES)
    operands = SLAB // 4 * (32 if dtype == torch.float32 else 16)
    return warps * (stages * step + operands) \
        + -(-warps * stages * 8 // 16) * 16


def pass_segments(dtype: torch.dtype, block_rows: int) -> int:
    """Segments one pass of the kernel takes: whole 128-segment blocks
    whose per-warp f32 sums fit a block's shared memory beside its rings,
    at most MAX_PASS_BLOCKS of them.  A larger S runs in passes, each
    re-reading the input."""
    warps = block_rows // M
    fit = (SMEM_PER_BLOCK - ring_bytes(dtype, block_rows)) \
        // (4 * warps * BLOCK_SEGMENTS)
    return min(fit, MAX_PASS_BLOCKS) * BLOCK_SEGMENTS


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grid_blocks(n: int, block_rows: int, device) -> int:
    """Blocks of the kernel's grid: WARPS_PER_SM warps per SM, no more
    than the input's steps fill."""
    device = torch.device(device)
    sms = _sms(device.index if device.index is not None
               else torch.cuda.current_device()) \
        if device.type == "cuda" else H100_SMS
    warps = block_rows // M
    per_sm = max(1, WARPS_PER_SM // warps)
    return max(1, min(per_sm * sms, -(-n // (SLAB * warps))))


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
    # A warp's words of an element fold back into the value exactly.
    x = values.reshape(-1).to(ACCUM_DTYPE)
    ids = ids.reshape(-1)
    valid = (ids >= 0) & (ids < s)
    warp = torch.arange(n, device=dev) // SLAB % (blocks * warps)
    key = (warp * s + ids.to(torch.int64))[valid]
    per_warp = torch.zeros(blocks * warps * s, dtype=ACCUM_DTYPE, device=dev)
    per_warp.index_add_(0, key, x[valid])
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
    lib.b7_ring_bytes.argtypes = [i, i]
    lib.b7_ring_bytes.restype = i
    lib.mma_segment_error_string.argtypes = [i]
    lib.mma_segment_error_string.restype = ctypes.c_char_p
    return lib


def segment_cuda(values, ids, num_segments: int, *, block_rows: int,
                 blocks: int | None = None) -> torch.Tensor:
    """B7: the f32 segmented sum of a flat f32 / bf16 / fp16 CUDA tensor
    by a flat int32 CUDA tensor of ids (16-byte aligned, contiguous, as
    many as values).  Returns shape (S,) f32 on values' device; one
    launch per pass of segments and one column sum (which writes every
    segment), each checked."""
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
    dev = values.device
    if n == 0 or s == 0:
        return torch.zeros(s, dtype=ACCUM_DTYPE, device=dev)
    if blocks is None:
        blocks = grid_blocks(n, block_rows, dev)
    out = torch.empty(s, dtype=ACCUM_DTYPE, device=dev)
    partials = torch.empty(blocks * s, dtype=ACCUM_DTYPE, device=dev)
    lib = _lib()
    # The raw stream handle: torch.cuda.current_stream().cuda_stream
    # builds a Stream object on every call.
    call = (values.data_ptr(), ids.data_ptr(), n, _DTYPES[values.dtype], s,
            block_rows, blocks, partials.data_ptr(), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = lib.b7_segment_sum(*call)
    else:   # the launch goes to the host thread's current card
        with torch.cuda.device(dev):
            rc = lib.b7_segment_sum(*call)
    if rc:
        msg = lib.mma_segment_error_string(rc).decode()
        raise RuntimeError(f"b7_segment_sum launch failed: {msg} ({rc})")
    LAUNCHES["b7_segment_sum"] += 1
    return out


def passes(num_segments: int, dtype: torch.dtype, block_rows: int) -> int:
    """Reads of the input one call makes: one per pass of segments."""
    return max(1, math.ceil(int(num_segments)
                            / pass_segments(dtype, block_rows)))
