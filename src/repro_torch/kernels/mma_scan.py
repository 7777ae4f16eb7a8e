"""Kernel B6: the chained triangular-MMA prefix scan on Hopper, beside
its plain PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_scan.cu`` (``sm_90a``, bound through ctypes
by ``kernels._build``).  ``scan_cuda`` replaces
``repro.kernels.mma_scan.mma_scan_kernel`` (launched by ``scan_call``).
Bound: bytes — the function reads its input once and writes f32 once,
and spends 32-48 tensor-core flops per element.  Design: the TPU carried
the running total across a sequential grid in VMEM; blocks on the H100
run in no order, so one launch does it with a decoupled look-back.  A
block takes its tile from an atomic ticket, keeps the tile in shared
memory, forms ``P = X x U_16`` on the tensor cores with the row and slab
carries in f32 on the CUDA cores, publishes its tile total, finds its
tile carry by looking back at its predecessors' published states, and
writes the outputs from the tile it still holds: one read and one write.
The tile carries are a compensated left fold over the tile totals in
tile order (``fold_carries``), folded forward from whichever published
state the look-back finds, so they are the same bits on every run.  No
float atomics.

``scan_plain`` computes the same function in plain PyTorch, with the
kernel's decomposition of the reference's tile walk (``P = X x U_m``,
row carries ``L' t``, a running tile carry): the row carries split into
one exclusive scan over each slab's 16 rows and one over the tile's
slabs, and the tile carries are the kernel's fold.  So kernel and plain
version differ only in the order of the f32 adds inside a tile.  The
wrapper ``kernels.ops.mma_scan`` uses it for CPU tensors, and only
there.  ``LAUNCHES`` counts the wrapper's launches, one per call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.core.reduction import _mm
from repro_torch.kernels import _build
from repro_torch.kernels.mma_reduce import (_DTYPES, M, _check,  # noqa: F401
                                            block_rows_ok)

LAUNCHES = {"b6_scan": 0}
# The longest chain the kernel takes: its slab carries (chain x warps
# floats) stay in shared memory.
MAX_CHAIN = 1024
# 32-bit words of the kernel's scratch: a header (the ticket counter,
# the newest published tile, a count of look-back steps), then one word
# per tile for its total (padded to an even count) and two for its
# inclusive state.
_HEADER_WORDS = 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _shift(incl):
    """Inclusive -> exclusive along the last axis (a leading zero)."""
    return torch.nn.functional.pad(incl[..., :-1], (1, 0))


def fold_states(totals: np.ndarray) -> tuple:
    """The compensated left fold over f32 tile totals a_0 .. a_{G-1}, in
    tile order: ``S_i = fl(S_{i-1} + a_i)`` and ``c_i = fl(c_{i-1} +
    e_i)``, with ``e_i`` the exact error of that add (TwoSum) and
    ``S_{-1} = c_{-1} = 0``.  Returns (S, c), f32 arrays of G + 1 states
    whose first is (0, 0).  ``np.add.accumulate`` adds in order, one f32
    rounding a step, so the fold takes four array passes on the host."""
    a = np.concatenate([np.zeros(1, np.float32),
                        np.asarray(totals, np.float32)])
    with np.errstate(all="ignore"):
        s = np.add.accumulate(a, dtype=np.float32)
        prev = np.concatenate([np.zeros(1, np.float32), s[:-1]])
        bp = s - prev
        e = (prev - (s - bp)) + (a - bp)
        e[0] = 0.0
        c = np.add.accumulate(e, dtype=np.float32)
    return s, c


def carry_of(s, c):
    """The carry a fold state (S, c) hands the next tile: fl(S + c), or
    S once a total is infinite or NaN (then c is NaN)."""
    with np.errstate(all="ignore"):
        return np.where(np.isnan(c), s, s + c).astype(np.float32)


def fold_carries(totals: torch.Tensor) -> torch.Tensor:
    """Kernel B6's exclusive tile carries: the carry of each state of
    ``fold_states`` before the tile, as f32 on the totals' device."""
    s, c = fold_states(totals.detach().to("cpu", ACCUM_DTYPE).numpy())
    return torch.from_numpy(carry_of(s[:-1], c[:-1])).to(totals.device)


def scan_parts(x, *, chain: int, block_rows: int) -> tuple:
    """The tile-local half of B6 in plain PyTorch: ``p`` (tile, slab,
    row, column; slabs in link-then-warp order) = P = X x U_16, ``carry``
    (tile, slab, row) = slab carry + row carry, and the (G,) f32 tile
    totals."""
    n = x.numel()
    tile = chain * block_rows * M
    groups = max(math.ceil(n / tile), 1)
    flat = torch.nn.functional.pad(x.reshape(-1), (0, groups * tile - n))
    u = torch.triu(torch.ones(M, M, dtype=flat.dtype, device=flat.device))
    p = _mm(flat.reshape(-1, M), u).reshape(groups, -1, M, M)
    rows = torch.cumsum(p[..., -1], dim=-1)            # (G, S, 16)
    slabs = _shift(torch.cumsum(rows[..., -1], dim=-1))
    tile_totals = slabs[:, -1] + rows[:, -1, -1]
    return p, slabs[..., None] + _shift(rows), tile_totals


def assemble(p, carry, tiles, n: int, inclusive: bool = True):
    """B6's outputs from ``scan_parts`` and the (G,) tile carries, in
    the kernel's order of adds: (P + row carry) + tile carry."""
    out = (p + carry[..., None]) + tiles[:, None, None, None]
    out = out.reshape(-1)[:n]
    return out if inclusive else _shift(out)


def scan_plain(x, *, chain: int, block_rows: int,
               inclusive: bool = True) -> torch.Tensor:
    """B6's function in plain PyTorch: the f32 prefix sum of a flat
    tensor (exclusive when ``inclusive=False``), shape (n,)."""
    p, carry, totals = scan_parts(x, chain=chain, block_rows=block_rows)
    return assemble(p, carry, fold_carries(totals), x.numel(), inclusive)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_scan")
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.b6_scan.argtypes = [ptr, ll, i, i, i, i, ptr, ptr, ptr]
    lib.b6_scan.restype = i
    lib.mma_scan_error_string.argtypes = [i]
    lib.mma_scan_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, chain: int, block_rows: int, inclusive: bool) -> tuple:
    """One B6 launch: (out, scratch), after the scratch's zeroing."""
    _check(x, block_rows, chain)
    if chain > MAX_CHAIN:
        raise ValueError(f"chain={chain} exceeds B6's {MAX_CHAIN}")
    dev = x.device
    groups = max(-(-x.numel() // (chain * block_rows * M)), 1)
    scratch = torch.zeros(_HEADER_WORDS + groups + groups % 2 + 2 * groups,
                          dtype=torch.int32, device=dev)
    out = torch.empty(x.numel(), dtype=ACCUM_DTYPE, device=dev)
    lib = _lib()
    # The raw stream handle: torch.cuda.current_stream(dev).cuda_stream
    # builds a Stream object on every call.
    args = (x.data_ptr(), x.numel(), _DTYPES[x.dtype], chain, block_rows,
            int(not inclusive), scratch.data_ptr(), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = lib.b6_scan(*args)
    else:   # the launch goes to the host thread's current card
        with torch.cuda.device(dev):
            rc = lib.b6_scan(*args)
    if rc:
        msg = lib.mma_scan_error_string(rc).decode()
        raise RuntimeError(f"b6_scan launch failed: {msg} ({rc})")
    LAUNCHES["b6_scan"] += 1
    return out, scratch


def scan_cuda(x, *, chain: int, block_rows: int,
              inclusive: bool = True) -> torch.Tensor:
    """B6: the f32 prefix sum of a flat f32 / bf16 / fp16 CUDA tensor
    (exclusive when ``inclusive=False``).  Returns shape (n,) f32 on
    x's device: the scratch's zeroing and one checked launch on the
    current stream."""
    return _launch(x, chain, block_rows, inclusive)[0]


def look_back_steps(x, *, chain: int, block_rows: int) -> float:
    """One B6 call's forward look-back steps per tile after the first
    (each reads up to 256 published totals at once; more than one means
    a walk waited or started far back), from the count the kernel
    keeps in its scratch.  Synchronizes."""
    _, scratch = _launch(x, chain, block_rows, True)
    groups = (scratch.numel() - _HEADER_WORDS) // 3
    return int(scratch[2]) / max(groups - 1, 1)
