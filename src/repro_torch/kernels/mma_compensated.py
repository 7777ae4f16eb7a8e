"""Kernels B4 and B5: the compensated (ec) and double-double (dd)
reductions on Hopper, each beside its plain PyTorch version and a launch
counter.

The CUDA source is ``csrc/mma_compensated.cu`` (``sm_90a``, bound
through ctypes by ``kernels._build``).  What each kernel replaces, what
bounds it on the H100 and what its design does about that:

``ec_cuda`` (B4) replaces ``repro.kernels.mma_compensated.mma_ec_kernel``
(launched by ``ec_call``).  Bound: bytes — it reads 4 bytes per element
and spends per bf16 word two f32 ops on the split and one 16-element
ones-MMA row.  Design: the warps load their 16 x 16 slabs as B1 does,
split each value into ``split_words`` round-to-nearest bf16 words in
registers, run one ``mma.sync`` m16n8k16 per word and link from a zero
accumulator, and fold the row sums into per-word lane accumulators
with TwoSum on the CUDA cores, so the tensor cores never add into a
running partial.  Each block writes one (sum, err) pair per word; a
second one-block stage runs the TwoSum tree over all pairs in a fixed
order.  No float atomics: they would round once per block in a varying
order and undo the compensation.

``dd_cuda`` (B5) replaces ``mma_dd_kernel`` (``dd_call``).  Bound: bytes
— 2-8 bytes per element against 3 f64 ops for the split and about 11
f32 ops per ``dd_add``.  Design: CUDA cores only (a tensor-core add is
not ``fl(a + b)``, so a TwoSum residual after it would not be exact);
each element splits in registers into a dd pair (``dd_from_any``), so
the reference's two host-side f32 planes are never built; squares use
TwoProd in its FMA form; pairs merge with ``dd_add`` per thread, warp
and block, then one block merges the blocks' pairs.  Output: the (2,)
f32 pair ``[hi, lo]``.

``ec_plain`` and ``dd_plain`` take the reference's zero-padded
``(T, m)`` tile array and compute the same functions in plain PyTorch,
following the kernels' decomposition (per tile and link the 16-element
row sums, per-word lanes, then the compensated collapse), so a kernel
against its plain version differs only in the order of its adds.  The
wrappers in ``kernels.ops`` use them for CPU tensors, and only there.
``LAUNCHES`` counts the wrappers' launches, one per call, by kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import (ACCUM_DTYPE, compensated_sum,
                                        dd_from_any, split_f32_words,
                                        two_sum)
from repro_torch.core.reduction import _dd_merge_tree, _dd_square
from repro_torch.kernels import _build
from repro_torch.kernels.mma_reduce import M, _check, _tiles

SPLIT_WORDS = (2, 3)     # the split-word counts B4 takes

_DD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.float64: 3}
DD_DTYPES = tuple(_DD_DTYPES)

LAUNCHES = {"b4_ec": 0, "b5_dd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------ plain versions


def ec_plain(x2d, *, chain: int, block_rows: int, split_words: int,
             square: bool = False) -> torch.Tensor:
    """(G*chain*block_rows, m) -> f32 scalar (B4's function): per tile,
    link and word the f32 sums of the 16-element rows, folded over the
    chain with TwoSum into lanes, then the TwoSum tree over every
    lane plus the residuals."""
    t = _tiles(x2d.to(ACCUM_DTYPE), chain * block_rows)
    if square:
        t = t * t
    t = t.reshape(t.shape[0], chain, block_rows, -1)
    lanes, errs = [], []
    for word in split_f32_words(t, split_words):
        rows = torch.sum(word.to(ACCUM_DTYPE), dim=-1)   # (G, chain, B)
        acc, err = rows[:, 0], torch.zeros_like(rows[:, 0])
        for r in range(1, chain):
            acc, e = two_sum(acc, rows[:, r])
            err = err + e
        lanes.append(acc.reshape(-1))
        errs.append(err.reshape(-1))
    return compensated_sum(torch.cat(lanes)) + torch.sum(torch.cat(errs))


def dd_plain(x2d, *, chain: int, block_rows: int,
             square: bool = False) -> torch.Tensor:
    """(G*chain*block_rows, m) in f64 / f32 / bf16 / fp16 -> (2,) f32
    ``[hi, lo]`` (B5's function): elementwise dd pairs (squared with
    ``square=True``), a dd merge tree per tile, then over the tiles."""
    t = _tiles(x2d, chain * block_rows)
    hi, lo = dd_from_any(t.reshape(t.shape[0], -1))
    if square:
        hi, lo = _dd_square(hi, lo)
    hi, lo = _dd_merge_tree(*_dd_merge_tree(hi, lo))
    return torch.stack([hi, lo])


# ------------------------------------------------------- CUDA kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_compensated")
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.b4_ec.argtypes = [ptr, ll, i, i, i, i, ptr, ptr, ptr]
    lib.b5_dd.argtypes = [ptr, ll, i, i, i, i, ptr, ptr, ptr]
    lib.b4_ec.restype = lib.b5_dd.restype = i
    lib.mma_compensated_error_string.argtypes = [i]
    lib.mma_compensated_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, x, *args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), x.numel(), *args, stream)
    if rc:
        msg = _lib().mma_compensated_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _partials(x, chain: int, block_rows: int, pairs_per_block: int):
    blocks = max(-(-x.numel() // (chain * block_rows * M)), 1)
    return torch.empty(2 * pairs_per_block * blocks, dtype=ACCUM_DTYPE,
                       device=x.device)


def ec_cuda(x, *, chain: int, block_rows: int, split_words: int,
            square: bool = False) -> torch.Tensor:
    """B4: compensated f32 sum (``square=True``: sum of squares) of a
    flat f32 CUDA tensor.  Returns a 0-d f32 tensor on x's device."""
    _check(x, block_rows, chain, dtypes=(torch.float32,))
    if split_words not in SPLIT_WORDS:
        raise ValueError(f"split_words={split_words} not in {SPLIT_WORDS}")
    partials = _partials(x, chain, block_rows, split_words)
    out = torch.empty(1, dtype=ACCUM_DTYPE, device=x.device)
    _launch("b4_ec", _lib().b4_ec, x, chain, block_rows, split_words,
            int(square), partials.data_ptr(), out.data_ptr())
    return out[0]


def dd_cuda(x, *, chain: int, block_rows: int,
            square: bool = False) -> torch.Tensor:
    """B5: double-double sum (``square=True``: sum of squares) of a flat
    f64 / f32 / bf16 / fp16 CUDA tensor.  Returns the (2,) f32 pair
    ``[hi, lo]`` on x's device."""
    _check(x, block_rows, chain, dtypes=DD_DTYPES)
    partials = _partials(x, chain, block_rows, 1)
    out = torch.empty(2, dtype=ACCUM_DTYPE, device=x.device)
    _launch("b5_dd", _lib().b5_dd, x, _DD_DTYPES[x.dtype], chain,
            block_rows, int(square), partials.data_ptr(), out.data_ptr())
    return out
