"""Kernel B10: fused RMSNorm -> matmul on Hopper, its row statistic a
ones-MMA, beside its plain PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_norm_matmul.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  ``norm_matmul_cuda`` replaces
``repro.kernels.mma_norm_matmul._nm_kernel`` (launched by ``_nm_call``
and ``mma_norm_matmul``): one walk over k gives the row sum of squares
of the raw x and the unnormalised ``(x * (1 + scale)) @ w`` (and
``@ w_gate``), and the epilogue scales by ``rstd``, adds the bias and
applies ``act(g) * up``.  Bound: operations at the models' widths
(2 rows d dout flops per projection), bytes at decode (the weights).
Design: a block owns 128 rows and 64 columns of the combined projection
(32 of up beside the same 32 of the gate), walks k in steps of 32 in a
loop with only its tile's accumulator (so no d limit from shared
memory), and multiplies in 3xTF32 on m16n8k8 (two TF32 words of
``x * (1 + scale)`` and of an f32 weight; a bf16 weight is exact in
one), each step's MMAs from zero and added to the running sum on the
CUDA cores; its warps compute the statistic as B8 does, from the x tiles
the block already holds.  No atomics and no split-k: the same bits on
every call, whatever the number of rows.

``norm_matmul_plain`` computes the same function in plain PyTorch with
the kernel's decomposition: the same f32 squares as exact bf16 words,
each 16-column tile's word sums through f32 matmuls against ones,
``(hi + mid) + lo`` per tile, the tiles added in k order; the same TF32
words of ``x * (1 + scale)`` and the weights, each 32-column step's
products through one f32 matmul and added to the running sum in step
order.  Kernel and plain version differ in the order of the adds inside
an MMA and a matmul, and in ``rsqrt``'s and the activations' last bits.
The wrapper ``kernels.ops.mma_norm_matmul`` uses it for CPU tensors, and
only there.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.precision import ACCUM_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.mma_rmsnorm import tile_sums_plain

LAUNCHES = {"b10_norm_matmul": 0}

# k per step of the block's loop (csrc kBK): one running-sum add each.
STEP = 32
# A block's tile (csrc kBM x kBN): 128 rows and 64 columns of the
# combined projection (32 output columns beside their 32 gate columns
# with a gate); blocks are ordered in groups of GROUP row tiles.
BLOCK_ROWS, BLOCK_COLS, GROUP = 128, 64, 16
_INT_MAX = 2 ** 31 - 1
# Dtypes the kernel takes for x and for the weights, with its codes.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "silu": 1, "gelu": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def apply_act(g: torch.Tensor, act) -> torch.Tensor:
    if act is None:
        return g
    if act == "silu":
        return F.silu(g)
    if act == "gelu":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown norm_matmul act: {act!r}")


def refusal(rows: int, d: int, dout: int, gate: bool, weights: tuple):
    """Why B10 cannot take a problem, or None.  It takes f32 and bf16
    weights (``weights``: their dtype names).  Its shared memory does not
    grow with d or dout (it walks k in STEP-column steps and holds one
    tile's accumulator), so only its int indices bound them: d and dout,
    its ceil(rows / 128) x ceil(dout / cols) blocks and a group's
    GROUP x ceil(dout / cols) blocks must stay below 2^31."""
    bad = [w for w in weights if w not in ("float32", "bfloat16")]
    if bad:
        return f"kernel B10 takes f32 and bf16 weights, got {bad[0]}"
    col_tiles = -(-dout // (BLOCK_COLS // 2 if gate else BLOCK_COLS))
    blocks = -(-rows // BLOCK_ROWS) * col_tiles
    if max(d, dout, blocks, GROUP * col_tiles) > _INT_MAX:
        return (f"d={d}, dout={dout} with {rows} rows exceed kernel B10's "
                f"int indexing (d, dout and its {blocks} blocks below "
                f"2^31)")
    return None


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 fraction bits), to nearest with
    ties away from zero: ``cvt.rna.tf32.f32`` with the low 13 bits
    cleared, as the kernel feeds its MMAs."""
    bits = x.to(ACCUM_DTYPE).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(ACCUM_DTYPE)


def tf32_words(x: torch.Tensor) -> tuple:
    """(hi, lo): ``hi = rna(x)``, ``lo = rna(x - hi)``, 22 bits of x."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.to(ACCUM_DTYPE) - hi)


def row_sums_plain(x2d: torch.Tensor) -> torch.Tensor:
    """The kernel's statistic: f32 sum of squares per row, (rows,), B8's
    16-column tile sums added in k order."""
    tile_sum = tile_sums_plain(x2d)
    total = tile_sum[:, 0]
    for k in range(1, tile_sum.shape[1]):
        total = total + tile_sum[:, k]
    return total


def _project(xs_words: tuple, w: torch.Tensor) -> torch.Tensor:
    """``xs @ w`` in the kernel's 3xTF32 form: per 32-column step one f32
    matmul of lo(xs)·hi(w) + hi(xs)·lo(w) + hi(xs)·hi(w) (no lo(w) for a
    bf16 w), each step's sum added to the running f32 sum in order."""
    xs_hi, xs_lo = xs_words
    w_hi, w_lo = tf32_words(w)
    if w.dtype == torch.bfloat16:
        a_parts, b_parts = (xs_lo, xs_hi), (w_hi, w_hi)
    else:
        a_parts, b_parts = (xs_hi, xs_lo, xs_hi), (w_lo, w_hi, w_hi)
    acc = None
    for k0 in range(0, xs_hi.shape[1], STEP):
        k = slice(k0, k0 + STEP)
        part = torch.matmul(torch.cat([a[:, k] for a in a_parts], dim=1),
                            torch.cat([b[k] for b in b_parts], dim=0))
        acc = part if acc is None else acc + part
    return acc


def norm_matmul_plain(x2d: torch.Tensor, scale: torch.Tensor,
                      w: torch.Tensor, *, w_gate=None, bias=None, act=None,
                      eps: float = 1e-6) -> torch.Tensor:
    """B10's function in plain PyTorch: x2d (rows, d) of any float dtype,
    scale (d,), w / w_gate (d, dout), bias (dout,) -> (rows, dout) in
    x2d.dtype."""
    d = x2d.shape[-1]
    rstd = torch.rsqrt(row_sums_plain(x2d) / d + eps)[:, None]
    s1 = 1.0 + scale.to(ACCUM_DTYPE).reshape(1, d)
    xs = tf32_words(x2d.to(ACCUM_DTYPE) * s1)
    up = _project(xs, w) * rstd
    if bias is not None:
        up = up + bias.to(ACCUM_DTYPE)
    if w_gate is not None:
        up = apply_act(_project(xs, w_gate) * rstd, act) * up
    return up.to(x2d.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_norm_matmul")
    ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
    lib.b10_norm_matmul.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ll, i, i,
                                    i, i, i, f, ptr]
    lib.b10_norm_matmul.restype = i
    lib.mma_norm_matmul_error_string.argtypes = [i]
    lib.mma_norm_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _weights(w, w_gate, d: int, device) -> tuple:
    """The kernel's weights: (d, dout), f32 or bf16, contiguous, on x's
    card.  A bf16 gate beside an f32 w (or the reverse) is widened to
    f32, which is exact, so both share one dtype."""
    for name, wi in (("w", w), ("w_gate", w_gate)):
        if wi is None:
            continue
        if wi.dtype not in _DTYPES or wi.device != device:
            raise ValueError(f"B10 takes {name} in f32 or bf16 on {device}, "
                             f"got {wi.dtype} on {wi.device}")
        if wi.dim() != 2 or wi.shape[0] != d or wi.shape != w.shape:
            raise ValueError(f"{name} must be (d={d}, dout) like w, got "
                             f"{tuple(wi.shape)}")
    if w_gate is not None and w_gate.dtype != w.dtype:
        w, w_gate = w.to(ACCUM_DTYPE), w_gate.to(ACCUM_DTYPE)
    return (w.contiguous(),
            None if w_gate is None else w_gate.contiguous())


def norm_matmul_cuda(x2d: torch.Tensor, scale: torch.Tensor,
                     w: torch.Tensor, *, w_gate=None, bias=None, act=None,
                     eps: float = 1e-6) -> torch.Tensor:
    """B10 on a contiguous (rows, d) f32 / bf16 CUDA tensor, with scale,
    the weights (f32 or bf16, independently of x) and the bias on the
    same card.  Returns a new (rows, dout) tensor of x2d's dtype; one
    launch, checked."""
    if not x2d.is_cuda or x2d.dtype not in _DTYPES:
        raise ValueError(f"B10 takes an f32 or bf16 CUDA tensor, got "
                         f"{x2d.dtype} on {x2d.device}")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"B10 takes a contiguous (rows, d) tensor, got "
                         f"shape {tuple(x2d.shape)}")
    if act not in _ACTS:
        raise ValueError(f"unknown norm_matmul act: {act!r}")
    rows, d = x2d.shape
    w, w_gate = _weights(w, w_gate, d, x2d.device)
    dout = w.shape[1]
    if not 1 <= d < 2 ** 31 or dout >= 2 ** 31:
        raise ValueError(f"B10 takes 1 <= d < 2^31 and dout < 2^31, got "
                         f"d={d}, dout={dout}")
    if scale.numel() != d or scale.device != x2d.device:
        raise ValueError(f"scale must hold d={d} values on {x2d.device}, "
                         f"got {scale.numel()} on {scale.device}")
    if bias is not None and (bias.numel() != dout
                             or bias.device != x2d.device):
        raise ValueError(f"bias must hold dout={dout} values on "
                         f"{x2d.device}, got {bias.numel()} on "
                         f"{bias.device}")
    out = torch.empty(rows, dout, dtype=x2d.dtype, device=x2d.device)
    if rows == 0 or dout == 0:
        return out
    s = scale.reshape(-1).to(ACCUM_DTYPE).contiguous()
    b = None if bias is None \
        else bias.reshape(-1).to(ACCUM_DTYPE).contiguous()
    lib = _lib()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.b10_norm_matmul(
            x2d.data_ptr(), s.data_ptr(), w.data_ptr(),
            None if w_gate is None else w_gate.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), rows, d,
            dout, _DTYPES[x2d.dtype], _DTYPES[w.dtype], _ACTS[act],
            float(eps), stream)
    if rc:
        msg = lib.mma_norm_matmul_error_string(rc).decode()
        raise RuntimeError(f"b10_norm_matmul launch failed: {msg} ({rc})")
    LAUNCHES["b10_norm_matmul"] += 1
    return out
