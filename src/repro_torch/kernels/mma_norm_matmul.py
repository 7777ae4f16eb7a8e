"""Kernel B10: fused RMSNorm -> matmul on Hopper, its row statistic a
ones-MMA, beside its plain PyTorch version and launch counters.

The CUDA source is ``csrc/mma_norm_matmul.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  ``norm_matmul_cuda`` replaces
``repro.kernels.mma_norm_matmul._nm_kernel`` (launched by ``_nm_call``
and ``mma_norm_matmul``): the unnormalised ``(x * (1 + scale)) @ w`` (and
``@ w_gate``) scaled by each row's ``rstd`` in the epilogue, with the
bias and ``act(g) * up``; the normalised rows never exist in device
memory.  Bound: operations at the models' widths (2 rows d dout flops
per projection), bytes at decode (the weights).

The tensor cores take bf16 words of the operands (rounded to nearest,
each the rest of the previous), and a product is the sum of the
products of word i of A (x's side) and word j of B (the weights' side)
with i + j < levels.  ``walk`` gives the form, a function of d and the
dtypes alone, never of rows:

- f32 x, f32 w: three words of ``x (1 + scale)`` by three of w, six
  products (about 22 bits a product);
- f32 x, bf16 w: three words of ``x (1 + scale)`` by w itself, three
  products (about 24 bits): f32 x keeps 21 bits whatever the weights;
- bf16 x, bf16 w: two words of ``x (1 + scale)`` by w itself, two
  products (16 bits);
- bf16 x, f32 w: x itself by two words of ``(1 + scale) w``, two
  products (16 bits).

``product_bits`` gives a form's bits from its words.

Every form walks k in steps of 64 columns: a step's products chain from
zero in the tensor cores, and the step's sum is added to the running f32
sum on the CUDA cores.  Up to three launches, each operand's words made
once: the row pass (each row's sum of squares, once, in B8's order,
``mma_rmsnorm.walk``, and from the same loads x's words where the form
splits x), the weight pass (an f32 weight's words), and the projections:
128-row x 128-column tiles of the combined projection (128 output
columns, or 64 of up beside the same 64 of the gate) on ``wgmma`` fed
by TMA from the word planes, two consumer warpgroups and a loading warp.
No atomics and no split of k: the same bits on every call, whatever the
number of rows.

``norm_matmul_plain`` computes the same function in plain PyTorch with
the kernel's decomposition: B8's statistic (``row_sums_plain``), the same
bf16 words, each step's products through one f32 matmul and added to the
running sum in step order.  Kernel and plain version differ in the order
of the adds inside an MMA and a matmul, and in ``rsqrt``'s and the
activations' last bits.  The wrapper ``kernels.ops.mma_norm_matmul``
uses it for CPU tensors, and only there.  ``LAUNCHES`` counts the
kernels' launches: ``b10_rows`` the row pass, ``b10_weights`` the weight
pass, ``b10_norm_matmul`` the projections.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision import ACCUM_DTYPE, split_f32_words
from repro_torch.kernels import _build
from repro_torch.kernels import mma_rmsnorm as _mrn
from repro_torch.kernels.mma_rmsnorm import row_sums_plain

LAUNCHES = {"b10_rows": 0, "b10_weights": 0, "b10_norm_matmul": 0}

# A block's tile (csrc kBM x kBN): 128 rows and 128 columns of the
# combined projection (64 output columns beside their 64 gate columns
# with a gate); blocks are ordered in groups of GROUP row tiles.
BLOCK_ROWS, BLOCK_COLS, GROUP = 128, 128, 16
# k columns a step (csrc kStep), and the column multiple of a word
# plane's row pitch (16 bytes of bf16, as TMA needs).
STEP, PITCH_COLS = 64, 8
_INT_MAX = 2 ** 31 - 1
# Dtypes the kernel takes for x and for the weights, with its codes.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "silu": 1, "gelu": 2}


class Walk(NamedTuple):
    """B10's walk for rows of d columns (csrc ``Form`` and
    ``stat_walk``)."""
    step: int      # k columns a step: its products chain, then one add
    a_words: int   # bf16 words of x's side
    b_words: int   # bf16 words of the weights' side
    levels: int    # products (i, j) with i + j < levels
    fold_w: bool   # 1 + scale multiplies w (else x)
    ranks: int     # the statistic: B8's cluster of runs
    chunks: int    # ... and its 128-byte chunks a run


@functools.cache
def walk(d: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> Walk:
    """The walk of a row of d columns for x and weights of these dtypes
    (anything but bf16 counts as f32): a function of d and the dtypes
    alone, never of rows.  ``1 + scale`` multiplies x before its split,
    except where a bf16 x meets f32 weights: x then goes in exactly and
    ``1 + scale`` multiplies the weights before theirs."""
    x16, w16 = x_dtype == torch.bfloat16, w_dtype == torch.bfloat16
    ranks, chunks, _ = _mrn.walk(d, torch.bfloat16 if x16
                                 else torch.float32)
    if x16:
        return (Walk(STEP, 2, 1, 2, False, ranks, chunks) if w16
                else Walk(STEP, 1, 2, 2, True, ranks, chunks))
    return Walk(STEP, 3, 1 if w16 else 3, 3, False, ranks, chunks)


def product_bits(wk: Walk) -> int:
    """The bits a product keeps under the walk: -log2 of the bound on its
    relative error, the rest past a split side's words (2^-8 a word; a
    side of one word is a bf16 operand as it is, exact) and the products
    with i + j >= levels that the walk drops."""
    err = sum(2.0 ** (-8 * n) for n in (wk.a_words, wk.b_words) if n > 1)
    err += sum(2.0 ** (-8 * (i + j)) for i in range(wk.a_words)
               for j in range(wk.b_words) if i + j >= wk.levels)
    return math.floor(-math.log2(err))


def products(wk: Walk) -> list:
    """The (A word, B word) products of a step, the smaller first, as
    the kernel chains them."""
    return [(i, lev - i) for lev in range(wk.levels - 1, -1, -1)
            for i in range(lev + 1)
            if i < wk.a_words and lev - i < wk.b_words]


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
    grow with d or dout (it walks k in steps and holds one tile's
    accumulators in registers), so only its int indices bound them: d,
    dout and the rows (TMA's coordinates), its ceil(rows / 128) x
    ceil(dout / cols) blocks and a group's GROUP x ceil(dout / cols)
    blocks must stay below 2^31."""
    bad = [w for w in weights if w not in ("float32", "bfloat16")]
    if bad:
        return f"kernel B10 takes f32 and bf16 weights, got {bad[0]}"
    col_tiles = -(-dout // (BLOCK_COLS // 2 if gate else BLOCK_COLS))
    blocks = -(-rows // BLOCK_ROWS) * col_tiles
    if max(d, dout, rows + BLOCK_ROWS, blocks, GROUP * col_tiles) > _INT_MAX:
        return (f"d={d}, dout={dout} with {rows} rows exceed kernel B10's "
                f"int indexing (d, dout, rows and its {blocks} blocks "
                f"below 2^31)")
    return None


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 fraction bits), to nearest with
    ties away from zero: ``cvt.rna.tf32.f32`` with the low 13 bits
    cleared, as kernel B9's MMAs are fed."""
    bits = x.to(ACCUM_DTYPE).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(ACCUM_DTYPE)


def tf32_words(x: torch.Tensor) -> tuple:
    """(hi, lo): ``hi = rna(x)``, ``lo = rna(x - hi)``, 22 bits of x."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.to(ACCUM_DTYPE) - hi)


def _words(v: torch.Tensor, n: int) -> list:
    """n bf16 words of f32 values, most significant first, as f32."""
    return [p.to(ACCUM_DTYPE) for p in split_f32_words(v, n)]


def _project(a: list, b: list, wk: Walk) -> torch.Tensor:
    """``A @ B`` from the words of both sides as the kernel walks it: per
    step of ``wk.step`` columns one f32 matmul of the step's products,
    each step's sum added to the running f32 sum in order."""
    pairs = products(wk)
    acc = None
    for k0 in range(0, a[0].shape[1], wk.step):
        k = slice(k0, k0 + wk.step)
        part = torch.matmul(torch.cat([a[i][:, k] for i, _ in pairs], dim=1),
                            torch.cat([b[j][k] for _, j in pairs], dim=0))
        acc = part if acc is None else acc + part
    return acc


def _weight_dtype(w: torch.Tensor, w_gate) -> torch.dtype:
    """The weights' dtype as the kernel takes them: a gate of another
    dtype than w widens both to f32 (``_weights``)."""
    if w_gate is not None and w_gate.dtype != w.dtype:
        return ACCUM_DTYPE
    return w.dtype


def norm_matmul_plain(x2d: torch.Tensor, scale: torch.Tensor,
                      w: torch.Tensor, *, w_gate=None, bias=None, act=None,
                      eps: float = 1e-6) -> torch.Tensor:
    """B10's function in plain PyTorch: x2d (rows, d) of any float dtype,
    scale (d,), w / w_gate (d, dout), bias (dout,) -> (rows, dout) in
    x2d.dtype."""
    d = x2d.shape[-1]
    wk = walk(d, x2d.dtype, _weight_dtype(w, w_gate))
    rstd = torch.rsqrt(row_sums_plain(x2d) / d + eps)[:, None]
    s1 = 1.0 + scale.to(ACCUM_DTYPE).reshape(d)
    xf = x2d.to(ACCUM_DTYPE)
    if wk.fold_w:       # x exact, 1 + scale into w
        a = _words(xf, wk.a_words)
        side = lambda m: _words(s1[:, None] * m.to(ACCUM_DTYPE),  # noqa: E731
                                wk.b_words)
    else:
        a = _words(xf * s1, wk.a_words)
        side = lambda m: _words(m.to(ACCUM_DTYPE), wk.b_words)  # noqa: E731
    up = _project(a, side(w), wk) * rstd
    if bias is not None:
        up = up + bias.to(ACCUM_DTYPE)
    if w_gate is not None:
        up = apply_act(_project(a, side(w_gate), wk) * rstd, act) * up
    return up.to(x2d.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_norm_matmul")
    ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
    lib.b10_norm_matmul.argtypes = [ptr] * 10 + [ll, i, i, ll, ll, ll, ll,
                                                 i, i, i, f, ptr]
    lib.b10_norm_matmul.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.b10_norm_matmul_walk.argtypes = [i, i, i] + [ip] * 7
    lib.b10_norm_matmul_walk.restype = i
    lib.mma_norm_matmul_error_string.argtypes = [i]
    lib.mma_norm_matmul_error_string.restype = ctypes.c_char_p
    return lib


def cuda_walk(d: int, x_dtype: torch.dtype, w_dtype: torch.dtype) -> Walk:
    """The walk the CUDA library takes (to check ``walk`` against it on
    the card)."""
    vals = [ctypes.c_int() for _ in range(7)]
    rc = _lib().b10_norm_matmul_walk(d, _DTYPES[x_dtype], _DTYPES[w_dtype],
                                     *map(ctypes.byref, vals))
    if rc:
        raise ValueError(f"b10_norm_matmul_walk refused d={d}")
    step, a_words, b_words, levels, fold_w, ranks, chunks = (
        v.value for v in vals)
    return Walk(step, a_words, b_words, levels, bool(fold_w), ranks, chunks)


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


def _tma_ready(t: torch.Tensor) -> tuple:
    """(array, row pitch) as TMA reads a contiguous (r, c) tensor: the
    tensor itself where its base and rows are 16-byte aligned, else a
    copy with rows padded to 16 bytes (the padding is never read)."""
    item = t.element_size()
    cols = t.shape[1]
    if (cols * item) % 16 == 0 and t.data_ptr() % 16 == 0:
        return t, cols
    pitch = -(-cols * item // 16) * 16 // item
    buf = t.new_zeros(t.shape[0], pitch)
    buf[:, :cols] = t
    return buf, pitch


def _planes(words: int, rows: int, cols: int, device) -> tuple:
    """(bf16 word planes, row pitch): ``words`` planes of rows x pitch,
    the pitch cols rounded up to PITCH_COLS."""
    pitch = -(-cols // PITCH_COLS) * PITCH_COLS
    return (torch.empty(words, rows, pitch, dtype=torch.bfloat16,
                        device=device), pitch)


def norm_matmul_cuda(x2d: torch.Tensor, scale: torch.Tensor,
                     w: torch.Tensor, *, w_gate=None, bias=None, act=None,
                     eps: float = 1e-6) -> torch.Tensor:
    """B10 on a contiguous (rows, d) f32 / bf16 CUDA tensor, with scale,
    the weights (f32 or bf16, independently of x) and the bias on the
    same card.  Returns a new (rows, dout) tensor of x2d's dtype; two
    launches (the row pass, the projections) or, for f32 weights, three
    (the weight pass between them), checked."""
    if not x2d.is_cuda or x2d.dtype not in _DTYPES:
        raise ValueError(f"B10 takes an f32 or bf16 CUDA tensor, got "
                         f"{x2d.dtype} on {x2d.device}")
    _build.need_memory("B10", x2d, scale, w, w_gate, bias)
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"B10 takes a contiguous (rows, d) tensor, got "
                         f"shape {tuple(x2d.shape)}")
    if act not in _ACTS:
        raise ValueError(f"unknown norm_matmul act: {act!r}")
    dev = x2d.device
    rows, d = x2d.shape
    w, w_gate = _weights(w, w_gate, d, dev)
    dout = w.shape[1]
    if not 1 <= d < 2 ** 31 or dout >= 2 ** 31:
        raise ValueError(f"B10 takes 1 <= d < 2^31 and dout < 2^31, got "
                         f"d={d}, dout={dout}")
    if scale.numel() != d or scale.device != dev:
        raise ValueError(f"scale must hold d={d} values on {dev}, "
                         f"got {scale.numel()} on {scale.device}")
    if bias is not None and (bias.numel() != dout or bias.device != dev):
        raise ValueError(f"bias must hold dout={dout} values on {dev}, "
                         f"got {bias.numel()} on {bias.device}")
    out = torch.empty(rows, dout, dtype=x2d.dtype, device=dev)
    if rows == 0 or dout == 0:
        return out
    wk = walk(d, x2d.dtype, w.dtype)
    s = scale.reshape(-1).to(ACCUM_DTYPE).contiguous()
    b = None if bias is None \
        else bias.reshape(-1).to(ACCUM_DTYPE).contiguous()
    part = torch.empty(wk.ranks * rows, dtype=ACCUM_DTYPE, device=dev)
    # x's side: its words (made by the row pass), or x as it is (TMA).
    xa, ldx, xw, ldxw = x2d, d, None, PITCH_COLS
    if wk.fold_w:
        xa, ldx = _tma_ready(x2d)
    else:
        xw, ldxw = _planes(wk.a_words, rows, d, dev)
    # The weights' side: an f32 weight's words (the weight pass), or a
    # bf16 one as it is (TMA).
    weights = w.dtype == ACCUM_DTYPE
    ww = wgw = None
    ldw, ldww = dout, PITCH_COLS
    if weights:
        ww, ldww = _planes(wk.b_words, d, dout, dev)
        if w_gate is not None:
            wgw = _planes(wk.b_words, d, dout, dev)[0]
    else:
        w, ldw = _tma_ready(w)
        if w_gate is not None:
            w_gate = _tma_ready(w_gate)[0]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    # The raw stream handle: torch.cuda.current_stream(dev).cuda_stream
    # builds a Stream object on every call.
    args = (xa.data_ptr(), s.data_ptr(), w.data_ptr(), ptr(w_gate), ptr(b),
            part.data_ptr(), ptr(xw), ptr(ww), ptr(wgw), out.data_ptr(),
            rows, d, dout, ldx, ldw, ldxw, ldww, _DTYPES[x2d.dtype],
            _DTYPES[w.dtype], _ACTS[act], float(eps),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = lib.b10_norm_matmul(*args)
    else:   # the launches go to the host thread's current card
        with torch.cuda.device(dev):
            rc = lib.b10_norm_matmul(*args)
    if rc:
        msg = lib.mma_norm_matmul_error_string(rc).decode()
        raise RuntimeError(f"b10_norm_matmul launch failed: {msg} ({rc})")
    LAUNCHES["b10_rows"] += 1
    LAUNCHES["b10_weights"] += weights
    LAUNCHES["b10_norm_matmul"] += 1
    return out
