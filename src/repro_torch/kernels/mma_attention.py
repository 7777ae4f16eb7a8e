"""Kernel B9: fused attention on Hopper, its row sum of exponentials a
ones-MMA carried across KV blocks with a Kahan carry, beside its plain
PyTorch version and a launch counter.

The CUDA source is ``csrc/mma_attention.cu`` (``sm_90a``, bound through
ctypes by ``kernels._build``).  ``attention_cuda`` replaces
``repro.kernels.mma_attention._attn_kernel`` (launched by ``_attn_call``
and ``mma_attention``): for qg (B, Sq, KV, G, hd), k (B, Sk, KV, hd) and
v (B, Sk, KV, hd_v) it returns (B, Sq, KV, G, hd_v) in v's dtype,

    s_ij = cap tanh(scale q_i.k_j / cap)   (no cap: scale q_i.k_j)
    o_i  = sum_j exp(s_ij - m_i) v_j / l_i,   l_i = sum_j exp(s_ij - m_i)

over the valid keys j of row i: ``lo_i <= j < hi_i`` with
``hi_i = min(Sk, kv_len[b], qpos_i + 1 if causal)`` and
``lo_i = qpos_i - window + 1`` with a window (else 0).  A row with no
valid key gives exactly 0.  Bound: operations at prefill (2 (hd + hd_v)
flops per unmasked score), bytes at decode (the KV cache).

The walk (shared by kernel and plain version).  The (Sq, G) rows of one
(batch, KV head) are packed, row ``r = i G + g``, so a group shares each
K/V load.  Keys are walked in blocks of ``BLOCK_K`` from 0 in order.  A
block that holds no valid key of a row leaves that row's state as it
was; a block that holds one updates it:

    m_new = max(m, max_j s_ij)                 (masked s = NEG_INF)
    corr  = exp(m - m_new);  p_ij = exp(s_ij - m_new)
    l_blk = p @ ones   (the ones-MMA: p's two TF32 words against ones)
    y = l_blk - c corr;  t = l corr + y;  c = (t - l corr) - y;  l = t
    acc   = acc corr + p @ v;  m = m_new

starting from m = ``M_INIT``, l = c = acc = 0, and ending
``o = acc / (l - c)`` where ``l - c > 0``, else 0.  So a row's bits
depend on its own positions alone, not on the rows beside it in a tile
or a batch, and the kernel may skip a block no row of its tile touches.

Products (3xTF32, as B10): f32 operands as two TF32 words (``hi =
rna(x)``, ``lo = rna(x - hi)``), the lo x lo term dropped; a bf16
operand is exact in one word.  q.k is summed per ``STEP`` columns of hd
(one chain of MMAs from zero), the steps added in order in f32.  p goes
into p @ v as two TF32 words when v is f32, and rounded to bf16 when v
is bf16 (as ``models.attention._direct_attn`` rounds it to v's dtype);
l always sums p's two words.  Every partial is f32.

``attention_plain`` computes the same walk in plain PyTorch: the same
words, the same steps, one f32 matmul per step and per block.  Kernel
and plain version differ in the order of the adds inside an MMA or a
matmul and in ``expf`` / ``tanhf``'s last bits.  The wrapper
``kernels.ops.mma_attention`` uses it for CPU tensors, and only there.
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import ACCUM_DTYPE, dtype_name
from repro_torch.kernels import _build
from repro_torch.kernels.mma_norm_matmul import tf32_words

LAUNCHES = {"b9_attention": 0}

NEG_INF = -2.0e38     # the masked score, as models.attention.NEG_INF
M_INIT = -1.0e30      # the row max's seed: exp(M_INIT - M_INIT) == 1
# Keys per block of the walk (csrc kBK) and hd columns per chain of
# q.k MMAs from zero (csrc kStep).
BLOCK_K, STEP = 32, 32
# A kernel block's query rows (csrc: 4 warps of 16; at most 16 rows a
# head take 16-row blocks whose warps split the columns).
BLOCK_ROWS = 64
# Shared memory a block may use on the H100 (227 KB).
SMEM_LIMIT = 232448
# The accumulator lives in registers, hd_v / 2 f32 a thread (128 at
# 256): the value head dim's limit.
MAX_HEAD_V = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _row_bytes(dim: int, f32: bool) -> int:
    """A shared tile row of dim elements (csrc row_bytes): f32 rows
    padded to a multiple of 32 words plus 4, bf16 rows to a multiple of
    64 elements plus 8."""
    if f32:
        return (-(-dim // 32) * 32 + 4) * 4
    return (-(-dim // 64) * 64 + 8) * 2


def _v_width(hd_v: int) -> int:
    """The kernel's value tile width: the instantiated 32, 64, 128 or 256
    at or above hd_v."""
    return next(w for w in (32, 64, 128, 256) if hd_v <= w)


def smem_bytes(hd: int, hd_v: int, q_f32: bool = True,
               kv_f32: bool = True) -> int:
    """Shared memory of a B9 block (csrc smem_bytes), the larger of its
    two tiles: two stages of a block of keys and a block of values, and
    either 64 query rows with their bounds, or (at most 16 rows a head)
    16 rows with their bounds and what the warps exchange: the score
    chains, the row maxes and p."""
    stages = 2 * BLOCK_K * (_row_bytes(hd, kv_f32)
                            + _row_bytes(_v_width(hd_v), kv_f32))
    tall = BLOCK_ROWS * (_row_bytes(hd, q_f32) + 8)
    wide = 16 * (_row_bytes(hd, q_f32) + 8) \
        + 4 * 16 * ((BLOCK_K + 8) * (-(-hd // STEP) + 1) + 4)
    return stages + max(tall, wide)


def refusal(hd: int, hd_v: int, dtypes: tuple):
    """Why B9 cannot take a problem, or None.  ``dtypes`` are the names
    of qg's, k's and v's dtypes: each f32 or bf16, k and v alike (q may
    differ: f32 activations against a bf16 cache)."""
    bad = [d for d in dtypes if d not in ("float32", "bfloat16")]
    if bad:
        return f"kernel B9 takes f32 and bf16 operands, got {bad[0]}"
    if len(dtypes) == 3 and dtypes[1] != dtypes[2]:
        return (f"kernel B9 takes k and v in one dtype, got {dtypes[1]} "
                f"and {dtypes[2]}")
    if hd_v > MAX_HEAD_V:
        return (f"value head dim {hd_v} exceeds kernel B9's register "
                f"accumulator ({MAX_HEAD_V})")
    need = smem_bytes(hd, hd_v, dtypes[0] == "float32",
                      dtypes[-1] == "float32")
    if need > SMEM_LIMIT:
        return (f"head dims {hd}/{hd_v} need {need} bytes of shared "
                f"memory a block in kernel B9, past the H100's "
                f"{SMEM_LIMIT}")
    return None


def _words(x: torch.Tensor) -> tuple:
    """The MMA words of an operand in f32: (hi, lo) of an f32 tensor, the
    exact value alone of a bf16 one."""
    if x.dtype == torch.float32:
        return tf32_words(x)
    return (x.to(ACCUM_DTYPE),)


def _product(a_words: tuple, b_words: tuple, steps: int) -> torch.Tensor:
    """``a @ b`` over the last dim of the a words / first of the b words,
    by the kernel's word pairs (lo x lo dropped), summed per ``steps``
    columns in one f32 matmul each and the steps added in order."""
    pairs = [(a, b) for i, a in enumerate(a_words)
             for j, b in enumerate(b_words) if i + j < 2]
    acc = None
    for k0 in range(0, a_words[0].shape[-1], steps):
        k = slice(k0, k0 + steps)
        part = torch.matmul(torch.cat([a[..., k] for a, _ in pairs], -1),
                            torch.cat([b[..., k, :] for _, b in pairs], -2))
        acc = part if acc is None else acc + part
    return acc


def row_bounds(qpos: torch.Tensor, kv_len, *, sk: int, causal: bool,
               window) -> tuple:
    """(lo, hi), int64 (B, Sq): the valid keys of each query row are
    ``lo <= j < hi``, both clamped to [0, Sk]."""
    q = qpos.to(torch.int64)
    hi = torch.full_like(q, sk)
    if kv_len is not None:
        hi = torch.minimum(hi, kv_len.to(torch.int64).reshape(-1, 1))
    if causal:
        hi = torch.minimum(hi, q + 1)
    lo = torch.zeros_like(q)
    if window is not None:
        lo = q - int(window) + 1
    return lo.clamp(0, sk), hi.clamp(0, sk)


def attention_plain(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    qpos: torch.Tensor, causal: bool = False, window=None,
                    kv_len=None, scale: float, cap=None) -> torch.Tensor:
    """B9's walk in plain PyTorch.  qg (B, Sq, KV, G, hd), k (B, Sk, KV,
    hd), v (B, Sk, KV, hd_v), each f32 or bf16; qpos (B, Sq) int; kv_len
    None or (B,) -> (B, Sq, KV, G, hd_v) in v.dtype."""
    B, Sq, KV, G, hd = qg.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    R = Sq * G
    out = torch.zeros(B, Sq, KV, G, hd_v, dtype=v.dtype, device=v.device)
    if min(B, R, KV, Sk) == 0:
        return out
    lo, hi = row_bounds(qpos, kv_len, sk=Sk, causal=causal, window=window)
    lo = lo.repeat_interleave(G, dim=1)[:, None, :, None]   # (B, 1, R, 1)
    hi = hi.repeat_interleave(G, dim=1)[:, None, :, None]
    live = lo < hi
    q_words = _words(qg.permute(0, 2, 1, 3, 4).reshape(B, KV, R, hd))
    m = torch.full((B, KV, R, 1), M_INIT, dtype=ACCUM_DTYPE,
                   device=qg.device)
    l = torch.zeros_like(m)
    c = torch.zeros_like(m)
    acc = torch.zeros(B, KV, R, hd_v, dtype=ACCUM_DTYPE, device=qg.device)
    first = int(torch.where(live, lo, Sk).min()) // BLOCK_K * BLOCK_K
    last = int(torch.where(live, hi, 0).max())
    for j0 in range(first, last, BLOCK_K):
        kb = k[:, j0:j0 + BLOCK_K].permute(0, 2, 3, 1)   # (B, KV, hd, bk)
        vb = v[:, j0:j0 + BLOCK_K].permute(0, 2, 1, 3)   # (B, KV, bk, hd_v)
        s = _product(q_words, _words(kb), STEP) * scale
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        j = torch.arange(j0, j0 + kb.shape[-1], device=qg.device)
        s = torch.where((j >= lo) & (j < hi), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        p_words = tf32_words(p)
        l_blk = torch.matmul(torch.cat(p_words, -1),
                             torch.ones(2 * p.shape[-1], 1,
                                        dtype=ACCUM_DTYPE, device=p.device))
        l_old, c_old = l * corr, c * corr
        y = l_blk - c_old
        t = l_old + y
        touch = live & (j0 < hi) & (j0 + BLOCK_K > lo)
        c = torch.where(touch, (t - l_old) - y, c)
        l = torch.where(touch, t, l)
        pv_words = p_words if v.dtype == torch.float32 \
            else (p.to(v.dtype).to(ACCUM_DTYPE),)
        acc = acc * corr + _product(pv_words, _words(vb), BLOCK_K)
        m = m_new
    lf = l - c
    o = torch.where(lf > 0.0, acc / torch.where(lf > 0.0, lf, 1.0), 0.0)
    return o.reshape(B, KV, Sq, G, hd_v).permute(0, 2, 1, 3, 4).to(v.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_attention")
    ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
    lib.b9_attention.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i, i, i, i,
                                 i, i, i, i, i, i, i, ll, f, i, f, ptr]
    lib.b9_attention.restype = i
    lib.mma_attention_error_string.argtypes = [i]
    lib.mma_attention_error_string.restype = ctypes.c_char_p
    return lib


def attention_cuda(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   qpos: torch.Tensor, causal: bool = False, window=None,
                   kv_len=None, scale: float, cap=None) -> torch.Tensor:
    """B9 on CUDA tensors: qg (B, Sq, KV, G, hd) f32 / bf16, k (B, Sk, KV,
    hd) and v (B, Sk, KV, hd_v) f32 / bf16 (one dtype for both), qpos
    (B, Sq) int32, kv_len None or (B,) int32, all contiguous on one card
    (the cache is never copied).  Returns a new (B, Sq, KV, G, hd_v)
    tensor in v's dtype; one launch, checked."""
    dev = qg.device
    for nm, t in (("qg", qg), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != dev or t.dtype not in _DTYPES:
            raise ValueError(f"B9 takes {nm} as an f32 or bf16 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"B9 takes a contiguous {nm}")
    if qg.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"B9 takes qg (B,Sq,KV,G,hd), k (B,Sk,KV,hd), v "
                         f"(B,Sk,KV,hd_v), got {tuple(qg.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, KV, G, hd = qg.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    if k.shape != (B, Sk, KV, hd) or v.shape[:3] != (B, Sk, KV):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match qg {tuple(qg.shape)}")
    reason = refusal(hd, hd_v, tuple(dtype_name(t.dtype)
                                     for t in (qg, k, v)))
    if reason is not None:
        raise ValueError(reason)
    if max(B, KV, Sq * G, Sk) >= 2 ** 31 or B > 65535 or KV > 65535:
        raise ValueError(f"B9's grid and int indices take B, KV <= 65535 "
                         f"and Sq G, Sk < 2^31, got {tuple(qg.shape)}, "
                         f"Sk={Sk}")
    if qpos.shape != (B, Sq) or qpos.dtype != torch.int32 \
            or qpos.device != dev or not qpos.is_contiguous():
        raise ValueError(f"B9 takes qpos as a contiguous (B, Sq) int32 "
                         f"tensor on {dev}")
    if kv_len is not None and (kv_len.shape != (B,)
                               or kv_len.dtype != torch.int32
                               or kv_len.device != dev):
        raise ValueError(f"B9 takes kv_len as a (B,) int32 tensor on {dev}")
    out = torch.empty(B, Sq, KV, G, hd_v, dtype=v.dtype, device=dev)
    if min(B, Sq, KV, G, hd_v) == 0:
        return out
    if Sk == 0 or hd == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.b9_attention(
            qg.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            B, Sq, Sk, KV, G, hd, hd_v, _DTYPES[qg.dtype], _DTYPES[k.dtype],
            int(bool(causal)), 0 if window is None else 1,
            0 if window is None else int(window), float(scale),
            0 if cap is None else 1, 0.0 if cap is None else float(cap),
            stream)
    if rc:
        msg = lib.mma_attention_error_string(rc).decode()
        raise RuntimeError(f"b9_attention launch failed: {msg} ({rc})")
    LAUNCHES["b9_attention"] += 1
    return out

