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
K/V load.  Keys are walked in blocks of ``block_k`` from 0 in order.  A
block that holds no valid key of a row leaves that row's state as it
was; a block that holds one updates it:

    m_new = max(m, max_j s_ij)                 (masked s = NEG_INF)
    corr  = exp(m - m_new);  p_ij = exp(s_ij - m_new)
    l_blk = words(p) @ ones   (the ones-MMA)
    y = l_blk - c corr;  t = l corr + y;  c = (t - l corr) - y;  l = t
    acc   = acc corr + p @ v;  m = m_new

starting from m = ``M_INIT``, l = c = acc = 0, and ending
``o = acc / (l - c)`` where ``l - c > 0``, else 0.  So a row's bits
depend on its own positions alone, not on the rows beside it in a tile
or a batch, and the kernel may skip a block no row of its tile touches.

Four forms of the kernel walk it, chosen by ``walk`` from the dtypes
and the shape alone (the CUDA source's ``form`` mirrors it):

* ``"wgmma"``, the bf16 prefill form: qg, k and v bf16, more than 16
  rows a head, hd and hd_v multiples of 16 up to 256.  Blocks of
  ``BLOCK_K_WG`` = 64 keys; q.k one chain over the whole hd (bf16
  products are exact in f32); l sums p's three bf16 words (hi = bf16(p),
  then the rests: ~24 bits); p rounded to bf16 for p @ v, which the
  kernel accumulates into acc on the tensor cores (``pv_accumulates``).
* ``"wgmma_f32"``, the f32 prefill form: qg, k and v f32 under the same
  conditions of rows and head dims.  Every f32 operand goes in as three
  bf16 words (hi = bf16(x), then the rests), made once a call by a
  word pass, and a product is the six word products (i, j) with i + j <
  3 (``WF_PRODUCTS``, the smaller first, as B10's f32 form): about 22
  bits.  Blocks of ``BLOCK_K_WF`` = 64 keys; q.k summed per ``STEP_WF``
  = 64 columns of hd (one chain from zero), the steps added in order in
  f32; l sums p's three bf16 words; p @ v is p's three words against
  v's three, from zero per block, added to acc corr.
* ``"decode"``, a decode step: at most 16 rows a head (``Sq G`` <=
  ``WG_MIN_ROWS``), a bf16 cache, q f32 or bf16, hd and hd_v multiples of
  16 up to 256.  Each row's keys are cut at absolute multiples of
  ``DECODE_CHUNK`` keys.  A chunk that holds a valid key of the row is
  walked alone, from the fresh state, in blocks of ``BLOCK_K_DC`` = 16
  keys by the update above, and ends with a state (m_c, l_c, c_c,
  acc_c); ``decode_merge`` then folds the row's chunks in chunk order,
  from M = ``M_INIT``, L = C = A = 0:

      M' = max(M, m_c);  a = exp(M - M');  b = exp(m_c - M')
      y = (l_c - c_c) b - C a;  t = L a + y;  C = (t - L a) - y;  L = t
      A = A a + acc_c b;  M = M'

  ending ``o = A / (L - C)`` where ``L - C > 0``, else 0.  For a row whose
  keys lie in one chunk, a = exp(M_INIT - m_c) is 0 in f32 and b = 1, so o
  is exactly that chunk's ``acc_c / (l_c - c_c)``: a short row has the
  bits of an unsplit walk.  q goes in as three bf16 words (hi = bf16(q),
  then the rests; a bf16 q is its hi word), each against the exact bf16
  k in one chain over the whole hd, a score ``(hi + mid) + lo``; l sums
  p's three bf16 words; p rounded to bf16 for p @ v, from zero per block
  and added to acc corr.  The kernel walks the chunks of every row side
  by side (one block per chunk, KV head and batch row), then merges them
  in a second launch.
* ``"mma_sync"``, every other problem (f32 q, k and v at a decode step,
  f32 q beside a bf16 cache with more than 16 rows, odd head dims).
  Blocks of ``BLOCK_K`` = 32
  keys.  Products in 3xTF32: f32 operands as two TF32 words
  (``hi = rna(x)``, ``lo = rna(x - hi)``), the lo x lo term dropped; a
  bf16 operand is exact in one word.  q.k is summed per ``STEP``
  columns of hd (one chain of MMAs from zero), the steps added in order
  in f32.  p goes into p @ v as two TF32 words when v is f32, and
  rounded to bf16 when v is bf16 (as ``models.attention._direct_attn``
  rounds it to v's dtype); l sums p's two TF32 words; p @ v runs from
  zero per block and is added to acc corr.

So a prefill row's bits differ from those of the same row in a decode
call; within a form they depend on the row alone (its own q, positions
and keys), never on the rows or batch slots beside it.  Every partial is
f32.

``attention_plain`` computes the same walk in plain PyTorch: the same
words, the same steps, one f32 matmul per step and per block.  Kernel
and plain version differ in the order of the adds inside an MMA or a
matmul and in exp / tanh's last bits (``expf`` / ``tanhf`` on the
mma.sync, f32 prefill and decode forms; ``ex2.approx`` on the bf16
prefill form, a few 2^-22 of p).  The wrapper
``kernels.ops.mma_attention`` uses it for CPU tensors, and only there.
``LAUNCHES`` counts the kernel's calls by form: ``b9_attention`` the
mma.sync form, ``b9_attention_wgmma`` the bf16 prefill form,
``b9_attention_f32`` the f32 prefill form (its word pass and its
attention kernel, two launches a call), ``b9_attention_decode`` the
decode form (its chunks' walk and their merge, two launches a call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.precision import ACCUM_DTYPE, dtype_name
from repro_torch.kernels import _build
from repro_torch.kernels.mma_norm_matmul import tf32_words

LAUNCHES = {"b9_attention": 0, "b9_attention_wgmma": 0,
            "b9_attention_f32": 0, "b9_attention_decode": 0}

NEG_INF = -2.0e38     # the masked score, as models.attention.NEG_INF
M_INIT = -1.0e30      # the row max's seed: exp(M_INIT - M_INIT) == 1
# The mma.sync form: keys per block of the walk (csrc kBK) and hd columns
# per chain of q.k MMAs from zero (csrc kStep).
BLOCK_K, STEP = 32, 32
# A kernel block's query rows (csrc: 4 warps of 16; at most 16 rows a
# head take 16-row blocks whose warps split the columns).
BLOCK_ROWS = 64
# The bf16 prefill form (csrc namespace wg): keys per block, query rows a
# block (two warpgroups of 64), the rows a head must exceed, the widest
# head, and the row tiles a grid holds (gridDim.z).
BLOCK_K_WG, BLOCK_ROWS_WG = 64, 128
WG_MIN_ROWS, WG_MAX_HEAD, WG_MAX_TILES = 16, 256, 65535
# The f32 prefill form (csrc namespace wf): keys per block, query rows a
# block (one consumer warpgroup), hd columns a q.k chain (and value
# columns a p @ v chunk), bf16 words an operand, the word products (A
# word, B word) with i + j < 3 in the kernel's order, a ring stage (one
# 64 x 64 tile of each word; p's words take one more), the ring's most
# stages, and the bytes beside Q, the ring and p (the ones, the
# mbarriers, the rows' bounds and the warps' bound reductions).  Its
# rows and head dims obey the bf16 form's limits above.
BLOCK_K_WF, BLOCK_ROWS_WF, STEP_WF, WF_WORDS = 64, 64, 64, 3
WF_PRODUCTS = ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))
WF_STAGE_BYTES, WF_STAGES_MAX = WF_WORDS * 64 * 128, 8
WF_EXTRA_BYTES = 512 + 8 * (1 + 2 * WF_STAGES_MAX) + 2 * 64 * 4 + 4 * 5 * 4
# The decode form (csrc namespace dc): keys a chunk, keys a block of the
# walk, the ring's budget in bytes (at 2 rows a block, and at 8 or 16),
# its least and most stages, and a row of p's words in shared memory (16
# keys and 8 of padding).  Its rows and head dims: at most WG_MIN_ROWS
# rows a head, hd and hd_v multiples of 16 up to WG_MAX_HEAD.
DECODE_CHUNK, BLOCK_K_DC = 2048, 16
DC_RING_BYTES, DC_RING_BYTES_ROWS = 49152, 16384
DC_STAGES_MIN, DC_STAGES_MAX, DC_PS = 2, 8, 24
# Shared memory a block may use on the H100 (227 KB).
SMEM_LIMIT = 232448
# The accumulator lives in registers, hd_v / 2 f32 a thread (128 at
# 256): the value head dim's limit.
MAX_HEAD_V = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The CUDA chooser's codes (csrc form) and each form's launch counter.
_FORMS = ("mma_sync", "wgmma", "wgmma_f32", "decode")
_COUNTERS = {"mma_sync": "b9_attention", "wgmma": "b9_attention_wgmma",
             "wgmma_f32": "b9_attention_f32",
             "decode": "b9_attention_decode"}


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


def _round64(d: int) -> int:
    return -(-d // 64) * 64


def wf_stages(hd: int) -> int:
    """The f32 prefill form's ring stages at head dim hd (csrc
    wf::stages): as many 24 KB stages as fit beside Q's three words of
    64 rows and p's (a stage's size), at most WF_STAGES_MAX."""
    q = WF_WORDS * BLOCK_ROWS_WF * _round64(hd) * 2
    fit = (SMEM_LIMIT - 1024 - q - WF_STAGE_BYTES - WF_EXTRA_BYTES) \
        // WF_STAGE_BYTES
    return min(WF_STAGES_MAX, fit)


def _dc_stage_bytes(hd: int, hd_v: int) -> int:
    """A decode-form ring stage (csrc dc::stage_bytes): a block's keys
    and values in slabs of 64 columns x 16 keys x 128 bytes."""
    return (-(-hd // 64) + -(-hd_v // 64)) * BLOCK_K_DC * 128


def dc_stages(hd: int, hd_v: int, rt: int) -> int:
    """The decode form's ring stages for a block of rt rows (csrc
    dc::stages): as many as DC_RING_BYTES holds at 2 rows,
    DC_RING_BYTES_ROWS at 8 or 16, from DC_STAGES_MIN to DC_STAGES_MAX:
    3 at hd = hd_v = 256 and 2 rows, 2 at hd = hd_v = 128 and 16."""
    fit = (DC_RING_BYTES_ROWS if rt > 2 else DC_RING_BYTES) \
        // _dc_stage_bytes(hd, hd_v)
    return max(DC_STAGES_MIN, min(DC_STAGES_MAX, fit))


def dc_row_tile(rows: int) -> int:
    """The rows a decode-form block holds (csrc dc::launch_rows): 2, 8 or
    16."""
    return 2 if rows <= 2 else 8 if rows <= 8 else 16


def smem_bytes(hd: int, hd_v: int, q_f32: bool = True,
               kv_f32: bool = True, form: str = "mma_sync",
               rows: int = WG_MIN_ROWS) -> int:
    """Shared memory of a B9 block.  The mma.sync form (csrc
    smem_bytes), the larger of its two tiles: two stages of a block of
    keys and a block of values, and either 64 query rows with their
    bounds, or (at most 16 rows a head) 16 rows with their bounds and
    what the warps exchange: the score chains, the row maxes and p.  The
    wgmma form (csrc wg::smem_bytes, bf16 only): 1024 bytes of alignment
    slack, 128 query rows and two stages of 64 keys and 64 values, each
    row padded to a multiple of 64 columns, then the ones-MMA's 512-byte
    operand, four mbarriers and four release counts, the rows' bounds and
    the warps' bound reductions.  The wgmma_f32 form (csrc
    wf::smem_bytes, f32 only): the alignment slack, Q's three words of 64
    rows, ``wf_stages(hd)`` ring stages of 24 KB, p's three words (a
    stage's size) and WF_EXTRA_BYTES; it does not grow with hd_v (a value
    chunk is a stage).  The decode form (csrc dc::smem_bytes, a bf16
    cache; ``rows`` a head): the alignment slack, ``dc_stages`` ring
    stages, q's four word columns a row of its row tile (rows of
    round32(hd) + 8 elements), p's three words of its 8-row tiles
    (DC_PS elements a row), 16 rows' corrections and bounds, and 8
    mbarriers."""
    if form == "decode":
        rt = dc_row_tile(rows)
        return (1024 + dc_stages(hd, hd_v, rt) * _dc_stage_bytes(hd, hd_v)
                + 4 * rt * (-(-hd // 32) * 32 + 8) * 2
                + 3 * (-(-rt // 8) * 8) * DC_PS * 2
                + WG_MIN_ROWS * 12 + DC_STAGES_MAX * 8)
    if form == "wgmma":
        return (1024 + 2 * BLOCK_ROWS_WG * _round64(hd)
                + 2 * 2 * BLOCK_K_WG * (_round64(hd) + _round64(hd_v))
                + 512 + 4 * 8 + 4 * 4 + 2 * BLOCK_ROWS_WG * 4 + 4 * 5 * 4)
    if form == "wgmma_f32":
        return (1024 + WF_WORDS * BLOCK_ROWS_WF * _round64(hd) * 2
                + (wf_stages(hd) + 1) * WF_STAGE_BYTES + WF_EXTRA_BYTES)
    stages = 2 * BLOCK_K * (_row_bytes(hd, kv_f32)
                            + _row_bytes(_v_width(hd_v), kv_f32))
    tall = BLOCK_ROWS * (_row_bytes(hd, q_f32) + 8)
    wide = 16 * (_row_bytes(hd, q_f32) + 8) \
        + 4 * 16 * ((BLOCK_K + 8) * (-(-hd // STEP) + 1) + 4)
    return stages + max(tall, wide)


@functools.lru_cache(maxsize=256)
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
    # The mma.sync form serves every row count; the wgmma forms and the
    # decode form are chosen only where they fit (walk); the decode form's
    # shared memory (at most ~90 KB, at hd 256 and 16 rows) fits at every
    # head dim it takes.
    need = smem_bytes(hd, hd_v, dtypes[0] == "float32",
                      dtypes[-1] == "float32")
    if need > SMEM_LIMIT:
        return (f"head dims {hd}/{hd_v} need {need} bytes of shared "
                f"memory a block in kernel B9, past the H100's "
                f"{SMEM_LIMIT}")
    return None


def _prefill_shape(rows: int, hd: int, hd_v: int, rows_a_block: int) -> bool:
    """The rows and head dims the wgmma forms take: more than 16 rows a
    head in at most WG_MAX_TILES row tiles, hd and hd_v multiples of 16
    up to 256."""
    return (rows > WG_MIN_ROWS and hd % 16 == 0 and hd_v % 16 == 0
            and 16 <= hd <= WG_MAX_HEAD and 16 <= hd_v <= WG_MAX_HEAD
            and -(-rows // rows_a_block) <= WG_MAX_TILES)


@functools.lru_cache(maxsize=1024)
def walk(q_dtype, kv_dtype, rows_per_head: int, hd: int, hd_v: int) -> tuple:
    """B9's form for these dtypes (torch dtypes or their names) and shape,
    as ``(form, block_k, step, pv_accumulates)``: ``("wgmma", 64, hd,
    True)`` for the bf16 prefill form (qg, k and v bf16, ``Sq G`` > 16
    rows a head, hd and hd_v multiples of 16 up to 256, its shared memory
    within the card's), ``("wgmma_f32", 64, 64, False)`` for the f32
    prefill form (qg, k and v f32 under the same conditions), else
    ``("mma_sync", 32, 32, False)``.  ``step`` is the hd columns of one
    chain of q.k MMAs from zero; ``pv_accumulates`` says p @ v
    accumulates into acc itself rather than from zero per block.  A pure
    function of dtypes and shape (never of B, kv_len or Sk): the CUDA
    source's ``form`` is its mirror.  ``("decode", 16, hd, False)`` is the
    decode form: at most 16 rows a head, a bf16 cache (q f32 or bf16), hd
    and hd_v multiples of 16 up to 256; its q.k is one chain over the
    whole hd per word of q."""
    q, kv = (d if isinstance(d, str) else dtype_name(d)
             for d in (q_dtype, kv_dtype))
    rows = int(rows_per_head)
    if (q == kv == "bfloat16"
            and _prefill_shape(rows, hd, hd_v, BLOCK_ROWS_WG)
            and smem_bytes(hd, hd_v, False, False, form="wgmma")
            <= SMEM_LIMIT):
        return "wgmma", BLOCK_K_WG, hd, True
    if (q == kv == "float32"
            and _prefill_shape(rows, hd, hd_v, BLOCK_ROWS_WF)
            and wf_stages(hd) >= 2
            and smem_bytes(hd, hd_v, form="wgmma_f32") <= SMEM_LIMIT):
        return "wgmma_f32", BLOCK_K_WF, STEP_WF, False
    if (kv == "bfloat16" and q in ("float32", "bfloat16")
            and rows <= WG_MIN_ROWS and hd % 16 == 0 and hd_v % 16 == 0
            and 16 <= hd <= WG_MAX_HEAD and 16 <= hd_v <= WG_MAX_HEAD):
        return "decode", BLOCK_K_DC, hd, False
    return "mma_sync", BLOCK_K, STEP, False


def bf16_words(x: torch.Tensor, n: int = 3) -> tuple:
    """x (f32) as ``n`` bf16 words widened to f32, hi = bf16(x) and each
    next word bf16 of what is left (the rests are exact in f32)."""
    out = []
    for _ in range(n):
        w = x.to(torch.bfloat16).to(ACCUM_DTYPE)
        out.append(w)
        x = x - w
    return tuple(out)


def _words(x: torch.Tensor) -> tuple:
    """The MMA words of an operand in f32: (hi, lo) of an f32 tensor, the
    exact value alone of a bf16 one."""
    if x.dtype == torch.float32:
        return tf32_words(x)
    return (x.to(ACCUM_DTYPE),)


def _product(a_words: tuple, b_words: tuple, steps: int,
             pairs: tuple = None) -> torch.Tensor:
    """``a @ b`` over the last dim of the a words / first of the b words,
    by the kernel's word pairs (default: the TF32 pairs, lo x lo
    dropped), summed per ``steps`` columns in one f32 matmul each and the
    steps added in order."""
    if pairs is None:
        pairs = tuple((i, j) for i in range(len(a_words))
                      for j in range(len(b_words)) if i + j < 2)
    acc = None
    for k0 in range(0, a_words[0].shape[-1], steps):
        k = slice(k0, k0 + steps)
        part = torch.matmul(
            torch.cat([a_words[i][..., k] for i, _ in pairs], -1),
            torch.cat([b_words[j][..., k, :] for _, j in pairs], -2))
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
    form, block_k, step, _ = walk(qg.dtype, k.dtype, R, hd, hd_v)
    lo, hi = row_bounds(qpos, kv_len, sk=Sk, causal=causal, window=window)
    if form == "decode":
        o = _decode_plain(qg, k, v, lo.repeat_interleave(G, dim=1),
                          hi.repeat_interleave(G, dim=1), scale=scale,
                          cap=cap)
        return o.reshape(B, KV, Sq, G, hd_v).permute(0, 2, 1, 3, 4) \
            .to(v.dtype)
    f32_form = form == "wgmma_f32"
    # The operands' MMA words: three bf16 words of each f32 operand on the
    # f32 prefill form (made once, as its word pass makes them), else
    # the mma.sync form's TF32 words; and the word pairs of a product.
    words = (lambda x: bf16_words(x, WF_WORDS)) if f32_form else _words
    pairs = WF_PRODUCTS if f32_form else None
    lo = lo.repeat_interleave(G, dim=1)[:, None, :, None]   # (B, 1, R, 1)
    hi = hi.repeat_interleave(G, dim=1)[:, None, :, None]
    live = lo < hi
    q_words = words(qg.permute(0, 2, 1, 3, 4).reshape(B, KV, R, hd))
    m = torch.full((B, KV, R, 1), M_INIT, dtype=ACCUM_DTYPE,
                   device=qg.device)
    l = torch.zeros_like(m)
    c = torch.zeros_like(m)
    acc = torch.zeros(B, KV, R, hd_v, dtype=ACCUM_DTYPE, device=qg.device)
    first = int(torch.where(live, lo, Sk).min()) // block_k * block_k
    last = int(torch.where(live, hi, 0).max())
    for j0 in range(first, last, block_k):
        kb = k[:, j0:j0 + block_k].permute(0, 2, 3, 1)   # (B, KV, hd, bk)
        vb = v[:, j0:j0 + block_k].permute(0, 2, 1, 3)   # (B, KV, bk, hd_v)
        s = _product(q_words, words(kb), step, pairs) * scale
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        j = torch.arange(j0, j0 + kb.shape[-1], device=qg.device)
        s = torch.where((j >= lo) & (j < hi), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        p_words = bf16_words(p) if form != "mma_sync" else tf32_words(p)
        # (a sum, not a product with a ones column: on the CPU a matrix
        # by a vector adds in an order that depends on the batch)
        l_blk = torch.cat(p_words, -1).sum(-1, keepdim=True)
        l_old, c_old = l * corr, c * corr
        y = l_blk - c_old
        t = l_old + y
        touch = live & (j0 < hi) & (j0 + block_k > lo)
        c = torch.where(touch, (t - l_old) - y, c)
        l = torch.where(touch, t, l)
        pv_words = p_words if v.dtype == torch.float32 \
            else (p.to(v.dtype).to(ACCUM_DTYPE),)
        acc = acc * corr + _product(pv_words, words(vb), block_k, pairs)
        m = m_new
    lf = l - c
    o = torch.where(lf > 0.0, acc / torch.where(lf > 0.0, lf, 1.0), 0.0)
    return o.reshape(B, KV, Sq, G, hd_v).permute(0, 2, 1, 3, 4).to(v.dtype)


def decode_merge(m: torch.Tensor, l: torch.Tensor, c: torch.Tensor,
                 acc: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The decode form's merge: chunk states m, l, c (..., nch, R, 1) and
    acc (..., nch, R, hd_v), f32, with ``live`` (broadcastable to m) true
    where the chunk holds a valid key of the row, folded in chunk order
    (the module docstring's fold; a chunk that is not live is skipped) ->
    o (..., R, hd_v) f32, 0 for a row with no live chunk."""
    M = torch.full_like(m[..., 0, :, :], M_INIT)
    L = torch.zeros_like(M)
    C = torch.zeros_like(M)
    A = torch.zeros_like(acc[..., 0, :, :])
    live = live.expand(m.shape)
    for ch in range(m.shape[-3]):
        mc, ac, lv = m[..., ch, :, :], acc[..., ch, :, :], live[..., ch, :, :]
        lf = l[..., ch, :, :] - c[..., ch, :, :]
        mn = torch.maximum(M, mc)
        a = torch.exp(M - mn)
        b = torch.exp(mc - mn)
        y = lf * b - C * a
        la = L * a
        t = la + y
        C = torch.where(lv, (t - la) - y, C)
        L = torch.where(lv, t, L)
        A = torch.where(lv, A * a + ac * b, A)
        M = torch.where(lv, mn, M)
    lf = L - C
    return torch.where(lf > 0.0, A / torch.where(lf > 0.0, lf, 1.0), 0.0)


def _decode_plain(qg, k, v, lo, hi, *, scale: float, cap) -> torch.Tensor:
    """The decode form's walk: qg (B, Sq, KV, G, hd) f32 / bf16, k and v
    bf16, lo / hi (B, R) int64 row bounds (rows r = i G + g) -> o (B, KV,
    R, hd_v) f32.  Every chunk of every row is walked side by side along a
    chunk axis, DECODE_CHUNK / BLOCK_K_DC blocks in all, then
    ``decode_merge`` folds them."""
    B, Sq, KV, G, hd = qg.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    R, bk, dev = Sq * G, BLOCK_K_DC, qg.device
    nch = -(-Sk // DECODE_CHUNK)
    q_words = bf16_words(qg.permute(0, 2, 1, 3, 4).reshape(B, KV, 1, R, hd)
                         .to(ACCUM_DTYPE))
    lo = lo[:, None, None, :, None]                      # (B, 1, 1, R, 1)
    hi = hi[:, None, None, :, None]
    c0 = torch.arange(nch, device=dev) * DECODE_CHUNK
    cv = c0.view(1, 1, nch, 1, 1)
    live = (lo < hi) & (cv < hi) & (cv + DECODE_CHUNK > lo)
    m = torch.full((B, KV, nch, R, 1), M_INIT, dtype=ACCUM_DTYPE, device=dev)
    l = torch.zeros_like(m)
    c = torch.zeros_like(m)
    acc = torch.zeros(B, KV, nch, R, hd_v, dtype=ACCUM_DTYPE, device=dev)
    for i in range(0, DECODE_CHUNK, bk):
        j = c0[:, None] + i + torch.arange(bk, device=dev)   # (nch, bk)
        inside = (j < Sk)[None, :, :, None, None]
        jc = j.clamp(max=Sk - 1)
        # (B, KV, nch, hd, bk) and (B, KV, nch, bk, hd_v); keys past Sk 0
        kb = torch.where(inside, k[:, jc], 0).permute(0, 3, 1, 4, 2) \
            .to(ACCUM_DTYPE)
        vb = torch.where(inside, v[:, jc], 0).permute(0, 3, 1, 2, 4) \
            .to(ACCUM_DTYPE)
        sw = [torch.matmul(w, kb) for w in q_words]
        s = ((sw[0] + sw[1]) + sw[2]) * scale
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        jv = j.view(1, 1, nch, 1, bk)
        s = torch.where((jv >= lo) & (jv < hi), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        p_words = bf16_words(p)
        l_blk = torch.cat(p_words, -1).sum(-1, keepdim=True)
        l_old, c_old = l * corr, c * corr
        y = l_blk - c_old
        t = l_old + y
        j0 = cv + i
        touch = live & (j0 < hi) & (j0 + bk > lo)
        c = torch.where(touch, (t - l_old) - y, c)
        l = torch.where(touch, t, l)
        acc = acc * corr + torch.matmul(p_words[0], vb)
        m = m_new
    return decode_merge(m, l, c, acc, live)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_attention")
    ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_float)
    lib.b9_attention.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i, i,
                                 i, i, i, i, i, i, i, i, i, ll, f, i, f,
                                 ptr]
    lib.b9_attention.restype = i
    lib.b9_attention_form.argtypes = [i, i, ll, i, i]
    lib.b9_attention_form.restype = i
    lib.mma_attention_error_string.argtypes = [i]
    lib.mma_attention_error_string.restype = ctypes.c_char_p
    return lib


def cuda_form(q_dtype, kv_dtype, rows_per_head: int, hd: int,
              hd_v: int) -> str:
    """The form the CUDA source's chooser (``b9_attention_form``) takes
    for these dtypes and shape: ``walk``'s mirror, for the card's checks
    that the two agree."""
    codes = [_DTYPES[d] if isinstance(d, torch.dtype)
             else _DTYPES[getattr(torch, d)] for d in (q_dtype, kv_dtype)]
    got = _lib().b9_attention_form(*codes, int(rows_per_head), int(hd),
                                   int(hd_v))
    return _FORMS[got]


def attention_cuda(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   qpos: torch.Tensor, causal: bool = False, window=None,
                   kv_len=None, scale: float, cap=None) -> torch.Tensor:
    """B9 on CUDA tensors: qg (B, Sq, KV, G, hd) f32 / bf16, k (B, Sk, KV,
    hd) and v (B, Sk, KV, hd_v) f32 / bf16 (one dtype for both), qpos
    (B, Sq) int32, kv_len None or (B,) int32, all contiguous on one card
    (the cache is never copied).  Returns a new (B, Sq, KV, G, hd_v)
    tensor in v's dtype; one launch (two on the f32 prefill form: its
    word pass into a scratch of bf16 word planes, then the attention
    kernel; two on the decode form: its chunks' walk into an f32 scratch
    of their states, then their merge), checked.  A failed build or
    launch raises: no form falls back to another."""
    dev = qg.device
    _build.need_memory("B9", qg, k, v, qpos, kv_len)
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
    form = walk(qg.dtype, k.dtype, Sq * G, hd, hd_v)[0]
    words = None
    if form != "mma_sync":
        # TMA, cp.async and the word pass's 16-byte loads read from
        # 16-byte-aligned bases: a view that starts elsewhere is copied
        # (the form is fixed by the shape).
        qg, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (qg, k, v))
    if form == "decode":
        nch = -(-Sk // DECODE_CHUNK)
        if nch * KV >= 2 ** 31:
            raise ValueError(f"B9's decode form takes fewer than 2^31 chunks "
                             f"of its KV heads, got {nch} x {KV}")
        # The chunks' states: [b][h][chunk][row][m, l - c, acc], written by
        # the blocks whose chunk holds a valid key, read by the merge for
        # those alone (so not zeroed).
        words = torch.empty(B * KV * nch * Sq * G * (hd_v + 2),
                            dtype=torch.float32, device=dev)
    if form == "wgmma_f32":
        if max(B * Sq * KV * G, B * Sk * KV) >= 2 ** 31:
            raise ValueError(f"B9's f32 prefill form takes fewer than 2^31 "
                             f"rows of q and of k, got {tuple(qg.shape)}, "
                             f"Sk={Sk}")
        # The word pass's planes: three bf16 words of q (rows packed per
        # (batch, KV head), r = i G + g), of k and of v.
        words = torch.empty(
            WF_WORDS * B * KV * (Sq * G * hd + Sk * (hd + hd_v)),
            dtype=torch.bfloat16, device=dev)
    lib = _lib()
    args = (qg.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            None if words is None else words.data_ptr(),
            B, Sq, Sk, KV, G, hd, hd_v, _DTYPES[qg.dtype], _DTYPES[k.dtype],
            int(bool(causal)), 0 if window is None else 1,
            0 if window is None else int(window), float(scale),
            0 if cap is None else 1, 0.0 if cap is None else float(cap),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.b9_attention(*args)
    else:   # the launch goes to the host thread's current card
        with torch.cuda.device(dev):
            rc = lib.b9_attention(*args)
    if rc:
        msg = lib.mma_attention_error_string(rc).decode()
        raise RuntimeError(f"b9_attention launch failed: {msg} ({rc})")
    LAUNCHES[_COUNTERS[form]] += 1
    return out
