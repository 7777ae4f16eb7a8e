"""Public wrappers for the reduction kernels (B1-B5), the prefix-scan
kernel B6, the segmented-sum kernel B7, the fused RMSNorm kernel B8, the
fused attention kernel B9 and the fused RMSNorm -> matmul kernel B10 —
the counterpart of those parts of ``repro.kernels.ops``,
``repro.kernels.mma_attention`` and ``repro.kernels.mma_norm_matmul``.

They flatten, resolve ``'auto'`` geometry and pick the variant.  Where
the reference chose interpret mode off the TPU, the port chooses by the
tensor's device: a CUDA tensor launches the Hopper kernel (or the
kernel's wrapper raises), a CPU tensor runs the kernel's plain PyTorch
version on the reference's zero-padded ``(T, m)`` tiles.  There is no
fallback from one to the other.

B1's single pass, B8, B9 and B10 are also ``torch.library`` ops
(``torch.ops.repro_torch.b1_single_pass``, ``b8_rmsnorm``,
``b9_attention``, ``b10_norm_matmul``), each with a fake implementation
that gives its output's shape and dtype and reads no pointer, and B9 and
B10 with flop formulas.  A CUDA call goes through the op when its input
is not a plain tensor (a fake one, under the dry run's
``FakeTensorMode``) or a dispatch mode is on (the dry run's recorder,
``FlopCounterMode``, ``CommDebugMode``), which then sees the launch by
name; otherwise it calls the kernel's wrapper directly, as the op's CUDA
implementation does, and pays nothing for the op (an op costs 1-21 us
more a call when defined with ``torch.library.Library`` and ``impl``,
16-41 us as a ``custom_op``, on an H100: ``probes/wrapper_host_us.py
--ops``).  Every other launch
raises on a fake or a meta tensor before it reads a pointer
(``kernels._build.need_memory``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels import mma_attention as _ma
from repro_torch.kernels import mma_compensated as _mc
from repro_torch.kernels import mma_norm_matmul as _mnm
from repro_torch.kernels import mma_reduce as _mr
from repro_torch.kernels import mma_rmsnorm as _mrn
from repro_torch.kernels import mma_scan as _ms
from repro_torch.kernels import mma_segment as _mseg

M = _mr.M


def _traced(x) -> bool:
    """Whether a CUDA call goes through the kernel's op (see the module
    docstring)."""
    return type(x) is not torch.Tensor or \
        torch._C._len_torch_dispatch_stack() > 0


@torch.library.custom_op("repro_torch::b1_single_pass", mutates_args=(),
                         device_types="cuda")
def _b1_op(x: torch.Tensor, chain: int, block_rows: int,
           square: bool) -> torch.Tensor:
    return _mr.single_pass_cuda(x, chain=chain, block_rows=block_rows,
                                square=square)


@_b1_op.register_fake
def _b1_fake(x, chain, block_rows, square):
    return x.new_empty((), dtype=torch.float32)


@torch.library.custom_op("repro_torch::b8_rmsnorm", mutates_args=(),
                         device_types="cuda")
def _b8_op(x2d: torch.Tensor, weight: torch.Tensor, eps: float,
           weight_offset: float) -> torch.Tensor:
    return _mrn.rmsnorm_cuda(x2d, weight, eps=eps,
                             weight_offset=weight_offset)


@_b8_op.register_fake
def _b8_fake(x2d, weight, eps, weight_offset):
    return torch.empty_like(x2d)


@torch.library.custom_op("repro_torch::b10_norm_matmul", mutates_args=(),
                         device_types="cuda")
def _b10_op(x2d: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
            w_gate: Optional[torch.Tensor], bias: Optional[torch.Tensor],
            act: Optional[str], eps: float) -> torch.Tensor:
    return _mnm.norm_matmul_cuda(x2d, scale, w, w_gate=w_gate, bias=bias,
                                 act=act, eps=eps)


@_b10_op.register_fake
def _b10_fake(x2d, scale, w, w_gate, bias, act, eps):
    return x2d.new_empty((x2d.shape[0], w.shape[1]))


@register_flop_formula(torch.ops.repro_torch.b10_norm_matmul)
def _b10_flops(x_shape, scale_shape, w_shape, w_gate_shape, *args,
               **kwargs) -> int:
    """The projections' products (the gate pair's two)."""
    rows, d = x_shape
    return 2 * rows * d * w_shape[1] * (1 if w_gate_shape is None else 2)


@torch.library.custom_op("repro_torch::b9_attention", mutates_args=(),
                         device_types="cuda")
def _b9_op(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: torch.Tensor, causal: bool, window: Optional[int],
           kv_len: Optional[torch.Tensor], scale: float,
           cap: Optional[float]) -> torch.Tensor:
    return _ma.attention_cuda(qg, k, v, qpos=qpos, causal=causal,
                              window=window, kv_len=kv_len, scale=scale,
                              cap=cap)


@_b9_op.register_fake
def _b9_fake(qg, k, v, qpos, causal, window, kv_len, scale, cap):
    return v.new_empty((*qg.shape[:4], v.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.b9_attention)
def _b9_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """The scores' and the values' products over every key, masked or
    not, as ``FlopCounterMode`` counts ``scaled_dot_product_attention``."""
    b, sq, kv, g, hd = q_shape
    return 2 * b * sq * kv * g * k_shape[1] * (hd + v_shape[-1])


def _to_tiles(x, tile_rows: int, m: int):
    """Flatten x, zero-pad to a multiple of tile_rows*m, view as (T, m)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    per_tile = tile_rows * m
    padded = int(math.ceil(max(n, 1) / per_tile)) * per_tile
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    return flat.reshape(padded // m, m)


def _resolve_auto(x, chain, block_rows, *, op: str,
                  engine: str = "pallas"):
    """Turn chain/block_rows='auto' into the registry's tuned ints, from
    a plan tuned for this engine on x's device."""
    if chain == "auto" or block_rows == "auto":
        from repro_torch.core import autotune
        plan = autotune.get_plan(x.numel(), x.dtype, op=op, engine=engine,
                                 backend=x.device.type)
        if chain == "auto":
            chain = plan.chain
        if block_rows == "auto":
            block_rows = plan.block_rows
    return int(chain), int(block_rows)


def _flat(x, m: int, dtypes=_mr.DTYPES):
    """The kernels' input: flat, contiguous, 16-byte aligned, in a dtype
    they take (other floats are cast to f32, as the reference's JAX
    canonicalises them)."""
    if x.is_cuda and m != M:
        raise ValueError(f"the Hopper kernels use m={M}, got m={m}")
    if x.dtype not in dtypes:
        x = x.to(torch.float32)
    flat = x.reshape(-1)
    if x.is_cuda and not _build.memoryless(flat) and flat.data_ptr() % 16:
        flat = flat.clone()
    return flat


def _single_pass(flat, chain: int, block_rows: int, m: int,
                 square: bool = False):
    if flat.is_cuda:
        if _traced(flat):
            return _b1_op(flat, chain, block_rows, square)
        return _mr.single_pass_cuda(flat, chain=chain,
                                    block_rows=block_rows, square=square)
    return _mr.single_pass_plain(_to_tiles(flat, chain * block_rows, m),
                                 chain=chain, block_rows=block_rows,
                                 square=square)


def _partials(flat, chain: int, block_rows: int, m: int):
    if flat.is_cuda:
        return _mr.partials_cuda(flat, chain=chain, block_rows=block_rows)
    return _mr.partials_plain(_to_tiles(flat, chain * block_rows, m),
                              chain=chain, block_rows=block_rows)


def mma_reduce(x, *, variant: str = "single_pass", chain=4,
               block_rows=128, m: int = M,
               mma_fraction: float = 0.5) -> torch.Tensor:
    """Sum all elements of ``x`` via chained ones-MMAs. Returns an f32
    scalar tensor on x's device.

    ``chain``/``block_rows`` accept 'auto' (the plan registry's tuned
    geometry for the ``pallas`` engine); integers are the paper's R and
    B.  ``variant``:
      'single_pass'  one launch of B1 (paper §5.2).
      'recurrence'   B2 levels map n -> n/(chain*block_rows*m) f32
                     partials until one tile remains, which B1 sums
                     (paper §5.1 / Alg. 1).
      'split'        one launch of B3, ``mma_fraction`` of every
                     (block_rows, m) tile on the tensor cores (paper
                     §5.3; ignores ``chain``).
    Any other value raises ``ValueError``.
    """
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="reduce_sum")
    flat = _flat(x, m)
    if variant == "single_pass":
        return _single_pass(flat, chain, block_rows, m)
    if variant == "recurrence":
        while flat.numel() > chain * block_rows * m:
            flat = _partials(flat, chain, block_rows, m)
        return _single_pass(flat, chain, block_rows, m)
    if variant == "split":
        mma_rows = _mr.mma_rows_for(block_rows, mma_fraction)
        if flat.is_cuda:
            return _mr.split_cuda(flat, block_rows=block_rows,
                                  mma_rows=mma_rows)
        return _mr.split_plain(_to_tiles(flat, block_rows, m),
                               block_rows=block_rows, mma_rows=mma_rows)
    raise ValueError(f"unknown variant: {variant!r}")


def mma_squared_sum(x, *, chain=4, block_rows=128,
                    m: int = M) -> torch.Tensor:
    """sum(x^2) in one B1 launch: squares in the input dtype, chained
    ones-MMAs, f32 partials throughout.  ``chain``/``block_rows``
    accept 'auto'."""
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="squared_sum")
    return _single_pass(_flat(x, m), chain, block_rows, m, square=True)


def mma_reduce_partials(x, *, chain: int = 4, block_rows: int = 128,
                        m: int = M) -> torch.Tensor:
    """One recurrence level (B2): per-tile f32 partial sums, shape (G,)."""
    return _partials(_flat(x, m), int(chain), int(block_rows), m)


def _ec(x, split_words: int, chain: int, block_rows: int, m: int,
        square: bool):
    # B4 splits f32 words whatever the input dtype, as the reference's
    # kernel does, so other inputs are cast to f32 first.
    flat = _flat(x, m, dtypes=(torch.float32,))
    if flat.is_cuda:
        return _mc.ec_cuda(flat, chain=chain, block_rows=block_rows,
                           split_words=split_words, square=square)
    return _mc.ec_plain(_to_tiles(flat, chain * block_rows, m),
                        chain=chain, block_rows=block_rows,
                        split_words=split_words, square=square)


def mma_ec_reduce(x, *, split_words: int = 2, chain=2, block_rows=128,
                  m: int = M) -> torch.Tensor:
    """Compensated split-bf16 sum (the ``pallas_ec`` engine; kernel B4):
    each f32 value splits into ``split_words`` bf16 words, one ones-MMA
    chain runs per word, and TwoSum folds the lanes.  Returns an f32
    scalar at (near) correctly-rounded accuracy.  ``chain`` /
    ``block_rows`` accept 'auto' (plan registry, engine
    ``'pallas_ec'``)."""
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="reduce_sum", engine="pallas_ec")
    return _ec(x, int(split_words), chain, block_rows, m, square=False)


def mma_ec_squared_sum(x, *, split_words: int = 2, chain=2,
                       block_rows=128, m: int = M) -> torch.Tensor:
    """Compensated sum of squares (kernel B4): each value squared in f32
    before the word split, then reduced as ``mma_ec_reduce``."""
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="squared_sum", engine="pallas_ec")
    return _ec(x, int(split_words), chain, block_rows, m, square=True)


def _dd(x, chain: int, block_rows: int, m: int, square: bool):
    flat = _flat(x, m, dtypes=_mc.DD_DTYPES)
    if flat.is_cuda:
        return _mc.dd_cuda(flat, chain=chain, block_rows=block_rows,
                           square=square)
    return _mc.dd_plain(_to_tiles(flat, chain * block_rows, m),
                        chain=chain, block_rows=block_rows, square=square)


def mma_dd_reduce(x, *, chain=2, block_rows=128,
                  m: int = M) -> torch.Tensor:
    """Double-double sum (the ``pallas_dd`` engine; kernel B5): the
    input splits into elementwise (hi, lo) f32 pairs (exactly, for f64)
    inside the kernel and merges with ``dd_add``.  Returns the
    f64-equivalent shape-(2,) f32 pair ``[hi, lo]``; collapse it with
    ``core.precision.dd_value``.  ``chain`` / ``block_rows`` accept
    'auto' (plan registry, engine ``'pallas_dd'``)."""
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="reduce_sum", engine="pallas_dd")
    return _dd(x, chain, block_rows, m, square=False)


def mma_dd_squared_sum(x, *, chain=2, block_rows=128,
                       m: int = M) -> torch.Tensor:
    """Double-double sum of squares (kernel B5): each dd pair squared
    exactly with TwoProd, then reduced as ``mma_dd_reduce``.  Returns
    the shape-(2,) pair ``[hi, lo]``."""
    chain, block_rows = _resolve_auto(x, chain, block_rows,
                                      op="squared_sum", engine="pallas_dd")
    return _dd(x, chain, block_rows, m, square=True)


def mma_scan(x, *, inclusive: bool = True, chain=4, block_rows=128,
             m: int = M) -> torch.Tensor:
    """Prefix sum of the *flattened* ``x`` via triangular MMAs (kernel
    B6).  Returns the f32 inclusive (or exclusive) prefix in x's
    original shape, scanning in row-major flattened order — the kernel
    twin of ``repro_torch.core.scan.tc_scan`` over one axis.
    ``chain`` / ``block_rows`` accept 'auto' (plan registry, op
    ``'scan'``, engine ``'pallas'``)."""
    chain, block_rows = _resolve_auto(x, chain, block_rows, op="scan")
    flat = _flat(x, m)
    if flat.is_cuda:
        out = _ms.scan_cuda(flat, chain=chain, block_rows=block_rows,
                            inclusive=inclusive)
    else:
        out = _ms.scan_plain(flat, chain=chain, block_rows=block_rows,
                             inclusive=inclusive)
    return out.reshape(x.shape)


def _ids_for_kernel(ids, num_segments: int):
    """B7's ids: int32, contiguous, 16-byte aligned.  int32 ids are read
    as given; wider ones are clamped to [-1, S] and cast in one pass, so
    an id past int32 cannot wrap into a segment."""
    if ids.dtype != torch.int32:
        ids = ids.clamp(-1, num_segments).to(torch.int32)
    if not ids.is_contiguous() or ids.data_ptr() % 16:
        ids = ids.contiguous().clone()
    return ids


def mma_segment_sum(values, segment_ids, num_segments: int, *,
                    block_rows=128, m: int = M) -> torch.Tensor:
    """Segmented sum via MMAs against the one-hot segment matrix (kernel
    B7).  ``values`` and ``segment_ids`` are flattened together; returns
    (num_segments,) f32 on values' device.  Empty segments are 0 and an
    id outside [0, num_segments), -1 included, adds nothing.

    ``block_rows`` (rows of 16 elements a block takes per step; one warp
    per 16 rows) accepts 'auto' (plan registry, op ``'segment_sum'``).
    No segment count clamps it: the per-block accumulator holds
    ``kernels.mma_segment.pass_segments`` segments (227 KB of shared
    memory per block), and more segments run in passes.  Integer and
    other float values are cast to f32.
    """
    _, block_rows = _resolve_auto(values, 1, block_rows, op="segment_sum")
    s = int(num_segments)
    flat = _flat(values, m)
    ids = torch.as_tensor(segment_ids, device=flat.device).reshape(-1)
    if ids.numel() != flat.numel():
        raise ValueError(f"{ids.numel()} ids for {flat.numel()} values")
    if flat.is_cuda:
        _build.need_memory("B7", flat, ids)
        return _mseg.segment_cuda(flat, _ids_for_kernel(ids, s), s,
                                  block_rows=block_rows)
    if not _mr.block_rows_ok(block_rows):
        raise ValueError(f"block_rows={block_rows} is not a multiple of "
                         f"{M} in [{M}, {_mr.MAX_BLOCK_ROWS}]")
    return _mseg.segment_plain(
        flat, ids, s, block_rows=block_rows,
        blocks=_mseg.grid_blocks(flat.numel(), block_rows, flat.device))


def mma_rmsnorm(x, weight, *, eps: float = 1e-6,
                weight_offset: float = 0.0) -> torch.Tensor:
    """Fused RMSNorm over the last dim of ``x`` (any leading dims),
    ``(x * rsqrt(mean(x^2) + eps)) * (weight + weight_offset)`` with the
    statistic in f32 whatever x's dtype; returns x.dtype in x's shape.

    A CUDA tensor (f32 or bf16) launches kernel B8, a CPU tensor runs
    its plain version; there is no fallback from one to the other.  The
    geometry is fixed by the card, not tuned: 16 rows (the m of the
    m16n8k16 MMA) are split across a thread-block cluster whose blocks
    each hold their slice in shared memory, so x is read once for any
    d >= 1 up to 24576 in f32 and 49152 in bf16 (wider rows are read a
    second time for the scaling pass), and the split is a function of d
    and the dtype alone (``kernels.mma_rmsnorm.walk``), so a row's bits
    do not depend on the batch.  The reference's 8 MiB VMEM row budget
    and its row padding are TPU facts: B8 masks ragged rows and columns
    and reads an unaligned input where it lies, and this wrapper copies
    nothing but a non-contiguous input.

    Folded behind the ``norm_matmul`` registry entry as the
    ``fused_pallas`` engine's norm-only (``w=None``) form; callers go
    through ``repro_torch.models.layers.rmsnorm`` / ``norm_matmul``.
    """
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    weight = torch.as_tensor(weight, device=x.device)
    if x2d.is_cuda:
        x2d = x2d.contiguous()
        out = _b8_op(x2d, weight, float(eps), float(weight_offset)) \
            if _traced(x2d) else \
            _mrn.rmsnorm_cuda(x2d, weight, eps=eps,
                              weight_offset=weight_offset)
    else:
        out = _mrn.rmsnorm_plain(x2d, weight, eps=eps,
                                 weight_offset=weight_offset)
    return out.reshape(x.shape)


def mma_norm_matmul(x, scale, w, *, w_gate=None, bias=None, act=None,
                    eps: float = 1e-6) -> torch.Tensor:
    """Fused ``rmsnorm(x) @ w``: x (..., d), scale (d,) with the gemma
    ``(1 + scale)`` weighting, w (d, dout) -> (..., dout) in x.dtype,
    without materialising the normalised rows.  ``bias`` (dout,) is
    added to the plain projection; with ``w_gate`` (d, dout) the output
    is the MLP pair ``act(rmsnorm(x) @ w_gate) * (rmsnorm(x) @ w
    [+ bias])``, ``act`` None, 'silu' or 'gelu' (tanh form).

    A CUDA tensor (f32 or bf16; weights f32 or bf16, independently of x)
    launches kernel B10, a CPU tensor runs its plain version; there is
    no fallback from one to the other.  The geometry is fixed by the
    card, not tuned (the reference's ``chain`` / ``block_rows`` knobs
    shaped its TPU grid): a block holds one 128 x 128 tile of the
    combined projection and walks k in a loop, so any d fits, where the
    reference padded d to 128 lanes and held the whole (rows, dout)
    accumulator in VMEM.

    Reached through the ``norm_matmul`` registry entry as the
    ``fused_pallas`` engine with ``w`` given; callers go through
    ``repro_torch.models.layers.norm_matmul`` / ``fused_mlp``.
    """
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    scale = torch.as_tensor(scale, device=x.device)
    if x2d.is_cuda:
        x2d = x2d.contiguous()
        out = _b10_op(x2d, scale, w, w_gate, bias, act, float(eps)) \
            if _traced(x2d) else \
            _mnm.norm_matmul_cuda(x2d, scale, w, w_gate=w_gate, bias=bias,
                                  act=act, eps=eps)
    else:
        out = _mnm.norm_matmul_plain(x2d, scale, w, w_gate=w_gate,
                                     bias=bias, act=act, eps=eps)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def mma_attention(qg, k, v, *, qpos, causal: bool = False, window=None,
                  kv_len=None, scale=None, cap=None) -> torch.Tensor:
    """Fused attention: qg (B, Sq, KV, G, hd), k (B, Sk, KV, hd), v (B, Sk,
    KV, hd_v) -> (B, Sq, KV, G, hd_v) in v.dtype, without the score
    matrix in device memory.  ``qpos`` is (Sq,) shared or (B, Sq) per-row
    absolute positions (key positions are 0..Sk-1); ``kv_len`` (None, a
    scalar or (B,)) masks ring-buffer slots past the valid count;
    ``window`` the sliding window, ``cap`` the logit softcap, ``scale``
    defaults to 1 / sqrt(hd).  A row with no valid key gives exactly 0.

    CUDA tensors (qg f32 or bf16; k and v f32 or bf16, independently of
    qg: f32 activations read a bf16 cache as it is) launch kernel B9, CPU
    tensors run its plain version; there is no fallback from one to the
    other.  The geometry is fixed by the card and by the kernel's form
    (``kernels.mma_attention.walk``: 64 query rows and 32 keys a step on
    mma.sync, 128 rows and 64 keys on the bf16 prefill form's wgmma, chunks
    of 2048 keys walked 16 at a time on the decode form), not tuned: the reference's ``chain`` / ``block_rows`` shaped its TPU
    grid.

    Reached through the ``attention`` registry entry as the
    ``fused_pallas`` engine; callers go through
    ``repro_torch.models.attention.attention``.
    """
    B, Sq = qg.shape[:2]
    scale = qg.shape[-1] ** -0.5 if scale is None else float(scale)
    qpos = torch.as_tensor(qpos, device=qg.device).to(torch.int32)
    qpos = qpos.expand(B, Sq).contiguous()
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=qg.device).to(torch.int32)
        kv_len = kv_len.reshape(-1).expand(B).contiguous()
    kw = dict(qpos=qpos, causal=causal, window=window, kv_len=kv_len,
              scale=scale, cap=cap)
    if qg.is_cuda:
        qg, k, v = qg.contiguous(), k.contiguous(), v.contiguous()
        if _traced(qg):
            return _b9_op(qg, k, v, qpos, causal,
                          None if window is None else int(window), kv_len,
                          scale, None if cap is None else float(cap))
        return _ma.attention_cuda(qg, k, v, **kw)
    return _ma.attention_plain(qg, k, v, **kw)
