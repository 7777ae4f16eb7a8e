#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

The main path is the paper's chained ones-MMA reduction:
``repro_torch.core.integration.reduce_sum`` / ``squared_sum`` ->
``core.dispatch`` -> the engines ``pallas`` (kernels B1-B3, CUDA C++ for
sm_90a), ``mma``, ``mma_chained`` and ``vpu``.  Phases, each of which
raises (and so exits non-zero) when it fails:

  1. device: the card's name and power limit, and the kernels' build;
  2. kernels against their plain PyTorch versions on the card, at
     n = 2^20 and 2^20 + 13, in f32, bf16 and fp16, over a few
     (chain, block_rows); and on counting inputs (0 and 1) that end in a
     ragged tail (n = 13, one tile + 13, 2^20 + 13), where kernel, plain
     version and the exact count must agree bit for bit; B1 and B3 also
     at 2^24 - 3 (R1 B16) and 2^26 - 3 (R1 B32), where every block of
     their walk takes 8 tiles, on normal and on counting inputs, and
     the CUDA library's walk must be ``walk``'s;
  3. the main path at n = 2^28 (uniform [0, 1] and normal; 1 GiB in f32,
     512 MiB in bf16 / fp16) through every engine and ``auto``, held to
     the reference's error ceilings against an f64 oracle on the cast
     input; the kernels' launch counters are zeroed before it and must
     have moved after it;
  4. one measured autotune sweep at n = 2^24, beside the model's pick;
  5. each kernel at the main path's shapes: held against its plain
     version (rounded data) and the exact count (counting data), then
     its median time (CUDA events) beside its bound, its plain version's
     time and ``torch.sum``'s, in every dtype with its share of the
     bound and its ratio to ``torch.sum``.  Phase 1 holds B1-B3's build
     to 0 spill bytes.

The compensated and double-double tier (kernels B4, B5; CUDA C++ in
``csrc/mma_compensated.cu``) adds its own phases beside those:

  2b. B4 and B5 against their plain versions on the card at n = 2^20 and
      2^20 + 13 (split_words 2 and 3, squares on and off, two
      geometries; B5 on f32 and f64 input), and on counting inputs,
      where kernel, plain version and count agree bit for bit, also at
      n = 2^28;
  3c. the tier's path at n = 2^28 (uniform [0, 1] and normal; 1 GiB of
      f32, 2 GiB of f64): ``reduce_sum`` / ``squared_sum`` through
      ``pallas_ec`` (2 and 3 words), ``mma_ec``, ``auto`` under
      ``MmaPolicy(split_words=3)``, and ``pallas_dd``, ``mma_dd`` and
      ``auto`` under ``F64_EQUIVALENT``, held to the reference's ec
      (1e-4 %) and dd (1e-10 %) ceilings against the f64 oracle of the
      input as given; B4's and B5's counters are zeroed before it and
      must have moved after it;
  3d. the integration example (``repro_torch.examples.integrate``) with
      ``auto`` and with ``pallas_dd``: the dd rows pass the 1e-12 gate,
      ``mma`` and ``mma_ec`` fail it;
  5b. B4 (2 and 3 words) and B5 (f64 and f32 input) timed at 2^28 beside
      their bound, their plain version and ``torch.sum(x, float64)``;
  6.  the cost model against the card: ``pallas`` over its R x B grid,
      ``vpu`` and ``mma`` timed at 2^20, 2^24 and 2^28 in f32, bf16 and
      fp16, the model's two estimated constants (``_STEP_US`` and the
      walk's ``_WALK_BLOCK_US``) fitted to each dtype's times, and the
      model's pick (with the constants as committed) held to 1.25x the
      measured best at each size and dtype, the two timed again in
      turns where they differ.

The prefix-scan path (kernel B6; CUDA C++ in ``csrc/mma_scan.cu``):
``repro_torch.core.integration.cumsum`` / ``masked_cumsum`` ->
``core.dispatch`` ops ``scan`` / ``masked_cumsum`` -> the engines
``pallas`` (B6), ``mma_chained``, ``mma_ec`` and ``vpu``.  Its phases:

  2c. B6 against ``scan_plain`` on the card at n = 2^20 and 2^20 + 13, in
      f32, bf16 and fp16, over three (chain, block_rows), inclusive and
      exclusive, within 2^-16 of the running sum|x| at every position;
      on counting inputs (n = 13, one tile + 13, 2^20 + 13, and 2^28 at
      the main geometry), where kernel, plain version and the exact
      int64 prefix agree bit for bit; and B6's look-back, whose tile
      carries must not depend on timing: two calls at 2^28 on normal
      input give the same bits at the main geometry and at chain 1,
      block_rows 32 (524288 tiles, the longest walks), and so does a
      call made while another stream runs large matmuls;
  3e. the scan path at n = 2^28 (uniform [0, 1] and normal, f32 and
      bf16): ``cumsum`` and ``masked_cumsum`` (a 0/1 mask from the seed)
      through every engine and ``auto``, each position's error relative
      to the running sum|x| there, against an f64 cumsum of the cast
      input, the maximum held to 5e-3 % (``vpu`` is ``torch.cumsum``:
      printed, not gated); B6's counter is zeroed before it and must
      have moved after it;
  5c. B6 timed at 2^28 (f32, bf16; chain 4, block_rows 128) beside its
      bound, the byte time of a form that reads x twice (under it, x was
      read once), ``scan_plain``, ``torch.cumsum`` and its look-back's
      forward steps a tile.  Phase 1 holds B6's build to 0 spill bytes.

The segmented-sum path (kernel B7; CUDA C++ in ``csrc/mma_segment.cu``):
``repro_torch.core.integration.segment_sum`` -> ``core.dispatch`` op
``segment_sum`` -> the engines ``pallas`` (B7), ``mma`` (the one-hot
contraction) and ``vpu`` (``index_add_``).  Its phases:

  2d. B7 against ``segment_plain`` on the card at n from 1 to 2^24
      (ragged tails included), S in {1, 19, 128, 256, 4096} (one, two
      and 32 blocks of 128 segments: register and shared-memory sums;
      4096 runs six passes at block_rows 512), random and sorted ids
      with -1 and out-of-range ids
      mixed in, f32, bf16 and fp16, within 2^-20 of each segment's
      sum|x|; and on counting inputs, where kernel, plain version and
      the exact count agree bit for bit, also at n = 2^28 with S = 128;
  3f. the segment path at n = 2^28: 128 segments with random ids (the
      reference's measured problem) and 256 with sorted ids in
      contiguous runs (DeepSeek-V3's routed experts, tokens ordered by
      expert), uniform [0, 1] and normal, f32 and bf16, through every
      engine and ``auto``; each segment's error relative to its sum|x|
      against the f64 segment sums, the maximum held to 5e-3 % (``vpu``
      printed, not gated); B7's counter is zeroed before it and must
      have moved after it;
  5d. B7 timed at 2^28 in both configurations (f32, bf16) beside its
      bound (bytes, or one MMA per group, word and 128-segment block
      hit) and its share of it, ``segment_plain``, ``index_add_``,
      ``torch.bincount`` (f64 out for bf16 weights) and the ``vpu``
      engine, bit-identical over two calls (every time the median of 15
      CUDA event timings); ``auto`` resolves to ``pallas`` and runs
      within 1.25x of the fastest engine timed; the cost model's two
      segment constants refitted from the f32 random case.  Phase 1
      holds B7's build to 0 spill bytes.

The norm path (kernels B8 and B10; CUDA C++ in ``csrc/mma_rmsnorm.cu``
and ``csrc/mma_norm_matmul.cu``): ``repro_torch.models.layers.rmsnorm``
/ ``norm_matmul`` / ``fused_mlp`` -> ``core.dispatch`` op
``norm_matmul`` -> the engines ``fused_pallas`` (B8 for the norm-only
form, B10 with ``w`` given), ``unfused_mma`` and ``vpu``.  Its phases:

  2e. B8 against ``rmsnorm_plain`` on the card, rows in {1, 17, 64, 4099}
      and d in {17, 40, 256, 2304, 4096, 7168, 7169}, f32 and bf16,
      weight_offset 0 and 1, on values of magnitude [0.5, 1] with random
      signs: f32 within 2^-20 relative plus 2^-24, bf16 within one ulp,
      two calls the same bits; rows too wide for shared memory (f32
      24577, 32768); views whose base is not 16-byte aligned, one launch
      each with an aligned copy's bits; a row's bits the same at 1, 17
      and 4099 rows; the CUDA walk equal to ``walk``;
  2f. B10 against ``norm_matmul_plain`` on the card, rows in {1, 17, 128}
      x d in {40, 256, 2304, 7168} x dout in {8, 100, 9216}, without a
      gate, with a silu gate and a bias, with a gelu gate; d 2305 with
      rows 64, 65, 129 and dout 200, 9217 (ragged against the k steps,
      the output tiles and the warpgroups' rows); then 4099 rows at d
      2304 and 7168 and dout 9216; x and weights in f32, in bf16, bf16 x
      with f32 weights and f32 x with bf16 weights (every form of the
      walk): within 2^-20 of each output's absolute-value scale (bf16
      plus one ulp), two calls the same bits, rows 0..r-1 of a 4099-row
      call the bits of an r-row call (r 17, 65, 129), the CUDA walk
      ``walk``'s.  Phase 1 holds B10's build to 0 spill bytes;
  3g. ``layers.rmsnorm`` through fused_pallas, unfused_mma, mma, vpu and
      auto, and the norm-only ``layers.norm_matmul`` through each of its
      engines and auto, at 65536 x 2304 (Gemma-2 2B prefill) and
      16384 x 7168 (DeepSeek-V3's width), f32 and bf16: Frobenius %
      error against the f64 oracle within the reference's NM_GATES
      (bf16 plus 100 * 2^-8 %); B8's counter must move; at the Gemma
      shape norm_matmul's auto plan runs within 1.25x of its fastest
      engine (both the fastest of their medians over balanced rounds);
  3h. ``norm_matmul`` with w given (``layers.norm_matmul`` with the
      config's gate and ``layers.fused_mlp``) at the MLP widths of the
      ported configs: Gemma-2 2B (2304 -> 9216, gelu) in f32, bf16,
      bf16 rows with f32 weights and f32 rows with bf16 weights (every
      form of B10's walk), DeepSeek-V3's dense MLP (7168 ->
      18432, silu) in bf16, each at 4096 rows (prefill) and 128 (a
      decode step), and on the reference's own problem, through
      fused_pallas (B10), unfused_mma, vpu and auto, within NM_GATES
      (bf16 plus the unit roundoff per rounding to bf16 on the path:
      B10 rounds only its output); B10's counter must move; auto within
      1.25x of the fastest engine at each Gemma shape and dtype;
      unfused_mma equals the two-op path bit for bit;
  5e. B8 timed at 65536 x 2304, 16384 x 7168 and 64 x 2304 (f32, bf16)
      beside its bound, the byte time of a form that reads x twice,
      ``rmsnorm_plain`` and ``F.rms_norm``, with its walk, shared memory
      a block and ptxas registers (no spills); at the decode step the
      host's work per call, B8's wrapper beside ``F.rms_norm``;
  5f. B10 timed at 3h's shapes beside its bound (bytes / 3.35 TB/s or
      flops / 989 TFLOP/s for bf16 weights, 495 TF32 for f32 ones),
      ``norm_matmul_plain`` and the ``unfused_mma`` engine as the
      yardstick (no single PyTorch call computes the function), a
      call's launches together (the row pass, an f32 weight's pass, the
      projections), and the launches' device time under
      torch.profiler; the cost model's B10 flop rate refitted per form
      ("x dtype/w dtype") and its byte rate from the decode shapes, both
      from the device time, and its host time per call with w given per
      engine at 8 x 256 x 256;
  6b. ``cumsum``'s engines and the plan ``auto`` resolves to, timed at
      2^20, 2^24 and 2^28 in f32 and bf16: the pick within 1.25x of the
      fastest; the model's host time per scan call refitted at 2^12;
      B6's R x B grid timed in bf16 at 2^24, 2^26 and 2^28 (printed).

The attention path (kernel B9; CUDA C++ in ``csrc/mma_attention.cu``):
``repro_torch.models.attention.attention`` -> ``core.dispatch`` op
``attention`` -> the engines ``fused_pallas`` (B9), ``unfused_mma``
(the KV-chunked online softmax) and ``vpu`` (the unchunked oracle).  B9
has four forms, chosen from dtypes and shape (``walk``): the bf16
prefill form (wgmma fed by TMA; counter ``b9_attention_wgmma``), the f32
prefill form (a word pass, then wgmma fed by TMA; ``b9_attention_f32``),
the decode form (each row's keys in chunks that blocks walk side by
side, then a merge in chunk order; ``b9_attention_decode``) and the
mma.sync form for the rest (``b9_attention``).  Its phases:

  2g. B9 against ``attention_plain`` on the card (B9_CASES): f32, bf16
      and f32 q beside a bf16 cache; hd 256 with G 2 and KV 4, 128, and
      192 / 128; Sq G and Sk ragged against the tiles; causal, window,
      softcap 50, per-row qpos with kv_len, rows at qpos -1; and in bf16
      B9_WG_CASES, which the wgmma form takes (rows a head 17 to 8192,
      Sk ragged against its 64-key blocks, hd 16 to 256), and in f32
      B9_WF_CASES (the f32 B9_CASES with more than 16 rows a head and
      hd, hd_v multiples of 16 take the f32 prefill form too), and in
      f32 q and in bf16 beside a bf16 cache B9_DC_CASES, which the decode
      form takes (rows spanning one to three chunks, Sk not a multiple of
      the chunk, rows with no key, 1 to 16 rows a head; the decode
      B9_CASES take it too): within 2^-20 (1 + sigma) of each output's
      absolute-value scale (bf16 v 2^-8 of it more and one ulp;
      B9_RTOL), two calls the same bits, a row's bits those of a one-row
      call, rows with no key exactly 0; each case's counter is its
      form's, and the CUDA chooser agrees with ``walk``; each of the four
      forms runs;
  3i. Gemma-2 2B's attention layer at full width (weights from the
      seed) through ``models.attention.attention`` with attn_method
      fused_pallas (B9), unfused_mma, vpu and auto: the global layer at
      4096 tokens and the local one at 8192 (f32 and bf16), and a decode
      step of 128 slots at per-row positions over [0, 32768) against
      bf16 ring caches of 32768 and 4096 slots (f32 and bf16
      activations), and against an f32 ring of 4096 slots (f32
      activations; unfused_mma refuses decode); and GLM-4 9B's layer at
      the same decode step over its bf16 ring of 32768 slots (f32
      activations; 16 rows a KV head); each engine's attention output
      held to the f64 oracle of its own qg / k / v within ATTN_CEILINGS
      plus 100 * 2^-8 % per rounding to bf16; the wgmma form's counter
      must move at the bf16 prefill shapes, the f32 prefill form's at the
      f32 ones, the decode form's at the five decode steps over a bf16
      ring and the mma.sync form's over the f32 ring, each alone; auto within 1.25x of the fastest engine at every
      shape, the layer timed in balanced orders;
  5g. B9 timed at 3i's shapes beside its bound (bytes / 3.35 TB/s or 2
      (hd + hd_v) flops per live score / 495 TF32 or 989 bf16 TFLOP/s),
      ``attention_plain`` and ``unfused_mma``; with cap=None B9 beside
      ``F.scaled_dot_product_attention``, the library yardstick (no
      softcap there), at every shape; at the f32 prefill shapes and the
      five decode steps over a bf16 ring also the mma.sync form as they
      ran before the f32 prefill and decode forms
      (``probes/b9_variants.py``'s mma_sync build), and the f32
      form's word pass and attention kernel, or the decode form's walk
      and merge, by torch.profiler's device time; the wgmma forms' and
      the decode form's registers and spills from ptxas (no spills); the
      cost model's B9 flop and byte rates and its attention host times
      per call refitted.

The model zoo's forward path (``models.transformer``, ``model_zoo``,
``mla``, ``moe``, ``rwkv6``, ``rglru``) reaches B8, B9 and B10 under the
config spellings ``reduce_method``, ``norm_matmul_method`` and
``attn_method`` = 'fused_pallas'.  Its phase runs after 5g, once phase
3i's operands are freed:

  3j. (a) every arch at its SMOKE size on the card with the plain
      engines: ``logits``, a finite loss within 3 of ln V, and a prefill
      of 2 x 12 tokens then one decode step within the reference's
      bound, max|got - ref| < 0.05 (max|ref| + 1), of the whole
      sequence's last logits; (b) Gemma-2 2B (4 layers: 2 local + 2
      global) and (c) DeepSeek-V3 (2 layers: one dense, one MoE; bf16
      params) at full width with the kernel spellings: the launch
      counters zeroed, a prefill of 4096 tokens and 16 decode steps
      (over the 4096-slot local ring), the counters read (B8, B10 and
      B9's wgmma form must move, and for Gemma-2 2B its decode form),
      then those 17 positions' logits within the same bound of
      ``logits`` over the whole sequence and of the plain engines on the
      same params (DeepSeek-V3's plain attention the chunked
      unfused_mma); the MoE's counts (= T k) and the tokens its capacity
      dropped; the median ms per prefill and per decode step (CUDA
      events, 5 calls after a warm one) beside the card's name and power
      limit, and each call's device time (a torch.profiler trace); the
      peak memory; (b') which engine ``auto`` takes for an f32 model's
      decode step over f32 caches.

It prints the card's ``nvidia-smi`` line, a ``{"kernels": [...]}`` line
(B1-B10, B9 once per form: its bf16 and f32 prefill forms at the global
prefill, the decode form at the global decode step with f32 q, the
mma.sync form at the local decode step over an f32 ring), and last
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without a CUDA card, or without the
repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

SEED = 0
N_MAIN = 1 << 28
N_CHECK = (1 << 20, (1 << 20) + 13)
N_TUNE = 1 << 24
GEOMETRIES = ((1, 32), (4, 128), (5, 512))      # (chain, block_rows)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
METHODS = ("pallas", "mma", "mma_chained", "vpu", "auto")
VARIANTS = ("single_pass", "recurrence", "split")
# The main path's kernel geometry: the hooks' chain=4 and the plan's
# default block_rows=128.
CHAIN, BLOCK_ROWS = 4, 128

# Percent-error ceilings of scripts/check_error_budget.py GATES (copied:
# this script imports nothing of the JAX package).  The reference gates
# uniform [0, 1] input, where the error relative to sum|x| is its percent
# error; on normal input, whose sum cancels, the same ceilings bound the
# error relative to sum|x| (the sum's condition number is not the
# engine's doing).  squared_sum is held to its engine's ceiling, against
# the squares the engine is specified to take (see run_main_path).
CEILINGS = {"vpu": 5e-4, "mma": 5e-3, "mma_chained": 5e-3, "pallas": 5e-3}

# Kernel against plain version on rounded data, both on the card:
# |kernel - plain| <= 2^-16 * sum|x| (sum of |x*x| with squares; per
# tile for B2).  Both accumulate in f32 in another order (atomics in B1
# and B3 change it from run to run), the tensor cores' adders truncate,
# and f32 input goes in as two TF32 words.  The largest ratio seen in
# sound runs is 2^-18.3 (B1 squares, bf16, n = 2^28), so the bound keeps
# a margin of about 5.  It cannot see one element or one tile go
# missing; the counting checks below can.
KERNEL_RTOL = 2.0 ** -16

# Counting inputs: values 0 and 1, a share of them 1, the last TAIL all
# 1, followed in memory by ones that lie past n.  Every partial sum is
# an integer below 2^24, so f32 adds in any order, the TF32 and 16-bit
# MMAs and the squares are all exact: kernel, plain version and the f64
# count must be equal.  A kernel that drops, repeats or misplaces an
# element, a tile or the tail, or reads past n, misses the count.
TAIL = 13
COUNT_SHARE_CHECK = 0.25        # n <= 2^20 + 13: counts below 2^19
COUNT_SHARE_MAIN = 1.0 / 32     # n = 2^28: counts near 2^23

# B1 and B3 walk their tiles on kernels.mma_reduce.walk's grid, each
# block ceil(8 / chain) tiles: sizes (chain, block_rows, n) at which
# every block of B1 and of B3 (at chain 1, the same block_rows) walks
# WALK_MIN_TILES tiles, with a ragged last tile (65536 tiles of 256
# elements, 131072 of 512); counting inputs with a 1/32 share of ones
# keep their counts near 2^19 and 2^21.
WALK_CASES = ((1, 16, (1 << 24) - 3), (1, 32, (1 << 26) - 3))
WALK_MIN_TILES = 8

# The pallas engine squares in the input dtype.  A square rounded to
# nearest in a dtype of unit roundoff u differs from the exact square by
# at most u * x^2, or half the subnormal spacing eta below the normal
# range, so its squared sum may lie at most u * sum x^2 + n * eta
# beyond its ceiling from the exact sum of squares: (u, eta) per dtype.
SQUARE_ROUNDING = {torch.float32: (2.0 ** -24, 2.0 ** -150),
                   torch.bfloat16: (2.0 ** -8, 2.0 ** -134),
                   torch.float16: (2.0 ** -11, 2.0 ** -25)}

# H100 SXM peaks (NVIDIA data sheet, dense): bytes and tensor-core flops.
HBM_BYTES_PER_S = 3.35e12
TC_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12,
            torch.float16: 989e12}
CUDA_CORE_FLOPS = 67e12
# Tensor-core flops per element a ones-MMA link spends: m16n8k16 (bf16,
# fp16) is 4096 flops per 256 elements; f32 runs four m16n8k8 TF32 MMAs
# (hi and lo words) per 256 elements, 8192 flops.
MMA_FLOPS_PER_ELEMENT = {torch.float32: 32, torch.bfloat16: 16,
                         torch.float16: 16}


# The tier's ceilings, the reference's GATES values (copied as above):
# ec = mma_ec_w2 / mma_ec_w3 / pallas_ec_w2 / sq_mma_ec_w2, dd = mma_dd /
# pallas_dd / sq_mma_dd / sq_pallas_dd; held on both input classes.
EC_CEILING = 1e-4
DD_CEILING = 1e-10
# B4 / B5 geometries of the kernel phase: the main path's (chain 4,
# block_rows 128) and the sweep's largest tile (5, 512).
TIER_GEOMETRIES = ((CHAIN, BLOCK_ROWS), (5, 512))

# B4 against its plain version: |kernel - plain| <= 2^-21 * sum|x|
# (sum of x*x with squares).  Both fold exact TwoSum steps over the
# same bf16 words, so they differ only in how each 16-element row of a
# word is summed before its fold, in the tensor cores (whose adders may
# truncate) or in an f32 torch.sum: at most 2^-23 of the rows' |sums|
# per side, all of one sign in the worst case, plus each side's final
# f32 rounding.  The largest ratio seen in sound runs is 2^-24.0, one
# f32 ulp of the result.
EC_RTOL = 2.0 ** -21
# B5 against its plain version: |kernel - plain| <= 2^-40 * sum|x|.
# Each dd_add rounds its folded low words once, ~2^-47 of its operands;
# the kernel chains up to 40 per thread plus log-depth trees (about 60
# steps deep, 2^-41), the plain version a tree of log2 n levels.  The
# largest ratio seen in sound runs is 2^-48.
DD_RTOL = 2.0 ** -40
# FP64 outside the tensor cores on the H100 SXM (NVIDIA data sheet).
FP64_FLOPS = 34e12
# Operations per element the tier's kernels do, counted from
# csrc/mma_compensated.cu.  B4, per bf16 word: a cvt to bf16, a cvt
# back, a subtract, half a pack, and 2 TwoSum folds (7 ops) per lane of
# 8 elements on the CUDA cores, 4.25 in all, plus 16 tensor-core flops
# (m16n8k16 against ones: 4096 flops per 256 elements); squares add one
# multiply.  B5: 3 f64 ops to split an f64 value (two cvts, a
# subtract), ~11 f32 ops per dd_add, 10 more for a dd square.
B4_CUDA_OPS_PER_WORD = 4.25
B4_TC_FLOPS_PER_WORD = 16
B5_F32_OPS, B5_SQUARE_OPS, B5_F64_SPLIT_OPS = 11, 10, 3

# The scan path (phases 2c, 3e, 5c).  Each prefix is a sum, so the
# engines are held to the reduce family's mma / pallas ceiling, taken
# at each position relative to the running sum|x| there (the reference
# gates no scan).  vpu is torch.cumsum, not the port's arithmetic.
SCAN_METHODS = ("pallas", "mma_chained", "mma_ec", "vpu", "auto")
SCAN_CEILING = CEILINGS["pallas"]
# B6 against scan_plain: |kernel - plain| <= 2^-16 of the running sum|x|
# at every position (KERNEL_RTOL's reasoning: both take f32 sums in
# another order; f32 input goes in as two TF32 words).
SCAN_RTOL = KERNEL_RTOL
# Phase 2c's repeat checks: the geometry with the most tiles at 2^28
# (524288, so the longest look-back walks), and the matmuls (8192^2 f32,
# ~1.1 TFLOP each) another stream runs beside one call.
SCAN_LONGEST_WALK = (1, 32)
SCAN_BUSY_MATMULS = 8
# Operations per element B6 does, counted from csrc/mma_scan.cu: six
# m16n8k8 TF32 MMAs per 16 x 16 slab in f32 (48 flops per element), two
# m16n8k16 in 16 bits (32); on the CUDA cores two carry adds, and for
# f32 the two-word split (a cvt, a subtract, a cvt).
B6_TC_FLOPS = {torch.float32: 48, torch.bfloat16: 32, torch.float16: 32}
B6_CUDA_OPS = {torch.float32: 5, torch.bfloat16: 2, torch.float16: 2}

# The segmented-sum path (phases 2d, 3f, 5d).  Each segment's result is
# a sum, so the engines are held to the reduce family's mma / pallas
# ceiling, relative to that segment's sum|x| (the reference gates no
# segment sum).  vpu is index_add_ with float atomics, sequential per
# segment and in no fixed order: printed, not gated.
SEG_METHODS = ("pallas", "mma", "vpu", "auto")
SEG_CEILING = CEILINGS["pallas"]
# B7 against segment_plain: |kernel - plain| <= 2^-20 of the segment's
# sum|x|.  Three bf16 words rebuild each f32 value exactly and every
# one-hot product is exact, so both sum the same words and differ only
# in the order of their f32 adds inside a warp (the tensor cores' 16
# products a word, a group's three words chained from zero, then the
# warp's running sum): a few roundings of 2^-24 each, far under 2^-20.
SEG_RTOL = 2.0 ** -20
SEG_N_CHECK = (1, 13, 4096 + 13, (1 << 20) + 13, 1 << 24)
# One, two and 32 blocks of 128 segments (4096: six passes at 32 warps).
SEG_COUNTS = (1, 19, 128, 256, 4096)
SEG_BLOCK_ROWS = (16, 128, 512)
# The path's two configurations: the reference's measured problem (128
# segments, random ids: src/repro/core/autotune.py:718,
# benchmarks/bench_scan.py:32) and DeepSeek-V3's 256 routed experts
# with tokens ordered by expert (sorted ids in contiguous runs).
SEG_CONFIGS = (("random", 128), ("sorted", 256))
# Tensor-core flops of one m16n8k16, which B7 runs per group of 16
# elements, bf16 word and 128-segment block its ids hit.
B7_MMA_FLOPS = 4096
B7_BLOCK_SEGMENTS = 128

# The norm path (phases 2e, 3g, 3h, 5e).  B8 against rmsnorm_plain:
# |kernel - plain| <= 2^-20 * |plain| + 2^-24 per f32 output.  Both sum
# the same exact bf16 words of the f32 squares, in another order inside
# an MMA (a few roundings of 2^-24 of the row's sum), and rsqrtf is
# within 2 ulp of torch.rsqrt's; x * rstd * w then adds at most ~2^-22
# relative.  bf16 outputs: within one bf16 ulp (a rounding boundary may
# fall between the two).
B8_RTOL, B8_ATOL = 2.0 ** -20, 2.0 ** -24
B8_ROWS = (1, 17, 64, 4099)
# 17 and 7169 are ragged against B8's chunks (32 f32 / 64 bf16 columns)
# and its cluster split, and their rows are not 16-byte aligned (the
# kernel's element-by-element loads).
B8_DS = (17, 40, 256, 2304, 4096, 7168, 7169)
# Rows wider than B8's shared memory (f32, more than 12 chunks a warp):
# the scaling pass re-reads them; 24577 also unaligned.
B8_WIDE = ((3, 24577), (3, 32768))
# Full-width shapes: Gemma-2 2B prefill, 16 x 4096 tokens at d = 2304
# (src/repro/configs/gemma2_2b.py:13), DeepSeek-V3's width 7168
# (src/repro/configs/deepseek_v3_671b.py:18) at 16384 tokens, and a
# decode step of 64 slots (timed only, phase 5e).
NORM_SHAPES = ((65536, 2304), (16384, 7168))
B8_TIMED_SHAPES = NORM_SHAPES + ((64, 2304),)
NORM_METHODS = ("fused_pallas", "unfused_mma", "mma", "vpu", "auto")
NM_ENGINES = ("fused_pallas", "unfused_mma", "vpu")
# scripts/check_error_budget.py NM_GATES (copied): Frobenius % error
# against the f64 oracle; the reduce engine 'mma' that rmsnorm's
# statistic runs on is held to the plain-MMA tier as unfused_mma.
NM_CEILINGS = {"fused_pallas": 5e-3, "unfused_mma": 5e-3, "mma": 5e-3,
               "vpu": 5e-4}
NM_EPS = 1e-6
# Phase 3h / 5f: the MLPs of two of the repo's configs
# (src/repro_torch/configs), read in main(): Gemma-2 2B (d_model 2304 ->
# d_ff 9216, gelu) in f32, bf16, bf16 rows with f32 weights (the
# transformer's own case: f32 parameters, bf16 activations) and f32 rows
# with bf16 weights (B10's fourth form: f32 activations beside weights
# kept in bf16), and DeepSeek-V3's dense MLP (7168 -> 18432, silu) in bf16; each at prefill
# (one sequence of SHAPES["train_4k"].seq_len = 4096 tokens) and at a
# decode step (SHAPES["decode_32k"].global_batch = 128 rows).  And the
# reference's own problem (nm_problem, copied from
# scripts/check_error_budget.py:115-145).
NM_CONFIGS = (("gemma2-2b", ("f32", "bf16", "mixed", "f32_bf16w")),
              ("deepseek-v3-671b", ("bf16",)))
NM_PICK_ARCH = "gemma2-2b"      # where auto is held to its fastest engine
NM_KINDS = {"f32": (torch.float32, torch.float32),
            "bf16": (torch.bfloat16, torch.bfloat16),
            "mixed": (torch.bfloat16, torch.float32),
            "f32_bf16w": (torch.float32, torch.bfloat16)}   # (x, weights)
NM_METHODS = ("fused_pallas", "unfused_mma", "vpu", "auto")
# Roundings to bf16 along each bf16 path of phase 3h, each up to the
# unit roundoff: unfused_mma rounds the normalized rows, both
# projections, the activation and the product (5), vpu and B10 only
# their output (1); fused_mlp's down projection in bf16 adds one to
# each.  With f32 weights beside bf16 rows, unfused_mma also rounds the
# two weights it casts (2 more), and fused_mlp the down projection's
# weight (1 more for every engine).
NM_BF16_ROUNDINGS = {"unfused_mma": 5, "vpu": 1, "fused_pallas": 1}
# B10 against norm_matmul_plain: |kernel - plain| <= 2^-20 of each
# output's absolute-value scale S (nm_scale: rstd |x (1 + scale)| |w|,
# plus |bias|, and for the gate pair |act(g) up|'s sensitivity with
# |act'| <= 1.2 and |act(g)| <= |g| + 0.3), plus one ulp for a bf16
# output (a rounding boundary may fall between the two).  Both take the
# same exact bf16 words of the operands and of the squares and differ in
# the order of their f32 adds (in the tensor cores' chain or a matmul,
# per k step of the walk) and in rsqrtf's and the activations' last
# bits: a few roundings of 2^-24 of S.  The largest ratio seen in the
# first run of the mma.sync form was 2^-24.1.
B10_RTOL = 2.0 ** -20
B10_ROWS = (1, 17, 128)
B10_DS = (40, 256, 2304, 7168)
B10_DOUTS = (8, 100, 9216)
B10_FORMS = ((None, False), ("silu", True), ("gelu", False))   # act, bias
B10_BIG_ROWS = 4099
# Phase 2f's ragged cases: d against the k steps (32 and 64), dout
# against the block's 64 / 128 output columns, and rows on both sides of
# a consumer warpgroup's 64 rows and of the block's 128 (the tile is one
# for every row count: no threshold chooses another).  Rows 0..r-1 of
# the 4099-row call are held to r-row calls at each B10_PART_ROWS.
B10_RAGGED = tuple((r, 2305, n) for r in (64, 65, 129) for n in (200, 9217))
B10_PART_ROWS = (17, 65, 129)
# Phase 5f fits the host time of a norm_matmul call with w given
# (autotune._NM_HOST_US) at this toy size (rows, d, dout) with a gelu
# gate, where the card's work is negligible.
NM_HOST_SHAPE = (8, 256, 256)
NM_SEEDS = (0, 1)
NM_ROWS, NM_D, NM_DOUT = 64, 256, 128

# Phase 2g / 3i / 5g: the attention path (kernel B9).  B9 against
# attention_plain: |kernel - plain| <= 2^-20 (1 + sigma_i) A_i, where A_i
# = sum_j p_ij |v_j| / l_i is each output's absolute-value scale and
# sigma_i = scale max_j sum_h |q_ih k_jh| its row's score scale (both in
# f64, attn_scales).  Both take the same TF32 words in the same chains and
# key blocks and differ in the order of the f32 adds inside an MMA or a
# matmul and in expf / tanhf's last bits: a score moves by a few 2^-24
# sigma, which exp turns into that relative error of p, and the output's
# own sums add a few 2^-24 A.  With a bf16 v both round p to bf16 for
# p v, and a p within those bits of a rounding boundary may round the
# other way, up to 2^-8 of its term: 2^-8 A more, and one bf16 ulp of
# the bf16 output.  The largest f32 ratio of the first runs was 2^-19.8
# of A alone (sigma ~10), ~2^-23 of (1 + sigma) A.
B9_RTOL = 2.0 ** -20
ATTN_KINDS = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "mixed": (torch.float32, torch.bfloat16)}   # (q, k and v)
# (B, Sq, Sk, KV, G, hd, hd_v, causal, window, cap, qpos, kv_len): Sq G
# and Sk ragged against the 64-row and 32-key tiles; 'padded' rows sit
# at position -1 (no key under the causal mask: exactly 0); kv_len
# draws per-row lengths and puts each row's query at its last key.
B9_CASES = (
    (2, 37, 45, 4, 2, 256, 256, True, None, 50.0, "tail", False),
    (1, 301, 300, 4, 2, 256, 256, True, 40, 50.0, "tail", False),
    (2, 70, 130, 2, 1, 128, 128, True, 16, None, "tail", False),
    (3, 129, 257, 8, 1, 128, 128, False, None, None, "tail", False),
    (2, 33, 100, 2, 2, 192, 128, True, None, None, "tail", False),
    (5, 1, 1000, 4, 2, 256, 256, False, None, 50.0, "tail", True),
    (3, 1, 300, 2, 2, 192, 128, False, None, None, "tail", True),
    (2, 5, 9, 1, 3, 16, 8, True, None, None, "padded", False),
    (2, 67, 75, 2, 3, 12, 8, True, 20, None, "padded", False),
)
# bf16 cases that land on B9's wgmma form (more than 16 rows a head, hd
# and hd_v multiples of 16 up to 256): rows a head 17 and 8192, Sk
# ragged against its 64-key blocks, hd 16 (a box wider than the row),
# 64, 128 with G 3 and padded rows, 192 / 128, 256 with kv_len.
B9_WG_CASES = (
    (1, 17, 83, 2, 1, 64, 64, True, None, None, "tail", False),
    (3, 33, 97, 2, 1, 16, 16, True, 8, None, "tail", False),
    (2, 100, 130, 2, 3, 128, 128, True, 50, 30.0, "padded", False),
    (1, 130, 190, 1, 2, 192, 128, False, None, None, "tail", False),
    (2, 40, 200, 2, 2, 256, 256, True, None, 50.0, "tail", True),
    (1, 4096, 4131, 1, 2, 256, 256, True, None, 50.0, "tail", False),
)
# f32 cases on B9's f32 prefill form beside B9_CASES' f32 ones: the global
# layer's 4096 rows of one KV head (8192 a head) at hd 256.
B9_WF_CASES = (
    (1, 4096, 4131, 1, 2, 256, 256, True, None, 50.0, "tail", False),
)
# Decode cases on B9's decode form (at most 16 rows a head beside a bf16
# cache; run in f32 q and in bf16), in chunks of DECODE_CHUNK (2048)
# keys: kv_len draws rows over one to three chunks, Sk not a multiple of
# the chunk; 1, 2, 8 and 16 rows a head; hd 16 to 256; a causal window
# across a chunk boundary; padded rows (no key: exactly 0).
B9_DC_CASES = (
    (4, 1, 4396, 2, 2, 64, 64, False, None, 50.0, "tail", True),
    (3, 1, 6221, 4, 2, 256, 256, False, None, None, "tail", True),
    (2, 1, 2053, 2, 1, 16, 16, False, None, None, "tail", True),
    (2, 4, 4101, 2, 2, 128, 128, True, 1200, 30.0, "tail", False),
    (2, 8, 2088, 1, 2, 192, 128, True, None, None, "padded", False),
)
# B9's launch counter by form.
B9_COUNTERS = {"mma_sync": "b9_attention", "wgmma": "b9_attention_wgmma",
               "wgmma_f32": "b9_attention_f32",
               "decode": "b9_attention_decode"}
# Phase 3i: Gemma-2 2B's attention layer at full width
# (repro_torch/configs/gemma2_2b.py: d_model 2304, 8 heads over 4 KV
# heads, head_dim 256, softcap 50, window 4096), weights from the seed.
# Prefill: the global layer at SHAPES["train_4k"].seq_len = 4096 tokens
# and the local layer at twice that, so that the window masks; decode:
# one step of SHAPES["decode_32k"].global_batch = 128 slots at per-row
# positions over [0, 32768) against bf16 ring caches of 32768 (global)
# and 4096 (local) slots, and against an f32 ring of 4096 (a model kept
# in f32 end to end: the mma.sync form's decode).  Each engine's
# attention output is held to an f64 oracle of the qg / k / v it was given (Frobenius % error), with
# the reduce tiers' ceilings (CEILINGS: fused_pallas and unfused_mma
# 5e-3 %, vpu 5e-4 %) plus 100 * 2^-8 % for each rounding to bf16 on the
# engine's path: with a bf16 v each engine rounds p and its output (2).
ATTN_ARCH = "gemma2-2b"
# ... and GLM-4 9B's decode step over the global ring (32 heads over 2 KV
# heads, head_dim 128, no softcap): 16 rows a KV head, the most B9's
# decode form takes, where its MMAs carry the most columns a key.
ATTN_ROWS_ARCH = "glm4-9b"
ATTN_METHODS = ("fused_pallas", "unfused_mma", "vpu", "auto")
ATTN_CEILINGS = {"fused_pallas": 5e-3, "unfused_mma": 5e-3, "vpu": 5e-4}
ATTN_BF16_ROUNDINGS = 2
# Phase 5g also times B9 per launch in a run of this many back to back,
# and reads its launches' device time from a trace of this many calls.
B9_RUN = 10
B9_TRACED = 3
# Phase 5g fits the attention host time per call at this toy size
# (B, S, KV, G, hd), where the card's work is negligible.
ATTN_HOST_SHAPE = (1, 64, 4, 2, 256)

# Phase 6b: the scan family's pick, at these sizes, in f32 and bf16.
# The model path (phase 3j).  (a) every arch at its SMOKE size with the
# plain engines; (b) Gemma-2 2B and (c) DeepSeek-V3 at full width, cut in
# depth only, with the kernel spellings (B8 for the norms, B10 for the
# dense MLPs and MLA's query chain, B9 for attention) against the plain
# engines on the same params.  DeepSeek-V3's plain attention is the
# chunked unfused_mma (its expanded prefill form at 4112 tokens and 128
# heads would hold ~9 GB of f32 scores a tensor under vpu); its params
# are bf16, drawn leaf by leaf (3 x 256 experts of 7168 x 2048 are 45 GB
# in f32).  MODEL_BOUND is the reference's prefill + decode check,
# max|got - ref| < 0.05 (max|ref| + 1) (tests/test_models.py).
DEV = "cuda"
MODEL_SMOKE_BATCH = (2, 12)
MODEL_PROMPT = 4096             # 3i's prefill shape
MODEL_STEPS = 16
MODEL_BOUND = 0.05
MODEL_TIMING_CALLS = 5
KERNEL_SPELLINGS = {"reduce_method": "fused_pallas",
                    "norm_matmul_method": "fused_pallas",
                    "attn_method": "fused_pallas"}
PLAIN_SPELLINGS = {"reduce_method": "mma",
                   "norm_matmul_method": "unfused_mma",
                   "attn_method": "vpu"}
MODEL_FULL = {
    "gemma2-2b": {
        "part": "b", "cuts": {"num_layers": 4}, "param_dtype": None,
        "reduced": ["num_layers 26 -> 4 (2 local + 2 global)"],
        "kernels": ("b8_rmsnorm", "b10_norm_matmul", "b9_attention_wgmma",
                    "b9_attention_decode")},
    "deepseek-v3-671b": {
        "part": "c", "cuts": {"num_layers": 2, "first_dense_layers": 1},
        "param_dtype": torch.bfloat16,
        "plain": {"attn_method": "unfused_mma"},
        "reduced": ["num_layers 61 -> 2",
                    "first_dense_layers 3 -> 1 (one dense, one MoE layer)",
                    "params bf16 (f32 in the config)"],
        "kernels": ("b8_rmsnorm", "b10_norm_matmul",
                    "b9_attention_wgmma")},
}

SCAN_PICK_SIZES = (1 << 20, 1 << 24, 1 << 28)
SCAN_HOST_N = 1 << 12
SCAN_ITERS = {1 << 12: 50, 1 << 20: 50, 1 << 24: 10, 1 << 26: 5,
              1 << 28: 3}
# ... and B6's whole R x B grid in bf16 at these sizes, where the card
# rather than the host bounds a scan.
SCAN_GRID_SIZES = (1 << 24, 1 << 26, 1 << 28)

# Phase 6: sizes, repeats and the slack the model's pick may take.
SWEEP_SIZES = (1 << 20, 1 << 24, 1 << 28)
SWEEP_ROUNDS = 5
SWEEP_ITERS = {1 << 20: 50, 1 << 24: 20, 1 << 28: 5}
PICK_SLACK = 1.25


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def nvidia_smi() -> str:
    got = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return got.stdout.strip().splitlines()[0]


def ptxas_report(lib) -> dict:
    """Registers (fewest, most) over a library's kernels and the bytes
    they spill, from the compiler's report beside it."""
    import re
    log = open(f"{lib}.log").read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
    return {"registers": [min(regs), max(regs)], "spill_bytes": spills}


def inputs(n: int, dist: str, gen: torch.Generator,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if dist == "uniform":
        return torch.rand(n, device="cuda", generator=gen, dtype=dtype)
    return torch.randn(n, device="cuda", generator=gen, dtype=dtype)


# ------------------------------------------------ phase 2: kernel checks


def check_kernels(mr, ops, gen) -> dict:
    """Each kernel against its plain version on the same card inputs;
    returns the largest |kernel - plain| per kernel."""
    worst = {k: 0.0 for k in mr.LAUNCHES}
    rows = []
    for n in N_CHECK:
        base = torch.randn(n, device="cuda", generator=gen)
        for dt in DTYPES:
            x = base.to(dt)
            for chain, block_rows in GEOMETRIES:
                tile = chain * block_rows
                x2d = ops._to_tiles(x, tile, mr.M)
                for square in (False, True):
                    got = mr.single_pass_cuda(x, chain=chain,
                                              block_rows=block_rows,
                                              square=square)
                    want = mr.single_pass_plain(x2d, chain=chain,
                                                block_rows=block_rows,
                                                square=square)
                    xs = (x * x) if square else x
                    scale = float(torch.sum(xs.abs(), dtype=torch.float64))
                    err = abs(float(got) - float(want))
                    rows.append(("b1_single_pass", n, name(dt), chain,
                                 block_rows, square, err, scale))
                    worst["b1_single_pass"] = max(worst["b1_single_pass"],
                                                  err)
                    check(err <= KERNEL_RTOL * scale,
                          f"B1 n={n} {dt} R={chain} B={block_rows} "
                          f"square={square}: {float(got)} vs {float(want)}")
                got = mr.partials_cuda(x, chain=chain, block_rows=block_rows)
                want = mr.partials_plain(x2d, chain=chain,
                                         block_rows=block_rows)
                scale = torch.sum(x2d.reshape(want.shape[0], -1).abs(),
                                  dim=1, dtype=torch.float64)
                diff = (got.double() - want.double()).abs()
                check(got.shape == want.shape,
                      f"B2 shape {tuple(got.shape)} vs {tuple(want.shape)}")
                check(bool(torch.all(diff <= KERNEL_RTOL * scale)),
                      f"B2 n={n} {dt} R={chain} B={block_rows}: "
                      f"max diff {float(diff.max())}")
                worst["b2_partials"] = max(worst["b2_partials"],
                                           float(diff.max()))
                rows.append(("b2_partials", n, name(dt), chain, block_rows,
                             False, float(diff.max()), float(scale.max())))
                x2s = ops._to_tiles(x, block_rows, mr.M)
                scale = float(torch.sum(x.abs(), dtype=torch.float64))
                for frac in (0.0, 0.5, 1.0):
                    mma_rows = mr.mma_rows_for(block_rows, frac)
                    got = mr.split_cuda(x, block_rows=block_rows,
                                        mma_rows=mma_rows)
                    want = mr.split_plain(x2s, block_rows=block_rows,
                                          mma_rows=mma_rows)
                    err = abs(float(got) - float(want))
                    worst["b3_split"] = max(worst["b3_split"], err)
                    rows.append(("b3_split", n, name(dt), 1, block_rows,
                                 mma_rows, err, scale))
                    check(err <= KERNEL_RTOL * scale,
                          f"B3 n={n} {dt} B={block_rows} "
                          f"mma_rows={mma_rows}: {float(got)} vs "
                          f"{float(want)}")
    counted = 0
    for dt in DTYPES:
        for chain, block_rows in GEOMETRIES:
            tile = chain * block_rows * mr.M
            for n in (TAIL, tile + TAIL, N_CHECK[1]):
                x = count_input(n, dt, COUNT_SHARE_CHECK, gen)
                counted += check_counts(mr, ops, x, chain, block_rows)
    walked = check_long_walks(mr, ops, gen, rows, worst)
    torch.cuda.synchronize()
    print(f"phase 2: {len(rows)} kernel-vs-plain checks passed, "
          f"worst |diff| {worst}; {counted} exact counts passed; "
          f"{walked} checks where every block walks >= {WALK_MIN_TILES} "
          f"tiles", flush=True)
    return {"worst": worst, "rows": rows, "counted": counted + walked}


def check_long_walks(mr, ops, gen, rows: list, worst: dict) -> int:
    """B1 (plain and squared) and B3 at sizes where every block of the
    walk takes WALK_MIN_TILES tiles or more and the tail is ragged:
    against the plain version (KERNEL_RTOL) on normal input, and against
    the exact count on counting input.  The CUDA library's walk must be
    ``walk``'s.  Returns the number of checks."""
    done = 0
    for chain, block_rows, n in WALK_CASES:
        for kname, ch in (("b1_single_pass", chain), ("b3_split", 1)):
            grid, tiles = mr.walk(n, ch, block_rows)
            check(tiles // grid >= WALK_MIN_TILES and n % mr.M,
                  f"{kname} n={n} R={ch} B={block_rows}: {tiles} tiles on "
                  f"{grid} blocks")
            check(mr.cuda_walk(n, ch, block_rows) == grid,
                  f"{kname} n={n} R={ch} B={block_rows}: the CUDA walk is "
                  f"not walk's")
        base = torch.randn(n, device="cuda", generator=gen)
        for dt in DTYPES:
            x = base.to(dt)
            x2d = ops._to_tiles(x, chain * block_rows, mr.M)
            for square in (False, True):
                got = mr.single_pass_cuda(x, chain=chain,
                                          block_rows=block_rows,
                                          square=square)
                want = mr.single_pass_plain(x2d, chain=chain,
                                            block_rows=block_rows,
                                            square=square)
                xs = (x * x) if square else x
                scale = float(torch.sum(xs.abs(), dtype=torch.float64))
                err = abs(float(got) - float(want))
                rows.append(("b1_single_pass", n, name(dt), chain,
                             block_rows, square, err, scale))
                worst["b1_single_pass"] = max(worst["b1_single_pass"], err)
                check(err <= KERNEL_RTOL * scale,
                      f"B1 walk n={n} {dt} R={chain} B={block_rows} "
                      f"square={square}: {float(got)} vs {float(want)}")
            mma_rows = mr.mma_rows_for(block_rows, 0.5)
            got = mr.split_cuda(x, block_rows=block_rows, mma_rows=mma_rows)
            want = mr.split_plain(ops._to_tiles(x, block_rows, mr.M),
                                  block_rows=block_rows, mma_rows=mma_rows)
            scale = float(torch.sum(x.abs(), dtype=torch.float64))
            err = abs(float(got) - float(want))
            rows.append(("b3_split", n, name(dt), 1, block_rows, mma_rows,
                         err, scale))
            worst["b3_split"] = max(worst["b3_split"], err)
            check(err <= KERNEL_RTOL * scale,
                  f"B3 walk n={n} {dt} B={block_rows} mma_rows={mma_rows}: "
                  f"{float(got)} vs {float(want)}")
            done += 3
            x = count_input(n, dt, COUNT_SHARE_MAIN, gen)
            done += check_counts(mr, ops, x, chain, block_rows)
        del base, x, x2d
    return done


def count_input(n: int, dt: torch.dtype, share: float,
                gen: torch.Generator) -> torch.Tensor:
    """n counting values (see TAIL) at the start of a buffer of ones."""
    buf = torch.ones(n + 64, device="cuda", dtype=dt)
    buf[:n] = (torch.rand(n, device="cuda", generator=gen) < share).to(dt)
    buf[max(0, n - TAIL):n] = 1
    return buf[:n]


def check_counts(mr, ops, x: torch.Tensor, chain: int,
                 block_rows: int) -> int:
    """B1 (with and without squares), B2 and B3 on a counting input: the
    kernel, the plain version and the f64 count must be equal.  Returns
    the number of checks."""
    n = x.numel()
    count = float(torch.sum(x, dtype=torch.float64))
    check(count < 2 ** 24, f"count {count} is not exact in f32")
    where = f"n={n} {name(x.dtype)} R={chain} B={block_rows}"
    x2d = ops._to_tiles(x, chain * block_rows, mr.M)
    for square in (False, True):
        got = float(mr.single_pass_cuda(x, chain=chain,
                                        block_rows=block_rows,
                                        square=square))
        want = float(mr.single_pass_plain(x2d, chain=chain,
                                          block_rows=block_rows,
                                          square=square))
        check(got == want == count, f"B1 count {where} square={square}: "
                                    f"kernel {got}, plain {want}, {count}")
    got = mr.partials_cuda(x, chain=chain, block_rows=block_rows)
    want = mr.partials_plain(x2d, chain=chain, block_rows=block_rows)
    per_tile = torch.sum(x2d.reshape(want.shape[0], -1), dim=1,
                         dtype=torch.float64)
    check(got.shape == want.shape and torch.equal(got, want)
          and torch.equal(got.double(), per_tile),
          f"B2 count {where}: {int((got.double() != per_tile).sum())} "
          f"of {per_tile.numel()} tiles differ")
    x2s = ops._to_tiles(x, block_rows, mr.M)
    for frac in (0.0, 0.5, 1.0):
        mma_rows = mr.mma_rows_for(block_rows, frac)
        got = float(mr.split_cuda(x, block_rows=block_rows,
                                  mma_rows=mma_rows))
        want = float(mr.split_plain(x2s, block_rows=block_rows,
                                    mma_rows=mma_rows))
        check(got == want == count, f"B3 count {where} mma_rows="
                                    f"{mma_rows}: kernel {got}, plain "
                                    f"{want}, {count}")
    return 6


# ------------------------------------- phase 2b: B4 / B5 kernel checks


def dd_f64(pair: torch.Tensor) -> float:
    """A dd [hi, lo] pair as one f64 value."""
    return float(torch.sum(pair.to(torch.float64)))


def check_tier_kernels(mc, ops, gen) -> dict:
    """B4 and B5 against their plain versions on the same card inputs,
    and on counting inputs; returns the worst |kernel - plain| / scale
    per kernel and the largest |kernel - plain| itself."""
    worst = {k: 0.0 for k in mc.LAUNCHES}
    worst_abs = {k: 0.0 for k in mc.LAUNCHES}
    rows = []

    def held(kname, got, want, scale, rtol, where):
        err = abs(got - want)
        rows.append((kname, where, got, want, err, scale))
        worst[kname] = max(worst[kname], err / scale)
        worst_abs[kname] = max(worst_abs[kname], err)
        check(err <= rtol * scale,
              f"{kname} {where}: kernel {got!r} vs plain {want!r}, "
              f"|diff| {err:.3g} > {rtol:.3g} of {scale:.6g}")

    for n in N_CHECK:
        x32 = torch.randn(n, device="cuda", generator=gen)
        x64 = torch.randn(n, device="cuda", generator=gen,
                          dtype=torch.float64)
        for chain, block_rows in TIER_GEOMETRIES:
            tile = chain * block_rows
            for square in (False, True):
                for words in mc.SPLIT_WORDS:
                    got = mc.ec_cuda(x32, chain=chain, block_rows=block_rows,
                                     split_words=words, square=square)
                    want = mc.ec_plain(ops._to_tiles(x32, tile, mc.M),
                                       chain=chain, block_rows=block_rows,
                                       split_words=words, square=square)
                    xs = x32.double() ** 2 if square else x32.double()
                    held("b4_ec", float(got), float(want),
                         float(torch.sum(xs.abs())), EC_RTOL,
                         f"n={n} R={chain} B={block_rows} w={words} "
                         f"square={square}")
                for x in (x32, x64):
                    got = mc.dd_cuda(x, chain=chain, block_rows=block_rows,
                                     square=square)
                    want = mc.dd_plain(ops._to_tiles(x, tile, mc.M),
                                       chain=chain, block_rows=block_rows,
                                       square=square)
                    check(got.shape == want.shape == (2,),
                          f"B5 result shape {tuple(got.shape)}")
                    xs = x.double() ** 2 if square else x.double()
                    held("b5_dd", dd_f64(got), dd_f64(want),
                         float(torch.sum(xs.abs())), DD_RTOL,
                         f"n={n} {name(x.dtype)} R={chain} B={block_rows} "
                         f"square={square}")
    counted = 0
    for dt in (torch.float32, torch.float64):
        for chain, block_rows in TIER_GEOMETRIES:
            tile = chain * block_rows * mc.M
            for n in (TAIL, tile + TAIL, N_CHECK[1]):
                x = count_input(n, dt, COUNT_SHARE_CHECK, gen)
                counted += check_tier_counts(mc, ops, x, chain, block_rows)
    torch.cuda.synchronize()
    print(f"phase 2b: {len(rows)} B4/B5 kernel-vs-plain checks passed, "
          f"worst |diff| / sum|x| {worst}; {counted} exact counts passed",
          flush=True)
    return {"worst": worst, "worst_abs": worst_abs, "rows": rows,
            "counted": counted}


def check_tier_counts(mc, ops, x: torch.Tensor, chain: int,
                      block_rows: int) -> int:
    """B4 (f32 input, both word counts) and B5 on a counting input, with
    and without squares: kernel, plain version and the f64 count must be
    equal (B5: the pair [count, 0]).  Returns the number of checks."""
    n = x.numel()
    count = float(torch.sum(x, dtype=torch.float64))
    check(count < 2 ** 24, f"count {count} is not exact in f32")
    where = f"n={n} {name(x.dtype)} R={chain} B={block_rows}"
    x2d = ops._to_tiles(x, chain * block_rows, mc.M)
    checks = 0
    for square in (False, True):
        if x.dtype == torch.float32:
            for words in mc.SPLIT_WORDS:
                got = float(mc.ec_cuda(x, chain=chain, block_rows=block_rows,
                                       split_words=words, square=square))
                want = float(mc.ec_plain(x2d, chain=chain,
                                         block_rows=block_rows,
                                         split_words=words, square=square))
                check(got == want == count,
                      f"B4 count {where} w={words} square={square}: "
                      f"kernel {got}, plain {want}, {count}")
                checks += 1
        got = mc.dd_cuda(x, chain=chain, block_rows=block_rows,
                         square=square).tolist()
        want = mc.dd_plain(x2d, chain=chain, block_rows=block_rows,
                           square=square).tolist()
        check(got == want == [count, 0.0],
              f"B5 count {where} square={square}: kernel {got}, plain "
              f"{want}, {count}")
        checks += 1
    return checks


# ------------------------------------------ phase 2c: B6 kernel checks


def shift(t: torch.Tensor) -> torch.Tensor:
    """Inclusive -> exclusive: a leading zero."""
    return torch.nn.functional.pad(t[:-1], (1, 0))


def running_abs(x: torch.Tensor) -> torch.Tensor:
    """The f64 running sum|x| at every position."""
    return torch.cumsum(x.to(torch.float64).abs(), dim=0)


def scan_ratio(got: torch.Tensor, want: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """|got - want| over the running sum|x|, at every position; where
    that sum is 0, any difference counts as infinite."""
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return torch.where(scale > 0, diff / scale.clamp_min(1e-300),
                       diff * math.inf).nan_to_num(0.0)


def check_scan_kernel(ms, gen) -> dict:
    """B6 against scan_plain on the same card inputs, and on counting
    inputs; returns the worst |kernel - plain| (absolute and over the
    running sum|x|)."""
    worst = worst_abs = 0.0
    rows = []
    for n in N_CHECK:
        base = torch.randn(n, device="cuda", generator=gen)
        for dt in DTYPES:
            x = base.to(dt)
            run = running_abs(x)
            for chain, block_rows in GEOMETRIES:
                for inclusive in (True, False):
                    got = ms.scan_cuda(x, chain=chain, block_rows=block_rows,
                                       inclusive=inclusive)
                    want = ms.scan_plain(x, chain=chain,
                                         block_rows=block_rows,
                                         inclusive=inclusive)
                    check(got.shape == want.shape == (n,)
                          and got.dtype == torch.float32,
                          f"B6 result {tuple(got.shape)} {got.dtype}")
                    ratio = float(scan_ratio(got, want, run if inclusive
                                             else shift(run)).max())
                    err = float((got.double() - want.double()).abs().max())
                    worst, worst_abs = max(worst, ratio), max(worst_abs, err)
                    rows.append(("b6_scan", n, name(dt), chain, block_rows,
                                 inclusive, err, ratio))
                    check(ratio <= SCAN_RTOL,
                          f"B6 n={n} {dt} R={chain} B={block_rows} "
                          f"inclusive={inclusive}: |kernel - plain| is "
                          f"{ratio:.3g} of the running sum|x|")
    counted = 0
    for dt in DTYPES:
        for chain, block_rows in GEOMETRIES:
            tile = chain * block_rows * ms.M
            for n in (TAIL, tile + TAIL, N_CHECK[1]):
                x = count_input(n, dt, COUNT_SHARE_CHECK, gen)
                counted += check_scan_counts(ms, x, chain, block_rows)
        x = count_input(N_MAIN, dt, COUNT_SHARE_MAIN, gen)
        counted += check_scan_counts(ms, x, CHAIN, BLOCK_ROWS)
        del x
    repeated = check_scan_repeats(ms, gen)
    torch.cuda.synchronize()
    print(f"phase 2c: {len(rows)} B6-vs-plain checks passed, worst |diff| "
          f"{worst_abs:.3g} ({worst:.3g} of the running sum|x|); "
          f"{counted} exact counts passed; the same bits in {repeated} "
          f"repeated calls", flush=True)
    return {"worst": worst, "worst_abs": worst_abs, "rows": rows,
            "counted": counted, "repeated": repeated}


def check_scan_repeats(ms, gen) -> int:
    """B6's tile carries are a fold in tile order, whichever published
    state each block's look-back meets: at 2^28 on normal input, a
    second call, and a call made while another stream keeps the card
    busy with matmuls, give the first call's bits, at the main geometry
    and at SCAN_LONGEST_WALK.  Returns the number of repeated calls."""
    x = torch.randn(N_MAIN, device="cuda", generator=gen)
    a = torch.randn(8192, 8192, device="cuda", generator=gen)
    busy = torch.cuda.Stream()
    calls = 0
    for chain, block_rows in ((CHAIN, BLOCK_ROWS), SCAN_LONGEST_WALK):
        geo = dict(chain=chain, block_rows=block_rows)
        first = ms.scan_cuda(x, **geo)
        check(torch.equal(first, ms.scan_cuda(x, **geo)),
              f"B6 R={chain} B={block_rows}: two calls differ")
        busy.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(busy):
            y = a
            for _ in range(SCAN_BUSY_MATMULS):
                y = y @ a
        beside = ms.scan_cuda(x, **geo)
        torch.cuda.synchronize()
        check(torch.equal(first, beside),
              f"B6 R={chain} B={block_rows}: a call beside a busy stream "
              f"differs")
        calls += 2
        del first, beside, y
    return calls


def check_scan_counts(ms, x: torch.Tensor, chain: int,
                      block_rows: int) -> int:
    """B6 on a counting input, inclusive and exclusive: kernel, plain
    version and the exact int64 prefix must be equal at every position.
    Returns the number of checks."""
    n = x.numel()
    exact = torch.cumsum(x.long(), dim=0)
    check(int(exact[-1]) < 2 ** 24, f"count {int(exact[-1])} is not exact "
                                    f"in f32")
    where = f"n={n} {name(x.dtype)} R={chain} B={block_rows}"
    for inclusive in (True, False):
        want = exact if inclusive else shift(exact)
        got = ms.scan_cuda(x, chain=chain, block_rows=block_rows,
                           inclusive=inclusive)
        plain = ms.scan_plain(x, chain=chain, block_rows=block_rows,
                              inclusive=inclusive)
        check(torch.equal(got.long(), want) and torch.equal(got, plain),
              f"B6 count {where} inclusive={inclusive}: "
              f"{int((got.long() != want).sum())} positions off the count, "
              f"{int((got != plain).sum())} off the plain version")
    return 2


# ------------------------------------------ phase 2d: B7 kernel checks


def seg_ids(n: int, s: int, kind: str, gen: torch.Generator,
            stray: bool = False) -> torch.Tensor:
    """n int32 ids in [0, s): random, or sorted into contiguous runs.
    With ``stray``, about 1 in 16 becomes -1 or an id past s (s, s + 3,
    2^30), which must add nothing."""
    ids = torch.randint(0, s, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    if kind == "sorted":
        ids = torch.sort(ids).values
    if stray:
        pick = torch.rand(n, device="cuda", generator=gen) < 1 / 16
        bad = torch.tensor([-1, s, s + 3, 1 << 30], device="cuda",
                           dtype=torch.int32)
        which = torch.randint(0, 4, (n,), device="cuda", generator=gen)
        ids = torch.where(pick, bad[which], ids)
    return ids


def seg_exact(x: torch.Tensor, ids: torch.Tensor, s: int) -> tuple:
    """The f64 segment sums of x and of |x| (ids outside [0, s) drop)."""
    keep = (ids >= 0) & (ids < s)
    idx = ids[keep].long()
    xs = x[keep].to(torch.float64)
    zero = torch.zeros(s, dtype=torch.float64, device="cuda")
    return zero.index_add(0, idx, xs), zero.index_add(0, idx, xs.abs())


def seg_ratio(got: torch.Tensor, want: torch.Tensor,
              scale: torch.Tensor) -> float:
    """max over segments of |got - want| / the segment's sum|x|; a
    segment whose sum|x| is 0 must match exactly."""
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return float(torch.where(scale > 0, diff / scale.clamp_min(1e-300),
                             diff * math.inf).nan_to_num(0.0).max())


def check_segment_kernel(sg, gen) -> dict:
    """B7 against segment_plain on the same card inputs (random and
    sorted ids with strays, every dtype, three block_rows), and on
    counting inputs where kernel, plain version and the exact count
    agree bit for bit (also at n = 2^28, S = 128)."""
    worst = worst_abs = 0.0
    rows = []
    for n in SEG_N_CHECK:
        base = torch.randn(n, device="cuda", generator=gen)
        for s in SEG_COUNTS:
            for kind in ("random", "sorted"):
                ids = seg_ids(n, s, kind, gen, stray=True)
                for dt in DTYPES:
                    x = base.to(dt)
                    _, scale = seg_exact(x, ids, s)
                    for block_rows in SEG_BLOCK_ROWS:
                        if n == SEG_N_CHECK[-1] and block_rows != BLOCK_ROWS:
                            continue
                        blocks = sg.grid_blocks(n, block_rows, "cuda")
                        got = sg.segment_cuda(x, ids, s,
                                              block_rows=block_rows)
                        want = sg.segment_plain(x, ids, s,
                                                block_rows=block_rows,
                                                blocks=blocks)
                        check(got.shape == want.shape == (s,)
                              and got.dtype == torch.float32,
                              f"B7 result {tuple(got.shape)} {got.dtype}")
                        ratio = seg_ratio(got, want, scale)
                        err = float((got.double() - want.double()).abs()
                                    .max())
                        worst, worst_abs = max(worst, ratio), \
                            max(worst_abs, err)
                        rows.append(("b7_segment_sum", n, s, kind, name(dt),
                                     block_rows, err, ratio))
                        check(ratio <= SEG_RTOL,
                              f"B7 n={n} S={s} {kind} {dt} B={block_rows}: "
                              f"|kernel - plain| is {ratio:.3g} of the "
                              f"segment's sum|x|")
    counted = 0
    for dt in DTYPES:
        for n in (TAIL, 4096 + TAIL, N_CHECK[1]):
            for s in (19, 128, 4096):
                x = count_input(n, dt, COUNT_SHARE_CHECK, gen)
                counted += check_segment_counts(
                    sg, x, seg_ids(n, s, "random", gen, stray=True), s)
        x = torch.ones(N_MAIN, device="cuda", dtype=dt)
        counted += check_segment_counts(sg, x, seg_ids(N_MAIN, 128, "random",
                                                       gen), 128)
        del x
    torch.cuda.synchronize()
    print(f"phase 2d: {len(rows)} B7-vs-plain checks passed, worst |diff| "
          f"{worst_abs:.3g} ({worst:.3g} of the segment's sum|x|); "
          f"{counted} exact counts passed", flush=True)
    return {"worst": worst, "worst_abs": worst_abs, "rows": rows,
            "counted": counted}


def check_segment_counts(sg, x: torch.Tensor, ids: torch.Tensor,
                         s: int) -> int:
    """B7 on a counting input: kernel, plain version and the exact int64
    count per segment must be equal.  Returns the number of checks."""
    n = x.numel()
    keep = (ids >= 0) & (ids < s)
    exact = torch.zeros(s, dtype=torch.int64, device="cuda").index_add_(
        0, ids[keep].long(), x[keep].long())
    check(int(exact.max()) < 2 ** 24, "count is not exact in f32")
    got = sg.segment_cuda(x, ids, s, block_rows=BLOCK_ROWS)
    plain = sg.segment_plain(x, ids, s, block_rows=BLOCK_ROWS,
                             blocks=sg.grid_blocks(n, BLOCK_ROWS, "cuda"))
    check(torch.equal(got.long(), exact) and torch.equal(got, plain),
          f"B7 count n={n} S={s} {name(x.dtype)}: "
          f"{int((got.long() != exact).sum())} segments off the count, "
          f"{int((got != plain).sum())} off the plain version")
    return 1


# --------------------------------------------------- phase 3: main path


def run_main_path(integration, kernels, autotune, gen) -> list:
    """reduce_sum / squared_sum through every engine at n = 2^28."""
    results = []
    for dist in ("uniform", "normal"):
        base = inputs(N_MAIN, dist, gen)
        for dt in DTYPES:
            x = base if dt == torch.float32 else base.to(dt)
            x64 = x.to(torch.float64)
            exact = {"reduce_sum": float(torch.sum(x64)),
                     "squared_sum": float(torch.sum(x64 * x64))}
            scale = {"reduce_sum": float(torch.sum(x64.abs())),
                     "squared_sum": exact["squared_sum"]}
            del x64
            # The pallas engine squares in the input dtype (as the
            # reference's kernel does), so its oracle sums those rounded
            # squares, and its distance from the exact sum of squares is
            # held to SQUARE_ROUNDING (the reference gates no pallas
            # squared sum); the other engines square in f32 or f64.
            rounded_sq = float(torch.sum(x * x, dtype=torch.float64))
            calls = []
            for method in METHODS:
                calls.append(("reduce_sum", method, lambda m=method:
                              integration.reduce_sum(x, method=m)))
                calls.append(("squared_sum", method, lambda m=method:
                              integration.squared_sum(x, method=m)))
            for variant in VARIANTS:
                calls.append(("reduce_sum", f"mma_reduce:{variant}",
                              lambda v=variant: kernels.mma_reduce(
                                  x, variant=v)))
            for op, method, fn in calls:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check(out.is_cuda and out.dtype == torch.float32
                      and out.dim() == 0,
                      f"{op}/{method}: result {out.device} {out.dtype} "
                      f"{tuple(out.shape)}")
                got = float(out)
                engine = method.split(":")[0]
                if engine == "auto":
                    engine = autotune.get_plan(x.numel(), x.dtype, op=op,
                                               backend="cuda").method
                if engine == "mma_reduce":
                    engine = "pallas"
                want, ceiling = exact[op], CEILINGS[engine]
                exact_limit = ceiling
                if op == "squared_sum" and engine == "pallas":
                    want = rounded_sq
                    u, eta = SQUARE_ROUNDING[dt]
                    exact_limit += 100.0 * (u + x.numel() * eta / scale[op])
                err = 100.0 * abs(got - want) / scale[op]
                exact_err = 100.0 * abs(got - exact[op]) / scale[op]
                results.append({"dist": dist, "dtype": name(dt), "op": op,
                                "method": method, "engine": engine,
                                "got": got, "want": want,
                                "pct_err_of_abs_sum": err,
                                "pct_err_vs_exact": exact_err,
                                "ceiling_pct": ceiling,
                                "exact_limit_pct": exact_limit,
                                "wall_s": wall})
                print(f"  {dist:7s} {name(dt):8s} {op:11s} {method:24s} "
                      f"engine={engine:11s} err={err:.3e}% "
                      f"(ceiling {ceiling:g}%; vs exact {exact_err:.3e}%, "
                      f"limit {exact_limit:.3g}%) {wall * 1e3:.1f} ms",
                      flush=True)
                check(torch.isfinite(out).item(), f"{op}/{method}: {got}")
                check(err <= ceiling,
                      f"{dist} {dt} {op}/{method}: {err:.3e}% > "
                      f"{ceiling:g}%")
                check(exact_err <= exact_limit,
                      f"{dist} {dt} {op}/{method}: {exact_err:.3e}% from "
                      f"the exact value > {exact_limit:.3g}%")
            del x
        del base
    return results


def run_other_ops(integration, gen) -> list:
    """masked_mean and expert_counts through their engines, against the
    f64 value, at moderate size."""
    rows = []
    n = 1 << 24
    v = torch.randn(n, device="cuda", generator=gen)
    mask = (torch.rand(n, device="cuda", generator=gen) > 0.5).float()
    want = float(torch.sum(v.double() * mask.double())
                 / torch.sum(mask.double()))
    scale = float(torch.sum((v * mask).abs().double())
                  / torch.sum(mask.double()))
    for method in METHODS:
        got = float(integration.masked_mean(v, mask, method=method))
        err = 100.0 * abs(got - want) / scale
        rows.append({"op": "masked_mean", "method": method,
                     "pct_err_of_abs_sum": err})
        check(err <= 5e-3, f"masked_mean/{method}: {got} vs {want}")
    experts = 64
    ids = torch.randint(0, experts, (n // experts,), device="cuda",
                        generator=gen)
    onehot = torch.nn.functional.one_hot(ids, experts).to(torch.bfloat16)
    want = torch.bincount(ids, minlength=experts).float()
    for method in ("mma", "vpu", "auto"):
        got = integration.expert_counts(onehot, method=method)
        rows.append({"op": "expert_counts", "method": method,
                     "max_abs_err": float((got - want).abs().max())})
        check(bool(torch.equal(got, want)), f"expert_counts/{method}")
    print(f"phase 3b: masked_mean and expert_counts agree: {rows}",
          flush=True)
    return rows


# ------------------------------------ phase 3c / 3d: the tier's path


def run_tier_path(integration, precision, autotune, gen) -> list:
    """reduce_sum / squared_sum through the ec and dd engines at
    n = 2^28, against the f64 oracle of the input as given."""
    pol3 = precision.MmaPolicy(split_words=3)
    pol2 = precision.MmaPolicy(split_words=2)
    f64 = precision.F64_EQUIVALENT
    ec_calls = (("pallas_ec:w2", "pallas_ec", pol2),
                ("pallas_ec:w3", "pallas_ec", pol3),
                ("mma_ec", "mma_ec", None),
                ("auto:w3", "auto", pol3))
    dd_calls = (("pallas_dd", "pallas_dd", f64),
                ("mma_dd", "mma_dd", f64),
                ("auto:f64", "auto", f64))
    results = []
    for dist in ("uniform", "normal"):
        for dt in (torch.float32, torch.float64):
            x = inputs(N_MAIN, dist, gen, dt)
            x64 = x.to(torch.float64)
            exact = {"reduce_sum": float(torch.sum(x64)),
                     "squared_sum": float(torch.sum(x64 * x64))}
            scale = {"reduce_sum": float(torch.sum(x64.abs())),
                     "squared_sum": exact["squared_sum"]}
            del x64
            calls = dd_calls if dt == torch.float64 else ec_calls + dd_calls
            for op in ("reduce_sum", "squared_sum"):
                for label, method, pol in calls:
                    t0 = time.perf_counter()
                    out = getattr(integration, op)(x, method=method,
                                                   precision=pol)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    engine = method
                    if method == "auto":
                        engine = autotune.get_plan(
                            x.numel(), x.dtype, op=op, backend="cuda",
                            policy=pol).method
                    dd = pol is f64
                    check(out.is_cuda and out.dtype == torch.float32
                          and tuple(out.shape) == ((2,) if dd else ()),
                          f"{op}/{label}: result {out.device} {out.dtype} "
                          f"{tuple(out.shape)}")
                    check(bool(torch.all(torch.isfinite(out))),
                          f"{op}/{label}: {out.tolist()}")
                    got = dd_f64(out)
                    ceiling = DD_CEILING if dd else EC_CEILING
                    err = 100.0 * abs(got - exact[op]) / scale[op]
                    results.append({"dist": dist, "dtype": name(dt),
                                    "op": op, "method": label,
                                    "engine": engine, "got": got,
                                    "want": exact[op],
                                    "pct_err_of_abs_sum": err,
                                    "ceiling_pct": ceiling,
                                    "wall_s": wall})
                    print(f"  {dist:7s} {name(dt):8s} {op:11s} {label:13s} "
                          f"engine={engine:9s} err={err:.3e}% (ceiling "
                          f"{ceiling:g}%) {wall * 1e3:.1f} ms", flush=True)
                    check(err <= ceiling,
                          f"{dist} {dt} {op}/{label}: {err:.3e}% > "
                          f"{ceiling:g}%")
            del x
    return results


def run_scan_path(integration, autotune, gen) -> list:
    """cumsum / masked_cumsum through every scan engine at n = 2^28,
    against an f64 cumsum of the cast (and masked) input."""
    results = []
    for dist in ("uniform", "normal"):
        base = inputs(N_MAIN, dist, gen)
        mask = (torch.rand(N_MAIN, device="cuda", generator=gen)
                < 0.5).float()
        for dt in (torch.float32, torch.bfloat16):
            x = base if dt == torch.float32 else base.to(dt)
            for op in ("scan", "masked_cumsum"):
                # masked_cumsum scans values * mask in f32: exact, as
                # the mask is 0 / 1.
                xs = x.to(torch.float64)
                if op == "masked_cumsum":
                    xs = xs * mask.to(torch.float64)
                want = torch.cumsum(xs, dim=0)
                run = torch.cumsum(xs.abs(), dim=0)
                del xs
                for method in SCAN_METHODS:
                    # Let the asynchronous oracle above finish first.
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if op == "scan":
                        out = integration.cumsum(x, method=method)
                    else:
                        out = integration.masked_cumsum(x, mask,
                                                        method=method)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    check(out.is_cuda and out.dtype == torch.float32
                          and out.shape == x.shape,
                          f"{op}/{method}: result {out.device} {out.dtype} "
                          f"{tuple(out.shape)}")
                    check(bool(torch.all(torch.isfinite(out))),
                          f"{op}/{method}: not finite")
                    engine = method
                    if method == "auto":
                        engine = autotune.get_plan(
                            N_MAIN, torch.float32 if op == "masked_cumsum"
                            else dt, op=op, backend="cuda").method
                    err = 100.0 * float(scan_ratio(out, want, run).max())
                    gated = method != "vpu"
                    results.append({"dist": dist, "dtype": name(dt),
                                    "op": op, "method": method,
                                    "engine": engine,
                                    "max_pct_err_of_running_abs": err,
                                    "ceiling_pct": SCAN_CEILING
                                    if gated else None, "wall_s": wall})
                    print(f"  {dist:7s} {name(dt):8s} {op:13s} "
                          f"{method:11s} engine={engine:11s} max err "
                          f"{err:.3e}% of the running sum|x| "
                          + (f"(ceiling {SCAN_CEILING:g}%)" if gated
                             else "(not gated)")
                          + f" {wall * 1e3:.1f} ms", flush=True)
                    check(not gated or err <= SCAN_CEILING,
                          f"{dist} {dt} {op}/{method}: {err:.3e}% > "
                          f"{SCAN_CEILING:g}%")
                    del out
                del want, run
            del x
        del base, mask
    return results


def run_segment_path(integration, autotune, gen) -> list:
    """segment_sum through every engine at n = 2^28 in both
    configurations, against the f64 segment sums of the cast input."""
    results = []
    for kind, s in SEG_CONFIGS:
        ids = seg_ids(N_MAIN, s, kind, gen)
        for dist in ("uniform", "normal"):
            base = inputs(N_MAIN, dist, gen)
            for dt in (torch.float32, torch.bfloat16):
                x = base if dt == torch.float32 else base.to(dt)
                want, scale = seg_exact(x, ids, s)
                for method in SEG_METHODS:
                    # Let the asynchronous oracle above finish first.
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = integration.segment_sum(x, ids, s, method=method)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    check(out.is_cuda and out.dtype == torch.float32
                          and tuple(out.shape) == (s,),
                          f"segment_sum/{method}: result {out.device} "
                          f"{out.dtype} {tuple(out.shape)}")
                    check(bool(torch.all(torch.isfinite(out))),
                          f"segment_sum/{method}: not finite")
                    engine = method
                    if method == "auto":
                        engine = autotune.get_plan(
                            N_MAIN, dt, op="segment_sum",
                            backend="cuda").method
                    err = 100.0 * seg_ratio(out, want, scale)
                    gated = method != "vpu"
                    results.append({"ids": kind, "segments": s,
                                    "dist": dist, "dtype": name(dt),
                                    "method": method, "engine": engine,
                                    "max_pct_err_of_segment_abs": err,
                                    "ceiling_pct": SEG_CEILING
                                    if gated else None, "wall_s": wall})
                    print(f"  {kind:6s} S={s:<4d} {dist:7s} {name(dt):8s} "
                          f"{method:6s} engine={engine:6s} max err "
                          f"{err:.3e}% of the segment's sum|x| "
                          + (f"(ceiling {SEG_CEILING:g}%)" if gated
                             else "(not gated)")
                          + f" {wall * 1e3:.1f} ms", flush=True)
                    check(not gated or err <= SEG_CEILING,
                          f"{kind} S={s} {dist} {dt} segment_sum/{method}: "
                          f"{err:.3e}% > {SEG_CEILING:g}%")
                    del out
                del x, want, scale
            del base
        del ids
    return results


def run_integrate_example() -> list:
    """The integration example on the card with auto and pallas_dd."""
    from repro_torch.examples import integrate
    rows = []
    for method in ("auto", "pallas_dd"):
        got = integrate.run("cuda", method)
        plans = [(k, p.method, p.chain, p.block_rows)
                 for k, p in got["plans"]]
        for est, errs in got["errors"].items():
            print(f"  integrate --method {method}: {est} "
                  + ", ".join(f"{k} rel={v:.3e}" for k, v in errs.items()
                              if k != "truth"), flush=True)
        print(f"  integrate --method {method}: plans {plans}", flush=True)
        check(got["passed"], f"integrate --method {method}: the 1e-12 gate "
                             f"did not separate the families: {got}")
        rows.append({"method": method, "errors": got["errors"],
                     "plans": plans})
    return rows


# ------------------------------------------ phase 2e: B8 kernel checks


def signed_input(rows: int, d: int, dt: torch.dtype,
                 gen: torch.Generator) -> torch.Tensor:
    """Values of magnitude in [0.5, 1] with random signs: every square is
    at least a quarter of the largest, so a lost or repeated column
    moves a row's mean of squares by at least 2^-15 of it at d = 7168."""
    mag = 0.5 + 0.5 * torch.rand(rows, d, device="cuda", generator=gen)
    sign = torch.randint(0, 2, (rows, d), device="cuda", generator=gen)
    return (mag * (2 * sign - 1)).to(dt)


def rmsnorm_diff(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, whether every element is within B8's tolerance
    of its plain version)."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    if want.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                         - 7)
        ok = bool(torch.all(diff <= ulp))
    else:
        ok = bool(torch.all(diff <= B8_RTOL * w.abs() + B8_ATOL))
    return float(diff.max()), ok


def check_rmsnorm_kernel(mrn, gen) -> dict:
    """B8 against rmsnorm_plain on the same card inputs, every shape of
    B8_ROWS x B8_DS, f32 and bf16, weight_offset 0 and 1; two calls give
    the same bits."""
    worst_abs, rows_out = 0.0, []
    for rows in B8_ROWS:
        for d in B8_DS:
            for dt in (torch.float32, torch.bfloat16):
                x = signed_input(rows, d, dt, gen)
                w = 0.1 * torch.randn(d, device="cuda", generator=gen)
                for offset in (0.0, 1.0):
                    got = mrn.rmsnorm_cuda(x, w, weight_offset=offset)
                    again = mrn.rmsnorm_cuda(x, w, weight_offset=offset)
                    want = mrn.rmsnorm_plain(x, w, weight_offset=offset)
                    check(got.shape == x.shape and got.dtype == dt,
                          f"B8 result {tuple(got.shape)} {got.dtype}")
                    diff, ok = rmsnorm_diff(got, want)
                    worst_abs = max(worst_abs, diff)
                    rows_out.append(("b8_rmsnorm", rows, d, name(dt), offset,
                                     diff))
                    check(ok, f"B8 rows={rows} d={d} {name(dt)} offset="
                              f"{offset}: |kernel - plain| {diff:.3g} over "
                              f"its tolerance")
                    check(torch.equal(got, again),
                          f"B8 rows={rows} d={d} {name(dt)}: two calls "
                          f"differ")
    for rows, d in B8_WIDE:
        x = signed_input(rows, d, torch.float32, gen)
        w = 0.1 * torch.randn(d, device="cuda", generator=gen)
        diff, ok = rmsnorm_diff(mrn.rmsnorm_cuda(x, w, weight_offset=1.0),
                                mrn.rmsnorm_plain(x, w, weight_offset=1.0))
        worst_abs = max(worst_abs, diff)
        rows_out.append(("b8_rmsnorm", rows, d, "f32", 1.0, diff))
        check(ok, f"B8 rows={rows} d={d} f32 (re-read): |kernel - plain| "
                  f"{diff:.3g} over its tolerance")
    for d in sorted({*B8_DS, *(d for _, d in B8_WIDE),
                     *(d for _, d in B8_TIMED_SHAPES)}):
        for dt in (torch.float32, torch.bfloat16):
            check(mrn.cuda_walk(d, dt) == mrn.walk(d, dt),
                  f"B8 d={d} {name(dt)}: the CUDA walk "
                  f"{mrn.cuda_walk(d, dt)} is not walk's {mrn.walk(d, dt)}")
    for d in (2304, 7169):
        for dt in (torch.float32, torch.bfloat16):
            # A contiguous view one element past a 16-byte boundary: read
            # where it lies, by one launch, with an aligned copy's bits.
            x = signed_input(1, 33 * d + 1, dt, gen).reshape(-1)[1:]
            x = x.view(33, d)
            w = 0.1 * torch.randn(d, device="cuda", generator=gen)
            before = mrn.LAUNCHES["b8_rmsnorm"]
            got = mrn.rmsnorm_cuda(x, w, weight_offset=1.0)
            check(x.data_ptr() % 16 != 0
                  and mrn.LAUNCHES["b8_rmsnorm"] == before + 1,
                  f"B8 d={d} {name(dt)}: the unaligned view was not one "
                  f"launch")
            diff, ok = rmsnorm_diff(got, mrn.rmsnorm_plain(
                x, w, weight_offset=1.0))
            worst_abs = max(worst_abs, diff)
            rows_out.append(("b8_rmsnorm_unaligned", 33, d, name(dt), 1.0,
                             diff))
            check(ok, f"B8 unaligned d={d} {name(dt)}: |kernel - plain| "
                      f"{diff:.3g} over its tolerance")
            check(torch.equal(got, mrn.rmsnorm_cuda(x.clone(), w,
                                                    weight_offset=1.0)),
                  f"B8 unaligned d={d} {name(dt)}: not an aligned copy's "
                  f"bits")
    for d in (17, 2304, 7169):
        for dt in (torch.float32, torch.bfloat16):
            # A row's bits whatever the row count: the walk is d's.
            x = signed_input(4099, d, dt, gen)
            w = 0.1 * torch.randn(d, device="cuda", generator=gen)
            full = mrn.rmsnorm_cuda(x, w)
            for lo, hi in ((0, 1), (0, 17), (4090, 4099)):
                check(torch.equal(mrn.rmsnorm_cuda(x[lo:hi].contiguous(), w),
                                  full[lo:hi]),
                      f"B8 d={d} {name(dt)}: rows {lo}..{hi - 1} of 4099 "
                      f"differ from a {hi - lo}-row call")
    torch.cuda.synchronize()
    print(f"phase 2e: {len(rows_out)} B8-vs-plain checks passed, worst "
          f"|diff| {worst_abs:.3g} (f32 within 2^-20 relative + 2^-24, bf16 "
          f"within one ulp; two calls the same bits; unaligned views and "
          f"re-read rows included); the CUDA walk == walk; a row's bits "
          f"the same at 1, 17 and 4099 rows", flush=True)
    return {"worst_abs": worst_abs, "rows": rows_out}


# ------------------------------------------ phase 2f: B10 kernel checks


def nm_inputs(rows: int, d: int, dout: int, act, bias: bool, kind: str,
              gen: torch.Generator) -> tuple:
    """x, scale, w, w_gate (None without act) and bias (or None) on the
    card, in the (x, weights) dtypes of ``kind``."""
    xdt, wdt = NM_KINDS[kind]
    x = torch.randn(rows, d, device="cuda", generator=gen).to(xdt)
    s = 0.1 * torch.randn(d, device="cuda", generator=gen)
    w, wg = ((torch.randn(d, dout, device="cuda", generator=gen)
              / math.sqrt(d)).to(wdt) for _ in range(2))
    b = torch.randn(dout, device="cuda", generator=gen) if bias else None
    return x, s, w, (wg if act else None), b


def nm_scale(x, s, w, wg, b) -> torch.Tensor:
    """Each B10 output's absolute-value scale (see B10_RTOL), in f64."""
    xf = x.double()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + NM_EPS)
    xs = (xf * (1.0 + s.double())).abs()
    up = rstd * (xs @ w.double().abs())
    if b is not None:
        up = up + b.double().abs()
    if wg is None:
        return up
    return up * (2.2 * rstd * (xs @ wg.double().abs()) + 0.3)


def nm_diff(got, want, scale) -> tuple:
    """(max |got - want| / scale, max |got - want|, whether every element
    is within B10's tolerance of its plain version)."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    bound = B10_RTOL * scale
    if want.dtype == torch.bfloat16:
        bound = bound + torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(1e-30))) - 7)
    return (float((diff / scale.clamp_min(1e-300)).max()), float(diff.max()),
            bool(torch.all(diff <= bound)))


def check_norm_matmul_kernel(mnm, gen) -> dict:
    """B10 against norm_matmul_plain on the same card inputs: rows in
    B10_ROWS x d in B10_DS x dout in B10_DOUTS, without a gate, with a
    silu gate and a bias, with a gelu gate, and the B10_RAGGED shapes, in
    every form of NM_KINDS; then 4099 rows at d 2304 and 7168 and dout
    9216.  Two calls give the same bits, and at 4099 rows the first r
    rows equal an r-row call's bit for bit (r in B10_PART_ROWS).  The
    CUDA walk equals ``walk`` at every d and form."""
    worst = {"f32_ratio": 0.0, "abs": 0.0}
    rows_out = []
    cases = [(r, d, n, act, bias) for d in B10_DS for n in B10_DOUTS
             for act, bias in B10_FORMS for r in B10_ROWS]
    cases += [(r, d, n, act, bias) for r, d, n in B10_RAGGED
              for act, bias in B10_FORMS]
    cases += [(B10_BIG_ROWS, d, 9216, act, bias) for d in (2304, 7168)
              for act, bias in (("gelu", False), ("silu", True))]
    for kind, (xdt, wdt) in NM_KINDS.items():
        for d in sorted({case[1] for case in cases}):
            check(mnm.cuda_walk(d, xdt, wdt) == mnm.walk(d, xdt, wdt),
                  f"B10 {kind} d={d}: the CUDA walk "
                  f"{mnm.cuda_walk(d, xdt, wdt)} is not walk's")
    for kind in NM_KINDS:
        for rows, d, dout, act, bias in cases:
            x, s, w, wg, b = nm_inputs(rows, d, dout, act, bias, kind, gen)
            call = dict(w_gate=wg, bias=b, act=act)
            got = mnm.norm_matmul_cuda(x, s, w, **call)
            again = mnm.norm_matmul_cuda(x, s, w, **call)
            want = mnm.norm_matmul_plain(x, s, w, **call)
            what = f"B10 {rows}x{d}x{dout} act={act} bias={bias} {kind}"
            check(got.shape == (rows, dout) and got.dtype == x.dtype
                  and bool(torch.all(torch.isfinite(got))),
                  f"{what}: {got.dtype} {tuple(got.shape)}")
            ratio, diff, ok = nm_diff(got, want, nm_scale(x, s, w, wg, b))
            if x.dtype == torch.float32:
                worst["f32_ratio"] = max(worst["f32_ratio"], ratio)
            worst["abs"] = max(worst["abs"], diff)
            rows_out.append(("b10_norm_matmul", rows, d, dout, act, bias,
                             kind, ratio, diff))
            check(ok, f"{what}: |kernel - plain| {diff:.3g} "
                      f"({ratio:.3g} of its scale) over its tolerance")
            check(torch.equal(got, again), f"{what}: two calls differ")
            if rows == B10_BIG_ROWS:
                for r in B10_PART_ROWS:
                    part = mnm.norm_matmul_cuda(x[:r].contiguous(), s, w,
                                                **call)
                    check(torch.equal(part, got[:r]),
                          f"{what}: rows 0..{r - 1} differ from a {r}-row "
                          f"call")
            del x, w, wg, got, again, want
    torch.cuda.synchronize()
    print(f"phase 2f: {len(rows_out)} B10-vs-plain checks passed, worst "
          f"|diff| {worst['abs']:.3g}, worst f32 |diff| / scale "
          f"{worst['f32_ratio']:.3g} (within 2^-20 of each output's scale, "
          f"bf16 plus one ulp; two calls the same bits; a row's bits "
          f"independent of the row count; the CUDA walk is walk's)",
          flush=True)
    return {"worst_abs": worst["abs"], "worst_f32_ratio": worst["f32_ratio"],
            "rows": rows_out}


# ------------------------------------ phase 3g / 3h: the norm path


def frob_pct(got: torch.Tensor, want64: torch.Tensor) -> float:
    return 100.0 * float(torch.linalg.vector_norm(got.double() - want64)
                         / torch.linalg.vector_norm(want64))


def norm_oracle(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """nm_oracle's form with no w: the f64 norm of the cast input."""
    x64 = x.double()
    ms = torch.mean(x64 * x64, dim=-1, keepdim=True)
    return x64 / torch.sqrt(ms + NM_EPS) * (1.0 + scale.double())


def nm_ceiling(engine: str, dt: torch.dtype, roundings: int = 1) -> float:
    """NM_GATES' ceiling for the engine; a bf16 path adds the unit
    roundoff, 100 * 2^-8 %, for each of its ``roundings`` to bf16."""
    ceiling = NM_CEILINGS[engine]
    return ceiling + (roundings * 100.0 * 2.0 ** -8
                      if dt == torch.bfloat16 else 0.0)


def norm_calls(layers, params, x) -> dict:
    """label -> call: layers.rmsnorm under every spelling (its own
    routes) and the norm-only norm_matmul under each engine and auto."""
    calls = {f"rmsnorm:{m}": (lambda m=m: layers.rmsnorm(params, x,
                                                         method=m))
             for m in NORM_METHODS}
    calls.update({f"norm_matmul:{m}": (lambda m=m: layers.norm_matmul(
        params, x, None, method=m)) for m in NM_ENGINES + ("auto",)})
    return calls


def norm_engine(label: str, x, params, autotune, dispatch) -> str:
    """The engine a label runs: its spelling, or the plan auto takes."""
    route, method = label.split(":")
    if method != "auto":
        return method
    if route == "rmsnorm":
        return autotune.get_plan(x.numel(), torch.float32, op="reduce_sum",
                                 engine=("mma", "vpu"),
                                 backend="cuda").method
    return dispatch.auto_plan("norm_matmul", x, w=None,
                              scale=params["scale"]).method


def run_norm_path(layers, param, dispatch, autotune, gen) -> tuple:
    """layers.rmsnorm through every spelling, and the norm-only
    norm_matmul through each engine and auto, at full width; Frobenius %
    error against the f64 oracle, held to NM_GATES; at the Gemma shape
    norm_matmul's auto plan against its fastest engine."""
    rows_out, picks = [], []
    rng = np.random.default_rng(SEED)
    for rows, d in NORM_SHAPES:
        scale_np = (0.1 * rng.standard_normal(d)).astype(np.float32)
        params = param.from_numpy({"scale": scale_np}, device="cuda")
        base = torch.randn(rows, d, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x = base if dt == torch.float32 else base.to(dt)
            want = norm_oracle(x, params["scale"])
            times = {}
            for label, fn in norm_calls(layers, params, x).items():
                torch.cuda.synchronize()
                out = fn()
                torch.cuda.synchronize()
                check(out.shape == x.shape and out.dtype == dt
                      and bool(torch.all(torch.isfinite(out))),
                      f"{label}: {out.dtype} {tuple(out.shape)}")
                err = frob_pct(out, want)
                engine = norm_engine(label, x, params, autotune, dispatch)
                ceiling = nm_ceiling(engine, dt)
                del out
                times[label] = median_ms(fn, reps=5, warmup=1)
                rows_out.append({"rows": rows, "d": d, "dtype": name(dt),
                                 "method": label, "engine": engine,
                                 "frob_pct_err": err, "ceiling_pct": ceiling,
                                 "ms": times[label]})
                print(f"  {rows}x{d} {name(dt):8s} {label:24s} "
                      f"engine={engine:12s} err={err:.3e}% (ceiling "
                      f"{ceiling:.3g}%) {times[label]:.4f} ms", flush=True)
                check(err <= ceiling, f"{rows}x{d} {dt} {label}: "
                                      f"{err:.3e}% > {ceiling:.3g}%")
            if (rows, d) == NORM_SHAPES[0]:
                # norm_matmul's engines and auto in balanced rounds, each
                # the fastest of its medians, as in phase 3h: with B8
                # near its bound a host burst on one single-call median
                # outweighs the engines' difference.
                calls = norm_calls(layers, params, x)
                methods = NM_ENGINES + ("auto",)
                best = dict.fromkeys(methods, math.inf)
                for order in balanced_orders(methods):
                    for m in order:
                        best[m] = min(best[m], median_ms(
                            calls[f"norm_matmul:{m}"], reps=5, warmup=1))
                for row in rows_out[-len(calls):]:
                    route, m = row["method"].split(":")
                    if route == "norm_matmul":
                        row["ms"] = best[m]
                picks.append(check_pick(
                    f"{rows}x{d} {name(dt)} norm_matmul (w=None)",
                    {m: best[m] for m in NM_ENGINES}, best["auto"]))
                picks[-1].update(rows=rows, d=d, dtype=name(dt))
            del x, want
        del base
    return rows_out, picks


def check_pick(what: str, engines: dict, auto_ms: float) -> dict:
    """auto's time within PICK_SLACK of the fastest engine's."""
    best = min(engines, key=engines.get)
    ratio = auto_ms / engines[best]
    print(f"  {what}: auto {auto_ms:.4f} ms; fastest engine {best} "
          f"{engines[best]:.4f} ms; ratio {ratio:.3f}", flush=True)
    check(ratio <= PICK_SLACK, f"{what}: auto runs {ratio:.2f}x the "
                               f"fastest engine (> {PICK_SLACK})")
    return {"auto_ms": auto_ms, "engine_ms": engines, "best": best,
            "best_ms": engines[best], "ratio": ratio}


def gate_oracle(x, scale, w_up, w_gate, act: str) -> torch.Tensor:
    """act(xh @ w_gate) * (xh @ w_up) in f64 (gelu in its tanh form)."""
    xh = norm_oracle(x, scale)
    g = xh @ w_gate.double()
    gate = torch.nn.functional.silu(g) if act == "silu" \
        else torch.nn.functional.gelu(g, approximate="tanh")
    return gate * (xh @ w_up.double())


def nm_roundings(label: str, engine: str, kind: str) -> int:
    """Roundings to bf16 on a bf16 path of phase 3h (NM_BF16_ROUNDINGS)."""
    n = NM_BF16_ROUNDINGS[engine]
    if kind == "mixed" and engine == "unfused_mma":
        n += 2
    if label == "fused_mlp":
        n += 1 + (kind == "mixed")
    return n


def balanced_orders(items: tuple) -> list:
    """Orders of ``items`` in which each item follows every other exactly
    once (a Williams design; odd lengths also take the rows reversed)."""
    n = len(items)
    first = [0] + [(k + 1) // 2 if k % 2 else n - k // 2
                   for k in range(1, n)]
    rows = [[(f + i) % n for f in first] for i in range(n)]
    if n % 2:
        rows += [row[::-1] for row in rows]
    return [tuple(items[j] for j in row) for row in rows]


def nm_problems(registry, base) -> list:
    """Phase 3h's (arch, d_model, d_ff, act, rows, kinds), from the
    ported configs and shapes: prefill and decode rows per config."""
    out = []
    for arch, kinds in NM_CONFIGS:
        cfg = registry.get_config(arch)
        for rows in (base.SHAPES["train_4k"].seq_len,
                     base.SHAPES["decode_32k"].global_batch):
            out.append((arch, cfg.d_model, cfg.d_ff, cfg.act, rows, kinds))
    return out


def nm_two_op(dispatch, autotune, x, s, w) -> torch.Tensor:
    """The port's two-op path, written as nm_two_op writes it
    (scripts/check_error_budget.py): the statistic on the 'mma' reduce
    engine, then the matmul in the input dtype."""
    ms = dispatch.execute("reduce_sum", x * x,
                          autotune.ReductionPlan(method="mma"),
                          axis=(1,))[..., None] / x.shape[-1]
    rstd = torch.rsqrt(ms + NM_EPS)
    return (x * rstd * (1.0 + s)).to(torch.float32) @ w


def run_norm_matmul_path(layers, param, dispatch, autotune, problems,
                         gen) -> tuple:
    """norm_matmul with w given (layers.norm_matmul with the config's
    gate and layers.fused_mlp) at the MLP widths of ``problems``, and the
    reference's own problem, through fused_pallas (B10), unfused_mma,
    vpu and auto, against f64 oracles of the cast inputs within
    NM_GATES (bf16: plus a unit roundoff per rounding to bf16,
    nm_roundings); at the Gemma shapes norm_matmul's auto plan against
    its fastest engine; unfused_mma equals the two-op path bit for
    bit."""
    rows_out, picks = [], []
    rng = np.random.default_rng(SEED + 1)
    for arch, d, dff, act, rows, kinds in problems:
        params = param.from_numpy(
            {"scale": (0.1 * rng.standard_normal(d)).astype(np.float32)},
            device="cuda")
        x32 = torch.randn(rows, d, device="cuda", generator=gen)
        mlp32 = {k: torch.randn(*shape, device="cuda", generator=gen)
                 / math.sqrt(shape[0]) for k, shape in
                 (("wi_up", (d, dff)), ("wi_gate", (d, dff)),
                  ("wo", (dff, d)))}
        for kind in kinds:
            xdt, wdt = NM_KINDS[kind]
            x = x32.to(xdt)
            mlp = {k: v.to(wdt) for k, v in mlp32.items()}
            kw = dict(w_gate=mlp["wi_gate"], act=act)
            want = gate_oracle(x, params["scale"], mlp["wi_up"],
                               mlp["wi_gate"], act)
            want_mlp = want @ mlp["wo"].double()
            problem = f"{arch} {rows}x{d}x{dff} {kind}"
            calls, found = {}, []
            for method in NM_METHODS:
                engine = method if method != "auto" else dispatch.auto_plan(
                    "norm_matmul", x, w=mlp["wi_up"], scale=params["scale"],
                    **kw).method
                for label, fn, ref in (
                        ("norm_matmul", lambda m=method: layers.norm_matmul(
                            params, x, mlp["wi_up"], method=m, **kw), want),
                        ("fused_mlp", lambda m=method: layers.fused_mlp(
                            params, mlp, x, act=act, method=m), want_mlp)):
                    ceiling = nm_ceiling(engine, xdt,
                                         nm_roundings(label, engine, kind))
                    torch.cuda.synchronize()
                    out = fn()
                    torch.cuda.synchronize()
                    check(out.shape == ref.shape and out.dtype == xdt,
                          f"{problem} {label}/{method}: {out.dtype} "
                          f"{tuple(out.shape)}")
                    err = frob_pct(out, ref)
                    del out
                    check(math.isfinite(err) and err <= ceiling,
                          f"{problem} {label}/{method}: {err:.3e}% > "
                          f"{ceiling:.3g}%")
                    calls[(label, method)] = fn
                    found.append({"problem": problem, "arch": arch,
                                  "rows": rows, "d": d, "d_ff": dff,
                                  "kind": kind, "op": label,
                                  "method": method, "engine": engine,
                                  "frob_pct_err": err,
                                  "ceiling_pct": ceiling})
            # norm_matmul's engines and auto in rounds whose orders make
            # each method follow every other once (balanced_orders), each
            # the fastest of its medians: a card slowed by the f32 matmuls
            # just before, or a host burst, then lands on no one method;
            # fused_mlp once.
            times = dict.fromkeys(NM_METHODS, math.inf)
            for order in balanced_orders(NM_METHODS):
                for method in order:
                    times[method] = min(times[method], median_ms(
                        calls[("norm_matmul", method)], reps=5, warmup=1))
            for row in found:
                row["ms"] = times[row["method"]] \
                    if row["op"] == "norm_matmul" else median_ms(
                        calls[("fused_mlp", row["method"])], reps=5,
                        warmup=1)
                rows_out.append(row)
                print(f"  {problem:36s} {row['op']:11s} {row['method']:12s} "
                      f"engine={row['engine']:12s} err="
                      f"{row['frob_pct_err']:.3e}% (ceiling "
                      f"{row['ceiling_pct']:.3g}%) {row['ms']:.4f} ms",
                      flush=True)
            pick = {"auto_ms": times["auto"], "engine_ms": {
                m: times[m] for m in NM_METHODS if m != "auto"}}
            if arch == NM_PICK_ARCH:
                pick = check_pick(f"{problem} norm_matmul (w, {act} gate)",
                                  pick["engine_ms"], times["auto"])
            pick.update(problem=problem)
            picks.append(pick)
            del x, mlp, want, want_mlp
        del x32, mlp32
    for seed in NM_SEEDS:
        prng = np.random.default_rng(seed)
        x32 = prng.standard_normal((NM_ROWS, NM_D)).astype(np.float32)
        s32 = (0.1 * prng.standard_normal(NM_D)).astype(np.float32)
        w32 = (prng.standard_normal((NM_D, NM_DOUT))
               / np.sqrt(NM_D)).astype(np.float32)
        x, s, w = (param.from_numpy(a, device="cuda")
                   for a in (x32, s32, w32))
        ref = norm_oracle(x, s) @ w.double()
        kw = {"w": w, "scale": s, "eps": NM_EPS}
        for method in NM_METHODS:
            out = dispatch.dispatch("norm_matmul", x, method=method, **kw)
            err = frob_pct(out, ref)
            engine = method if method != "auto" else dispatch.auto_plan(
                "norm_matmul", x, **kw).method
            ceiling = nm_ceiling(engine, x.dtype)
            rows_out.append({"problem": f"nm_problem seed {seed}",
                             "op": "norm_matmul", "method": method,
                             "engine": engine, "frob_pct_err": err,
                             "ceiling_pct": ceiling})
            print(f"  nm_problem seed={seed} {method:11s} err={err:.3e}% "
                  f"(ceiling {ceiling:g}%)", flush=True)
            check(err <= ceiling, f"nm_problem {seed} {method}: {err:.3e}%")
        got = dispatch.execute("norm_matmul", x,
                               autotune.ReductionPlan(method="unfused_mma"),
                               **kw)
        two = nm_two_op(dispatch, autotune, x, s, w)
        check(torch.equal(got, two), f"nm_problem {seed}: unfused_mma is not "
                                     f"bit-identical to the two-op path")
        print(f"  nm_problem seed={seed}: unfused_mma == the two-op path, "
              f"bit for bit", flush=True)
    return rows_out, picks


# ----------------------------------------------------- phase 5: timings


def median_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n: int, dt: torch.dtype, out_values: int, mma_share: float):
    """Least time in ms for one call, and what bounds it: every input
    byte read once and every output written once at HBM rate, against
    the tensor-core flops of the MMA share and the CUDA-core adds of the
    rest at their peaks."""
    itemsize = torch.empty((), dtype=dt).element_size()
    bytes_ms = (n * itemsize + 4 * out_values) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(mma_share * n * MMA_FLOPS_PER_ELEMENT[dt] / TC_FLOPS[dt],
                 (1.0 - mma_share) * n / CUDA_CORE_FLOPS) * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def time_kernels(mr, ops, gen, launches: dict, worst: dict) -> tuple:
    """Each kernel at the main path's geometry and n = 2^28: held to the
    exact count on counting input and to KERNEL_RTOL against its plain
    version on normal input, then timed on the normal input.  The f32
    shape goes to the ``kernels`` line, every dtype to the details."""
    src = "src/repro_torch/kernels/csrc/mma_reduce.cu"
    replaces = {"b1_single_pass": "src/repro/kernels/mma_reduce.py:73",
                "b2_partials": "src/repro/kernels/mma_reduce.py:96",
                "b3_split": "src/repro/kernels/mma_reduce.py:105"}
    tile = CHAIN * BLOCK_ROWS
    mma_rows = mr.mma_rows_for(BLOCK_ROWS, 0.5)
    base = torch.randn(N_MAIN, device="cuda", generator=gen)
    entries, details = [], []
    for dt in DTYPES:
        check_counts(mr, ops, count_input(N_MAIN, dt, COUNT_SHARE_MAIN, gen),
                     CHAIN, BLOCK_ROWS)
        x = base if dt == torch.float32 else base.to(dt)
        x2d = ops._to_tiles(x, tile, mr.M)
        x2s = ops._to_tiles(x, BLOCK_ROWS, mr.M)
        groups = x2d.shape[0] // tile
        abs_sum = torch.sum(x.abs(), dtype=torch.float64)
        scales = {"b1_single_pass": abs_sum, "b3_split": abs_sum,
                  "b1_single_pass_square": torch.sum(
                      (x * x).abs(), dtype=torch.float64),
                  "b2_partials": torch.sum(x2d.reshape(groups, -1).abs(),
                                           dim=1, dtype=torch.float64)}
        cases = {
            "b1_single_pass": (
                lambda: mr.single_pass_cuda(x, chain=CHAIN,
                                            block_rows=BLOCK_ROWS),
                lambda: mr.single_pass_plain(x2d, chain=CHAIN,
                                             block_rows=BLOCK_ROWS),
                lambda: torch.sum(x, dtype=torch.float32), 1, 1.0),
            "b1_single_pass_square": (
                lambda: mr.single_pass_cuda(x, chain=CHAIN,
                                            block_rows=BLOCK_ROWS,
                                            square=True),
                lambda: mr.single_pass_plain(x2d, chain=CHAIN,
                                             block_rows=BLOCK_ROWS,
                                             square=True),
                None, 1, 1.0),
            "b2_partials": (
                lambda: mr.partials_cuda(x, chain=CHAIN,
                                         block_rows=BLOCK_ROWS),
                lambda: mr.partials_plain(x2d, chain=CHAIN,
                                          block_rows=BLOCK_ROWS),
                lambda: torch.sum(x.view(groups, -1), dim=1,
                                  dtype=torch.float32), groups, 1.0),
            "b3_split": (
                lambda: mr.split_cuda(x, block_rows=BLOCK_ROWS,
                                      mma_rows=mma_rows),
                lambda: mr.split_plain(x2s, block_rows=BLOCK_ROWS,
                                       mma_rows=mma_rows),
                lambda: torch.sum(x, dtype=torch.float32), 1,
                mma_rows / BLOCK_ROWS),
        }
        for kname, (kern, plain, lib, outs, share) in cases.items():
            got, want = kern(), plain()
            check(got.shape == want.shape,
                  f"{kname} shape {tuple(got.shape)} vs {tuple(want.shape)}")
            diff = (got.double() - want.double()).abs()
            check(bool(torch.all(diff <= KERNEL_RTOL * scales[kname])),
                  f"{kname} {name(dt)} n=2^28: |kernel - plain| "
                  f"{float(diff.max())} over 2^-16 of sum|x|")
            diff = float(diff.max())
            # plain, kernel, kernel, plain: the two versions in turns.
            p1 = median_ms(plain)
            k1 = median_ms(kern)
            k2 = median_ms(kern)
            p2 = median_ms(plain)
            lib_ms = median_ms(lib) if lib is not None else None
            bound_ms, bound_by = bound(N_MAIN, dt, outs, share)
            row = {"name": kname, "dtype": name(dt), "n": N_MAIN,
                   "chain": CHAIN, "block_rows": BLOCK_ROWS,
                   "ms": min(k1, k2), "ms_runs": [k1, k2],
                   "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": diff,
                   "share_of_bound": bound_ms / min(k1, k2),
                   "over_library": (min(k1, k2) / lib_ms
                                    if lib_ms is not None else None)}
            details.append(row)
            over = (f"{row['over_library']:.3f}x the library"
                    if lib_ms is not None else "no library call")
            print(f"  {kname:22s} {name(dt):8s} kernel {row['ms']:.4f} ms "
                  f"({100 * row['share_of_bound']:.1f} % of the bound, "
                  f"{over}) plain {row['plain_ms']:.4f} ms library "
                  f"{lib_ms} ms bound {bound_ms:.4f} ms ({bound_by}) "
                  f"|diff| {diff:.3g}", flush=True)
            if dt == torch.float32 and kname in launches:
                entries.append({
                    "name": kname, "route": "cuda", "source": src,
                    "replaces": replaces[kname],
                    "launches": launches[kname],
                    "max_abs_err": max(diff, worst[kname]),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms})
        del x, x2d, x2s
    return entries, details


def tier_bound(n: int, itemsize: int, out_bytes: int, f32_ops: float,
               tc_flops: float, f64_ops: float) -> tuple:
    """Least time in ms for one B4 / B5 call: the input read once and the
    output written once at HBM rate, against each unit's operations per
    element at its peak (CUDA-core f32, tensor-core bf16, f64)."""
    bytes_ms = (n * itemsize + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n * f32_ops / CUDA_CORE_FLOPS,
                 n * tc_flops / TC_FLOPS[torch.bfloat16],
                 n * f64_ops / FP64_FLOPS) * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def time_tier_kernels(mc, ops, gen, launches: dict, worst: dict) -> tuple:
    """B4 (f32, 2 and 3 words) and B5 (f64 and f32 input) at the main
    path's geometry and n = 2^28: held to the exact count on counting
    input and to their bound against the plain version on normal input,
    then timed.  B4 with 3 words and B5 on f64 go to the ``kernels``
    line (the words ``auto`` runs under split_words=3, and the
    integration example's dtype), every case to the details."""
    src = "src/repro_torch/kernels/csrc/mma_compensated.cu"
    replaces = {"b4_ec": "src/repro/kernels/mma_compensated.py:96",
                "b5_dd": "src/repro/kernels/mma_compensated.py:198"}
    for dt in (torch.float32, torch.float64):
        check_tier_counts(mc, ops, count_input(N_MAIN, dt, COUNT_SHARE_MAIN,
                                               gen), CHAIN, BLOCK_ROWS)
    x32 = torch.randn(N_MAIN, device="cuda", generator=gen)
    x64 = torch.randn(N_MAIN, device="cuda", generator=gen,
                      dtype=torch.float64)
    tile = CHAIN * BLOCK_ROWS
    geo = dict(chain=CHAIN, block_rows=BLOCK_ROWS)
    cases = []
    for words in mc.SPLIT_WORDS:
        cases.append(("b4_ec", f"w{words}", x32,
                      lambda w=words: mc.ec_cuda(x32, split_words=w, **geo),
                      lambda w=words: mc.ec_plain(
                          ops._to_tiles(x32, tile, mc.M), split_words=w,
                          **geo),
                      EC_RTOL, 4,
                      (B4_CUDA_OPS_PER_WORD * words,
                       B4_TC_FLOPS_PER_WORD * words, 0.0)))
    for x in (x64, x32):
        split = B5_F64_SPLIT_OPS if x.dtype == torch.float64 else 0.0
        cases.append(("b5_dd", name(x.dtype), x,
                      lambda x=x: mc.dd_cuda(x, **geo),
                      lambda x=x: mc.dd_plain(
                          ops._to_tiles(x, tile, mc.M), **geo),
                      DD_RTOL, 8, (B5_F32_OPS, 0.0, split)))
    entries, details = [], []
    for kname, case, x, kern, plain, rtol, out_bytes, per_elem in cases:
        scale = float(torch.sum(x.abs(), dtype=torch.float64))
        got, want = dd_f64(kern()), dd_f64(plain())
        diff = abs(got - want)
        check(diff <= rtol * scale,
              f"{kname} {case} n=2^28: |kernel - plain| {diff} over "
              f"{rtol:.3g} of sum|x|")
        p1 = median_ms(plain)
        k1 = median_ms(kern)
        k2 = median_ms(kern)
        p2 = median_ms(plain)
        lib_ms = median_ms(lambda x=x: torch.sum(x, dtype=torch.float64))
        bound_ms, bound_by = tier_bound(N_MAIN, x.element_size(), out_bytes,
                                        *per_elem)
        row = {"name": kname, "case": case, "dtype": name(x.dtype),
               "n": N_MAIN, "chain": CHAIN, "block_rows": BLOCK_ROWS,
               "ms": min(k1, k2), "ms_runs": [k1, k2],
               "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": diff,
               "diff_over_abs_sum": diff / scale}
        details.append(row)
        print(f"  {kname:6s} {case:8s} kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.4f} ms torch.sum(f64) {lib_ms:.4f} ms "
              f"bound {bound_ms:.4f} ms ({bound_by}) |diff| {diff:.3g}",
              flush=True)
        if case in ("w3", "float64"):
            entries.append({
                "name": kname, "route": "cuda", "source": src,
                "replaces": replaces[kname], "launches": launches[kname],
                "max_abs_err": max(diff, worst[kname]),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms})
    del x32, x64
    return entries, details


def scan_bound(n: int, dt: torch.dtype) -> tuple:
    """Least time in ms for one B6 call: the input read once and the f32
    output written once at HBM rate, against its tensor-core flops and
    CUDA-core ops at their peaks."""
    itemsize = torch.empty((), dtype=dt).element_size()
    bytes_ms = n * (itemsize + 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n * B6_TC_FLOPS[dt] / TC_FLOPS[dt],
                 n * B6_CUDA_OPS[dt] / CUDA_CORE_FLOPS) * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def scan_two_read_ms(n: int, dt: torch.dtype) -> float:
    """The byte time of a B6 that reads x twice and writes f32 once: a
    form that re-reads its tiles cannot get under it, so a time below it
    shows x read once."""
    itemsize = torch.empty((), dtype=dt).element_size()
    return n * (2 * itemsize + 4) / HBM_BYTES_PER_S * 1e3


def time_scan_kernel(ms, gen, launches: int, worst_abs: float) -> tuple:
    """B6 at the main geometry and n = 2^28, f32 and bf16: held to
    SCAN_RTOL of the running sum|x| against scan_plain on normal input,
    then timed beside its bound, the two-read byte time, scan_plain and
    torch.cumsum, with its look-back's forward steps a tile.  f32 goes
    to the ``kernels`` line, both to the details."""
    base = torch.randn(N_MAIN, device="cuda", generator=gen)
    geo = dict(chain=CHAIN, block_rows=BLOCK_ROWS)
    entry, details = None, []
    for dt in (torch.float32, torch.bfloat16):
        x = base if dt == torch.float32 else base.to(dt)
        got, want = ms.scan_cuda(x, **geo), ms.scan_plain(x, **geo)
        ratio = float(scan_ratio(got, want, running_abs(x)).max())
        diff = float((got.double() - want.double()).abs().max())
        del got, want
        check(ratio <= SCAN_RTOL, f"B6 {name(dt)} n=2^28: |kernel - plain| "
                                  f"is {ratio:.3g} of the running sum|x|")
        kern = lambda: ms.scan_cuda(x, **geo)  # noqa: E731
        plain = lambda: ms.scan_plain(x, **geo)  # noqa: E731
        p1 = median_ms(plain)
        k1 = median_ms(kern)
        k2 = median_ms(kern)
        p2 = median_ms(plain)
        lib_ms = median_ms(lambda: torch.cumsum(x, dim=0,
                                                dtype=torch.float32))
        bound_ms, bound_by = scan_bound(N_MAIN, dt)
        two_read = scan_two_read_ms(N_MAIN, dt)
        steps = ms.look_back_steps(x, **geo)
        row = {"name": "b6_scan", "dtype": name(dt), "n": N_MAIN, **geo,
               "ms": min(k1, k2), "ms_runs": [k1, k2],
               "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "two_read_ms": two_read,
               "share_of_bound": bound_ms / min(k1, k2),
               "look_back_steps": steps, "max_abs_err": diff,
               "diff_over_running_abs": ratio}
        details.append(row)
        print(f"  b6_scan {name(dt):8s} kernel {row['ms']:.4f} ms plain "
              f"{row['plain_ms']:.4f} ms torch.cumsum {lib_ms:.4f} ms bound "
              f"{bound_ms:.4f} ms ({bound_by}; "
              f"{100 * row['share_of_bound']:.1f} % of it) two-read "
              f"{two_read:.4f} ms (under it: {row['ms'] < two_read}) "
              f"look-back {steps:.2f} steps a tile |diff| {diff:.3g} "
              f"({ratio:.3g} of the running sum|x|)", flush=True)
        if dt == torch.float32:
            entry = {"name": "b6_scan", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/mma_scan.cu",
                     "replaces": "src/repro/kernels/mma_scan.py:63",
                     "launches": launches,
                     "max_abs_err": max(diff, worst_abs),
                     "ms": row["ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms}
        del x
    del base
    return entry, details


def seg_bound(x: torch.Tensor, ids: torch.Tensor, s: int) -> tuple:
    """Least time in ms for one B7 call on these inputs: values and ids
    read once and S floats written at HBM rate, against the tensor-core
    flops of the MMAs this data needs in B7's encoding, one per group of
    16 elements, bf16 word (three for f32) and 128-segment block that the
    group's valid ids hit (at 989 TFLOP/s).  Returns (ms, what bounds it,
    MMAs)."""
    n = x.numel()
    bytes_ms = (n * (x.element_size() + ids.element_size()) + 4 * s) \
        / HBM_BYTES_PER_S * 1e3
    keep = (ids >= 0) & (ids < s)
    group = torch.arange(n, device="cuda")[keep] // 16
    blocks = -(-s // B7_BLOCK_SEGMENTS)
    hits = torch.unique(group * blocks
                        + ids[keep].long() // B7_BLOCK_SEGMENTS).numel()
    mmas = hits * (3 if x.dtype == torch.float32 else 1)
    ops_ms = mmas * B7_MMA_FLOPS / TC_FLOPS[torch.bfloat16] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", mmas
    return ops_ms, "operations", mmas


def time_segment_kernel(sg, autotune, dispatch, gen, launches: int,
                        worst_abs: float) -> tuple:
    """B7 at n = 2^28 in both configurations, f32 and bf16: held to
    SEG_RTOL against segment_plain and to the same bits over two calls,
    then timed beside its bound, segment_plain, the library's index_add_
    and bincount, and the pallas and vpu engines; auto must resolve to
    pallas and run within 1.25x of the fastest engine.  The f32 random
    S = 128 case (the reference's measured problem) goes to the
    ``kernels`` line, every case to the details; that case also refits
    the cost model's two segment constants."""
    entry, details, fit = None, [], {}
    for kind, s in SEG_CONFIGS:
        ids = seg_ids(N_MAIN, s, kind, gen)
        base = torch.randn(N_MAIN, device="cuda", generator=gen)
        blocks = sg.grid_blocks(N_MAIN, BLOCK_ROWS, "cuda")
        for dt in (torch.float32, torch.bfloat16):
            x = base if dt == torch.float32 else base.to(dt)
            kern = lambda: sg.segment_cuda(  # noqa: E731
                x, ids, s, block_rows=BLOCK_ROWS)
            plain = lambda: sg.segment_plain(  # noqa: E731
                x, ids, s, block_rows=BLOCK_ROWS, blocks=blocks)
            got, again, want = kern(), kern(), plain()
            _, scale = seg_exact(x, ids, s)
            ratio = seg_ratio(got, want, scale)
            diff = float((got.double() - want.double()).abs().max())
            check(ratio <= SEG_RTOL, f"B7 {kind} S={s} {name(dt)} n=2^28: "
                                     f"|kernel - plain| is {ratio:.3g} of "
                                     f"the segment's sum|x|")
            check(torch.equal(got, again), f"B7 {kind} S={s} {name(dt)}: "
                                           f"two calls differ")
            del got, again, want, scale
            vpu_plan = autotune.ReductionPlan(method="vpu")
            pallas_plan = autotune.ReductionPlan(method="pallas",
                                                 block_rows=BLOCK_ROWS)
            auto_plan = autotune.get_plan(N_MAIN, dt, op="segment_sum",
                                          backend="cuda")
            check(auto_plan.method == "pallas",
                  f"segment_sum auto resolves to {auto_plan.method} at "
                  f"2^28 {kind} S={s} {name(dt)}, not pallas")
            p1 = median_ms(plain)
            k1 = median_ms(kern)
            k2 = median_ms(kern)
            p2 = median_ms(plain)
            lib_ms = median_ms(lambda: torch.zeros(
                s, device="cuda").index_add_(
                    0, ids, x if dt == torch.float32 else x.float()))
            counts = torch.bincount(ids, weights=x, minlength=s)
            bincount_ms = median_ms(lambda: torch.bincount(
                ids, weights=x, minlength=s))
            engine_ms = {
                engine: median_ms(lambda plan=plan: dispatch.execute(
                    "segment_sum", x, plan, segment_ids=ids,
                    num_segments=s))
                for engine, plan in (("pallas", pallas_plan),
                                     ("vpu", vpu_plan),
                                     ("auto", auto_plan))}
            vpu_ms = engine_ms["vpu"]
            fastest = min(engine_ms["pallas"], vpu_ms)
            check(engine_ms["auto"] <= 1.25 * fastest,
                  f"segment_sum auto {engine_ms['auto']:.4f} ms > 1.25x "
                  f"the fastest engine's {fastest:.4f} ms ({kind} S={s} "
                  f"{name(dt)})")
            bound_ms, bound_by, mmas = seg_bound(x, ids, s)
            row = {"name": "b7_segment_sum", "ids": kind, "segments": s,
                   "dtype": name(dt), "n": N_MAIN, "block_rows": BLOCK_ROWS,
                   "blocks": blocks, "mmas": mmas,
                   "tc_flops": mmas * B7_MMA_FLOPS,
                   "passes": sg.passes(s, dt, BLOCK_ROWS),
                   "ms": min(k1, k2), "ms_runs": [k1, k2],
                   "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
                   "library_ms": lib_ms, "bincount_ms": bincount_ms,
                   "bincount_dtype": name(counts.dtype),
                   "vpu_ms": vpu_ms, "engine_ms": engine_ms,
                   "auto_block_rows": auto_plan.block_rows,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "share_of_bound": bound_ms / min(k1, k2),
                   "max_abs_err": diff, "diff_over_segment_abs": ratio}
            del counts
            details.append(row)
            print(f"  b7 {kind:6s} S={s:<4d} {name(dt):8s} kernel "
                  f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
                  f"index_add_ {lib_ms:.4f} ms bincount {bincount_ms:.4f} "
                  f"ms ({row['bincount_dtype']} out) engines pallas "
                  f"{engine_ms['pallas']:.4f} vpu {vpu_ms:.4f} auto "
                  f"{engine_ms['auto']:.4f} ms (B{auto_plan.block_rows}) "
                  f"bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{100 * row['share_of_bound']:.1f} % of it; {mmas} "
                  f"MMAs) |diff| {diff:.3g} ({ratio:.3g} of the segment's "
                  f"sum|x|)", flush=True)
            if (kind, s, dt) == ("random", 128, torch.float32):
                entry = {"name": "b7_segment_sum", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "mma_segment.cu",
                         "replaces": "src/repro/kernels/mma_scan.py:86",
                         "launches": launches,
                         "max_abs_err": max(diff, worst_abs),
                         "ms": row["ms"], "plain_ms": row["plain_ms"],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms}
                fit = fit_segment_constants(autotune, row, vpu_plan)
            del x
        del ids, base
    return entry, details, fit


def fit_segment_constants(autotune, row: dict, vpu_plan) -> dict:
    """The segment family's two fitted constants from the f32 random
    S = 128 times: B7's us per group of 16 elements and 128-segment
    block beyond the rest of its modelled cost (its bytes), and the vpu
    engine's us per element beyond the rest of its modelled cost."""
    n, s = row["n"], row["segments"]
    pallas_plan = autotune.ReductionPlan(method="pallas",
                                         block_rows=row["block_rows"])
    saved = autotune._SEG_ATOMIC_US, autotune._B7_GROUP_US
    try:
        autotune._SEG_ATOMIC_US = autotune._B7_GROUP_US = 0.0
        rest = autotune.model_cost(vpu_plan, n, torch.float32,
                                   op="segment_sum")
        b7_rest = autotune.model_cost(pallas_plan, n, torch.float32,
                                      op="segment_sum")
    finally:
        autotune._SEG_ATOMIC_US, autotune._B7_GROUP_US = saved
    units = -(-n // 16) * -(-s // B7_BLOCK_SEGMENTS)
    fit = {"b7_group_us": max(row["ms"] * 1e3 - b7_rest, 0.0) / units,
           "seg_atomic_us": max(row["vpu_ms"] * 1e3 - rest, 0.0) / n}
    pick = autotune.autotune(n, torch.float32, op="segment_sum",
                             backend="cuda")
    fit["model_pick"] = pick.method
    print(f"phase 5d: fitted _B7_GROUP_US {fit['b7_group_us']:.6g} us, "
          f"_SEG_ATOMIC_US {fit['seg_atomic_us']:.6g} us; committed "
          f"{autotune._B7_GROUP_US}, {autotune._SEG_ATOMIC_US}; the model "
          f"picks {pick.method} for segment_sum at n = 2^28 f32",
          flush=True)
    return fit


def rmsnorm_bound(rows: int, d: int, dt: torch.dtype) -> tuple:
    """Least time in ms for one B8 call: x read once, out written once
    and d f32 weights read at HBM rate, against the statistic's
    tensor-core flops (16 per element and bf16 word) at 989 TFLOP/s."""
    itemsize = torch.empty((), dtype=dt).element_size()
    words = 3 if dt == torch.float32 else 2
    bytes_ms = (2 * rows * d * itemsize + 4 * d) / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * d * 16 * words / TC_FLOPS[torch.bfloat16] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def host_us(fn, calls: int = 1000) -> float:
    """Host time in us per call of fn, launched back to back without a
    wait (the card keeps up at a decode step's size)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def rmsnorm_three_pass_ms(rows: int, d: int, dt: torch.dtype) -> float:
    """The byte time of a B8 that reads x twice (3 itemsize bytes an
    element and the weights): a form that re-reads its rows cannot get
    under it, so a time below it shows x read once."""
    itemsize = torch.empty((), dtype=dt).element_size()
    return (3 * rows * d * itemsize + 4 * d) / HBM_BYTES_PER_S * 1e3


def time_rmsnorm_kernel(mrn, gen, launches: int, worst_abs: float,
                        ptxas: dict) -> tuple:
    """B8 at the timed shapes, f32 and bf16: held to its tolerance against
    rmsnorm_plain and to the same bits over two calls, then timed beside
    its bound, the three-pass byte time, rmsnorm_plain and F.rms_norm
    (the library call computing the same function, never called by the
    port), with its walk and shared memory.  The Gemma prefill f32 case
    goes to the ``kernels`` line, every case to the details."""
    print(f"phase 5e: ptxas (registers, spill store bytes) of B8 by dtype "
          f"and load path: {ptxas}", flush=True)
    check(all(spill == 0 for _, spill in ptxas.values()),
          f"B8 spills: {ptxas}")
    entry, details = None, []
    for rows, d in B8_TIMED_SHAPES:
        base = torch.randn(rows, d, device="cuda", generator=gen)
        w = 0.1 * torch.randn(d, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x = base if dt == torch.float32 else base.to(dt)
            kern = lambda: mrn.rmsnorm_cuda(  # noqa: E731
                x, w, weight_offset=1.0)
            plain = lambda: mrn.rmsnorm_plain(  # noqa: E731
                x, w, weight_offset=1.0)
            got, again, want = kern(), kern(), plain()
            diff, ok = rmsnorm_diff(got, want)
            check(ok, f"B8 {rows}x{d} {name(dt)}: |kernel - plain| {diff:.3g}")
            check(torch.equal(got, again), f"B8 {rows}x{d} {name(dt)}: two "
                                           f"calls differ")
            del got, again, want
            lib_w = (w + 1.0).to(dt)
            p1 = median_ms(plain)
            k1 = median_ms(kern)
            k2 = median_ms(kern)
            p2 = median_ms(plain)
            lib_ms = median_ms(lambda: torch.nn.functional.rms_norm(
                x, (d,), weight=lib_w, eps=NM_EPS))
            bound_ms, bound_by = rmsnorm_bound(rows, d, dt)
            three_ms = rmsnorm_three_pass_ms(rows, d, dt)
            cluster, chunks, resident = mrn.walk(d, dt)
            row = {"name": "b8_rmsnorm", "rows": rows, "d": d,
                   "dtype": name(dt), "ms": min(k1, k2), "ms_runs": [k1, k2],
                   "plain_ms": min(p1, p2), "plain_ms_runs": [p1, p2],
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "three_pass_ms": three_ms,
                   "max_abs_err": diff,
                   "share_of_bound": bound_ms / min(k1, k2),
                   "cluster": cluster, "chunks_per_warp": chunks,
                   "resident_chunks": resident,
                   "smem_bytes": mrn.smem_bytes(d, dt)}
            details.append(row)
            print(f"  b8 {rows}x{d} {name(dt):8s} kernel {row['ms']:.4f} ms "
                  f"plain {row['plain_ms']:.4f} ms F.rms_norm {lib_ms:.4f} ms "
                  f"bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{100 * row['share_of_bound']:.1f} % of it) three-pass "
                  f"{three_ms:.4f} ms (under it: {row['ms'] < three_ms}) "
                  f"|diff| {diff:.3g}; cluster {cluster}, {chunks} chunks "
                  f"a warp ({resident} resident), {row['smem_bytes']} B "
                  f"shared a block", flush=True)
            if (rows, d) == B8_TIMED_SHAPES[-1]:
                # A decode step: the host's work per call, which is what
                # sets its time (launches queued without a wait).
                row["host_us"] = host_us(kern)
                row["library_host_us"] = host_us(
                    lambda: torch.nn.functional.rms_norm(
                        x, (d,), weight=lib_w, eps=NM_EPS))
                print(f"  b8 {rows}x{d} {name(dt):8s} host work a call: "
                      f"B8's wrapper {row['host_us']:.2f} us, F.rms_norm "
                      f"{row['library_host_us']:.2f} us", flush=True)
            if (rows, d, dt) == (*NORM_SHAPES[0], torch.float32):
                entry = {"name": "b8_rmsnorm", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "mma_rmsnorm.cu",
                         "replaces": "src/repro/kernels/mma_rmsnorm.py:27",
                         "launches": launches,
                         "max_abs_err": max(diff, worst_abs),
                         "ms": row["ms"], "plain_ms": row["plain_ms"],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms}
            del x
        del base
    return entry, details


def nm_bound(rows: int, d: int, dout: int, xdt: torch.dtype,
             wdt: torch.dtype) -> tuple:
    """Least time in ms for one B10 call with a gate: x, both weights, the
    d scale values and the output moved once at HBM rate, against its
    flops (2 rows d dout per projection) at the tensor cores' peak for
    the weights' type (989 TFLOP/s bf16, 495 TF32 for f32).  Returns
    (ms, what bounds it, bytes, flops)."""
    xi = torch.empty((), dtype=xdt).element_size()
    wi = torch.empty((), dtype=wdt).element_size()
    nbytes = rows * d * xi + 2 * d * dout * wi + 4 * d + rows * dout * xi
    flops = 2.0 * rows * d * dout * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / TC_FLOPS[wdt] * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, flops
    return ops_ms, "operations", nbytes, flops


def time_norm_matmul_kernel(mnm, dispatch, autotune, problems, gen,
                            launches: int, worst_abs: float) -> tuple:
    """B10 at phase 3h's shapes (the config's gate, no bias): held to its
    tolerance against norm_matmul_plain and to the same bits over two
    calls, then timed (median of 15 CUDA-event timings, in turns with
    the plain version) beside its bound, the plain version and the
    unfused_mma engine, the yardstick (no single PyTorch call computes
    this function).  The time is a call's: B10's launches (the row
    pass, an f32 weight's pass, the projections) together.  The cost
    model's B10 rates are refitted from the launches' device time
    (b10_device_us; the cost model adds the host time, _NM_HOST_US, on
    top): _B10_FLOPS_PER_US per form ("x dtype/w dtype") from the
    prefill shapes, flops over the device time the committed byte rate
    leaves; then _B10_BYTES_PER_US from the decode shapes, the cost
    model's bytes (autotune.b10_bytes) over the device time the fitted
    flop rates leave, summed over the cases (each case's ratio
    printed).  Gemma-2 2B's prefill in f32 goes to the ``kernels`` line,
    every case to the details."""
    entry, details, fits, decode = None, [], {}, []
    for arch, d, dff, act, rows, kinds in problems:
        for kind in kinds:
            x, s, w, wg, _ = nm_inputs(rows, d, dff, act, False, kind, gen)
            kern = lambda: mnm.norm_matmul_cuda(  # noqa: E731
                x, s, w, w_gate=wg, act=act)
            plain = lambda: mnm.norm_matmul_plain(  # noqa: E731
                x, s, w, w_gate=wg, act=act)
            plan = autotune.ReductionPlan(method="unfused_mma")
            unfused = lambda: dispatch.execute(  # noqa: E731
                "norm_matmul", x, plan, w=w, scale=s, w_gate=wg, act=act)
            got, again, want = kern(), kern(), plain()
            ratio, diff, ok = nm_diff(got, want, nm_scale(x, s, w, wg, None))
            what = f"B10 {arch} {rows}x{d}x{dff} {kind}"
            check(ok, f"{what}: |kernel - plain| {diff:.3g}")
            check(torch.equal(got, again), f"{what}: two calls differ")
            del got, again, want
            p1 = median_ms(plain, reps=3, warmup=1)
            k1 = median_ms(kern)
            k2 = median_ms(kern)
            p2 = median_ms(plain, reps=3, warmup=1)
            u_ms = median_ms(unfused)
            dev_us = b10_device_us(kern)
            bound_ms, bound_by, nbytes, flops = nm_bound(rows, d, dff,
                                                         x.dtype, w.dtype)
            ms = min(k1, k2)
            row = {"name": "b10_norm_matmul", "arch": arch, "rows": rows,
                   "d": d, "d_ff": dff, "act": act, "kind": kind,
                   "x_dtype": name(x.dtype), "w_dtype": name(w.dtype),
                   "ms": ms, "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
                   "plain_ms_runs": [p1, p2], "unfused_mma_ms": u_ms,
                   "device_ms": dev_us / 1e3,
                   "library_ms": None, "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": diff,
                   "share_of_bound": bound_ms / ms,
                   "tflops": flops / ms * 1e-9}
            details.append(row)
            print(f"  b10 {arch:16s} {rows}x{d}x{dff} {kind:9s} kernel "
                  f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s; device "
                  f"{dev_us / 1e3:.4f} ms) plain "
                  f"{row['plain_ms']:.4f} ms unfused_mma {u_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}; "
                  f"{100 * row['share_of_bound']:.1f} % of it) |diff| "
                  f"{diff:.3g}", flush=True)
            form = f"{name(x.dtype)}/{name(w.dtype)}"
            model_bytes = autotune.b10_bytes(
                rows * d, name(x.dtype), name(w.dtype),
                {"d": d, "dout": dff, "gate": 1})
            if rows > 1024:
                left = dev_us - model_bytes / autotune._B10_BYTES_PER_US
                fits.setdefault(form, []).append(flops / left)
            else:
                decode.append((form, model_bytes, flops, dev_us))
            if (arch, rows, kind) == (NM_PICK_ARCH, problems[0][4], "f32"):
                entry = {"name": "b10_norm_matmul", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "mma_norm_matmul.cu",
                         "replaces": "src/repro/kernels/"
                                     "mma_norm_matmul.py:70",
                         "launches": launches,
                         "max_abs_err": max(diff, worst_abs),
                         "ms": ms, "plain_ms": row["plain_ms"],
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
            del x, s, w, wg
    fit = {k: statistics.fmean(v) for k, v in fits.items()}
    rates = {**autotune._B10_FLOPS_PER_US, **fit}
    left = [(nb, us - fl / rates[form]) for form, nb, fl, us in decode]
    byte_fits = [nb / t for nb, t in left if t > 0]
    shown = {k: round(v / 1e6, 2) for k, v in fit.items()}
    fit["bytes_per_us"] = (sum(nb for nb, _ in left)
                           / sum(t for _, t in left)
                           if sum(t for _, t in left) > 0 else None)
    print(f"phase 5f: fitted _B10_FLOPS_PER_US {shown} x 1e6 "
          f"(per prefill case {fits}); committed "
          f"{autotune._B10_FLOPS_PER_US}; fitted _B10_BYTES_PER_US "
          f"{fit['bytes_per_us']} (per decode case {byte_fits}); committed "
          f"{autotune._B10_BYTES_PER_US}", flush=True)
    return entry, details, fit


def b10_device_us(call, calls: int = 5) -> float:
    """µs of device time a B10 call's launches take (the row pass, an
    f32 weight's pass, the projections), the mean over ``calls`` calls
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    # A trace can come back without the card's activity (CUPTI lost its
    # buffer): such a session is traced again, three sessions at most.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        total = sum(getattr(ev, "device_time_total", 0) or 0
                    for ev in prof.key_averages()
                    if any(k in ev.key for k in ("row_kernel",
                                                 "weight_kernel",
                                                 "nm_kernel")))
        if total > 0:
            break
    check(total > 0, "torch.profiler saw no device time of B10's launches "
                     "in three traces")
    return total / calls


def fit_nm_host(dispatch, autotune, gen) -> dict:
    """µs of host time per norm_matmul call with w given, per kind and
    engine: each engine at NM_HOST_SHAPE with a gelu gate, the fastest
    CUDA-event median of 50 calls over the rounds of balanced_orders."""
    rows, d, dout = NM_HOST_SHAPE
    fit = {}
    for kind in NM_KINDS:
        x, s, w, wg, _ = nm_inputs(rows, d, dout, "gelu", False, kind, gen)
        calls = {m: (lambda p=autotune.ReductionPlan(method=m):
                     dispatch.execute("norm_matmul", x, p, w=w, scale=s,
                                      w_gate=wg, act="gelu"))
                 for m in NM_ENGINES}
        us = dict.fromkeys(NM_ENGINES, math.inf)
        for order in balanced_orders(NM_ENGINES):
            for m in order:
                us[m] = min(us[m], 1e3 * median_ms(calls[m], reps=50,
                                                   warmup=5))
        fit[kind] = us
    print(f"phase 5f: fitted _NM_HOST_US (us a call, per kind) "
          + "; ".join(f"{k}: " + ", ".join(f"{m} {v:.1f}" for m, v in
                                          us.items())
                      for k, us in fit.items())
          + f"; committed {autotune._NM_HOST_US}", flush=True)
    return fit


# ------------------------------------------ phase 2g: B9 kernel checks


def attn_inputs(B, Sq, Sk, KV, G, hd, hd_v, kind, qpos, kv_len,
                gen) -> tuple:
    """qg, k, v on the card in ``kind``'s dtypes, qpos (B, Sq) int32 and
    kv_len (B,) int32 or None."""
    qd, kd = ATTN_KINDS[kind]
    qg = torch.randn(B, Sq, KV, G, hd, device="cuda", generator=gen).to(qd)
    k = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen).to(kd)
    v = torch.randn(B, Sk, KV, hd_v, device="cuda", generator=gen).to(kd)
    pos = (torch.arange(Sq, device="cuda") + max(Sk - Sq, 0))
    pos = pos.to(torch.int32).expand(B, Sq).contiguous()
    kvl = None
    if kv_len:
        kvl = torch.randint(0, Sk + 1, (B,), device="cuda",
                            generator=gen).to(torch.int32)
        pos = (kvl[:, None] - 1).expand(B, Sq).contiguous()
    if qpos == "padded":
        pos = pos.clone()
        pos[:, 0] = -1
    return qg, k, v, pos, kvl


def attn_oracle(ma, qg, k, v, *, qpos, causal, window, kv_len, scale, cap,
                abs_v: bool = False, rows_per_chunk: int = 8) -> torch.Tensor:
    """f64 attention of these operands (with abs_v, sum_j p_ij |v_j| /
    l_i, the absolute-value scale), (B, Sq, KV, G, hd_v), a few batch rows
    at a time so that a decode cache is never widened whole."""
    qpos = torch.as_tensor(qpos, device=qg.device)
    if qpos.ndim == 1:
        qpos = qpos.expand(qg.shape[0], -1)
    outs = []
    for b0 in range(0, qg.shape[0], rows_per_chunk):
        sl = slice(b0, b0 + rows_per_chunk)
        s = torch.einsum("bqkgh,bckh->bkgqc", qg[sl].double(),
                         k[sl].double()) * scale
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        lo, hi = ma.row_bounds(qpos[sl], None if kv_len is None
                               else kv_len[sl], sk=k.shape[1],
                               causal=causal, window=window)
        j = torch.arange(k.shape[1], device=qg.device)
        valid = ((j >= lo[..., None]) & (j < hi[..., None]))[:, None, None]
        p = torch.softmax(torch.where(valid, s, -1e300), -1) * valid
        del s
        vv = v[sl].double()
        outs.append(torch.einsum("bkgqc,bckh->bqkgh", p,
                                 vv.abs() if abs_v else vv))
        del p, vv
    return torch.cat(outs)


def attn_sigma(qg, k, scale, rows_per_chunk: int = 8) -> torch.Tensor:
    """Each row's score scale scale max_j sum_h |q_ih k_jh|, as
    (B, Sq, KV, G, 1) f64, a few batch rows at a time."""
    sig = torch.cat([torch.einsum(
        "bqkgh,bckh->bkgqc", qg[b0:b0 + rows_per_chunk].double().abs(),
        k[b0:b0 + rows_per_chunk].double().abs()).amax(-1)
        for b0 in range(0, qg.shape[0], rows_per_chunk)]) * scale
    return sig.permute(0, 3, 1, 2)[..., None]


def attn_diff(got, want, a, sigma) -> tuple:
    """(max |got - want| / ((1 + sigma) A), max |got - want|, whether
    every element is within B9's tolerance of its plain version)."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    scale = (1.0 + sigma) * a
    bound = B9_RTOL * scale
    if want.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * a + torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(1e-30))) - 7)
    return (float((diff / scale.clamp_min(1e-300)).max()), float(diff.max()),
            bool(torch.all(diff <= bound)))


def check_attention_kernel(ma, gen) -> dict:
    """B9 against attention_plain on the same card inputs: B9_CASES for
    f32, bf16 and f32 q beside a bf16 cache, B9_WG_CASES in bf16 (the
    wgmma form), B9_WF_CASES in f32 (the f32 prefill form, which the
    f32 B9_CASES with more than 16 rows a head take too) and B9_DC_CASES
    in f32 q and in bf16 beside a bf16 cache (the decode form, which the
    decode B9_CASES beside a bf16 cache take too); each launch
    moves its form's counter, the CUDA chooser
    agrees with walk; two calls give the same bits, rows 0..k of a B-row
    call equal a (k + 1)-row call, and rows with no valid key are
    exactly 0."""
    worst = {"f32_ratio": 0.0, "abs": 0.0}
    rows_out = []
    forms = dict.fromkeys(B9_COUNTERS, 0)
    # B9_WG_CASES draw from a generator of their own, so that the phases
    # after this one see the same random data as before they were added.
    wg_gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    wf_gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dc_gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [(kind, case, gen) for kind in ATTN_KINDS for case in B9_CASES] \
        + [("bf16", case, wg_gen) for case in B9_WG_CASES] \
        + [("f32", case, wf_gen) for case in B9_WF_CASES] \
        + [(kind, case, dc_gen) for kind in ("mixed", "bf16")
           for case in B9_DC_CASES]
    for kind, (B, Sq, Sk, KV, G, hd, hd_v, causal, window, cap, qpos,
               kv_len), case_gen in cases:
        qg, k, v, pos, kvl = attn_inputs(B, Sq, Sk, KV, G, hd, hd_v,
                                         kind, qpos, kv_len, case_gen)
        if kvl is not None and case_gen is dc_gen:
            # a row with no key, and one past the first chunk boundary
            kvl[0] = 0
            kvl[-1] = max(int(kvl[-1]), 2049)
            pos = (kvl[:, None] - 1).expand(B, Sq).contiguous()
        kw = dict(qpos=pos, causal=causal, window=window, kv_len=kvl,
                  scale=hd ** -0.5, cap=cap)
        form = ma.walk(qg.dtype, k.dtype, Sq * G, hd, hd_v)[0]
        check(ma.cuda_form(qg.dtype, k.dtype, Sq * G, hd, hd_v) == form,
              f"B9 {kind} rows {Sq * G} hd {hd}/{hd_v}: the CUDA "
              f"chooser disagrees with walk ({form})")
        counter = B9_COUNTERS[form]
        before = dict(ma.LAUNCHES)
        got = ma.attention_cuda(qg, k, v, **kw)
        check(ma.LAUNCHES[counter] == before[counter] + 1
              and sum(ma.LAUNCHES.values()) == sum(before.values()) + 1,
              f"B9 {kind} rows {Sq * G} hd {hd}/{hd_v}: launched "
              f"{ma.LAUNCHES} after {before}, not the {form} form")
        forms[form] += 1
        again = ma.attention_cuda(qg, k, v, **kw)
        want = ma.attention_plain(qg, k, v, **kw)
        what = (f"B9 {B}x{Sq}x{Sk} kv{KV} g{G} hd {hd}/{hd_v} causal="
                f"{causal} window={window} cap={cap} {qpos} kv_len="
                f"{kv_len} {kind} ({form})")
        check(got.shape == (B, Sq, KV, G, hd_v) and got.dtype == v.dtype
              and bool(torch.all(torch.isfinite(got))),
              f"{what}: {got.dtype} {tuple(got.shape)}")
        a = attn_oracle(ma, qg, k, v, abs_v=True, **kw)
        ratio, diff, ok = attn_diff(got, want, a,
                                    attn_sigma(qg, k, kw["scale"]))
        if kind == "f32":
            worst["f32_ratio"] = max(worst["f32_ratio"], ratio)
        worst["abs"] = max(worst["abs"], diff)
        rows_out.append((counter, B, Sq, Sk, KV, G, hd, hd_v,
                         causal, window, cap, qpos, kv_len, kind, ratio,
                         diff))
        check(ok, f"{what}: |kernel - plain| {diff:.3g} ({ratio:.3g} "
                  f"of its scale) over its tolerance")
        check(torch.equal(got, again), f"{what}: two calls differ")
        if qpos == "padded":
            check(torch.equal(got[:, 0], torch.zeros_like(got[:, 0])),
                  f"{what}: a row with no valid key is not exactly 0")
        if kvl is not None and int(kvl.min()) == 0:
            zero = int(torch.argmin(kvl))
            check(torch.equal(got[zero], torch.zeros_like(got[zero])),
                  f"{what}: a row with kv_len 0 is not exactly 0")
        if B > 1:
            part = ma.attention_cuda(
                qg[:1].contiguous(), k[:1].contiguous(),
                v[:1].contiguous(), **dict(
                    kw, qpos=pos[:1].contiguous(),
                    kv_len=None if kvl is None else kvl[:1].contiguous()))
            check(torch.equal(part, got[:1]),
                  f"{what}: row 0 differs from a one-row call")
        del qg, k, v, got, again, want, a
    torch.cuda.synchronize()
    check(min(forms.values()) > 0, f"phase 2g: a B9 form never ran {forms}")
    print(f"phase 2g: {len(rows_out)} B9-vs-plain checks passed "
          f"(by form {forms}), worst "
          f"|diff| {worst['abs']:.3g}, worst f32 |diff| / ((1 + sigma) A) "
          f"{worst['f32_ratio']:.3g} (within 2^-20 of it, bf16 v plus 2^-8 "
          f"A and one ulp; two calls the same bits; a row's bits "
          f"independent of the batch; rows with no key exactly 0)",
          flush=True)
    return {"worst_abs": worst["abs"], "worst_f32_ratio": worst["f32_ratio"],
            "rows": rows_out}


# ---------------------------- phase 3i: the attention layer at full width


class AttnCapture:
    """Records the qg / k / v / kwargs that ``models.attention``'s
    registry call receives and what it returns, so that phase 3i holds
    each engine's attention output to an oracle of its own operands."""

    def __init__(self, attention_module):
        self.mod = attention_module
        self.inner = attention_module._registry_attn
        self.seen = {}

    def __enter__(self):
        def spy(cfg, qg, k, v, **kw):
            out = self.inner(cfg, qg, k, v, **kw)
            self.seen = dict(qg=qg, k=k, v=v, kw=kw, out=out)
            return out
        self.mod._registry_attn = spy
        return self

    def __exit__(self, *exc):
        self.mod._registry_attn = self.inner
        return False


def attn_problems(registry, base) -> list:
    """Phase 3i's (label, arch, kind, phase, tokens or slots, capacity,
    dtypes): Gemma-2 2B's global and local layers at prefill and at a
    decode step, and GLM-4 9B's decode step (ATTN_ROWS_ARCH)."""
    seq = base.SHAPES["train_4k"].seq_len
    slots = base.SHAPES["decode_32k"].global_batch
    cache = base.SHAPES["decode_32k"].seq_len
    cfg = registry.get_config(ATTN_ARCH)
    return [("prefill global", ATTN_ARCH, "global", "prefill", seq, None,
             ("f32", "bf16")),
            ("prefill local", ATTN_ARCH, "local", "prefill", 2 * seq, None,
             ("f32", "bf16")),
            ("decode global", ATTN_ARCH, "global", "decode", slots, cache,
             ("mixed", "bf16")),
            ("decode local", ATTN_ARCH, "local", "decode", slots,
             cfg.window, ("mixed", "bf16")),
            ("decode local", ATTN_ARCH, "local", "decode", slots,
             cfg.window, ("f32",)),
            ("decode 16 rows", ATTN_ROWS_ARCH, "global", "decode", slots,
             cache, ("mixed",))]


def run_attention_path(A, param, dispatch, registry, base, ma, gen) -> tuple:
    """models.attention.attention with attn_method per engine at Gemma-2
    2B's and GLM-4 9B's full widths (attn_problems): each engine's attention output
    against the f64 oracle of its own qg / k / v within ATTN_CEILINGS
    (+ 100 * 2^-8 % per rounding to bf16); auto within PICK_SLACK of the
    fastest engine, the layer timed in balanced_orders.  B9's wgmma form
    must launch at the bf16 prefill shapes, its f32 prefill form at the
    f32 ones, its decode form at decode over a bf16 ring and its mma.sync
    form over an f32 ring, each alone.  Returns (rows, picks, shapes)
    where shapes keeps each problem's operands for 5g."""
    import dataclasses
    rows_out, picks, shapes, params = [], [], [], {}
    for label, arch, kind, phase, n, capacity, kinds in attn_problems(
            registry, base):
        cfg0 = registry.get_config(arch)
        if arch not in params:
            params[arch] = param.init_tree(gen, A.attn_specs(cfg0),
                                           device="cuda")
        decode = phase == "decode"
        if decode:
            cache = A.make_cache(cfg0, n, capacity,
                                 dtype=ATTN_KINDS[kinds[0]][1])
            cache["k"].copy_(torch.randn(cache["k"].shape, device="cuda",
                                         generator=gen,
                                         dtype=cache["k"].dtype))
            cache["v"].copy_(torch.randn(cache["v"].shape, device="cuda",
                                         generator=gen,
                                         dtype=cache["v"].dtype))
            positions = torch.randint(0, base.SHAPES["decode_32k"].seq_len,
                                      (n, 1), device="cuda", generator=gen)
            x32 = torch.randn(n, 1, cfg0.d_model, device="cuda",
                              generator=gen)
        else:
            cache = None
            positions = torch.arange(n, device="cuda")
            x32 = torch.randn(1, n, cfg0.d_model, device="cuda",
                              generator=gen)
        for dkind in kinds:
            x = x32.to(ATTN_KINDS[dkind][0])
            problem = f"{label} {dkind}"
            methods = tuple(m for m in ATTN_METHODS
                            if not (decode and m == "unfused_mma"))
            calls, found, operands = {}, [], None
            before = dict(ma.LAUNCHES)
            for method in methods:
                cfg = dataclasses.replace(cfg0, attn_method=method)
                call = (lambda c=cfg, w=params[arch]: A.attention(
                    w, c, x, positions=positions, kind=kind,
                    cache=cache, decode=decode)[0])
                torch.cuda.synchronize()
                with AttnCapture(A) as cap:
                    out = call()
                torch.cuda.synchronize()
                seen = cap.seen
                kw = {key: seen["kw"][key] for key in
                      ("qpos", "causal", "window", "kv_len", "scale")}
                kw["cap"] = cfg0.attn_softcap
                engine = method if method != "auto" else dispatch.auto_plan(
                    "attention", seen["qg"], k=seen["k"], v=seen["v"],
                    cap=cfg0.attn_softcap, chunk=cfg0.attn_chunk,
                    **{key: kw[key] for key in ("qpos", "causal", "window",
                                                "kv_len", "scale")}).method
                o = seen["out"]
                check(out.shape == x.shape and o.dtype == seen["v"].dtype
                      and bool(torch.all(torch.isfinite(o))),
                      f"{problem} {method}: {o.dtype} {tuple(o.shape)}")
                kl = kw["kv_len"]
                kl = None if kl is None else torch.as_tensor(
                    kl, device="cuda").reshape(-1).expand(n if decode
                                                          else 1)
                want = attn_oracle(ma, seen["qg"], seen["k"], seen["v"],
                                   **dict(kw, kv_len=kl))
                err = frob_pct(o, want)
                ceiling = ATTN_CEILINGS[engine] + (
                    ATTN_BF16_ROUNDINGS * 100.0 * 2.0 ** -8
                    if seen["v"].dtype == torch.bfloat16 else 0.0)
                check(math.isfinite(err) and err <= ceiling,
                      f"{problem} {method}: {err:.3e}% > {ceiling:.3g}%")
                if operands is None:
                    operands = dict(qg=seen["qg"], k=seen["k"],
                                    v=seen["v"], kw=dict(kw, kv_len=kl))
                del o, want, out, seen
                cap.seen = {}
                calls[method] = call
                found.append({"problem": problem, "kind": kind,
                              "phase": phase, "n": n, "dtype": dkind,
                              "method": method, "engine": engine,
                              "frob_pct_err": err, "ceiling_pct": ceiling})
            times = dict.fromkeys(methods, math.inf)
            for order in balanced_orders(methods):
                for method in order:
                    times[method] = min(times[method], median_ms(
                        calls[method], reps=3, warmup=1))
            for row in found:
                row["ms"] = times[row["method"]]
                rows_out.append(row)
                print(f"  {problem:22s} {row['method']:12s} engine="
                      f"{row['engine']:12s} err={row['frob_pct_err']:.3e}% "
                      f"(ceiling {row['ceiling_pct']:.3g}%) "
                      f"{row['ms']:.4f} ms", flush=True)
            pick = check_pick(f"{problem} attention", {
                m: times[m] for m in methods if m != "auto"}, times["auto"])
            moved = {key: ma.LAUNCHES[key] - before[key] for key in before}
            form = B9_COUNTERS[
                ("mma_sync" if dkind == "f32" else "decode") if decode
                else "wgmma" if dkind == "bf16" else "wgmma_f32"]
            check(moved[form] > 0 and sum(moved.values()) == moved[form],
                  f"{problem}: B9 launches by form {moved}, expected "
                  f"{form} alone")
            print(f"  {problem:22s} B9 launches by form {moved}", flush=True)
            pick.update(problem=problem, b9_launches=moved)
            picks.append(pick)
            shapes.append((problem, dkind, decode, operands))
            del x
        del cache, x32
    return rows_out, picks, shapes


# ------------------------------------------- phase 3j: the model path


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def model_bound(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|got - ref|, max|ref| + 1): the reference's prefill + decode
    check holds the first below MODEL_BOUND times the second."""
    got, ref = got.to(torch.float32), ref.to(torch.float32)
    return (float(torch.max(torch.abs(got - ref))),
            float(torch.max(torch.abs(ref))) + 1.0)


def smoke_batch(cfg, gen, b: int, s: int) -> dict:
    """A train batch of random tokens (and the modality inputs) on the
    card, as ``tests/test_models.py`` makes one."""
    def tokens(shape):
        return torch.randint(0, cfg.vocab_size, shape, device=DEV,
                             generator=gen, dtype=torch.int32)
    out = {"tokens": tokens((b, s)), "labels": tokens((b, s)),
           "mask": torch.ones((b, s), device=DEV)}
    if cfg.vision_tokens:
        out["vision_embeds"] = torch.randn(
            b, cfg.vision_tokens, cfg.d_model, device=DEV,
            generator=gen).to(torch.bfloat16)
    if cfg.is_encdec:
        out["src_embeds"] = torch.randn(b, s, cfg.d_model, device=DEV,
                                        generator=gen).to(torch.bfloat16)
    return out


def run_model_smoke(registry, model_zoo, gen) -> list:
    """Phase 3j (a): every arch at its SMOKE size on the card with the
    plain engines: logits, the loss near ln V, and a prefill of
    MODEL_SMOKE_BATCH tokens then one decode step against the whole
    sequence's last logits within MODEL_BOUND."""
    rows = []
    b, s = MODEL_SMOKE_BATCH
    for arch in registry.list_archs():
        cfg = registry.get_config(arch, smoke=True)
        model = model_zoo.build(cfg)
        params = model.init(gen, DEV)
        batch = smoke_batch(cfg, gen, b, s)
        logits = model.logits(params, batch)
        check(tuple(logits.shape) == (b, s, cfg.vocab_size)
              and logits.device.type == DEV
              and bool(torch.all(torch.isfinite(logits))),
              f"3j {arch}: logits {tuple(logits.shape)} on "
              f"{logits.device}")
        loss, metrics = model.loss(params, batch)
        loss = float(loss)
        check(math.isfinite(loss)
              and abs(loss - math.log(cfg.vocab_size)) < 3.0,
              f"3j {arch}: loss {loss} against ln V "
              f"{math.log(cfg.vocab_size):.3f}")
        prompt = {k: v for k, v in batch.items()
                  if k not in ("labels", "mask")}
        _, caches = model.prefill(params, prompt)
        check(all(leaf.device.type == DEV for leaf in tree_leaves(caches)),
              f"3j {arch}: a cache leaf is off the card")
        nxt = torch.randint(0, cfg.vocab_size, (b, 1), device=DEV,
                            generator=gen, dtype=torch.int32)
        got, _ = model.decode_step(params, {"token": nxt, "pos": s,
                                            "caches": caches})
        full = model.logits(params, dict(
            prompt, tokens=torch.cat([prompt["tokens"], nxt], 1)))[:, -1:]
        diff, scale = model_bound(got, full)
        check(diff < MODEL_BOUND * scale,
              f"3j {arch}: prefill + decode {diff} against the full "
              f"forward's last logits (bound {MODEL_BOUND * scale})")
        rows.append({"arch": arch, "loss": loss,
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "decode_diff": diff, "decode_scale": scale})
        del params, caches
    print(f"phase 3j (a): ten archs at SMOKE size on the card: "
          + ", ".join(f"{r['arch']} loss {r['loss']:.3f} decode "
                      f"{r['decode_diff']:.2e}" for r in rows), flush=True)
    return rows


class MoeCapture:
    """Records each ``moe._route`` call's tokens and expert ids, so that
    phase 3j prints the MoE's counts and the tokens its capacity
    dropped."""

    def __init__(self, moe_module):
        self.mod = moe_module
        self.inner = moe_module._route
        self.calls = []

    def __enter__(self):
        def spy(cfg, router_w, x_flat):
            ids, w, probs = self.inner(cfg, router_w, x_flat)
            mc = cfg.moe
            t = x_flat.shape[0]
            cap = max(8, int(math.ceil(mc.capacity_factor * t * mc.top_k
                                       / mc.num_experts)))
            counts = torch.bincount(ids.reshape(-1),
                                    minlength=mc.num_experts)
            self.calls.append({
                "tokens": t, "counts_sum": int(counts.sum()),
                "top_k": mc.top_k, "capacity": cap,
                "dropped": int(torch.clamp(counts - cap, min=0).sum())})
            return ids, w, probs
        self.mod._route = spy
        return self

    def __exit__(self, *exc):
        self.mod._route = self.inner
        return False


def model_params(param, model, dtype):
    """The model's parameters on the card from SEED; with ``dtype``
    each leaf is drawn in f32 and cast as it is made, so that the f32
    tree never stands whole."""
    import dataclasses
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    if dtype is None:
        return model.init(gen, DEV)
    specs = tree_map(lambda p: dataclasses.replace(p, dtype=dtype),
                     model.specs)
    return param.init_tree(gen, specs, device=DEV)


def full_width_cfg(registry, arch: str, cuts: dict):
    """The arch's FULL config cut in depth only."""
    import dataclasses
    cfg = registry.get_config(arch)
    if "first_dense_layers" in cuts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=cuts["first_dense_layers"]))
    return dataclasses.replace(cfg, num_layers=cuts["num_layers"])


def device_ms(call, calls: int = 3):
    """ms of device time a call's kernels take (every CUDA event's time
    in a torch.profiler trace over ``calls`` calls, per call), or None
    when three traces saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        total = sum(ev.device_time_total for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA)
        if total > 0:
            return total / calls / 1e3
    return None


def run_model_full(arch: str, registry, model_zoo, param, moe,
                   counters: tuple, smi: str) -> dict:
    """Phase 3j (b) / (c): one model at full width, cut in depth
    (MODEL_FULL[arch]), with the kernel spellings: a prefill of
    MODEL_PROMPT tokens and MODEL_STEPS decode steps with the launch
    counters zeroed just before and read just after (each of the
    arch's kernels must move), then their logits against ``logits`` of
    the whole sequence and against the plain engines' on the same
    params, within MODEL_BOUND; the median ms per prefill and per decode
    step (CUDA events, MODEL_TIMING_CALLS after a warm call) and the
    peak memory."""
    import dataclasses
    spec = MODEL_FULL[arch]
    base_cfg = full_width_cfg(registry, arch, spec["cuts"])
    kcfg = dataclasses.replace(base_cfg, **KERNEL_SPELLINGS)
    pcfg = dataclasses.replace(base_cfg, **{**PLAIN_SPELLINGS,
                                            **spec.get("plain", {})})
    model, plain = model_zoo.build(kcfg), model_zoo.build(pcfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_params(param, model, spec["param_dtype"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    tokens = torch.randint(0, kcfg.vocab_size,
                           (1, MODEL_PROMPT + MODEL_STEPS), device=DEV,
                           generator=gen, dtype=torch.int32)
    prompt = tokens[:, :MODEL_PROMPT]

    def decode(caches, i: int):
        return model.decode_step(params, {
            "token": tokens[:, MODEL_PROMPT + i - 1:MODEL_PROMPT + i]
            if i <= MODEL_STEPS else tokens[:, -1:],
            "pos": MODEL_PROMPT + i - 1, "caches": caches})

    with MoeCapture(moe) as routed:
        for mod in counters:
            mod.reset_launches()
        first, caches = model.prefill(params, {"tokens": prompt})
        outs = [first]
        for i in range(1, MODEL_STEPS + 1):
            step, caches = decode(caches, i)
            outs.append(step)
        torch.cuda.synchronize()
        launches = {kname: count for mod in counters
                    for kname, count in mod.LAUNCHES.items()}
    for kname in spec["kernels"]:
        check(launches[kname] > 0,
              f"3j {arch}: kernel {kname} was not launched on the model "
              f"path ({launches})")
    got = torch.cat(outs, dim=1)          # positions P-1 .. P+STEPS-1
    full = model.logits(params, {"tokens": tokens})[:, MODEL_PROMPT - 1:] \
        .clone()
    vs_full = model_bound(got, full)
    ref = plain.logits(params, {"tokens": tokens})[:, MODEL_PROMPT - 1:] \
        .clone()
    vs_plain = model_bound(got, ref)
    full_vs_plain = model_bound(full, ref)
    del full, ref
    for what, (diff, scale) in (("prefill + decode vs logits", vs_full),
                                ("prefill + decode vs plain", vs_plain),
                                ("logits vs plain", full_vs_plain)):
        check(diff < MODEL_BOUND * scale,
              f"3j {arch}: {what} {diff} (bound {MODEL_BOUND * scale})")

    prefill_ms = median_ms(lambda: model.prefill(params, {"tokens": prompt}),
                           reps=MODEL_TIMING_CALLS, warmup=1)
    state = {"caches": caches, "i": MODEL_STEPS + 1}

    def one_step():
        _, state["caches"] = decode(state["caches"], state["i"])
        state["i"] += 1
    decode_ms = median_ms(one_step, reps=MODEL_TIMING_CALLS, warmup=1)
    # The device's busy share of a call: its kernels' device time (a
    # trace) over its CUDA-event median.
    busy = {"prefill_device_ms": device_ms(
                lambda: model.prefill(params, {"tokens": prompt})),
            "decode_device_ms": device_ms(one_step)}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    row = {"arch": arch, "cuts": spec["cuts"],
           "reduced": spec["reduced"],
           "param_dtype": name(spec["param_dtype"] or torch.float32),
           "num_params": model.num_params(), "init_s": init_s,
           "launches": launches, "vs_full": vs_full, "vs_plain": vs_plain,
           "full_vs_plain": full_vs_plain, "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, **busy, "peak_gib": peak_gib,
           "card": smi}
    if routed.calls:
        row["moe_prefill"] = routed.calls[0]
        row["moe_decode_dropped"] = sum(c["dropped"]
                                        for c in routed.calls[1:])
        for c in routed.calls:
            check(c["counts_sum"] == c["tokens"] * c["top_k"],
                  f"3j {arch}: MoE counts sum {c['counts_sum']} != T k")
    print(f"phase 3j ({spec['part']}): {arch} {json.dumps(row)}",
          flush=True)
    print(f"phase 3j ({spec['part']}): {arch} prefill of {MODEL_PROMPT} "
          f"tokens {prefill_ms:.4f} ms, decode step {decode_ms:.4f} ms "
          f"(median of {MODEL_TIMING_CALLS}, CUDA events); device time "
          f"{busy['prefill_device_ms']} / {busy['decode_device_ms']} ms "
          f"(torch.profiler) on {smi}", flush=True)
    del params, caches, state
    torch.cuda.empty_cache()
    return row


def run_auto_f32_decode(registry, model_zoo, transformer, param, ma,
                        smi: str) -> dict:
    """Phase 3j (b'): which engine ``auto`` takes for an f32 model's
    decode step over f32 caches (B9 serves an f32 cache only in its
    mma.sync form; unfused_mma refuses a decode step's dynamic kv_len):
    Gemma-2 2B cut as in (b), compute dtype f32 and attn_method 'auto',
    a prefill of MODEL_PROMPT tokens into f32 caches, then one decode
    step with B9's counters zeroed just before it."""
    import dataclasses
    cfg = dataclasses.replace(
        full_width_cfg(registry, "gemma2-2b",
                       MODEL_FULL["gemma2-2b"]["cuts"]),
        compute_dtype=torch.float32, attn_method="auto")
    model = model_zoo.build(cfg)
    params = model_params(param, model, None)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (1, MODEL_PROMPT + 1),
                           device=DEV, generator=gen, dtype=torch.int32)
    caches = transformer.init_decoder_cache(
        cfg, 1, MODEL_PROMPT + 64, dtype=torch.float32, device=DEV)
    _, caches, _ = transformer.decoder_forward(
        params, cfg, tokens[:, :MODEL_PROMPT], caches=caches)
    torch.cuda.synchronize()
    ma.reset_launches()
    hidden, _, _ = transformer.decoder_forward(
        params, cfg, tokens[:, MODEL_PROMPT:],
        positions=torch.tensor([MODEL_PROMPT], device=DEV), caches=caches,
        decode=True)
    torch.cuda.synchronize()
    launches = dict(ma.LAUNCHES)
    check(bool(torch.all(torch.isfinite(hidden))),
          "3j (b'): the f32 decode step is not finite")
    engine = "fused_pallas (B9)" if sum(launches.values()) else "vpu"
    print(f"phase 3j (b'): auto at an f32 decode step over f32 caches "
          f"(Gemma-2 2B, 4 layers) takes {engine}; B9 launches "
          f"{launches} on {smi}", flush=True)
    del params, caches
    torch.cuda.empty_cache()
    return {"engine": engine, "launches": launches}


# ------------------------------------------------- phase 5g: B9 timings


def attn_bound(qg, k, v, kw) -> tuple:
    """Least time in ms for one B9 call: q, the keys and values each row
    reads (up to its kv_len, all of them at prefill) and o moved once
    at HBM rate, against 2 (hd + hd_v) flops per live score at the tensor
    cores' peak (TF32's 495 TFLOP/s when an operand is f32, else bf16's
    989).  Returns (ms, what bounds it, bytes, flops)."""
    import importlib
    ma = importlib.import_module("repro_torch.kernels.mma_attention")
    B, Sq, KV, G, hd = qg.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    qpos = torch.as_tensor(kw["qpos"], device="cuda")
    if qpos.ndim == 1:
        qpos = qpos.expand(B, -1)
    lo, hi = ma.row_bounds(qpos, kw["kv_len"], sk=Sk, causal=kw["causal"],
                           window=kw["window"])
    live = float((hi - lo).clamp_min(0).sum()) * KV * G
    keys = float(hi.amax(1).sum()) * KV if kw["kv_len"] is not None \
        else float(B * Sk * KV)
    nbytes = qg.numel() * qg.element_size() \
        + keys * (hd + hd_v) * k.element_size() \
        + B * Sq * KV * G * hd_v * v.element_size()
    flops = 2.0 * (hd + hd_v) * live
    peak = TC_FLOPS[torch.float32 if torch.float32 in (qg.dtype, k.dtype)
                    else torch.bfloat16]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes, flops
    return ops_ms, "operations", nbytes, flops


def sdpa_call(qg, k, v, kw):
    """F.scaled_dot_product_attention on the same operands (no softcap:
    SDPA has none), q in the cache's dtype, the kv_len mask or a
    window's causal band as a boolean attn_mask; the operands are laid
    out (B, heads, S, hd) beforehand."""
    import torch.nn.functional as F
    B, Sq, KV, G, hd = qg.shape
    q = qg.to(k.dtype).permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd)
    kk = k.permute(0, 2, 1, 3).contiguous()
    vv = v.permute(0, 2, 1, 3).contiguous()
    mask = None
    j = torch.arange(k.shape[1], device="cuda")
    if kw["kv_len"] is not None:
        mask = (j[None] < kw["kv_len"].reshape(-1, 1))[:, None, None]
    elif kw["window"] is not None:
        i = torch.as_tensor(kw["qpos"], device="cuda").reshape(-1, Sq)[0]
        band = (j[None] > i[:, None] - kw["window"]) \
            & ((j[None] <= i[:, None]) if kw["causal"] else True)
        mask = band[None, None]
    causal = kw["causal"] and mask is None
    return lambda: F.scaled_dot_product_attention(
        q, kk, vv, attn_mask=mask, is_causal=causal, scale=kw["scale"],
        enable_gqa=True)


def ptxas_kernels(lib, needle: str) -> dict:
    """{kernel: (registers, spill store bytes)} for the kernels of a
    library whose mangled name holds ``needle``, from the compiler's
    report beside it."""
    import re
    found, name = {}, None
    for line in open(f"{lib}.log"):
        got = re.search(r"Compiling entry function '([^']+)'", line)
        if got:
            name = got.group(1) if needle in got.group(1) else None
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            found[name] = [None, int(spill.group(1))]
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name in found:
            found[name][0] = int(regs.group(1))
    return {key: tuple(val) for key, val in found.items()}


def time_attention_kernel(ma, dispatch, autotune, shapes, launches: dict,
                          worst_abs: dict, probe, sync_dll) -> tuple:
    """B9 at phase 3i's shapes, on the operands the layer gave it: held
    to its tolerance against attention_plain and to the same bits over two
    calls, then timed (median CUDA-event time, in turns with the plain
    version) beside its bound, the plain version and unfused_mma (at
    prefill; it refuses decode); and, with cap=None, beside B9 without
    the softcap and F.scaled_dot_product_attention, the library
    yardstick (every shape, a window as SDPA's mask).  The cost model's
    B9 rates are refitted: _B9_FLOPS_PER_US from the prefill shapes,
    _B9_BYTES_PER_US from the decode form's at 2 rows a head and
    _B9_DECODE_FLOPS_PER_US from its 16-row step.  At the f32 prefill shapes
    and the decode steps over a bf16 ring the mma.sync form as they ran
    before the f32 prefill and decode forms (the probe's mma_sync build,
    ``sync_dll``) is timed in turns with B9, and the f32 form's or the
    decode form's two launches are read by torch.profiler.  The
    ``kernels`` line takes the wgmma and f32 prefill forms at the global
    prefill, the decode form at the global decode step (mixed) and the
    mma.sync form at the local decode step over an f32 ring; every case
    goes to the details."""
    entries, details, fits = {}, [], {}
    for problem, dkind, decode, op in shapes:
        qg, k, v, kw = op["qg"], op["k"], op["v"], dict(op["kw"])
        qpos = torch.as_tensor(kw["qpos"], device="cuda").to(torch.int32)
        qpos = qpos.expand(qg.shape[0], qg.shape[1]).contiguous()
        kl = kw["kv_len"]
        kk = dict(kw, qpos=qpos, kv_len=None if kl is None
                  else kl.to(torch.int32).contiguous())
        kern = lambda: ma.attention_cuda(qg, k, v, **kk)  # noqa: E731
        plain = lambda: ma.attention_plain(qg, k, v, **kk)  # noqa: E731
        got, again, want = kern(), kern(), plain()
        a = attn_oracle(ma, qg, k, v, abs_v=True, **kk)
        ratio, diff, ok = attn_diff(got, want, a,
                                    attn_sigma(qg, k, kk["scale"]))
        check(ok, f"B9 {problem}: |kernel - plain| {diff:.3g}")
        check(torch.equal(got, again), f"B9 {problem}: two calls differ")
        del got, again, want, a
        form = ma.walk(qg.dtype, k.dtype, qg.shape[1] * qg.shape[3],
                       qg.shape[-1], v.shape[-1])[0]
        sync = sync_ms = device = None
        if form in ("wgmma_f32", "decode"):
            sync = probe.variant_call(sync_dll, qg, k, v, kk)
        # in turns: plain, mma.sync, B9, B9, mma.sync, plain
        p1 = median_ms(plain, reps=1, warmup=0)
        s1 = None if sync is None else median_ms(sync, reps=5, warmup=1)
        k1 = median_ms(kern, reps=5, warmup=1)
        k2 = median_ms(kern, reps=5, warmup=1)
        s2 = None if sync is None else median_ms(sync, reps=5, warmup=1)
        p2 = median_ms(plain, reps=1, warmup=0)
        if sync is not None:
            sync_ms = min(s1, s2)
            keys = ("words_kernel", "attn_f32_kernel") \
                if form == "wgmma_f32" else ("attn_decode_kernel",
                                             "merge_kernel")
            # A trace can come back without a kernel's launches (CUPTI
            # lost them): such a trace is taken again, three at most.
            for _ in range(3):
                device = probe.device_ms(kern, keys, calls=B9_TRACED)
                if set(device) == set(keys):
                    break
            check(set(device) == set(keys),
                  f"torch.profiler saw {device} of B9's {form} form in "
                  f"three traces")
            lost = {key: val["launches"] for key, val in device.items()
                    if val["launches"] != B9_TRACED}
            if lost:
                print(f"  b9 {problem}: the trace holds {lost} launches of "
                      f"{B9_TRACED} calls; device ms are over the launches "
                      f"it holds", flush=True)
        # per launch in a run of B9_RUN back to back: the card's time
        # without the host's per-call work between launches
        run_ms = median_ms(lambda: [kern() for _ in range(B9_RUN)], reps=3,
                           warmup=1) / B9_RUN
        u_ms = None
        if not decode:
            plan = autotune.ReductionPlan(method="unfused_mma")
            u_ms = median_ms(lambda: dispatch.execute(
                "attention", qg, plan, k=k, v=v, chunk=1024,
                **{key: kw[key] for key in kw if key != "kv_len"}),
                reps=3, warmup=1)
        nocap = dict(kk, cap=None)
        nocap_ms = median_ms(lambda: ma.attention_cuda(qg, k, v, **nocap),
                             reps=5, warmup=1)
        lib_ms = median_ms(sdpa_call(qg, k, v, kk), reps=5, warmup=1)
        bound_ms, bound_by, nbytes, flops = attn_bound(qg, k, v, kk)
        ms = min(k1, k2)
        kname = B9_COUNTERS[form]
        row = {"name": kname, "problem": problem, "dtype": dkind,
               "ms": ms, "ms_runs": [k1, k2], "ms_back_to_back": run_ms,
               "plain_ms": min(p1, p2),
               "plain_ms_runs": [p1, p2], "unfused_mma_ms": u_ms,
               "nocap_ms": nocap_ms, "library_ms": lib_ms,
               "mma_sync_ms": sync_ms, "device_ms": device,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops, "max_abs_err": diff,
               "share_of_bound": bound_ms / ms,
               "tflops": flops / ms * 1e-9,
               "gbps": nbytes / ms * 1e-6}
        details.append(row)
        print(f"  b9 {problem:22s} ({form}) kernel {ms:.4f} ms "
              f"({run_ms:.4f} back to back; {row['tflops']:.1f} "
              f"TFLOP/s, {row['gbps']:.0f} GB/s) plain {row['plain_ms']:.3f}"
              f" ms unfused_mma {u_ms if u_ms is None else round(u_ms, 4)} "
              f"ms; cap=None: B9 {nocap_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
              f"({nocap_ms / lib_ms:.3f}x); bound {bound_ms:.4f} ms ({bound_by}; "
              f"{100 * row['share_of_bound']:.1f} % of it) |diff| "
              f"{diff:.3g}"
              + ("" if sync_ms is None else
                 f"; the mma.sync form {sync_ms:.4f} ms ({ms / sync_ms:.3f}x "
                 f"of it); device ms by launch {device}"), flush=True)
        if decode:
            # the model's bytes (every slot of the cache, q and o) over
            # time: the decode form's rate at 2 rows a head, or the
            # mma.sync form's (an f32 cache); past 2 rows the decode
            # form's flops (every slot) over time
            B, Sq, KV, G, hd = qg.shape
            io = B * k.shape[1] * KV * (hd + v.shape[-1]) * k.element_size() \
                + B * Sq * KV * G * (hd * qg.element_size()
                                     + v.shape[-1] * v.element_size())
            if form == "decode" and Sq * G > 2:
                fits.setdefault("decode_flops", []).append(
                    2.0 * (hd + v.shape[-1]) * B * Sq * KV * G * k.shape[1]
                    / (ms * 1e3))
            else:
                fits.setdefault("bytes" if form == "decode"
                                else "sync_bytes", []).append(io / (ms * 1e3))
        elif not decode:
            fits.setdefault({"f32": "float32", "bf16": "bfloat16"}[dkind],
                            []).append(flops / (ms * 1e3))
        if problem in ("prefill global bf16", "prefill global f32",
                       "decode global mixed", "decode local f32"):
            entries[kname] = {
                "name": kname, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mma_attention.cu",
                "replaces": "src/repro/kernels/mma_attention.py:64",
                "launches": launches[kname],
                "max_abs_err": max(diff, worst_abs[kname]),
                "ms": ms, "plain_ms": row["plain_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
    byte_keys = ("bytes", "sync_bytes", "decode_flops")
    fit = {key: statistics.fmean(val) for key, val in fits.items()
           if key not in byte_keys}
    fit.update({key: min(fits[key]) for key in byte_keys})
    print(f"phase 5g: fitted _B9_FLOPS_PER_US "
          f"{ {key: round(val / 1e6, 2) for key, val in fit.items() if key not in byte_keys} }"
          f" x 1e6 (flops over time, per case {fits}), "
          f"_B9_BYTES_PER_US {fit['bytes'] / 1e6:.4g} x 1e6 (the model's "
          f"bytes over time, the decode form's slowest case at 2 rows a "
          f"head), _B9_DECODE_FLOPS_PER_US {fit['decode_flops'] / 1e6:.4g} "
          f"x 1e6 (the model's flops over time at 16 rows a head), "
          f"_B9_SYNC_BYTES_PER_US {fit['sync_bytes'] / 1e6:.4g} x 1e6 (the "
          f"mma.sync form over the f32 ring); committed "
          f"{autotune._B9_FLOPS_PER_US}, {autotune._B9_BYTES_PER_US}, "
          f"{autotune._B9_DECODE_FLOPS_PER_US}, "
          f"{autotune._B9_SYNC_BYTES_PER_US}", flush=True)
    return [entries["b9_attention_wgmma"], entries["b9_attention_f32"],
            entries["b9_attention_decode"], entries["b9_attention"]], \
        details, fit


def fit_attn_host(dispatch, autotune, gen) -> dict:
    """µs of host time per attention call, per engine: each at
    ATTN_HOST_SHAPE (causal, softcap, one chunk), the fastest CUDA-event
    median of 50 calls over the rounds of balanced_orders."""
    B, S, KV, G, hd = ATTN_HOST_SHAPE
    fit = {}
    for kind in ("f32", "bf16"):
        dt = ATTN_KINDS[kind][0]
        qg = torch.randn(B, S, KV, G, hd, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, S, KV, hd, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, S, KV, hd, device="cuda", generator=gen).to(dt)
        kw = dict(k=k, v=v, qpos=torch.arange(S, device="cuda"),
                  causal=True, scale=hd ** -0.5, cap=50.0, chunk=1024)
        calls = {m: (lambda p=autotune.ReductionPlan(method=m):
                     dispatch.execute("attention", qg, p, **kw))
                 for m in ATTN_CEILINGS}
        us = dict.fromkeys(ATTN_CEILINGS, math.inf)
        for order in balanced_orders(tuple(ATTN_CEILINGS)):
            for m in order:
                us[m] = min(us[m], 1e3 * median_ms(calls[m], reps=50,
                                                   warmup=5))
        fit[kind] = us
    mean = {m: statistics.fmean(fit[k][m] for k in fit)
            for m in ATTN_CEILINGS}
    print(f"phase 5g: fitted _ATTN_HOST_US (us a call, per kind) "
          + "; ".join(f"{k}: " + ", ".join(f"{m} {v:.1f}" for m, v in
                                          us.items())
                      for k, us in fit.items())
          + f"; means {({m: round(v, 1) for m, v in mean.items()})}; "
          f"committed {autotune._ATTN_HOST_US}", flush=True)
    return fit


# ---------------------------------------- phase 6: the cost model's fit


def sweep_times(autotune, dispatch, gen, dt: torch.dtype) -> dict:
    """{n: {plan: µs}}: every pallas (R, B) candidate, vpu and mma on one
    card input of dtype ``dt`` per size, timed as the autotuner times a
    plan (CUDA events around SWEEP_ITERS back-to-back calls through the
    executor), the median of SWEEP_ROUNDS rounds."""
    out = {}
    for n in SWEEP_SIZES:
        x = torch.randn(n, device="cuda", generator=gen).to(dt)
        plans = [c for c in autotune.candidate_plans(n, dt)
                 if c.method in ("pallas", "vpu", "mma")]
        out[n] = {p: plan_us(dispatch, x, p) for p in plans}
        pallas = sorted((us, p.chain, p.block_rows)
                        for p, us in out[n].items() if p.method == "pallas")
        other = {p.method: us for p, us in out[n].items()
                 if p.method != "pallas"}
        print(f"  {name(dt)} n=2^{n.bit_length() - 1}: vpu "
              f"{other['vpu']:.1f} us, mma {other['mma']:.1f} us, pallas "
              f"(R, B) fastest {pallas[:3]}, slowest {pallas[-1]}",
              flush=True)
        del x
    return out


def plan_us(dispatch, x: torch.Tensor, plan) -> float:
    iters = SWEEP_ITERS[x.numel()]
    for _ in range(2):
        dispatch.execute("reduce_sum", x, plan)
    runs = []
    for _ in range(SWEEP_ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            dispatch.execute("reduce_sum", x, plan)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) * 1e3 / iters)
    return statistics.median(runs)


def model_terms(autotune, plan, n: int, dt: torch.dtype) -> tuple:
    """model_cost = base + _STEP_US * a + _WALK_BLOCK_US * b: the model
    of the reduce engines phase 6 times is linear in its two estimated
    constants, so (base, a, b) come from three evaluations with the
    constants set to 0 and 1."""
    saved = autotune._STEP_US, autotune._WALK_BLOCK_US
    try:
        vals = []
        for step, walk in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0)):
            autotune._STEP_US, autotune._WALK_BLOCK_US = step, walk
            vals.append(autotune.model_cost(plan, n, dt))
    finally:
        autotune._STEP_US, autotune._WALK_BLOCK_US = saved
    return vals[0], vals[1] - vals[0], vals[2] - vals[0]


def fit_constants(autotune, times: dict, dt: torch.dtype) -> dict:
    """Non-negative least squares, in relative terms, of the measured
    times on base + step * a + walk * b + call (``call`` is the host's
    cost per call, the same for every engine, so it moves no pick and
    stays out of the model)."""
    import numpy as np
    rows, target = [], []
    for n, by_plan in times.items():
        for plan, us in by_plan.items():
            base, a, b = model_terms(autotune, plan, n, dt)
            rows.append([a / us, b / us, 1.0 / us])
            target.append(1.0 - base / us)
    a_mat, y = np.asarray(rows), np.asarray(target)
    best = None
    for mask in range(8):
        cols = [i for i in range(3) if mask >> i & 1]
        coef = np.zeros(3)
        if cols:
            sol, *_ = np.linalg.lstsq(a_mat[:, cols], y, rcond=None)
            if np.any(sol < 0):
                continue
            coef[cols] = sol
        res = float(np.sum((a_mat @ coef - y) ** 2))
        if best is None or res < best[0]:
            best = (res, coef)
    res, coef = best
    return {"step_us": float(coef[0]), "walk_block_us": float(coef[1]),
            "call_us": float(coef[2]),
            "rms_rel_residual": math.sqrt(res / len(y))}


def model_picks(autotune, dispatch, times: dict, gen,
                dt: torch.dtype) -> list:
    """At each size the model's pick, with the constants as committed,
    beside the measured best.  Where they differ, both are timed again
    in turns (balanced_orders), each the median of its rounds: the best
    of the sweep is the least of many noisy medians, and a burst of load
    on the shared host during one plan's sweep then lands on both."""
    rows = []
    for n, by_plan in times.items():
        best_plan = min(by_plan, key=by_plan.get)
        pick = autotune.autotune(n, dt, backend="cuda")
        same = (pick.method, pick.chain, pick.block_rows) == (
            best_plan.method, best_plan.chain, best_plan.block_rows)
        if same:
            pick_us = best_us = by_plan[best_plan]
        else:
            x = torch.randn(n, device="cuda", generator=gen).to(dt)
            runs = {0: [], 1: []}
            for order in balanced_orders((0, 1)) * 2:
                for k in order:
                    runs[k].append(plan_us(dispatch, x, (pick, best_plan)[k]))
            pick_us, best_us = (statistics.median(runs[k]) for k in (0, 1))
            del x
        ratio = pick_us / best_us
        rows.append({"dtype": name(dt), "n": n,
                     "model_pick": [pick.method, pick.chain,
                                    pick.block_rows],
                     "model_pick_us": pick_us,
                     "best": [best_plan.method, best_plan.chain,
                              best_plan.block_rows],
                     "best_us": best_us,
                     "best_sweep_us": by_plan[best_plan], "ratio": ratio})
        print(f"  {name(dt)} n=2^{n.bit_length() - 1}: model picks "
              f"{pick.method} (R={pick.chain}, B={pick.block_rows}) "
              f"{pick_us:.1f} us; measured best {best_plan.method} "
              f"(R={best_plan.chain}, B={best_plan.block_rows}) "
              f"{best_us:.1f} us (in the sweep {by_plan[best_plan]:.1f}); "
              f"ratio {ratio:.3f}", flush=True)
    return rows


def check_reduce_picks(autotune, dispatch, gen) -> dict:
    """Phase 6 in every dtype the kernels take: the sweep, the fit of the
    model's constants, and the model's pick, which must run within
    PICK_SLACK of the measured best at every size and dtype."""
    out = {"sweep_us": {}, "fit": {}, "model_picks": []}
    for dt in DTYPES:
        times = sweep_times(autotune, dispatch, gen, dt)
        fit = fit_constants(autotune, times, dt)
        print(f"phase 6: {name(dt)} fitted _STEP_US {fit['step_us']:.6g} "
              f"us, _WALK_BLOCK_US {fit['walk_block_us']:.6g} us, host "
              f"per call {fit['call_us']:.6g} us (rms relative residual "
              f"{fit['rms_rel_residual']:.3g}); committed _STEP_US "
              f"{autotune._STEP_US}, _WALK_BLOCK_US "
              f"{autotune._WALK_BLOCK_US}", flush=True)
        out["model_picks"] += model_picks(autotune, dispatch, times, gen,
                                          dt)
        out["fit"][name(dt)] = fit
        out["sweep_us"][name(dt)] = {
            str(n): [[p.method, p.chain, p.block_rows, us]
                     for p, us in by.items()] for n, by in times.items()}
    for row in out["model_picks"]:
        check(row["ratio"] <= PICK_SLACK,
              f"{row['dtype']} n={row['n']}: the model's pick runs "
              f"{row['ratio']:.2f}x the measured best (> {PICK_SLACK})")
    return out


# ------------------------------------ phase 6b: the scan family's pick


def scan_plans_us(dispatch, x: torch.Tensor, plans: list) -> list:
    """µs a call of each plan costs in a stream of calls through the
    executor: CUDA events around SCAN_ITERS calls, the median over the
    rounds of balanced_orders (the host's time where it exceeds the
    card's).  Each plan follows every other in as many rounds, so a
    burst of load on the shared host, and what the plan timed before
    leaves behind, fall on all of them alike (on one H100, a B6 plan
    timed right after mma_ec ran ~20 us slower at 2^24 bf16 than in B6's
    grid; rounds that only rotated the order kept the last plan after
    mma_ec in all but one)."""
    iters = SCAN_ITERS[x.numel()]
    for plan in plans:
        for _ in range(2):
            dispatch.execute("scan", x, plan)
    runs = [[] for _ in plans]
    for order in balanced_orders(tuple(range(len(plans)))):
        for k in order:
            plan = plans[k]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                dispatch.execute("scan", x, plan)
            end.record()
            end.synchronize()
            runs[k].append(start.elapsed_time(end) * 1e3 / iters)
    return [statistics.median(r) for r in runs]


def plan_knobs(dispatch, plan) -> tuple:
    """A scan plan's engine and the knobs that engine sweeps: two plans
    with the same knobs run the same code."""
    sweep = dispatch.op_spec("scan").engine(plan.method).sweep
    return (plan.method,) + tuple(getattr(plan, k) for k in sweep)


def check_scan_picks(autotune, dispatch, gen) -> dict:
    """cumsum's engines, each at the plan its explicit method runs, and
    the plan ``auto`` resolves to, timed at SCAN_PICK_SIZES in f32 and
    bf16; the auto plan must run within PICK_SLACK of the fastest.  At
    n = 2^12, where the card's work is negligible, the same timings fit
    the model's host time per call (``_SCAN_HOST_US``)."""
    engines = ("vpu", "pallas", "mma_chained", "mma_ec")
    plans = {m: autotune.ReductionPlan(method=m, chain=CHAIN) for m in engines}
    x = torch.randn(SCAN_HOST_N, device="cuda", generator=gen)
    host = dict(zip(plans, scan_plans_us(dispatch, x, list(plans.values()))))
    print(f"phase 6b: fitted _SCAN_HOST_US "
          + ", ".join(f"{m} {us:.1f}" for m, us in host.items())
          + f" us; committed {autotune._SCAN_HOST_US}", flush=True)
    grid = scan_grid(autotune, dispatch, gen)
    rows = []
    for n in SCAN_PICK_SIZES:
        base = torch.randn(n, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x = base if dt == torch.float32 else base.to(dt)
            pick = autotune.get_plan(n, dt, op="scan", backend="cuda")
            same = next((m for m, p in plans.items()
                         if plan_knobs(dispatch, p) == plan_knobs(dispatch,
                                                                  pick)),
                        None)
            timed = list(plans.values()) + ([] if same else [pick])
            us = scan_plans_us(dispatch, x, timed)
            times = dict(zip(plans, us))
            pick_us = times[same] if same else us[-1]
            best = min(times, key=times.get)
            best_us = min(times[best], pick_us)
            ratio = pick_us / best_us
            rows.append({"n": n, "dtype": name(dt), "us": times,
                         "pick": [pick.method, pick.chain, pick.block_rows],
                         "pick_us": pick_us, "best": best,
                         "ratio": ratio})
            print(f"  n=2^{n.bit_length() - 1} {name(dt):8s} "
                  + " ".join(f"{m} {us:.1f}" for m, us in times.items())
                  + f" us; auto picks {pick.method} (R={pick.chain}, "
                  f"B={pick.block_rows}) {pick_us:.1f} us; ratio {ratio:.3f}",
                  flush=True)
            check(ratio <= PICK_SLACK,
                  f"scan n={n} {dt}: the pick runs {ratio:.2f}x the fastest "
                  f"engine (> {PICK_SLACK})")
            del x
        del base
    return {"host_us": host, "picks": rows, "grid": grid}


def scan_grid(autotune, dispatch, gen) -> list:
    """B6's R x B grid timed in bf16 at SCAN_GRID_SIZES, beside each
    plan's count of blocks: the record of whether a grid whose last wave
    of blocks runs part-empty costs time (the model does not price it:
    on one H100 at 2^24, 78 % fill, the R5 plans ran within 4 % of the
    fastest)."""
    rows = []
    for n in SCAN_GRID_SIZES:
        x = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
        plans = list(autotune.candidate_plans(n, torch.bfloat16, op="scan",
                                              engine=("pallas",)))
        us = scan_plans_us(dispatch, x, plans)
        grid = [{"chain": p.chain, "block_rows": p.block_rows,
                 "blocks": math.ceil(n / (p.chain * p.block_rows * p.m)),
                 "us": t} for p, t in zip(plans, us)]
        fastest = min(us)
        rows.append({"n": n, "plans": grid})
        print(f"  B6 grid n=2^{n.bit_length() - 1} bf16 (us / fastest, "
              f"blocks): " + " ".join(
                  f"R{g['chain']}B{g['block_rows']} {g['us'] / fastest:.3f}"
                  f"/{g['blocks']}" for g in grid), flush=True)
        del x
    return rows


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import kernels
    from repro_torch.core import autotune, dispatch, integration, precision
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import mma_compensated as mc
    ms = importlib.import_module("repro_torch.kernels.mma_scan")
    sg = importlib.import_module("repro_torch.kernels.mma_segment")
    mrn = importlib.import_module("repro_torch.kernels.mma_rmsnorm")
    mnm = importlib.import_module("repro_torch.kernels.mma_norm_matmul")
    ma = importlib.import_module("repro_torch.kernels.mma_attention")
    from repro_torch.configs import base, registry
    from repro_torch.models import attention as attn_layer
    from repro_torch.models import layers, param
    # The package exports the functions mma_reduce and mma_scan under
    # the modules' names, so the kernel modules are fetched by their
    # full names.
    mr = importlib.import_module("repro_torch.kernels.mma_reduce")

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    # The mma.sync form as f32 prefill and decode ran it before B9's f32
    # prefill and decode forms (phase 5g's yardstick), built beside the
    # libraries.
    spec = importlib.util.spec_from_file_location(
        "b9_variants", os.path.join(ROOT, "probes", "b9_variants.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    sync_build = probe.start_builds({"mma_sync": probe.MMA_SYNC}, "b9")
    libs = _build.build_all()
    sync_dll = probe.finish_builds(sync_build)[0]["mma_sync"]
    build_s = time.perf_counter() - t0
    print(f"phase 1: built {sorted(libs)} in {build_s:.1f} s", flush=True)
    ptxas = {lib: ptxas_report(path) for lib, path in libs.items()}
    print(f"phase 1: ptxas (registers min-max, spill bytes) {ptxas}",
          flush=True)
    for lib, what in (("mma_scan", "B6"), ("mma_reduce", "B1-B3"),
                      ("mma_segment", "B7"), ("mma_norm_matmul", "B10")):
        check(ptxas[lib]["spill_bytes"] == 0,
              f"{what} spill: {ptxas[lib]}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(mr, ops, gen)
    tier_checks = check_tier_kernels(mc, ops, gen)
    scan_checks = check_scan_kernel(ms, gen)
    seg_checks = check_segment_kernel(sg, gen)
    norm_checks = check_rmsnorm_kernel(mrn, gen)
    nm_checks = check_norm_matmul_kernel(mnm, gen)
    attn_checks = check_attention_kernel(ma, gen)

    print("phase 3: main path at n = 2^28", flush=True)
    mr.reset_launches()
    main_rows = run_main_path(integration, kernels, autotune, gen)
    torch.cuda.synchronize()
    launches = dict(mr.LAUNCHES)
    print(f"phase 3: launches on the main path {launches}", flush=True)
    for kname, count in launches.items():
        check(count > 0, f"kernel {kname} was not launched on the main "
                         f"path")
    other_rows = run_other_ops(integration, gen)

    print("phase 3c: the compensated and double-double tier at n = 2^28",
          flush=True)
    mc.reset_launches()
    tier_rows = run_tier_path(integration, precision, autotune, gen)
    torch.cuda.synchronize()
    tier_launches = dict(mc.LAUNCHES)
    print(f"phase 3c: launches on the tier's path {tier_launches}",
          flush=True)
    for kname, count in tier_launches.items():
        check(count > 0, f"kernel {kname} was not launched on the tier's "
                         f"path")
    print("phase 3e: the scan path at n = 2^28", flush=True)
    ms.reset_launches()
    scan_rows = run_scan_path(integration, autotune, gen)
    torch.cuda.synchronize()
    scan_launches = ms.LAUNCHES["b6_scan"]
    print(f"phase 3e: launches on the scan path {dict(ms.LAUNCHES)}",
          flush=True)
    check(scan_launches > 0, "kernel b6_scan was not launched on the scan "
                             "path")
    print("phase 3f: the segmented-sum path at n = 2^28", flush=True)
    sg.reset_launches()
    seg_rows = run_segment_path(integration, autotune, gen)
    torch.cuda.synchronize()
    seg_launches = sg.LAUNCHES["b7_segment_sum"]
    auto_engines = sorted({r["engine"] for r in seg_rows
                           if r["method"] == "auto"})
    print(f"phase 3f: launches on the segment path {dict(sg.LAUNCHES)}; "
          f"auto resolved to {auto_engines}", flush=True)
    check(seg_launches > 0, "kernel b7_segment_sum was not launched on the "
                            "segment path")
    print("phase 3g: the norm path at full width", flush=True)
    mrn.reset_launches()
    norm_rows, norm_picks = run_norm_path(layers, param, dispatch, autotune,
                                          gen)
    torch.cuda.synchronize()
    norm_launches = mrn.LAUNCHES["b8_rmsnorm"]
    print(f"phase 3g: launches on the norm path {dict(mrn.LAUNCHES)}",
          flush=True)
    check(norm_launches > 0, "kernel b8_rmsnorm was not launched on the "
                             "norm path")
    print("phase 3h: norm_matmul with w given at the configs' MLP widths",
          flush=True)
    problems = nm_problems(registry, base)
    mnm.reset_launches()
    nm_rows, nm_picks = run_norm_matmul_path(layers, param, dispatch,
                                             autotune, problems, gen)
    torch.cuda.synchronize()
    nm_launches = mnm.LAUNCHES["b10_norm_matmul"]
    print(f"phase 3h: launches on the norm_matmul path {dict(mnm.LAUNCHES)}",
          flush=True)
    check(nm_launches > 0, "kernel b10_norm_matmul was not launched on the "
                           "norm_matmul path")
    print("phase 3i: the attention layer at Gemma-2 2B's and GLM-4 9B's "
          "full widths",
          flush=True)
    ma.reset_launches()
    attn_rows, attn_picks, attn_shapes = run_attention_path(
        attn_layer, param, dispatch, registry, base, ma, gen)
    torch.cuda.synchronize()
    attn_launches = dict(ma.LAUNCHES)
    print(f"phase 3i: launches on the attention path {attn_launches}",
          flush=True)
    for kname, count in attn_launches.items():
        check(count > 0, f"kernel {kname} was not launched on the attention "
                         f"path")
    print("phase 3d: the integration example on the card", flush=True)
    integrate_rows = run_integrate_example()

    t0 = time.perf_counter()
    plan = autotune.get_plan(N_TUNE, torch.float32, measure=True,
                             backend="cuda")
    tune_s = time.perf_counter() - t0
    check(plan.source == "measured", f"autotune: {plan}")
    # Recorded beside the measured pick; phase 6 holds the model's pick
    # to the measured times.
    model_plan = autotune.autotune(N_TUNE, torch.float32, backend="cuda")
    print(f"phase 4: measured plan at n = 2^24 f32 in {tune_s:.1f} s: "
          f"{plan}; the cost model picks {model_plan.method} "
          f"(chain {model_plan.chain}, block_rows "
          f"{model_plan.block_rows})", flush=True)

    print("phase 5: kernel timings at n = 2^28", flush=True)
    entries, timing_rows = time_kernels(mr, ops, gen, launches,
                                        checks["worst"])
    print("phase 5b: B4 and B5 timings at n = 2^28", flush=True)
    tier_entries, tier_timing_rows = time_tier_kernels(
        mc, ops, gen, tier_launches, tier_checks["worst_abs"])
    entries += tier_entries
    print("phase 5c: B6 timings at n = 2^28", flush=True)
    scan_entry, scan_timing_rows = time_scan_kernel(
        ms, gen, scan_launches, scan_checks["worst_abs"])
    entries.append(scan_entry)
    print("phase 5d: B7 timings at n = 2^28", flush=True)
    seg_entry, seg_timing_rows, seg_fit = time_segment_kernel(
        sg, autotune, dispatch, gen, seg_launches, seg_checks["worst_abs"])
    entries.append(seg_entry)
    print("phase 5e: B8 timings", flush=True)
    b8_ptxas = ptxas_kernels(libs["mma_rmsnorm"], "rmsnorm_kernel")
    norm_entry, norm_timing_rows = time_rmsnorm_kernel(
        mrn, gen, norm_launches, norm_checks["worst_abs"], b8_ptxas)
    entries.append(norm_entry)
    print("phase 5f: B10 timings at phase 3h's shapes", flush=True)
    nm_entry, nm_timing_rows, nm_fit = time_norm_matmul_kernel(
        mnm, dispatch, autotune, problems, gen, nm_launches,
        nm_checks["worst_abs"])
    entries.append(nm_entry)
    nm_host = fit_nm_host(dispatch, autotune, gen)
    print("phase 5g: B9 timings at phase 3i's shapes", flush=True)
    attn_worst = {kname: max([r[-1] for r in attn_checks["rows"]
                              if r[0] == kname], default=0.0)
                  for kname in attn_launches}
    attn_entries, attn_timing_rows, attn_fit = time_attention_kernel(
        ma, dispatch, autotune, attn_shapes, attn_launches, attn_worst,
        probe, sync_dll)
    del attn_shapes
    entries += attn_entries
    wg_ptxas = ptxas_kernels(libs["mma_attention"], "attn_wgmma_kernel")
    print(f"phase 5g: ptxas (registers, spill store bytes) of the wgmma "
          f"form by value width: "
          f"{ {name.split('ILi')[1].split('E')[0]: val for name, val in wg_ptxas.items()} }",
          flush=True)
    check(all(spill == 0 for _, spill in wg_ptxas.values()),
          f"the wgmma form spills: {wg_ptxas}")
    wf_ptxas = {**ptxas_kernels(libs["mma_attention"], "attn_f32_kernel"),
                **ptxas_kernels(libs["mma_attention"], "words_kernel")}
    shown = {name.split("wf")[1][2:30]: val for name, val in wf_ptxas.items()}
    print(f"phase 5g: ptxas (registers, spill store bytes) of the f32 "
          f"prefill form by value width and cap, and its word pass: "
          f"{shown}", flush=True)
    check(len(wf_ptxas) == 9
          and all(spill == 0 for _, spill in wf_ptxas.values()),
          f"the f32 prefill form spills: {wf_ptxas}")
    dc_ptxas = {**ptxas_kernels(libs["mma_attention"], "attn_decode_kernel"),
                **ptxas_kernels(libs["mma_attention"], "merge_kernel")}
    shown = {name[name.find("attn_decode") if "attn_decode" in name
                  else name.find("merge"):][:40]: val
             for name, val in dc_ptxas.items()}
    print(f"phase 5g: ptxas (registers, spill store bytes) of the decode "
          f"form by rows and value width, and its merge: {shown}",
          flush=True)
    check(len(dc_ptxas) == 7
          and all(spill == 0 for _, spill in dc_ptxas.values()),
          f"the decode form spills: {dc_ptxas}")
    attn_host = fit_attn_host(dispatch, autotune, gen)

    print("phase 3j: the model zoo's forward path", flush=True)
    from repro_torch.models import model_zoo, moe, transformer
    torch.cuda.empty_cache()
    print(f"phase 3j: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held "
          f"by earlier phases", flush=True)
    model_rows = run_model_smoke(registry, model_zoo, gen)
    model_full = [run_model_full(arch, registry, model_zoo, param, moe,
                                 (mrn, mnm, ma), smi)
                  for arch in MODEL_FULL]
    auto_f32 = run_auto_f32_decode(registry, model_zoo, transformer, param,
                                   ma, smi)

    print("phase 6: the cost model against measured times (f32, bf16, "
          "fp16)", flush=True)
    t0 = time.perf_counter()
    reduce_picks = check_reduce_picks(autotune, dispatch, gen)
    sweep_s = time.perf_counter() - t0
    print("phase 6b: the cost model's scan pick against measured times",
          flush=True)
    scan_picks = check_scan_picks(autotune, dispatch, gen)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi,
                   "torch": torch.__version__, "build_s": build_s,
                   "ptxas": ptxas,
                   "kernel_checks": checks["rows"],
                   "main_path": main_rows, "other_ops": other_rows,
                   "exact_counts": checks["counted"],
                   "launches": launches, "tuned_plan": plan.to_dict(),
                   "model_plan": model_plan.to_dict(),
                   "tune_s": tune_s, "timings": timing_rows,
                   "tier_kernel_checks": tier_checks["rows"],
                   "tier_exact_counts": tier_checks["counted"],
                   "tier_path": tier_rows, "tier_launches": tier_launches,
                   "integrate": integrate_rows,
                   "tier_timings": tier_timing_rows,
                   "scan_kernel_checks": scan_checks["rows"],
                   "scan_exact_counts": scan_checks["counted"],
                   "scan_repeats": scan_checks["repeated"],
                   "scan_path": scan_rows, "scan_launches": scan_launches,
                   "scan_timings": scan_timing_rows,
                   "segment_kernel_checks": seg_checks["rows"],
                   "segment_exact_counts": seg_checks["counted"],
                   "segment_path": seg_rows,
                   "segment_launches": seg_launches,
                   "segment_timings": seg_timing_rows,
                   "segment_fit": seg_fit,
                   "norm_kernel_checks": norm_checks["rows"],
                   "norm_path": norm_rows, "norm_picks": norm_picks,
                   "norm_launches": norm_launches,
                   "norm_matmul_kernel_checks": nm_checks["rows"],
                   "norm_matmul_path": nm_rows,
                   "norm_matmul_picks": nm_picks,
                   "norm_matmul_launches": nm_launches,
                   "norm_timings": norm_timing_rows,
                   "b8_ptxas": b8_ptxas,
                   "norm_matmul_timings": nm_timing_rows,
                   "b10_fit": nm_fit, "nm_host_us": nm_host,
                   "attention_kernel_checks": attn_checks["rows"],
                   "attention_path": attn_rows,
                   "attention_picks": attn_picks,
                   "attention_launches": attn_launches,
                   "attention_timings": attn_timing_rows,
                   "b9_fit": attn_fit, "attn_host_us": attn_host,
                   "b9_wgmma_ptxas": wg_ptxas, "b9_f32_ptxas": wf_ptxas,
                   "b9_decode_ptxas": dc_ptxas,
                   "model_smoke": model_rows, "model_full": model_full,
                   "auto_f32_decode": auto_f32,
                   "scan_picks": scan_picks,
                   "sweep_us": reduce_picks["sweep_us"],
                   "fit": reduce_picks["fit"],
                   "model_picks": reduce_picks["model_picks"],
                   "sweep_s": sweep_s,
                   "total_s": time.perf_counter() - t_start}, f, indent=1)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
