"""The segmented-sum slice of the PyTorch port against the JAX package, on
shared numpy inputs: ``core.scan.tc_segment_reduce`` and
``tc_linear_recurrence``, kernel B7's plain version behind
``kernels.ops.mma_segment_sum``, the dispatch op ``segment_sum`` with
every engine and alias, and the hook ``integration.segment_sum``.

Tolerances, each stated where it is used:

* segment sums: |port - reference| <= 2^-20 of the segment's sum|x|.
  Both packages sum the same f32 values (every one-hot product is
  exact, 16-bit values widen exactly, and three bf16 words rebuild an
  f32 value exactly in B7's plain version); only the order of the f32
  adds differs, a few roundings of 2^-24 each.  A segment no id hits
  must be exactly 0 in both.
* ``tc_linear_recurrence``: 1e-5 relative plus 1e-6 absolute (exp of
  f32 log-space scans, as the scan slice holds ``tc_cumprod``).

The reference's Pallas kernel runs in interpret mode, as the reference's
own tests run it on the CPU; ``tests/test_torch_cuda.py`` holds the
Hopper kernel itself against its plain version on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jd
from repro.core import integration as ji
from repro.core import scan as js
from repro.kernels import ops as jops
from repro_torch import core as tcore
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as td
from repro_torch.core import integration as ti
from repro_torch.core import scan as ts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

tsg = importlib.import_module("repro_torch.kernels.mma_segment")

RTOL = 2.0 ** -20
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _values(x: np.ndarray, dtype: str = "float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x.copy()).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _assert_segments_close(got, want, tx, ids: np.ndarray, s: int):
    """|got - want| <= RTOL of each segment's sum|x| (of the values as
    the port holds them); a segment no id hits is exactly 0 in both."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape == (s,)
    x = tx.to(torch.float64).reshape(-1).numpy()
    keep = (ids >= 0) & (ids < s)
    scale = np.zeros(s)
    np.add.at(scale, ids[keep], np.abs(x[keep]))
    assert np.all(np.abs(got - want) <= RTOL * scale), \
        np.max(np.abs(got - want) - RTOL * scale)


def _case(name: str, rng):
    """(values, ids, S, dtype) for one tc_segment_reduce case."""
    n, s, dtype = 2_000, 37, "float32"
    x = rng.normal(size=n).astype(np.float32)
    ids = rng.integers(0, s, n)
    if name == "sorted":
        ids = np.sort(ids)
    elif name == "empty_segment":
        ids = np.where(ids == 5, 6, ids)
    elif name == "n0":
        x, ids = x[:0], ids[:0]
    elif name == "s0":
        s, ids = 0, ids * 0 - 1
    elif name == "int_values":
        x = rng.integers(-50, 50, n).astype(np.int32)
    elif name in ("bfloat16", "float16"):
        dtype = name
    elif name == "stray_ids":
        stray = rng.random(n) < 0.1
        ids = np.where(stray, rng.choice([-1, s, s + 7, 1 << 20], n), ids)
    return x, ids.astype(np.int32), s, dtype


SEGMENT_CASES = ("unsorted", "sorted", "empty_segment", "n0", "s0",
                 "int_values", "bfloat16", "float16", "stray_ids",
                 "blocked")


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_tc_segment_reduce_matches_reference(case, monkeypatch):
    rng = np.random.default_rng(SEGMENT_CASES.index(case))
    x, ids, s, dtype = _case(case, rng)
    if case == "blocked":
        # Mask blocks of 64 elements: the port's loop runs 32 steps.
        monkeypatch.setattr(ts, "_MASK_BUDGET", 4 * s * 64)
    if x.dtype == np.int32:
        jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    else:
        jx, tx = _values(x, dtype)
    want = js.tc_segment_reduce(jx, jnp.asarray(ids), s)
    got = ts.tc_segment_reduce(tx, torch.from_numpy(ids), s)
    assert got.dtype == torch.float32
    _assert_segments_close(got, want, tx, ids, s)
    if case == "empty_segment":
        assert float(got[5]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mma_segment_sum_matches_reference_kernel(dtype):
    # The reference test's problem (tests/test_scan.py): 3777 elements,
    # 19 segments, block_rows 8 there; the Hopper kernel takes rows in
    # whole 16-row warps, so the port runs its smallest, 16.
    rng = np.random.default_rng(12)
    x = rng.normal(size=3777).astype(np.float32)
    ids = rng.integers(0, 19, size=3777).astype(np.int32)
    jx, tx = _values(x, dtype)
    want = jops.mma_segment_sum(jx, jnp.asarray(ids), 19, block_rows=8,
                                interpret=True)
    got = tops.mma_segment_sum(tx, torch.from_numpy(ids), 19, block_rows=16)
    _assert_segments_close(got, want, tx, ids, 19)
    with pytest.raises(ValueError, match="block_rows"):
        tops.mma_segment_sum(tx, torch.from_numpy(ids), 19, block_rows=8)


def test_mma_segment_sum_many_segments():
    # The reference's VMEM clamp case: S = 4096 at 2000 elements; here
    # the default block_rows stays and the card would run one pass (16
    # at block_rows 512, whose 32 warps' rings leave room for 256).
    rng = np.random.default_rng(19)
    x = rng.normal(size=2_000).astype(np.float32)
    ids = rng.integers(0, 4096, size=2_000)
    jx, tx = _values(x)
    want = jops.mma_segment_sum(jx, jnp.asarray(ids.astype(np.int32)), 4096,
                                interpret=True)
    got = tops.mma_segment_sum(tx, torch.from_numpy(ids), 4096)
    _assert_segments_close(got, want, tx, ids, 4096)
    assert tsg.passes(4096, torch.float32, 128) == 1
    assert tsg.passes(4096, torch.float32, 512) == 16
    # 8 warps x (2 stages x 2 KB + 2 KB of operands) + mbarriers beside
    # 44 blocks of 128 f32 sums a warp; bf16 stages are 1.5 KB and its
    # operands 1 KB; at most 64 blocks a pass.
    assert tsg.ring_bytes(torch.float32, 128) == 49280
    assert tsg.pass_segments(torch.float32, 128) == 5632
    assert tsg.pass_segments(torch.bfloat16, 128) == 6144
    assert tsg.pass_segments(torch.float32, 512) == 256
    assert tsg.pass_segments(torch.float32, 16) == 8192


# Segment counts around B7's 128-segment blocks: one block, a block's
# edges, the switch from register sums (one or two blocks) to shared
# memory (three or more), and a count past a pass at 32 warps.
BLOCK_EDGE_COUNTS = (1, 16, 127, 128, 129, 256, 4096)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", BLOCK_EDGE_COUNTS)
def test_segment_plain_across_blocks_matches_reference(s, dtype):
    # Stray ids (-1, S, 2^30) and a ragged tail (n is no multiple of a
    # group or a step); a geometry of 3 blocks of 2 warps, so several
    # warps take several steps each.
    rng = np.random.default_rng(s)
    n = 3_001
    x = rng.normal(size=n).astype(np.float32)
    ids = rng.integers(0, s, n)
    stray = rng.random(n) < 0.1
    ids = np.where(stray, rng.choice([-1, s, 1 << 30], n), ids).astype(
        np.int32)
    jx, tx = _values(x, dtype)
    got = tsg.segment_plain(tx, torch.from_numpy(ids), s, block_rows=32,
                            blocks=3)
    assert got.dtype == torch.float32 and got.shape == (s,)
    want = jops.mma_segment_sum(jx, jnp.asarray(ids), s, interpret=True)
    _assert_segments_close(got, want, tx, ids, s)
    _assert_segments_close(got, tref.segment_sum_ref(tx, torch.from_numpy(
        ids), s), tx, ids, s)


@pytest.mark.parametrize("block_rows,blocks", [(16, 1), (32, 3), (128, 2),
                                               (512, 264)])
@pytest.mark.parametrize("s", [1, 129, 4096])
def test_segment_plain_counts_exactly_at_every_geometry(s, block_rows,
                                                         blocks):
    # Counting data (0 and 1; every order of adds is exact) in all three
    # dtypes, with stray ids and a ragged tail: the plain version equals
    # the exact count whatever the geometry.
    rng = np.random.default_rng(s + block_rows)
    n = 10_007
    ids = rng.integers(-1, s + 1, n).astype(np.int32)
    ids[::97] = 1 << 30
    keep = (ids >= 0) & (ids < s)
    ones = rng.random(n) < 0.5
    count = np.bincount(ids[keep], weights=ones[keep], minlength=s)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        got = tsg.segment_plain(torch.from_numpy(ones).to(dt),
                                torch.from_numpy(ids), s,
                                block_rows=block_rows, blocks=blocks)
        assert np.array_equal(got.double().numpy(), count), dt


@pytest.mark.parametrize("block_rows,blocks", [(16, 1), (128, 3),
                                               (512, 528)])
def test_segment_plain_geometries_and_counts(block_rows, blocks):
    rng = np.random.default_rng(block_rows)
    n, s = 20_013, 19
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-2, s + 2, n).astype(np.int32))
    got = tsg.segment_plain(x, ids, s, block_rows=block_rows, blocks=blocks)
    want = tref.segment_sum_ref(x, ids, s)
    _assert_segments_close(got, want, x, ids.numpy(), s)
    # Counting data: every order of adds is exact.
    ones = (torch.from_numpy(rng.random(n)) < 0.5).to(torch.bfloat16)
    got = tsg.segment_plain(ones, ids, s, block_rows=block_rows,
                            blocks=blocks)
    keep = (ids >= 0) & (ids < s)
    count = torch.bincount(ids[keep].long(), weights=ones[keep].double(),
                           minlength=s)
    assert torch.equal(got.double(), count)


SEGMENT_METHODS = ("mma", "mma_chained", "pallas", "vpu", "auto")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", SEGMENT_METHODS)
def test_every_segment_engine_matches_reference(method, dtype,
                                                fresh_registries):
    rng = np.random.default_rng(14)
    n, s = 5_000, 37
    x = rng.normal(size=n).astype(np.float32)
    ids = rng.integers(-1, s + 1, n).astype(np.int32)
    jx, tx = _values(x, dtype)
    spec = td.op_spec("segment_sum")
    kw = {"segment_ids": torch.from_numpy(ids), "num_segments": s}
    got = td.dispatch("segment_sum", tx, method=method, **kw)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _assert_segments_close(got, spec.reference(tx, **kw), tx, ids, s)
    if method != "auto":
        want = jd.dispatch("segment_sum", jx, method=method,
                           segment_ids=jnp.asarray(ids), num_segments=s)
        _assert_segments_close(got, want, tx, ids, s)


def test_segment_sum_hook_and_its_plans(fresh_registries):
    rng = np.random.default_rng(7)
    n, s = 3_001, 23
    x = rng.random(n).astype(np.float32)
    ids = rng.integers(-1, s, n)
    tx = torch.from_numpy(x)
    for method in ("mma", "pallas", "vpu", "auto"):
        got = ti.segment_sum(tx, ids, s, method=method)
        want = ji.segment_sum(jnp.asarray(x), jnp.asarray(ids), s,
                              method=method)
        _assert_segments_close(got, want, tx, ids, s)
    # The ids follow the values' device; any integer dtype is taken.
    got = ti.segment_sum(tx, torch.from_numpy(ids.astype(np.int16)), s)
    _assert_segments_close(got, ref_sum(x, ids, s), tx, ids, s)
    assert [k for k, _ in tat.default_registry().items()] \
        == ["segment_sum|4096|float32|cpu"]
    plan = tat.get_plan(n, torch.float32, op="segment_sum", backend="cpu")
    got = tat.execute_plan(tx, plan, op="segment_sum",
                           segment_ids=torch.from_numpy(ids),
                           num_segments=s)
    _assert_segments_close(got, ref_sum(x, ids, s), tx, ids, s)
    assert ti.segment_sum(torch.ones(5), torch.tensor([0, 2, 2, -1, 9]),
                          3).tolist() == [1.0, 0.0, 2.0]


def ref_sum(x: np.ndarray, ids: np.ndarray, s: int) -> np.ndarray:
    keep = (ids >= 0) & (ids < s)
    out = np.zeros(s)
    np.add.at(out, ids[keep], x[keep].astype(np.float64))
    return out


def test_segment_cost_model_and_candidates():
    # B7 sweeps block_rows alone, at chain 1, as the reference's kernel.
    plans = [p for p in tat.candidate_plans(1 << 20, torch.float32,
                                            op="segment_sum")]
    assert [(p.method, p.chain, p.block_rows) for p in plans] == [
        ("mma", 1, 128), ("pallas", 1, 32), ("pallas", 1, 128),
        ("pallas", 1, 512), ("vpu", 1, 128)]
    # mma is charged its one-hot mask, vpu its atomics, B7 its bytes
    # once a pass and a term per group and 128-segment block: at the
    # measured problem's size the model picks the kernel.
    n = 1 << 28
    cost = {p.method: tat.model_cost(p, n, torch.float32,
                                     op="segment_sum") for p in plans}
    assert min(cost, key=cost.get) == "pallas"
    assert cost["mma"] > cost["vpu"] > cost["pallas"]
    b7 = plans[2]
    assert (b7.method, b7.block_rows) == ("pallas", 128)
    b7_cost = tat.model_cost(b7, n, torch.float32, op="segment_sum")
    assert b7_cost == pytest.approx(
        8.0 * n / tat._HBM_BYTES_PER_US + tat._B7_GROUP_US * n / 16
        + tat._grid(b7, n))
    # A 16-bit input moves 6 bytes an element, not 8.
    assert tat.model_cost(b7, n, torch.bfloat16, op="segment_sum") \
        == pytest.approx(b7_cost - 2.0 * n / tat._HBM_BYTES_PER_US)
    x, kw = tat._measure_problem("segment_sum", 4096, torch.float32, 0,
                                 "cpu")
    assert kw["num_segments"] == tat._MEASURE_SEGMENTS == 128
    assert kw["segment_ids"].shape == x.shape


@pytest.mark.parametrize("chunk", [16, 8])
def test_tc_linear_recurrence_matches_reference(chunk):
    rng = np.random.default_rng(chunk)
    bsz, s, w = 2, 37, 5
    log_a = -rng.random((bsz, s, w)).astype(np.float32) * 0.5
    b = rng.normal(size=(bsz, s, w)).astype(np.float32)
    h0 = rng.normal(size=(bsz, w)).astype(np.float32)
    jh, jfin = js.tc_linear_recurrence(jnp.asarray(log_a), jnp.asarray(b),
                                       jnp.asarray(h0), chunk=chunk)
    th, tfin = ts.tc_linear_recurrence(torch.from_numpy(log_a),
                                       torch.from_numpy(b),
                                       torch.from_numpy(h0), chunk=chunk)
    assert th.shape == (bsz, s, w) and tfin.shape == (bsz, w)
    assert th.dtype == tfin.dtype == torch.float32
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tfin), _np(jfin), rtol=1e-5, atol=1e-6)
    # Against the recurrence itself, in f64.
    h = h0.astype(np.float64)
    a = np.exp(np.maximum(log_a.astype(np.float64), -1.0e4))
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(_np(th)[:, t], h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tfin), h, rtol=1e-5, atol=1e-5)
    # A zero decay (log a = -inf) floors at a finite log, never NaN, and
    # resets the state to that step's input in both packages.  (After
    # it the chunk's log-space differences cancel near -1e4, where f32
    # keeps about 1e-3 absolute: the two packages then differ in that
    # rounding, not in the algorithm.)
    log_a[0, 3, 1] = -np.inf
    jh, _ = js.tc_linear_recurrence(jnp.asarray(log_a), jnp.asarray(b),
                                    jnp.asarray(h0), chunk=chunk)
    th, _ = ts.tc_linear_recurrence(torch.from_numpy(log_a),
                                    torch.from_numpy(b),
                                    torch.from_numpy(h0), chunk=chunk)
    assert bool(torch.all(torch.isfinite(th)))
    assert float(th[0, 3, 1]) == float(jh[0, 3, 1]) == float(b[0, 3, 1])


def test_core_exports_the_segment_slice():
    for name in ("tc_segment_reduce", "tc_linear_recurrence",
                 "segment_sum"):
        assert callable(getattr(tcore, name)), name
