"""The port's plain chained-MMA core (``repro_torch.core.reduction``)
against the JAX package's ``repro.core.reduction``, on shared numpy
inputs, with the paper's m = 16 on both sides.

Both sides contract in f32 (the port casts 16-bit operands to f32 on the
CPU, where products of 16-bit values are exact), in another order: each
result agrees to 2^-16 of the sum of the magnitudes it adds up.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reduction as jr
from repro_torch.core import autotune as tat
from repro_torch.core import reduction as tr

M = 16
RTOL = 2.0 ** -16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _pair(x32: np.ndarray, dtype: str = "float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x32).astype(jdt), torch.from_numpy(x32.copy()).to(tdt)


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).numpy()


def _agree(got, want, abs_scale):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= RTOL * np.asarray(abs_scale)
                  + 1e-30), (got, want)


@pytest.fixture()
def fresh_port_registry():
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def test_default_tile_is_the_papers_16():
    assert tr.DEFAULT_M == 16


@pytest.mark.parametrize("variant", ["single_pass", "recurrence", "split"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5_000, 70_001])
@pytest.mark.parametrize("chain", [1, 4])
def test_tc_reduce_matches_reference(variant, dtype, n, chain):
    x = np.random.default_rng(n + chain).normal(size=n).astype(np.float32)
    xj, xt = _pair(x, dtype)
    got = tr.tc_reduce(xt, variant=variant, chain=chain)
    want = jr.tc_reduce(xj, variant=variant, chain=chain, m=M)
    assert got.dtype == torch.float32 and got.dim() == 0
    _agree(got, want, np.abs(_f64(xt)).sum())


@pytest.mark.parametrize("mma_fraction", [0.0, 0.3, 1.0])
def test_tc_reduce_split_fraction(mma_fraction):
    x = np.random.default_rng(1).uniform(size=9_999).astype(np.float32)
    xj, xt = _pair(x)
    got = tr.tc_reduce(xt, variant="split", mma_fraction=mma_fraction)
    want = jr.tc_reduce(xj, variant="split", m=M, mma_fraction=mma_fraction)
    _agree(got, want, np.abs(x).sum())


def test_fp16_partials_overflow_at_the_same_n():
    """``keep_f32_partials=False`` casts each recurrence level's partials
    back to fp16, which overflows once a level's partials pass 65504 and
    another level follows: the paper's fp16 failure, at the same n in
    both packages.  f32 partials stay finite."""
    pattern = []
    for n in (4_096, 65_536, 65_537, 131_072):
        x = np.random.default_rng(n).uniform(0.0, 64.0, n).astype(np.float32)
        xj, xt = _pair(x, "float16")
        kw = dict(variant="recurrence", chain=1)
        got = tr.tc_reduce(xt, keep_f32_partials=False, **kw)
        want = jr.tc_reduce(xj, keep_f32_partials=False, m=M, **kw)
        assert bool(torch.isinf(got)) == bool(np.isinf(want))
        pattern.append(bool(torch.isinf(got)))
        if not pattern[-1]:
            _agree(got, want, np.abs(_f64(xt)).sum())
        kept = tr.tc_reduce(xt, keep_f32_partials=True, **kw)
        _agree(kept, jr.tc_reduce(xj, m=M, **kw), np.abs(_f64(xt)).sum())
    assert pattern == [False, False, True, True]


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        tr.tc_reduce(torch.ones(8), variant="tree")


def test_chain_auto_resolves_from_the_plan_registry(fresh_port_registry):
    x = torch.ones(3_000)
    assert float(tr.tc_reduce(x, chain="auto")) == 3000.0
    keys = [k for k, _ in tat.default_registry().items()]
    assert keys == ["reduce_sum|4096|float32|cpu|mma_chained"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", ["ones", "mask", "self"])
def test_tc_contract_matches_reference(dtype, b):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 50)).astype(np.float32)
    other = {"ones": np.ones_like(a), "self": a,
             "mask": (rng.random(a.shape) > 0.5).astype(np.float32)}[b]
    aj, at = _pair(a, dtype)
    bj, bt = _pair(other, dtype)
    got = tr.tc_contract(at, bt)
    assert got.dtype == torch.float32 and got.dim() == 0
    _agree(got, jr.tc_contract(aj, bj), np.abs(_f64(at) * _f64(bt)).sum())


@pytest.mark.parametrize("axes", [(0,), (2,), (1, 2), (0, 2), (0, 1, 2)])
@pytest.mark.parametrize("squared", [False, True])
def test_tc_reduce_axes_matches_reference(axes, squared):
    x = np.random.default_rng(3).normal(size=(3, 5, 17)).astype(np.float32)
    xj, xt = _pair(x)
    got = tr.tc_reduce_axes(xt, axes, b=xt if squared else None)
    want = jr.tc_reduce_axes(xj, axes, b=xj if squared else None)
    mags = np.abs(x.astype(np.float64) * (x if squared else 1.0))
    _agree(got, want, mags.sum(axis=axes))


@pytest.mark.parametrize("d", [64, 2304])
def test_tc_reduce_lastdim_row_bits_do_not_depend_on_the_rows(d):
    """A row's sum has the bits of that row alone at 1 to 64 rows (a
    decode step against one request at a time): the rows go to the
    library padded to one shape.  Unpadded, the CPU's f32 products of 1
    and 2 rows against a ones column disagreed in most random rows
    (``probes/row_count.py``), and with them the continuous-batching
    engine's norms."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32))
    x = x.to(torch.bfloat16).to(torch.float32) ** 2
    for rows in (1, 2, 4, 17, 64):
        got = tr.tc_reduce_lastdim(x[:rows])
        for r in range(rows):
            assert torch.equal(got[r], tr.tc_reduce_lastdim(x[r:r + 1])[0]), \
                (rows, r)


def test_tc_reduce_lastdim_and_rows_match_reference():
    x = np.random.default_rng(4).normal(size=(4, 6, 33)).astype(np.float32)
    xj, xt = _pair(x, "bfloat16")
    mags = np.abs(_f64(xt))
    _agree(tr.tc_reduce_lastdim(xt), jr.tc_reduce_lastdim(xj),
           mags.sum(axis=-1))
    x2j, x2t = xj.reshape(24, 33), xt.reshape(24, 33)
    got = tr.tc_reduce_rows(x2t)
    assert got.shape == (24,) and got.dtype == torch.float32
    _agree(got, jr.tc_reduce_rows(x2j, m=M), mags.reshape(24, 33).sum(1))
