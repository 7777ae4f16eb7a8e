"""Kernels B1-B3 of the PyTorch port against the JAX package's Pallas
kernels, on shared numpy inputs.

On the CPU each wrapper of the port runs its kernel's plain PyTorch
version; the reference's kernels run in interpret mode, as its own tests
run them, with m = 16 on both sides.  Both accumulate in f32, in another
order, so sums agree to 2^-16 of sum|x| (per tile for the partials).
The port squares in the input dtype, as the reference's kernel code
says; the reference's kernel in interpret mode skips that rounding of
bf16 / fp16 squares, so there the two agree to the dtype's unit
roundoff of sum(x^2), and the port agrees to 2^-16 with the reference's
own rounded ``x * x``.  ``tests/test_torch_cuda.py`` holds the Hopper
kernels themselves against these plain versions on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# Both packages export the function mma_reduce under the kernel
# module's name, so the modules are fetched by their full names.
jmr = importlib.import_module("repro.kernels.mma_reduce")
tmr = importlib.import_module("repro_torch.kernels.mma_reduce")

M = 16
RTOL = 2.0 ** -16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
UNIT_ROUNDOFF = {"float32": 0.0, "bfloat16": 2.0 ** -8,
                 "float16": 2.0 ** -11}


def _pair(x32: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x32).astype(jdt), torch.from_numpy(x32.copy()).to(tdt)


def _abs_sum(t: torch.Tensor, square: bool = False) -> float:
    t = t * t if square else t
    return float(torch.sum(t.abs(), dtype=torch.float64))


def _close(got, want, scale: float, rtol: float = RTOL):
    assert abs(float(got) - float(want)) <= rtol * scale + 1e-30, \
        (float(got), float(want), scale)


def _close_squares(got, xj, want_interpret, scale: float, dtype: str):
    """A sum of squares against the reference: its rounded ``x * x`` to
    2^-16, its interpret-mode kernel to the dtype's unit roundoff."""
    _close(got, jnp.sum((xj * xj).astype(jnp.float32)), scale)
    _close(got, want_interpret, scale, RTOL + UNIT_ROUNDOFF[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("chain,block_rows", [(1, 32), (4, 128)])
def test_b1_plain_matches_pallas(dtype, square, chain, block_rows):
    tile = chain * block_rows
    x = np.random.default_rng(chain).normal(size=3 * tile * M)
    xj, xt = _pair(x.astype(np.float32), dtype)
    got = tmr.single_pass_plain(xt.reshape(-1, M), chain=chain,
                                block_rows=block_rows, square=square)
    want = jmr.single_pass_call(xj.reshape(-1, M), chain=chain,
                                block_rows=block_rows, interpret=True,
                                square=square)[0, 0]
    assert got.dtype == torch.float32 and got.dim() == 0
    if square:
        _close_squares(got, xj, want, _abs_sum(xt, True), dtype)
    else:
        _close(got, want, _abs_sum(xt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain,block_rows", [(1, 32), (5, 32)])
def test_b2_plain_matches_pallas_partial_by_partial(dtype, chain,
                                                    block_rows):
    tile = chain * block_rows
    x = np.random.default_rng(7).uniform(size=6 * tile * M)
    xj, xt = _pair(x.astype(np.float32), dtype)
    got = tmr.partials_plain(xt.reshape(-1, M), chain=chain,
                             block_rows=block_rows)
    want = np.asarray(jmr.partials_call(xj.reshape(-1, M), chain=chain,
                                        block_rows=block_rows,
                                        interpret=True))[:, 0]
    assert got.shape == want.shape == (6,)
    tiles = xt.reshape(6, -1)
    for g in range(6):
        _close(got[g], want[g], _abs_sum(tiles[g]))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("mma_fraction", [0.0, 0.25, 0.5, 1.0])
def test_b3_plain_matches_pallas(dtype, mma_fraction):
    # At these fractions of 128 rows the port's 16-row rounding and the
    # reference's 8-row rounding give the same MMA share.
    block_rows = 128
    x = np.random.default_rng(3).normal(size=4 * block_rows * M)
    xj, xt = _pair(x.astype(np.float32), dtype)
    mma_rows = tmr.mma_rows_for(block_rows, mma_fraction)
    assert mma_rows == int(mma_fraction * block_rows)
    got = tmr.split_plain(xt.reshape(-1, M), block_rows=block_rows,
                          mma_rows=mma_rows)
    want = jmr.split_call(xj.reshape(-1, M), block_rows=block_rows,
                          mma_fraction=mma_fraction, interpret=True)[0, 0]
    _close(got, want, _abs_sum(xt))


def test_b3_rounds_the_mma_share_to_whole_links():
    for block_rows in (16, 32, 128, 512):
        for frac in np.linspace(0.0, 1.0, 11):
            rows = tmr.mma_rows_for(block_rows, float(frac))
            assert rows % M == 0 and 0 <= rows <= block_rows
            assert abs(rows - frac * block_rows) <= M / 2


@pytest.mark.parametrize("variant", ["single_pass", "recurrence", "split"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 4_097, 70_001])
def test_mma_reduce_matches_reference(variant, dtype, n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    xj, xt = _pair(x, dtype)
    kw = dict(variant=variant, chain=2, block_rows=32, m=M)
    got = tops.mma_reduce(xt, **kw)
    want = jops.mma_reduce(xj, interpret=True, **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want, _abs_sum(xt))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mma_squared_sum_matches_reference(dtype):
    x = np.random.default_rng(11).normal(size=20_011).astype(np.float32)
    xj, xt = _pair(x, dtype)
    got = tops.mma_squared_sum(xt, chain=4, block_rows=32, m=M)
    want = jops.mma_squared_sum(xj, chain=4, block_rows=32, m=M,
                                interpret=True)
    _close_squares(got, xj, want, _abs_sum(xt, square=True), dtype)


@pytest.mark.parametrize("shape", [(37,), (128, 128), (3, 5, 7, 11)])
def test_mma_reduce_partials_match_reference(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    xj, xt = _pair(x, "float32")
    got = tops.mma_reduce_partials(xt, chain=2, block_rows=32, m=M)
    want = np.asarray(jops.mma_reduce_partials(
        xj, chain=2, block_rows=32, m=M, interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=RTOL * _abs_sum(xt), rtol=0)


def test_ref_oracles_match_reference():
    x = np.random.default_rng(5).normal(size=(64, M)).astype(np.float32)
    xj, xt = _pair(x, "bfloat16")
    _close(tref.reduce_ref(xt), jref.reduce_ref(xj), _abs_sum(xt))
    _close(tref.squared_sum_ref(xt), jref.squared_sum_ref(xj),
           _abs_sum(xt, True))
    got = tref.partials_ref(xt, chain=2, block_rows=8)
    want = np.asarray(jref.partials_ref(xj, chain=2, block_rows=8))
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        tops.mma_reduce(torch.ones(10), variant="tree")


def test_cpu_runs_do_not_count_launches():
    tmr.reset_launches()
    x = torch.ones(5000)
    for variant in ("single_pass", "recurrence", "split"):
        assert float(tops.mma_reduce(x, variant=variant)) == 5000.0
    assert float(tops.mma_squared_sum(2 * x)) == 20000.0
    assert tmr.LAUNCHES == {"b1_single_pass": 0, "b2_partials": 0,
                            "b3_split": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.ones(4096)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmr.single_pass_cuda(x, chain=1, block_rows=32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmr.partials_cuda(x, chain=1, block_rows=32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmr.split_cuda(x, block_rows=32, mma_rows=16)


def test_block_rows_the_kernels_take():
    assert [b for b in range(1, 1025) if tmr.block_rows_ok(b)] \
        == list(range(16, 513, 16))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    src = _build.CSRC / "mma_reduce.cu"
    assert src.exists()
    assert _build.library_path(src).parent == _build.BUILD_DIR
