"""The port on the card: kernels B1-B3 against their plain PyTorch
versions, the wrappers' checks and launch counters, and the entry
points' device rule.  Every test here needs an NVIDIA card (and nvcc to
build the kernels) and skips without one; this file imports nothing of
JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel and plain version both accumulate in f32, in another order (B1
and B3 with float atomics), so they agree to 2^-16 of sum|x| (per tile
for B2's partials).  That bound cannot see a few elements go missing,
so the kernels are also run on counting inputs (0 and 1, partial sums
integers below 2^24), where every order of adds is exact and kernel,
plain version and count must be equal.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import integration
from repro_torch.kernels import ops

mr = importlib.import_module("repro_torch.kernels.mma_reduce")

M = 16
RTOL = 2.0 ** -16
pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")


def _abs_sum(t: torch.Tensor, square: bool = False) -> float:
    t = t * t if square else t
    return float(torch.sum(t.abs(), dtype=torch.float64))


def _close(got, want, scale: float):
    assert abs(float(got) - float(want)) <= RTOL * scale + 1e-30, \
        (float(got), float(want), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 13])
def test_kernels_match_plain_on_card(cuda, dtype, n):
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n, device="cuda", generator=gen).to(dtype)
    for chain, block_rows in ((1, 32), (4, 128), (5, 512)):
        x2d = ops._to_tiles(x, chain * block_rows, M)
        for square in (False, True):
            _close(mr.single_pass_cuda(x, chain=chain,
                                       block_rows=block_rows,
                                       square=square),
                   mr.single_pass_plain(x2d, chain=chain,
                                        block_rows=block_rows,
                                        square=square),
                   _abs_sum(x, square))
        got = mr.partials_cuda(x, chain=chain, block_rows=block_rows)
        want = mr.partials_plain(x2d, chain=chain, block_rows=block_rows)
        scale = torch.sum(x2d.reshape(want.shape[0], -1).abs(), dim=1,
                          dtype=torch.float64)
        assert got.shape == want.shape
        assert bool(torch.all((got.double() - want.double()).abs()
                              <= RTOL * scale))
        mma_rows = mr.mma_rows_for(block_rows, 0.5)
        _close(mr.split_cuda(x, block_rows=block_rows, mma_rows=mma_rows),
               mr.split_plain(ops._to_tiles(x, block_rows, M),
                              block_rows=block_rows, mma_rows=mma_rows),
               _abs_sum(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("chain,block_rows", [(1, 32), (4, 128), (5, 512)])
def test_kernels_count_exactly_with_a_ragged_tail(cuda, dtype, chain,
                                                  block_rows):
    tile = chain * block_rows * M
    gen = torch.Generator(device="cuda").manual_seed(tile)
    for n in (13, tile + 13, (1 << 16) + 13):
        # 0/1 values, the last 13 all 1, and ones past n that a kernel
        # reading beyond its input would count.
        buf = torch.ones(n + 64, device="cuda", dtype=dtype)
        buf[:n] = (torch.rand(n, device="cuda", generator=gen)
                   < 0.25).to(dtype)
        buf[n - 13:n] = 1
        x = buf[:n]
        count = float(torch.sum(x, dtype=torch.float64))
        x2d = ops._to_tiles(x, chain * block_rows, M)
        for square in (False, True):
            got = mr.single_pass_cuda(x, chain=chain, block_rows=block_rows,
                                      square=square)
            assert float(got) == count, (n, square)
            assert float(mr.single_pass_plain(
                x2d, chain=chain, block_rows=block_rows,
                square=square)) == count
        got = mr.partials_cuda(x, chain=chain, block_rows=block_rows)
        want = torch.sum(x2d.reshape(got.shape[0], -1), dim=1,
                         dtype=torch.float64)
        assert torch.equal(got.double(), want), n
        for frac in (0.0, 0.5, 1.0):
            mma_rows = mr.mma_rows_for(block_rows, frac)
            assert float(mr.split_cuda(x, block_rows=block_rows,
                                       mma_rows=mma_rows)) == count, \
                (n, mma_rows)


def test_wrappers_count_launches_and_check_geometry(cuda):
    x = torch.ones(1 << 20, device="cuda")
    mr.reset_launches()
    assert float(ops.mma_reduce(x, variant="recurrence", chain=1,
                                block_rows=32)) == float(1 << 20)
    assert mr.LAUNCHES == {"b1_single_pass": 1, "b2_partials": 2,
                           "b3_split": 0}
    with pytest.raises(ValueError, match="block_rows"):
        mr.single_pass_cuda(x, chain=1, block_rows=24)
    with pytest.raises(ValueError, match="mma_rows"):
        mr.split_cuda(x, block_rows=32, mma_rows=8)
    with pytest.raises(ValueError, match="dtype"):
        mr.single_pass_cuda(x.double(), chain=1, block_rows=32)
    with pytest.raises(ValueError, match="m=16"):
        ops.mma_reduce(x, m=128)
    # A view off the 16-byte grid is copied before the launch.
    odd = x[1:]
    assert float(ops.mma_reduce(odd)) == float((1 << 20) - 1)


def test_entry_points_run_on_the_card(cuda):
    x = np.random.default_rng(0).normal(size=(64, 1000)).astype(np.float32)
    want = float(np.sum(x, dtype=np.float64))
    for method in ("auto", "mma", "mma_chained", "pallas", "vpu"):
        got = integration.reduce_sum(x, method=method)
        assert got.is_cuda and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=0,
                                   atol=RTOL * np.abs(x).sum())
        half = integration.squared_sum(torch.from_numpy(x).cuda()
                                       .to(torch.bfloat16), method=method)
        assert half.is_cuda and half.dtype == torch.float32
    rows = integration.reduce_sum(torch.from_numpy(x).cuda(), axis=1)
    np.testing.assert_allclose(rows.cpu().numpy(), x.sum(axis=1),
                               rtol=1e-5, atol=1e-3)
