"""The port on the card: kernels B1-B8 and B10 against their plain PyTorch
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
plain version and count must be equal.  The compensated B4 agrees with
its plain version to 2^-21 of sum|x| and the double-double B5 to 2^-40
(the bounds ``chip_smoke.py`` states and justifies).  The scan kernel
B6 agrees with its plain version to 2^-16 of the running sum|x| at
every position, on counting inputs with the exact int64 prefix, and
with itself bit for bit over repeated calls and beside a busy stream
(its tile carries are a fold in tile order, whatever the look-back
meets).
The segmented-sum kernel B7 agrees with its plain version to 2^-20 of
each segment's sum|x| (both sum the same exact bf16 words, in another
order), on counting inputs with the exact count, and with itself bit
for bit.  The RMSNorm kernel B8 agrees with its plain version to 2^-20
of each f32 output plus 2^-24 (sums in another order, ``rsqrtf``
within 2 ulp), within one ulp in bf16, and with itself bit for bit; a
row's bits do not depend on the batch or on the input's alignment, and
its CUDA walk agrees with ``walk``.
The fused RMSNorm -> matmul kernel B10 agrees with its plain version to
2^-20 of each output's absolute-value scale (its f32 sums and
``rsqrtf`` in another order; the scale is ``_nm_scale``'s), plus one ulp
in bf16, with itself bit for bit, and a row's bits do not depend on how
many rows came with it.  The fused attention kernel B9 agrees with its
plain version to 2^-20 (1 + sigma) of each output's absolute-value scale
(``_attn_scales``: a score's f32 adds in another order move it by a few
2^-24 sigma, which exp turns into that relative error of p), and with a
bf16 v to 2^-8 of that scale more plus one bf16 ulp (both round p to
bf16, and a p near a rounding boundary may round the other way); it
repeats its bits, a row's bits do not depend on the batch, and a row
with no valid key is exactly 0.  Its bf16 prefill form (wgmma fed by
TMA), its f32 prefill form (three bf16 words of each operand made
once, then wgmma fed by TMA) and its decode form (each row's keys cut
into chunks that blocks walk side by side, then a merge in chunk order)
are held to the same bounds at the shapes that take them, count their
launches apart, and its CUDA chooser agrees with ``walk``.
The model zoo runs on the card: every arch at its SMOKE size (prefill
and a decode step within the reference's model bound, max|got - ref| <
0.05 (max|ref| + 1), of the full forward), Gemma-2 2B and DeepSeek-V3
with the ``fused_pallas`` spellings moving B8's, B9's and B10's counters
(within the same bound of the plain engines), and the MoE combine
repeating its bits.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import autotune, integration, precision
from repro_torch.kernels import mma_compensated as mc
from repro_torch.kernels import ops

mr = importlib.import_module("repro_torch.kernels.mma_reduce")
ms = importlib.import_module("repro_torch.kernels.mma_scan")
sg = importlib.import_module("repro_torch.kernels.mma_segment")
mrn = importlib.import_module("repro_torch.kernels.mma_rmsnorm")
mnm = importlib.import_module("repro_torch.kernels.mma_norm_matmul")
ma = importlib.import_module("repro_torch.kernels.mma_attention")

M = 16
RTOL = 2.0 ** -16
EC_RTOL = 2.0 ** -21
DD_RTOL = 2.0 ** -40
pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")


def _abs_sum(t: torch.Tensor, square: bool = False) -> float:
    t = t * t if square else t
    return float(torch.sum(t.abs(), dtype=torch.float64))


def _close(got, want, scale: float, rtol: float = RTOL):
    assert abs(float(got) - float(want)) <= rtol * scale + 1e-30, \
        (float(got), float(want), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
# 2^24 + 5: B1's and B3's blocks each walk several tiles (8 at R1 B32)
# and the last one is ragged.
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 13, (1 << 24) + 5])
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
    # (1 << 24) + 5: at R1 B32 every block of B1's and B3's walk takes
    # several tiles (counts near 2^22, still exact in f32).
    for n in (13, tile + 13, (1 << 16) + 13, (1 << 24) + 5):
        # 0/1 values, the last 13 all 1, and ones past n that a kernel
        # reading beyond its input would count.
        buf = torch.ones(n + 64, device="cuda", dtype=dtype)
        buf[:n] = (torch.rand(n, device="cuda", generator=gen)
                   < 0.25).to(dtype)
        buf[n - 13:n] = 1
        x = buf[:n]
        count = float(torch.sum(x, dtype=torch.float64))
        assert count < 2 ** 24
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


def test_b1_b3_cuda_walk_mirrors_walk(cuda):
    for n in (0, 1, 15, 4096, (1 << 20) + 7, (1 << 28) + 5, 1 << 50):
        for chain in (1, 4, 5):
            for block_rows in (16, 128, 512):
                assert mr.cuda_walk(n, chain, block_rows) \
                    == mr.walk(n, chain, block_rows)[0]


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


def _dd(pair) -> float:
    return float(torch.sum(pair.to(torch.float64)))


@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 13])
@pytest.mark.parametrize("chain,block_rows", [(4, 128), (5, 512)])
def test_tier_kernels_match_plain_on_card(cuda, n, chain, block_rows):
    gen = torch.Generator(device="cuda").manual_seed(n + chain)
    x32 = torch.randn(n, device="cuda", generator=gen)
    x64 = torch.randn(n, device="cuda", generator=gen, dtype=torch.float64)
    tile = chain * block_rows
    for square in (False, True):
        for words in (2, 3):
            got = mc.ec_cuda(x32, chain=chain, block_rows=block_rows,
                             split_words=words, square=square)
            want = mc.ec_plain(ops._to_tiles(x32, tile, M), chain=chain,
                               block_rows=block_rows, split_words=words,
                               square=square)
            assert got.dim() == 0
            _close(got, want, _abs_sum(x32.double(), square), EC_RTOL)
        for x in (x32, x64, x32.to(torch.bfloat16)):
            got = mc.dd_cuda(x, chain=chain, block_rows=block_rows,
                             square=square)
            want = mc.dd_plain(ops._to_tiles(x, tile, M), chain=chain,
                               block_rows=block_rows, square=square)
            assert got.shape == want.shape == (2,)
            assert abs(_dd(got) - _dd(want)) \
                <= DD_RTOL * _abs_sum(x.double(), square)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chain,block_rows", [(1, 32), (4, 128), (5, 512)])
def test_tier_kernels_count_exactly_with_a_ragged_tail(cuda, dtype, chain,
                                                       block_rows):
    tile = chain * block_rows * M
    gen = torch.Generator(device="cuda").manual_seed(tile)
    # (1 << 24) + 5: at R1 B32 every block of B1's and B3's walk takes
    # several tiles (counts near 2^22, still exact in f32).
    for n in (13, tile + 13, (1 << 16) + 13, (1 << 24) + 5):
        buf = torch.ones(n + 64, device="cuda", dtype=dtype)
        buf[:n] = (torch.rand(n, device="cuda", generator=gen)
                   < 0.25).to(dtype)
        buf[n - 13:n] = 1
        x = buf[:n]
        count = float(torch.sum(x, dtype=torch.float64))
        assert count < 2 ** 24
        x2d = ops._to_tiles(x, chain * block_rows, M)
        for square in (False, True):
            if dtype == torch.float32:
                for words in (2, 3):
                    got = mc.ec_cuda(x, chain=chain, block_rows=block_rows,
                                     split_words=words, square=square)
                    want = mc.ec_plain(x2d, chain=chain,
                                       block_rows=block_rows,
                                       split_words=words, square=square)
                    assert float(got) == float(want) == count, (n, words)
            got = mc.dd_cuda(x, chain=chain, block_rows=block_rows,
                             square=square)
            want = mc.dd_plain(x2d, chain=chain, block_rows=block_rows,
                               square=square)
            assert got.tolist() == want.tolist() == [count, 0.0], n


def test_tier_wrappers_count_launches_and_check_geometry(cuda):
    x = torch.ones(1 << 20, device="cuda")
    mc.reset_launches()
    assert float(ops.mma_ec_reduce(x, split_words=3)) == float(1 << 20)
    assert ops.mma_dd_squared_sum(x.double()).tolist() \
        == [float(1 << 20), 0.0]
    assert mc.LAUNCHES == {"b4_ec": 1, "b5_dd": 1}
    with pytest.raises(ValueError, match="block_rows"):
        mc.ec_cuda(x, chain=1, block_rows=24, split_words=2)
    with pytest.raises(ValueError, match="split_words"):
        mc.ec_cuda(x, chain=1, block_rows=32, split_words=4)
    with pytest.raises(ValueError, match="dtype"):
        mc.ec_cuda(x.double(), chain=1, block_rows=32, split_words=2)
    with pytest.raises(ValueError, match="dtype"):
        mc.dd_cuda(x.int(), chain=1, block_rows=32)
    # A view off the 16-byte grid is copied before the launch.
    assert float(ops.mma_ec_reduce(x[1:])) == float((1 << 20) - 1)
    assert ops.mma_dd_reduce(x.double()[1:]).tolist() \
        == [float((1 << 20) - 1), 0.0]


def test_tier_entry_points_run_on_the_card(cuda):
    x = np.random.default_rng(1).uniform(size=(64, 1000))
    want = float(np.sum(x))
    x32 = torch.from_numpy(x.astype(np.float32)).cuda()
    for method in ("mma_ec", "pallas_ec"):
        got = integration.reduce_sum(
            x32, method=method, precision=precision.MmaPolicy(split_words=3))
        assert got.is_cuda and got.dim() == 0
        np.testing.assert_allclose(float(got), float(x32.double().sum()),
                                   rtol=1e-6)
    for method in ("mma_dd", "pallas_dd", "auto"):
        got = integration.reduce_sum(torch.from_numpy(x).cuda(),
                                     method=method,
                                     precision=precision.F64_EQUIVALENT)
        assert got.is_cuda and got.shape == (2,)
        assert abs(precision.dd_value(got) - want) <= 1e-12 * want


SCAN_GEOMETRIES = ((1, 32), (4, 128), (5, 512))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 13])
def test_scan_kernel_matches_plain_on_card(cuda, dtype, n):
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n, device="cuda", generator=gen).to(dtype)
    running = torch.cumsum(x.double().abs(), dim=0)
    for chain, block_rows in SCAN_GEOMETRIES:
        for inclusive in (True, False):
            got = ms.scan_cuda(x, chain=chain, block_rows=block_rows,
                               inclusive=inclusive)
            want = ms.scan_plain(x, chain=chain, block_rows=block_rows,
                                 inclusive=inclusive)
            assert got.shape == want.shape == (n,)
            assert got.dtype == torch.float32
            scale = running if inclusive else torch.nn.functional.pad(
                running[:-1], (1, 0))
            diff = (got.double() - want.double()).abs()
            assert bool(torch.all(diff <= RTOL * scale)), \
                (chain, block_rows, inclusive, float(diff.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("chain,block_rows", SCAN_GEOMETRIES)
def test_scan_kernel_counts_exactly_with_a_ragged_tail(cuda, dtype, chain,
                                                       block_rows):
    tile = chain * block_rows * M
    gen = torch.Generator(device="cuda").manual_seed(tile)
    # (1 << 24) + 5: at R1 B32 every block of B1's and B3's walk takes
    # several tiles (counts near 2^22, still exact in f32).
    for n in (13, tile + 13, (1 << 16) + 13, (1 << 24) + 5):
        buf = torch.ones(n + 64, device="cuda", dtype=dtype)
        buf[:n] = (torch.rand(n, device="cuda", generator=gen)
                   < 0.25).to(dtype)
        buf[n - 13:n] = 1
        x = buf[:n]
        exact = torch.cumsum(x.long(), dim=0)
        for inclusive in (True, False):
            want = exact if inclusive \
                else torch.nn.functional.pad(exact[:-1], (1, 0))
            got = ms.scan_cuda(x, chain=chain, block_rows=block_rows,
                               inclusive=inclusive)
            plain = ms.scan_plain(x, chain=chain, block_rows=block_rows,
                                  inclusive=inclusive)
            assert torch.equal(got, plain), (n, inclusive)
            assert torch.equal(got.long(), want), (n, inclusive)


def test_scan_wrapper_counts_launches_and_checks_geometry(cuda):
    x = torch.ones(1 << 20, device="cuda")
    ms.reset_launches()
    got = ops.mma_scan(x.reshape(1024, 1024))
    assert got.shape == (1024, 1024) and float(got[-1, -1]) == 1 << 20
    assert ms.LAUNCHES == {"b6_scan": 1}
    with pytest.raises(ValueError, match="block_rows"):
        ms.scan_cuda(x, chain=1, block_rows=24)
    with pytest.raises(ValueError, match="dtype"):
        ms.scan_cuda(x.double(), chain=1, block_rows=32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ms.scan_cuda(x.cpu(), chain=1, block_rows=32)
    with pytest.raises(ValueError, match="chain"):
        ms.scan_cuda(x, chain=ms.MAX_CHAIN + 1, block_rows=32)
    # A view off the 16-byte grid is copied before the launch.
    assert float(ops.mma_scan(x[1:])[-1]) == float((1 << 20) - 1)
    assert ms.LAUNCHES == {"b6_scan": 2}
    # Every plan of the sweep, and tiles too large for shared memory
    # (links read twice through a staging slab): one launch each, within
    # RTOL of the plain version, and exact on a ramp of small integers.
    gen = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn(3 * (1 << 16) + 13, device="cuda", generator=gen)
    ramp = (torch.arange(y.numel(), device="cuda") % 3).float()
    running = torch.cumsum(y.double().abs(), dim=0)
    plans = [(c, b) for c in autotune.CHAINS for b in autotune.BLOCK_ROWS]
    for dtype in (torch.float32, torch.bfloat16):
        for chain, block_rows in plans + [(8, 512), (64, 512), (300, 32)]:
            before = ms.LAUNCHES["b6_scan"]
            got = ms.scan_cuda(y.to(dtype), chain=chain,
                               block_rows=block_rows)
            assert ms.LAUNCHES["b6_scan"] == before + 1
            want = ms.scan_plain(y.to(dtype), chain=chain,
                                 block_rows=block_rows)
            diff = (got.double() - want.double()).abs()
            assert bool(torch.all(diff <= RTOL * running)), \
                (dtype, chain, block_rows, float(diff.max()))
            exact = torch.cumsum(ramp.long(), dim=0)
            got = ms.scan_cuda(ramp.to(dtype), chain=chain,
                               block_rows=block_rows)
            assert torch.equal(got.long(), exact), (dtype, chain, block_rows)


@pytest.mark.parametrize("chain,block_rows", [(4, 128), (1, 32)])
def test_scan_kernel_repeats_its_bits(cuda, chain, block_rows):
    """The tile carries are a fold in tile order, whichever published
    state each block's look-back stops at: two calls, and a call while
    another stream keeps the card busy with a large matmul, give the
    same bits."""
    gen = torch.Generator(device="cuda").manual_seed(chain * block_rows)
    x = torch.randn(1 << 24, device="cuda", generator=gen)
    geo = dict(chain=chain, block_rows=block_rows)
    first = ms.scan_cuda(x, **geo)
    assert torch.equal(first, ms.scan_cuda(x, **geo))
    a = torch.randn(8192, 8192, device="cuda", generator=gen)
    busy = torch.cuda.Stream()
    busy.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(busy):
        for _ in range(4):
            a = a @ a.T / 8192.0
    beside = ms.scan_cuda(x, **geo)
    torch.cuda.synchronize()
    assert torch.equal(first, beside)


def test_scan_entry_points_run_on_the_card(cuda):
    rng = np.random.default_rng(2)
    x = rng.normal(size=1 << 18).astype(np.float32)
    mask = (rng.random(1 << 18) > 0.5).astype(np.float32)
    want = np.cumsum(x, dtype=np.float64)
    wmask = np.cumsum(x * mask, dtype=np.float64)
    scale = np.cumsum(np.abs(x), dtype=np.float64)
    ms.reset_launches()
    for method in ("auto", "mma", "mma_chained", "mma_ec", "pallas", "vpu"):
        got = integration.cumsum(x, method=method)
        assert got.is_cuda and got.dtype == torch.float32
        assert np.all(np.abs(got.cpu().numpy() - want) <= 1e-5 * scale)
        got = integration.masked_cumsum(x, mask, method=method)
        assert got.is_cuda
        assert np.all(np.abs(got.cpu().numpy() - wmask) <= 1e-5 * scale)
    assert ms.LAUNCHES["b6_scan"] >= 2
    rows = integration.cumsum(torch.from_numpy(x).cuda().reshape(64, -1),
                              axis=0, method="mma")
    assert rows.shape == (64, (1 << 18) // 64)


SEG_RTOL = 2.0 ** -20


def _seg_ids(n: int, s: int, gen, sort: bool = False) -> torch.Tensor:
    """int32 ids in [0, s), about 1 in 16 of them -1 or past s."""
    ids = torch.randint(0, s, (n,), device="cuda", generator=gen,
                        dtype=torch.int32)
    if sort:
        ids = torch.sort(ids).values
    stray = torch.rand(n, device="cuda", generator=gen) < 1 / 16
    bad = torch.tensor([-1, s, s + 3, 1 << 30], device="cuda",
                       dtype=torch.int32)
    pick = torch.randint(0, 4, (n,), device="cuda", generator=gen)
    return torch.where(stray, bad[pick], ids)


def _seg_scale(x, ids, s: int) -> torch.Tensor:
    keep = (ids >= 0) & (ids < s)
    return torch.zeros(s, dtype=torch.float64, device="cuda").index_add_(
        0, ids[keep].long(), x[keep].double().abs())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 13])
def test_segment_kernel_matches_plain_on_card(cuda, dtype, n):
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n, device="cuda", generator=gen).to(dtype)
    for s in (1, 19, 128, 4096):
        for sort in (False, True):
            ids = _seg_ids(n, s, gen, sort)
            scale = _seg_scale(x, ids, s)
            for block_rows in (16, 128, 512):
                got = sg.segment_cuda(x, ids, s, block_rows=block_rows)
                want = sg.segment_plain(
                    x, ids, s, block_rows=block_rows,
                    blocks=sg.grid_blocks(n, block_rows, "cuda"))
                assert got.shape == want.shape == (s,)
                assert got.dtype == torch.float32
                diff = (got.double() - want.double()).abs()
                assert bool(torch.all(diff <= SEG_RTOL * scale)), \
                    (s, sort, block_rows, float(diff.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_segment_kernel_counts_exactly_with_a_ragged_tail(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(7)
    for n in (13, 4096 + 13, (1 << 16) + 13):
        buf = torch.ones(n + 64, device="cuda", dtype=dtype)
        buf[:n] = (torch.rand(n, device="cuda", generator=gen)
                   < 0.25).to(dtype)
        buf[n - 13:n] = 1
        x = buf[:n]
        for s in (19, 128, 4096):
            ids = _seg_ids(n, s, gen)
            keep = (ids >= 0) & (ids < s)
            exact = torch.zeros(s, dtype=torch.int64, device="cuda") \
                .index_add_(0, ids[keep].long(), x[keep].long())
            got = sg.segment_cuda(x, ids, s, block_rows=128)
            plain = sg.segment_plain(x, ids, s, block_rows=128,
                                     blocks=sg.grid_blocks(n, 128, "cuda"))
            assert torch.equal(got, plain), (n, s)
            assert torch.equal(got.long(), exact), (n, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_segment_kernel_across_block_edges(cuda, dtype):
    # Counts at the 128-segment blocks' edges; the switch from register
    # sums (one or two blocks) to shared memory (three or more); ids that
    # hit only the second block; sorted ids (steps that skip blocks) and
    # random ones; a ragged tail.  Same bits on a second call.
    gen = torch.Generator(device="cuda").manual_seed(11)
    n = (1 << 18) + 77
    x = torch.randn(n, device="cuda", generator=gen).to(dtype)
    cases = [(s, sort) for s in (16, 127, 128, 129, 255, 256, 257, 384)
             for sort in (False, True)]
    second = torch.randint(128, 256, (n,), device="cuda", generator=gen,
                           dtype=torch.int32)
    for s, sort in cases + [(256, "second"), (384, "second")]:
        ids = second if sort == "second" else _seg_ids(n, s, gen, sort)
        for block_rows in (32, 128):
            got = sg.segment_cuda(x, ids, s, block_rows=block_rows)
            want = sg.segment_plain(
                x, ids, s, block_rows=block_rows,
                blocks=sg.grid_blocks(n, block_rows, "cuda"))
            diff = (got.double() - want.double()).abs()
            assert bool(torch.all(diff <= SEG_RTOL * _seg_scale(x, ids, s))), \
                (s, sort, block_rows, float(diff.max()))
            assert torch.equal(sg.segment_cuda(x, ids, s,
                                               block_rows=block_rows), got)
            if sort == "second":
                assert bool(torch.all(got[:128] == 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_segment_kernel_keeps_each_element_with_its_id(cuda, dtype):
    # Element e of a group takes k slot 2t, 2t + 1, 2t + 8 or 2t + 9 of
    # lane t = (e mod 16) / 4: its value and id must travel together.
    # Segment 8 (e mod 16) + (e / 16) mod 8 gets only the value
    # 1 + e mod 16 + 16 ((e / 16) mod 8), so each segment's exact sum
    # is its count times its own value; any element in another's slot
    # moves a sum off it.
    n = (1 << 16) + 29
    e = torch.arange(n, device="cuda")
    pos, grp = e % 16, (e // 16) % 8
    ids = (8 * pos + grp).to(torch.int32)
    x = (1 + pos + 16 * grp).to(dtype)
    want = torch.zeros(128, dtype=torch.int64, device="cuda").index_add_(
        0, ids.long(), x.long())
    for block_rows in (16, 128, 512):
        got = sg.segment_cuda(x, ids, 128, block_rows=block_rows)
        assert torch.equal(got.long(), want), block_rows
        assert torch.equal(got, got.round())
    # The same past a pass's base (S = 2 passes at 32 warps, f32).
    s = 2 * sg.pass_segments(torch.float32, 512)
    far = ids + (s - 128)
    got = sg.segment_cuda(x.float(), far, s, block_rows=512)
    assert torch.equal(got[s - 128:].long(), want)
    assert bool(torch.all(got[:s - 128] == 0))


def test_segment_kernel_runs_passes_and_repeats_its_bits(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = (1 << 20) + 5
    x = torch.rand(n, device="cuda", generator=gen)
    lib = sg._lib()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dt]
        for block_rows in (16, 128, 512):
            per = sg.pass_segments(dt, block_rows)
            assert per == lib.b7_pass_segments(code, block_rows)
            assert sg.ring_bytes(dt, block_rows) == lib.b7_ring_bytes(
                code, block_rows)
    # One segment past a pass: the last one comes from a second pass.
    s = sg.pass_segments(torch.float32, 512) + 1
    ids = _seg_ids(n, s, gen, sort=True)
    got = sg.segment_cuda(x, ids, s, block_rows=512)
    want = sg.segment_plain(x, ids, s, block_rows=512,
                            blocks=sg.grid_blocks(n, 512, "cuda"))
    diff = (got.double() - want.double()).abs()
    assert bool(torch.all(diff <= SEG_RTOL * _seg_scale(x, ids, s)))
    assert float(got[-1]) > 0
    ids = _seg_ids(n, 128, gen)
    first = sg.segment_cuda(x, ids, 128, block_rows=128)
    for _ in range(3):
        assert torch.equal(sg.segment_cuda(x, ids, 128, block_rows=128),
                           first)


def test_segment_wrapper_counts_launches_and_raises(cuda):
    x = torch.ones(1 << 20, device="cuda")
    ids = torch.arange(1 << 20, device="cuda") % 7
    sg.reset_launches()
    got = ops.mma_segment_sum(x, ids, 5)
    assert got.tolist() == [float(((1 << 20) + 6 - k) // 7)
                            for k in range(5)]
    assert sg.LAUNCHES == {"b7_segment_sum": 1}
    i32 = ids.to(torch.int32)
    with pytest.raises(ValueError, match="block_rows"):
        sg.segment_cuda(x, i32, 5, block_rows=24)
    with pytest.raises(ValueError, match="dtype"):
        sg.segment_cuda(x.double(), i32, 5, block_rows=128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sg.segment_cuda(x.cpu(), i32.cpu(), 5, block_rows=128)
    with pytest.raises(ValueError, match="int32"):
        sg.segment_cuda(x, ids, 5, block_rows=128)
    # A launch the card refuses (an empty grid) raises; nothing counts.
    with pytest.raises(RuntimeError, match="b7_segment_sum launch failed"):
        sg.segment_cuda(x, i32, 5, block_rows=128, blocks=0)
    assert sg.LAUNCHES == {"b7_segment_sum": 1}
    # int64 ids past int32 are clamped before the cast, never wrapped.
    far = torch.full((1 << 20,), (1 << 32) + 2, device="cuda")
    assert float(ops.mma_segment_sum(x, far, 5).sum()) == 0.0
    # Views off the 16-byte grid are copied before the launch.
    got = ops.mma_segment_sum(x[1:], ids[1:], 5)
    assert float(got.sum()) == float((1 << 20) - 1 - (ids[1:] >= 5).sum())


def test_segment_entry_points_run_on_the_card(cuda):
    rng = np.random.default_rng(4)
    n, s = 1 << 18, 37
    x = rng.normal(size=n).astype(np.float32)
    ids = rng.integers(-1, s + 1, n)
    keep = (ids >= 0) & (ids < s)
    want, scale = np.zeros(s), np.zeros(s)
    np.add.at(want, ids[keep], x[keep].astype(np.float64))
    np.add.at(scale, ids[keep], np.abs(x[keep]).astype(np.float64))
    sg.reset_launches()
    for method in ("auto", "mma", "mma_chained", "pallas", "vpu"):
        got = integration.segment_sum(x, ids, s, method=method)
        assert got.is_cuda and got.dtype == torch.float32
        assert got.shape == (s,)
        assert np.all(np.abs(got.cpu().numpy() - want) <= 1e-5 * scale)
    assert sg.LAUNCHES["b7_segment_sum"] >= 1


# ------------------------------------------------ B8: fused RMSNorm


def _rmsnorm_close(got, want):
    g, w = got.double(), want.double()
    if want.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                         - 7)
        assert bool(torch.all((g - w).abs() <= ulp))
    else:
        assert bool(torch.all((g - w).abs() <= 2.0 ** -20 * w.abs()
                              + 2.0 ** -24))


def _signed(rows, d, dtype, gen):
    mag = 0.5 + 0.5 * torch.rand(rows, d, device="cuda", generator=gen)
    sign = torch.randint(0, 2, (rows, d), device="cuda", generator=gen)
    return (mag * (2 * sign - 1)).to(dtype)


# d ragged against B8's chunks (32 f32 / 64 bf16 columns) and cluster
# split (17, 7169), d whose rows are not 16-byte aligned (odd d: the
# element-by-element loads), and d too wide for shared memory (24577 f32
# and 32768 f32 re-read their rows for the scaling pass; 24577 also
# unaligned).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 40), (17, 256), (64, 2304),
                                    (129, 7168), (33, 1), (3, 17),
                                    (20, 7169), (5, 24577), (3, 32768)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, dtype, rows, d):
    gen = torch.Generator(device="cuda").manual_seed(rows * d)
    x = _signed(rows, d, dtype, gen)
    w = 0.1 * torch.randn(d, device="cuda", generator=gen)
    for offset in (0.0, 1.0):
        got = mrn.rmsnorm_cuda(x, w, weight_offset=offset)
        assert got.dtype == dtype and got.shape == x.shape
        _rmsnorm_close(got, mrn.rmsnorm_plain(x, w, weight_offset=offset))
        assert torch.equal(got, mrn.rmsnorm_cuda(x, w,
                                                 weight_offset=offset))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2304, 7168, 7169])
def test_rmsnorm_kernel_misaligned_base_on_card(cuda, dtype, d):
    """A contiguous view that starts one element past a 16-byte boundary
    is read where it lies (element by element), never by the plain
    version, and gives the bits of an aligned copy."""
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    buf = _signed(1, 33 * d + 1, dtype, gen).reshape(-1)
    x = buf[1:].view(33, d)
    assert x.data_ptr() % 16 != 0
    w = 0.1 * torch.randn(d, device="cuda", generator=gen)
    before = mrn.LAUNCHES["b8_rmsnorm"]
    got = mrn.rmsnorm_cuda(x, w, weight_offset=1.0)
    assert mrn.LAUNCHES["b8_rmsnorm"] == before + 1
    _rmsnorm_close(got, mrn.rmsnorm_plain(x, w, weight_offset=1.0))
    assert torch.equal(got, mrn.rmsnorm_cuda(x.clone(), w,
                                             weight_offset=1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [17, 2304, 7169])
def test_rmsnorm_kernel_is_batch_independent(cuda, dtype, d):
    """B8's walk depends on d and the dtype alone: a row has the same bits
    in a call of 1, 17 or 4099 rows."""
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = _signed(4099, d, dtype, gen)
    w = 0.1 * torch.randn(d, device="cuda", generator=gen)
    full = mrn.rmsnorm_cuda(x, w)
    assert torch.equal(mrn.rmsnorm_cuda(x[:17].contiguous(), w), full[:17])
    assert torch.equal(mrn.rmsnorm_cuda(x[:1].contiguous(), w), full[:1])
    assert torch.equal(mrn.rmsnorm_cuda(x[4090:].contiguous(), w),
                       full[4090:])


def test_rmsnorm_cuda_walk_mirrors_walk(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 17, 40, 2304, 4096, 7168, 7169, 12288, 24577, 65536):
            assert mrn.cuda_walk(d, dtype) == mrn.walk(d, dtype), (d, dtype)


def test_rmsnorm_wrapper_counts_launches_and_raises(cuda):
    x = torch.randn(2, 3, 40, device="cuda")
    mrn.reset_launches()
    got = ops.mma_rmsnorm(x, torch.zeros(40, device="cuda"),
                          weight_offset=1.0)
    assert mrn.LAUNCHES["b8_rmsnorm"] == 1 and got.shape == x.shape
    _rmsnorm_close(got, mrn.rmsnorm_plain(x.reshape(-1, 40),
                                          torch.zeros(40, device="cuda"),
                                          weight_offset=1.0).reshape(x.shape))
    with pytest.raises(ValueError, match="f32 or bf16"):
        mrn.rmsnorm_cuda(x.reshape(-1, 40).half(),
                         torch.zeros(40, device="cuda"))
    with pytest.raises(ValueError, match="weight"):
        mrn.rmsnorm_cuda(x.reshape(-1, 40), torch.zeros(39, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        mrn.rmsnorm_cuda(x.reshape(-1, 40).T, torch.zeros(6, device="cuda"))
    assert mrn.LAUNCHES["b8_rmsnorm"] == 1


def test_norm_entry_points_run_on_the_card(cuda):
    from repro_torch.core import dispatch
    from repro_torch.models import layers
    x = torch.randn(4, 8, 2304, device="cuda")
    params = {"scale": 0.1 * torch.randn(2304, device="cuda")}
    mrn.reset_launches()
    fused = layers.rmsnorm(params, x, method="fused_pallas")
    assert fused.is_cuda and mrn.LAUNCHES["b8_rmsnorm"] == 1
    plain = layers.rmsnorm(params, x, method="unfused_mma")
    assert float((fused - plain).abs().max()) < 1e-5
    got = dispatch.dispatch("norm_matmul", x.cpu().numpy(),
                            method="fused_pallas", w=None,
                            scale=params["scale"])
    assert got.is_cuda and mrn.LAUNCHES["b8_rmsnorm"] == 2
    w = torch.randn(2304, 64, device="cuda") / 48.0
    mnm.reset_launches()
    got = dispatch.dispatch("norm_matmul", x, method="fused_pallas", w=w,
                            scale=params["scale"])
    assert got.is_cuda and mnm.LAUNCHES["b10_norm_matmul"] == 1
    out = layers.norm_matmul(params, x, w, method="fused_pallas")
    assert out.is_cuda and out.shape == (4, 8, 64)
    assert torch.equal(out, got) and mnm.LAUNCHES["b10_norm_matmul"] == 2


# ------------------------------------- B10: fused RMSNorm -> matmul

NM_RTOL = 2.0 ** -20


def _nm_inputs(rows, d, dout, act, bias, x_dtype, w_dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, device="cuda", generator=gen).to(x_dtype)
    s = 0.1 * torch.randn(d, device="cuda", generator=gen)
    w, wg = ((torch.randn(d, dout, device="cuda", generator=gen)
              / d ** 0.5).to(w_dtype) for _ in range(2))
    b = torch.randn(dout, device="cuda", generator=gen) if bias else None
    return x, s, w, (wg if act else None), b


def _nm_scale(x, s, w, wg, b):
    """What each output's rounding errors scale with: rstd times the
    absolute-value projections, |bias|, and for the gate pair
    |act(g) up|'s sensitivity, |act'| <= 1.2 and |act(g)| <= |g| + 0.3."""
    xf = x.double()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    xs = (xf * (1.0 + s.double())).abs()
    up = rstd * (xs @ w.double().abs())
    if b is not None:
        up = up + b.double().abs()
    if wg is None:
        return up
    return up * (2.2 * rstd * (xs @ wg.double().abs()) + 0.3)


def _nm_close(got, want, scale):
    g, w = got.double(), want.double()
    bound = NM_RTOL * scale
    if want.dtype == torch.bfloat16:
        bound = bound + torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(1e-30))) - 7)
    assert bool(torch.all((g - w).abs() <= bound)), \
        float(((g - w).abs() - bound).max())


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("rows,d,dout,act,bias", [
    (1, 40, 8, None, False), (17, 256, 100, "silu", True),
    (130, 2304, 100, "gelu", False), (64, 7168, 300, "silu", False),
    (257, 33, 129, None, True), (65, 2305, 200, "gelu", True),
    (129, 2305, 9217, "silu", False), (128, 96, 257, None, False)])
def test_norm_matmul_kernel_matches_plain_on_card(cuda, rows, d, dout, act,
                                                  bias, x_dtype, w_dtype):
    x, s, w, wg, b = _nm_inputs(rows, d, dout, act, bias, x_dtype, w_dtype,
                                rows * d + dout)
    got = mnm.norm_matmul_cuda(x, s, w, w_gate=wg, bias=b, act=act)
    assert got.dtype == x_dtype and got.shape == (rows, dout)
    _nm_close(got, mnm.norm_matmul_plain(x, s, w, w_gate=wg, bias=b,
                                         act=act), _nm_scale(x, s, w, wg, b))
    assert torch.equal(got, mnm.norm_matmul_cuda(x, s, w, w_gate=wg,
                                                 bias=b, act=act))


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_norm_matmul_kernel_keeps_f32_bits_with_f32_x(cuda, w_dtype):
    """With f32 x B10 keeps about 22 bits a product whatever the weights'
    dtype (kernels.mma_norm_matmul.product_bits): against the f64 oracle
    of the inputs every output is within 2^-22 of its absolute-value
    scale.  Without a gate or bias the output's own f32 rounding, about
    2^-25 of the scale, is what is left; two words of x (16 bits) err by
    about 2^-21.4 of it (norm_matmul_plain at this shape on the CPU)."""
    x, s, w, _, _ = _nm_inputs(65, 2305, 200, None, False, torch.float32,
                               w_dtype, 11)
    got = mnm.norm_matmul_cuda(x, s, w)
    xf = x.double()
    want = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + s.double()) @ w.double()
    scale = _nm_scale(x, s, w, None, None)
    assert bool(torch.all((got.double() - want).abs()
                          <= 2.0 ** -22 * scale))


@pytest.mark.parametrize("act", [None, "gelu"])
def test_norm_matmul_kernel_is_batch_independent(cuda, act):
    x, s, w, wg, b = _nm_inputs(4099, 2304, 200, act, True, torch.bfloat16,
                                torch.float32, 7)
    full = mnm.norm_matmul_cuda(x, s, w, w_gate=wg, bias=b, act=act)
    for rows in (1, 17, 64, 65, 128, 129):
        part = mnm.norm_matmul_cuda(x[:rows].contiguous(), s, w, w_gate=wg,
                                    bias=b, act=act)
        assert torch.equal(part, full[:rows]), rows


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 33, 2304, 2305, 7168])
def test_b10_cuda_walk_mirrors_walk(cuda, d, x_dtype, w_dtype):
    assert mnm.cuda_walk(d, x_dtype, w_dtype) == mnm.walk(d, x_dtype,
                                                          w_dtype)


def test_norm_matmul_wrapper_counts_launches_and_raises(cuda, monkeypatch):
    x, s, w, wg, b = _nm_inputs(6, 40, 24, "silu", True, torch.float32,
                                torch.bfloat16, 3)
    mnm.reset_launches()
    got = ops.mma_norm_matmul(x.reshape(2, 3, 40), s, w, w_gate=wg.float(),
                              bias=b, act="silu")
    assert mnm.LAUNCHES["b10_norm_matmul"] == 1 and got.shape == (2, 3, 24)
    _nm_close(got.reshape(6, 24),
              mnm.norm_matmul_plain(x, s, w, w_gate=wg.float(), bias=b,
                                    act="silu"),
              _nm_scale(x, s, w, wg.float(), b))
    with pytest.raises(ValueError, match="f32 or bf16"):
        mnm.norm_matmul_cuda(x.half(), s, w)
    with pytest.raises(ValueError, match="f32 or bf16"):
        mnm.norm_matmul_cuda(x, s, w.half())
    with pytest.raises(ValueError, match="w_gate"):
        mnm.norm_matmul_cuda(x, s, w, w_gate=wg[:, :5])
    with pytest.raises(ValueError, match="scale"):
        mnm.norm_matmul_cuda(x, s[:39], w)
    with pytest.raises(ValueError, match="contiguous"):
        mnm.norm_matmul_cuda(x.T, s, w)
    with pytest.raises(ValueError, match="act"):
        mnm.norm_matmul_cuda(x, s, w, w_gate=wg, act="relu")
    # A launch the kernel refuses (an activation code it does not know)
    # raises with CUDA's error string and counts nothing.
    monkeypatch.setitem(mnm._ACTS, "silu", 7)
    with pytest.raises(RuntimeError, match="b10_norm_matmul launch failed"):
        mnm.norm_matmul_cuda(x, s, w, w_gate=wg, act="silu")
    assert mnm.LAUNCHES["b10_norm_matmul"] == 1


def test_fused_mlp_runs_b10_on_the_card(cuda):
    """The model's case: bf16 rows, f32 weights, through layers.fused_mlp
    with fused_pallas; B10 multiplies the f32 weights as they are."""
    from repro_torch.models import layers
    x, s, w, wg, _ = _nm_inputs(64, 256, 512, "gelu", False, torch.bfloat16,
                                torch.float32, 11)
    wo = torch.randn(512, 256, device="cuda") / 512 ** 0.5
    mnm.reset_launches()
    out = layers.fused_mlp({"scale": s}, {"wi_up": w, "wi_gate": wg,
                                          "wo": wo}, x.reshape(4, 16, 256),
                           act="gelu", method="fused_pallas")
    assert mnm.LAUNCHES["b10_norm_matmul"] == 1
    h = mnm.norm_matmul_cuda(x, s, w, w_gate=wg, act="gelu")
    assert torch.equal(out.reshape(64, 256), h @ wo.to(torch.bfloat16))
    _nm_close(h, mnm.norm_matmul_plain(x, s, w, w_gate=wg, act="gelu"),
              _nm_scale(x, s, w, wg, None))


# ------------------------------------------------ B9: fused attention

ATTN_RTOL = 2.0 ** -20
ATTN_KINDS = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "mixed": (torch.float32, torch.bfloat16)}   # (q, cache)


def _attn_inputs(B, Sq, Sk, KV, G, hd, hd_v, kind, seed, *, qpos="tail",
                 kv_len=False):
    qd, kd = ATTN_KINDS[kind]
    gen = torch.Generator(device="cuda").manual_seed(seed)
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


def _attn_scales(qg, k, v, *, qpos, causal, window, kv_len, scale, cap):
    """Each output's absolute-value scale sum_j p_ij |v_j| / l_i and each
    row's score scale sigma_i = scale max_j sum_h |q_ih k_jh|, in f64."""
    s = torch.einsum("bqkgh,bckh->bkgqc", qg.double(), k.double()) * scale
    sigma = (torch.einsum("bqkgh,bckh->bkgqc", qg.double().abs(),
                          k.double().abs()) * scale).amax(-1)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    lo, hi = ma.row_bounds(qpos, kv_len, sk=k.shape[1], causal=causal,
                           window=window)
    j = torch.arange(k.shape[1], device=qg.device)
    valid = ((j >= lo[..., None]) & (j < hi[..., None]))[:, None, None]
    p = torch.softmax(torch.where(valid, s, -1e300), -1) * valid
    a = torch.einsum("bkgqc,bckh->bqkgh", p, v.double().abs())
    return a, sigma.permute(0, 3, 1, 2)[..., None]


def _attn_close(got, want, scales):
    a, sigma = scales
    g, w = got.double(), want.double()
    bound = ATTN_RTOL * (1.0 + sigma) * a
    if want.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * a + torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(1e-30))) - 7)
    assert bool(torch.all((g - w).abs() <= bound)), \
        float(((g - w).abs() - bound).max())


ATTN_CASES = [
    # (B, Sq, Sk, KV, G, hd, hd_v, causal, window, cap, qpos, kv_len)
    (2, 37, 45, 4, 2, 256, 256, True, None, 50.0, "tail", False),
    (2, 70, 130, 2, 1, 128, 128, True, 16, None, "tail", False),
    (2, 33, 100, 2, 2, 192, 128, True, None, None, "tail", False),
    (3, 1, 300, 4, 2, 256, 256, False, None, 50.0, "tail", True),
    (2, 5, 9, 1, 3, 16, 8, True, None, None, "padded", False),
    (2, 7, 75, 2, 3, 12, 8, True, 20, None, "tail", False),
]


@pytest.mark.parametrize("kind", list(ATTN_KINDS))
@pytest.mark.parametrize(
    "B,Sq,Sk,KV,G,hd,hd_v,causal,window,cap,qpos,kv_len", ATTN_CASES)
def test_attention_kernel_matches_plain_on_card(cuda, B, Sq, Sk, KV, G, hd,
                                                hd_v, causal, window, cap,
                                                qpos, kv_len, kind):
    qg, k, v, pos, kvl = _attn_inputs(B, Sq, Sk, KV, G, hd, hd_v, kind,
                                      Sq * Sk + hd, qpos=qpos, kv_len=kv_len)
    kw = dict(qpos=pos, causal=causal, window=window, kv_len=kvl,
              scale=hd ** -0.5, cap=cap)
    got = ma.attention_cuda(qg, k, v, **kw)
    assert got.dtype == v.dtype and got.shape == (B, Sq, KV, G, hd_v)
    _attn_close(got, ma.attention_plain(qg, k, v, **kw),
                _attn_scales(qg, k, v, **kw))
    assert torch.equal(got, ma.attention_cuda(qg, k, v, **kw))
    if qpos == "padded":
        assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))


# bf16 problems the wgmma form takes: rows a head 17 and 8192, Sk
# ragged against its 64-key blocks, hd 16 (a box wider than the row),
# 48 / 80, 64, 128, 192 / 128 and 256; G 3 rows packed across tiles.
ATTN_WG_CASES = [
    (1, 17, 83, 2, 1, 64, 64, True, None, None, "tail", False),
    (3, 33, 97, 2, 1, 16, 16, True, 8, None, "tail", False),
    (2, 24, 150, 1, 1, 48, 80, True, None, None, "tail", False),
    (2, 100, 130, 2, 3, 128, 128, True, 50, 30.0, "padded", False),
    (1, 130, 190, 1, 2, 192, 128, False, None, None, "tail", False),
    (2, 40, 200, 2, 2, 256, 256, True, None, 50.0, "tail", True),
    (1, 4096, 4131, 1, 2, 256, 256, True, None, 50.0, "tail", False),
]


@pytest.mark.parametrize(
    "B,Sq,Sk,KV,G,hd,hd_v,causal,window,cap,qpos,kv_len", ATTN_WG_CASES)
def test_attention_wgmma_form_matches_plain_on_card(cuda, B, Sq, Sk, KV, G,
                                                    hd, hd_v, causal, window,
                                                    cap, qpos, kv_len):
    assert ma.walk(torch.bfloat16, torch.bfloat16, Sq * G, hd,
                   hd_v)[0] == "wgmma"
    qg, k, v, pos, kvl = _attn_inputs(B, Sq, Sk, KV, G, hd, hd_v, "bf16",
                                      Sq + Sk + hd, qpos=qpos, kv_len=kv_len)
    kw = dict(qpos=pos, causal=causal, window=window, kv_len=kvl,
              scale=hd ** -0.5, cap=cap)
    ma.reset_launches()
    got = ma.attention_cuda(qg, k, v, **kw)
    assert ma.LAUNCHES == {"b9_attention": 0, "b9_attention_wgmma": 1,
                           "b9_attention_f32": 0, "b9_attention_decode": 0}
    assert got.dtype == v.dtype and got.shape == (B, Sq, KV, G, hd_v)
    _attn_close(got, ma.attention_plain(qg, k, v, **kw),
                _attn_scales(qg, k, v, **kw))
    assert torch.equal(got, ma.attention_cuda(qg, k, v, **kw))
    if qpos == "padded":
        assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    if B > 1:
        part = ma.attention_cuda(
            qg[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous(),
            **dict(kw, qpos=pos[:1].contiguous(),
                   kv_len=None if kvl is None else kvl[:1].contiguous()))
        assert torch.equal(part, got[:1])


# f32 problems the f32 prefill form takes: the same shapes (rows a head
# 17 to 8192, hd 16 to 256, hd_v 80 past a 64-column chunk).
ATTN_WF_CASES = ATTN_WG_CASES


@pytest.mark.parametrize(
    "B,Sq,Sk,KV,G,hd,hd_v,causal,window,cap,qpos,kv_len", ATTN_WF_CASES)
def test_attention_wgmma_f32_form_matches_plain_on_card(
        cuda, B, Sq, Sk, KV, G, hd, hd_v, causal, window, cap, qpos,
        kv_len):
    assert ma.walk(torch.float32, torch.float32, Sq * G, hd,
                   hd_v)[0] == "wgmma_f32"
    qg, k, v, pos, kvl = _attn_inputs(B, Sq, Sk, KV, G, hd, hd_v, "f32",
                                      Sq + Sk + hd, qpos=qpos, kv_len=kv_len)
    kw = dict(qpos=pos, causal=causal, window=window, kv_len=kvl,
              scale=hd ** -0.5, cap=cap)
    ma.reset_launches()
    got = ma.attention_cuda(qg, k, v, **kw)
    assert ma.LAUNCHES == {"b9_attention": 0, "b9_attention_wgmma": 0,
                           "b9_attention_f32": 1, "b9_attention_decode": 0}
    assert got.dtype == v.dtype and got.shape == (B, Sq, KV, G, hd_v)
    _attn_close(got, ma.attention_plain(qg, k, v, **kw),
                _attn_scales(qg, k, v, **kw))
    assert torch.equal(got, ma.attention_cuda(qg, k, v, **kw))
    if qpos == "padded":
        assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    if B > 1:
        part = ma.attention_cuda(
            qg[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous(),
            **dict(kw, qpos=pos[:1].contiguous(),
                   kv_len=None if kvl is None else kvl[:1].contiguous()))
        assert torch.equal(part, got[:1])


# Decode problems the decode form takes (at most 16 rows a head, a bf16
# cache), in chunks of ma.DECODE_CHUNK keys: Sk not a multiple of the
# chunk, rows whose kv_len crosses one, two or three chunk boundaries or
# none, rows with no key (kv_len 0 or position -1), 1, 2, 8 and 16 rows a
# head, hd 16 to 256, a window and the causal mask.
_C = ma.DECODE_CHUNK
ATTN_DC_CASES = [
    # (B, Sq, Sk, KV, G, hd, hd_v, causal, window, cap, qpos, kv_len)
    (4, 1, 2 * _C + 300, 2, 2, 64, 64, False, None, 50.0, "tail", True),
    (3, 1, 3 * _C + 77, 4, 2, 256, 256, False, None, None, "tail", True),
    (2, 1, _C + 5, 2, 1, 16, 16, False, None, None, "tail", True),
    (2, 4, 2 * _C + 5, 2, 2, 128, 128, True, _C // 2 + 100, 30.0, "tail",
     False),
    (2, 8, _C + 40, 1, 2, 192, 128, True, None, None, "padded", False),
]


@pytest.mark.parametrize("kind", ["mixed", "bf16"])
@pytest.mark.parametrize(
    "B,Sq,Sk,KV,G,hd,hd_v,causal,window,cap,qpos,kv_len", ATTN_DC_CASES)
def test_attention_decode_form_matches_plain_on_card(cuda, B, Sq, Sk, KV, G,
                                                     hd, hd_v, causal, window,
                                                     cap, qpos, kv_len,
                                                     kind):
    qd, kd = ATTN_KINDS[kind]
    assert ma.walk(qd, kd, Sq * G, hd, hd_v)[0] == "decode"
    qg, k, v, pos, kvl = _attn_inputs(B, Sq, Sk, KV, G, hd, hd_v, kind,
                                      Sq + Sk + hd, qpos=qpos, kv_len=kv_len)
    if kvl is not None:     # a row with no key, and one past the chunks'
        kvl[0] = 0          # first boundary
        kvl[-1] = max(int(kvl[-1]), _C + 1)
        pos = (kvl[:, None] - 1).expand(B, Sq).contiguous()
    kw = dict(qpos=pos, causal=causal, window=window, kv_len=kvl,
              scale=hd ** -0.5, cap=cap)
    ma.reset_launches()
    got = ma.attention_cuda(qg, k, v, **kw)
    assert ma.LAUNCHES == {"b9_attention": 0, "b9_attention_wgmma": 0,
                           "b9_attention_f32": 0, "b9_attention_decode": 1}
    assert got.dtype == v.dtype and got.shape == (B, Sq, KV, G, hd_v)
    _attn_close(got, ma.attention_plain(qg, k, v, **kw),
                _attn_scales(qg, k, v, **kw))
    assert torch.equal(got, ma.attention_cuda(qg, k, v, **kw))
    if kvl is not None:
        assert torch.equal(got[0], torch.zeros_like(got[0]))
    if qpos == "padded":
        assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    part = ma.attention_cuda(
        qg[-1:].contiguous(), k[-1:].contiguous(), v[-1:].contiguous(),
        **dict(kw, qpos=pos[-1:].contiguous(),
               kv_len=None if kvl is None else kvl[-1:].contiguous()))
    assert torch.equal(part, got[-1:])


def test_attention_cuda_chooser_mirrors_walk(cuda):
    """The CUDA source's form chooser and ``walk`` agree, at the
    boundaries: rows a head 1, 16 / 17, hd 12, 16, 256, 272, 288, hd_v 8,
    16, 256, and every dtype pair; a decode step's rows take the decode
    form beside a bf16 cache and the mma.sync form beside an f32 one."""
    for q_dt, kv_dt in ((torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.float32),
                        (torch.float32, torch.bfloat16),
                        (torch.bfloat16, torch.float32)):
        for rows in (1, 16, 17, 8192, 128 * 65535, 128 * 65535 + 1):
            for hd in (12, 16, 24, 64, 192, 256, 272, 288):
                for hd_v in (8, 16, 128, 256):
                    want = ma.walk(q_dt, kv_dt, rows, hd, hd_v)[0]
                    assert ma.cuda_form(q_dt, kv_dt, rows, hd,
                                        hd_v) == want, (q_dt, kv_dt, rows,
                                                        hd, hd_v)
    assert ma.walk(torch.bfloat16, torch.bfloat16, 17, 256, 256)[0] \
        == "wgmma"
    assert ma.walk(torch.float32, torch.float32, 17, 256, 256)[0] \
        == "wgmma_f32"
    for q_dt in (torch.float32, torch.bfloat16):
        assert ma.cuda_form(q_dt, torch.bfloat16, 2, 256, 256) == "decode"
        assert ma.cuda_form(q_dt, torch.bfloat16, 16, 16, 16) == "decode"
    assert ma.cuda_form(torch.float32, torch.float32, 2, 256, 256) \
        == "mma_sync"
    assert ma.cuda_form(torch.float32, torch.bfloat16, 17, 256, 256) \
        == "mma_sync"


@pytest.mark.parametrize("kind", list(ATTN_KINDS))
def test_attention_kernel_is_batch_independent(cuda, kind):
    """A row's bits do not depend on the rows beside it: rows 0..k of a
    B-row call equal a (k + 1)-row call, at prefill and at decode (the
    decode form beside a bf16 cache, its rows crossing chunks)."""
    for Sq, Sk, kv_len in ((40, 200, False), (1, 200, True),
                           (1, 3 * ma.DECODE_CHUNK + 5, True)):
        qg, k, v, pos, kvl = _attn_inputs(6, Sq, Sk, 2, 2, 256, 256, kind,
                                          5, kv_len=kv_len)
        kw = dict(causal=not kv_len, window=None, scale=0.0625, cap=50.0)
        full = ma.attention_cuda(qg, k, v, qpos=pos, kv_len=kvl, **kw)
        for rows in (1, 4):
            part = ma.attention_cuda(
                qg[:rows].contiguous(), k[:rows].contiguous(),
                v[:rows].contiguous(), qpos=pos[:rows].contiguous(),
                kv_len=None if kvl is None else kvl[:rows].contiguous(),
                **kw)
            assert torch.equal(part, full[:rows]), (Sq, rows)


def test_attention_wrapper_counts_launches_and_raises(cuda):
    from repro_torch.core import dispatch
    qg, k, v, pos, kvl = _attn_inputs(2, 1, 64, 2, 2, 16, 16, "mixed", 9,
                                      kv_len=True)
    kw = dict(k=k, v=v, qpos=pos, kv_len=kvl, scale=0.25)
    ma.reset_launches()
    got = dispatch.dispatch("attention", qg, method="fused_pallas", **kw)
    assert ma.LAUNCHES["b9_attention_decode"] == 1 \
        and got.dtype == torch.bfloat16
    dispatch.dispatch("attention", qg.cpu(), method="fused_pallas",
                      **{n: t.cpu() if torch.is_tensor(t) else t
                         for n, t in kw.items()})
    assert ma.LAUNCHES["b9_attention_decode"] == 1  # the CPU: the plain one
    call = dict(qpos=pos, kv_len=kvl, scale=0.25)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ma.attention_cuda(qg.half(), k, v, **call)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ma.attention_cuda(qg, k.half(), v.half(), **call)
    with pytest.raises(ValueError, match="one dtype"):
        ma.attention_cuda(qg, k, v.float(), **call)
    with pytest.raises(ValueError, match="contiguous"):
        ma.attention_cuda(qg, k.transpose(1, 2), v, **call)
    with pytest.raises(ValueError, match="qpos"):
        ma.attention_cuda(qg, k, v, qpos=pos.long(), kv_len=kvl, scale=0.25)
    with pytest.raises(ValueError, match="fused_pallas"):
        dispatch.dispatch("attention", qg.half(), method="fused_pallas",
                          **kw)
    assert ma.LAUNCHES["b9_attention_decode"] == 1


def test_attention_layer_runs_b9_on_the_card(cuda):
    """models.attention.attention with attn_method='fused_pallas' on the
    card: prefill into a bf16 cache (f32 q, k and v: B9's f32 prefill
    form) and a per-row decode step (f32 q against the bf16 cache: the
    decode form), both through B9, each held to the vpu engine's
    output."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import attention as A
    from repro_torch.models import param
    cfg = dataclasses.replace(registry.get_config("gemma2-2b", smoke=True),
                              attn_method="fused_pallas")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = param.init_tree(gen, A.attn_specs(cfg))
    x = torch.randn(2, 12, cfg.d_model, device="cuda", generator=gen)
    cache = A.make_cache(cfg, 2, 16)
    ma.reset_launches()
    out, cache = A.attention(params, cfg, x, positions=torch.arange(12,
                             device="cuda"), cache=cache, kind="local")
    assert ma.LAUNCHES == {"b9_attention": 0, "b9_attention_wgmma": 0,
                           "b9_attention_f32": 1, "b9_attention_decode": 0}
    vpu = dataclasses.replace(cfg, attn_method="vpu")
    want, _ = A.attention(params, vpu, x, positions=torch.arange(
        12, device="cuda"), kind="local")
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    pos = torch.tensor([[12], [3]], device="cuda")
    step = torch.randn(2, 1, cfg.d_model, device="cuda", generator=gen)
    out, _ = A.attention(params, cfg, step, positions=pos, cache=cache,
                         decode=True, kind="local")
    assert ma.LAUNCHES == {"b9_attention": 0, "b9_attention_wgmma": 0,
                           "b9_attention_f32": 1, "b9_attention_decode": 1}
    assert out.shape == (2, 1, cfg.d_model)
    assert bool(torch.all(torch.isfinite(out)))


# ------------------------------------------------------------ the models


def _model_batch(cfg, gen, b: int = 2, s: int = 12) -> dict:
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                                   generator=gen, dtype=torch.int32)}
    if cfg.vision_tokens:
        out["vision_embeds"] = torch.randn(
            b, cfg.vision_tokens, cfg.d_model, device="cuda",
            generator=gen).to(torch.bfloat16)
    if cfg.is_encdec:
        out["src_embeds"] = torch.randn(b, s, cfg.d_model, device="cuda",
                                        generator=gen).to(torch.bfloat16)
    return out


def _prefill_then_step(model, params, batch, nxt):
    """(prefill + one decode step's logits, the whole sequence's last
    logits), as ``tests/test_models.py`` compares them."""
    _, caches = model.prefill(params, batch)
    got, _ = model.decode_step(params, {"token": nxt,
                                        "pos": batch["tokens"].shape[1],
                                        "caches": caches})
    full = model.logits(params, dict(
        batch, tokens=torch.cat([batch["tokens"], nxt], 1)))[:, -1:]
    return got, full


def _within_model_bound(got, ref):
    """The reference's bound: max|got - ref| < 0.05 (max|ref| + 1)."""
    diff = float(torch.max(torch.abs(got.float() - ref.float())))
    assert diff < 0.05 * (float(torch.max(torch.abs(ref.float()))) + 1.0)


ARCHS = ("gemma3-27b", "gemma2-2b", "glm4-9b", "mistral-large-123b",
         "deepseek-v3-671b", "arctic-480b", "rwkv6-7b",
         "llama-3.2-vision-90b", "seamless-m4t-large-v2",
         "recurrentgemma-2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_prefill_then_decode_on_the_card(cuda, arch):
    """Each arch at its SMOKE size with the plain engines: parameters,
    caches and logits on the card, prefill + a decode step within the
    model bound of the full forward."""
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    cfg = registry.get_config(arch, smoke=True)
    model = model_zoo.build(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    assert all(t.is_cuda for t in integration._leaves(params))
    batch = _model_batch(cfg, gen)
    nxt = torch.randint(0, cfg.vocab_size, (2, 1), device="cuda",
                        generator=gen, dtype=torch.int32)
    got, full = _prefill_then_step(model, params, batch, nxt)
    assert got.is_cuda and got.shape == (2, 1, cfg.vocab_size)
    _within_model_bound(got, full)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b"])
def test_kernel_spellings_run_b8_b9_b10_in_the_model(cuda, arch):
    """fused_pallas for the norms, the MLPs (and MLA's query chain) and
    attention: B8's, B10's and B9's counters move over a prefill and a
    decode step, and the logits stay within the model bound of the
    plain engines' on the same params."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    base = registry.get_config(arch, smoke=True)
    fused = dataclasses.replace(base, reduce_method="fused_pallas",
                                norm_matmul_method="fused_pallas",
                                attn_method="fused_pallas")
    model, plain = model_zoo.build(fused), model_zoo.build(base)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = model.init(gen)
    batch = _model_batch(base, gen)
    nxt = torch.randint(0, base.vocab_size, (2, 1), device="cuda",
                        generator=gen, dtype=torch.int32)
    for mod in (mrn, mnm, ma):
        mod.reset_launches()
    got, full = _prefill_then_step(model, params, batch, nxt)
    torch.cuda.synchronize()
    assert mrn.LAUNCHES["b8_rmsnorm"] > 0
    assert mnm.LAUNCHES["b10_norm_matmul"] > 0
    assert sum(ma.LAUNCHES.values()) > 0
    _within_model_bound(got, full)
    want, _ = _prefill_then_step(plain, params, batch, nxt)
    _within_model_bound(got, want)


def test_moe_combine_repeats_its_bits_on_the_card(cuda):
    """The combine sums each token's k contributions in a fixed order
    (no float atomics): two calls give the same bits."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import moe, param
    cfg = registry.get_config("deepseek-v3-671b", smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=64, top_k=8))
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = param.init_tree(gen, moe.moe_specs(cfg))
    x = torch.randn(4, 1024, cfg.d_model, device="cuda", generator=gen)
    a, aux_a = moe.moe_block(params, cfg, x)
    b, aux_b = moe.moe_block(params, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
