"""The prefix-scan slice of the PyTorch port against the JAX package, on
shared numpy inputs: ``core.scan`` (``tc_scan`` in both variants,
``tc_scan_ec``, ``tc_cumprod``), kernel B6's plain version behind
``kernels.ops.mma_scan``, the dispatch ops ``scan`` / ``masked_cumsum``
and the hooks ``cumsum`` / ``masked_cumsum``.

Tolerances, each stated where it is used:

* the reference's own (``tests/test_scan.py::_tol``): absolute
  1e-4 * sqrt(n) for f32 input, 3e-2 * sqrt(n) for 16-bit input, with
  rtol 1e-2;
* tighter, where both packages do the same f32 arithmetic in another
  order (every product of the triangular MMA is exact in f32, 16-bit
  inputs included): |port - reference| <= 2^-16 of the running sum|x|
  at every position;
* the compensated scans: 2^-20 of the running sum|x| (both are within
  a few f32 roundings of the exact prefix of the word split);
* ``tc_cumprod``: 1e-5 relative plus 1e-6 absolute (exp of two f32
  log-space scans).

The reference's Pallas kernel runs in interpret mode with m = 16, as
``tests/test_torch_kernels.py`` runs B1-B3; ``tests/test_torch_cuda.py``
holds the Hopper kernel itself against the plain version on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import dispatch as jd
from repro.core import integration as ji
from repro.core import scan as js
from repro.kernels import ops as jops
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as td
from repro_torch.core import integration as ti
from repro_torch.core import precision as tp
from repro_torch.core import scan as ts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# The package exports the function mma_scan under the kernel module's
# name, so the module is fetched by its full name.
tms = importlib.import_module("repro_torch.kernels.mma_scan")

M = 16
RTOL = 2.0 ** -16
EC_RTOL = 2.0 ** -20
SIZES = [1, 7, 127, 128, 129, 511, 4096, 16_385]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
SCAN_OPS = ("scan", "masked_cumsum")


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _pair(x32: np.ndarray, dtype: str = "float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x32).astype(jdt), torch.from_numpy(x32.copy()).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _running_abs(xt: torch.Tensor, axis: int = -1) -> np.ndarray:
    """The running sum|x| at every position, which bounds the inclusive
    prefix there and the exclusive one too."""
    return np.cumsum(np.abs(_np(xt)), axis=axis) + 1e-30


def _ref_tol(dtype: str, n: int) -> dict:
    """The reference's ``tests/test_scan.py::_tol``."""
    atol = (1e-4 if dtype == "float32" else 3e-2) * max(np.sqrt(n), 1)
    return dict(atol=atol, rtol=1e-2)


def _close_running(got, want, scale: np.ndarray, rtol: float = RTOL):
    diff = np.abs(_np(got) - _np(want))
    assert diff.shape == scale.shape, (diff.shape, scale.shape)
    worst = float(np.max(diff / scale)) if diff.size else 0.0
    assert worst <= rtol, worst


# ------------------------------------------------------------ tc_scan


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["single_pass", "recurrence"])
def test_tc_scan_matches_the_reference(variant, dtype):
    for n in SIZES:
        x = np.random.default_rng(n).normal(size=n).astype(np.float32)
        xj, xt = _pair(x, dtype)
        scale = _running_abs(xt)
        for chain in range(1, 6):
            got = ts.tc_scan(xt, variant=variant, chain=chain)
            want = js.tc_scan(xj, variant=variant, chain=chain, m=M)
            assert got.dtype == torch.float32 and got.shape == xt.shape
            np.testing.assert_allclose(_np(got), _np(want),
                                       **_ref_tol(dtype, n),
                                       err_msg=f"n={n} chain={chain}")
            _close_running(got, want, scale)


@pytest.mark.parametrize("variant", ["single_pass", "recurrence"])
def test_tc_scan_exclusive_and_on_a_middle_axis(variant):
    x = np.random.default_rng(3).normal(size=(3, 700, 5)).astype(np.float32)
    xj, xt = _pair(x)
    for inclusive in (True, False):
        got = ts.tc_scan(xt, axis=1, inclusive=inclusive, variant=variant,
                         chain=3)
        want = js.tc_scan(xj, axis=1, inclusive=inclusive, variant=variant,
                          chain=3, m=M)
        assert got.shape == xt.shape
        np.testing.assert_allclose(_np(got), _np(want),
                                   **_ref_tol("float32", 700))
        _close_running(got, want, _running_abs(xt, axis=1))
    excl = ts.tc_scan(xt, axis=1, inclusive=False, variant=variant)
    assert torch.all(excl[:, 0, :] == 0)


def test_tc_scan_keeps_integer_prefixes_exact():
    counts = np.random.default_rng(4).integers(0, 4096, size=4000)
    got = ts.tc_scan(torch.from_numpy(counts), inclusive=False,
                     precision=tp.EXACT_OFFSETS)
    want = np.concatenate([[0], np.cumsum(counts)[:-1]])
    assert want[-1] < 2 ** 24
    np.testing.assert_array_equal(_np(got), want)


def test_tc_scan_gradient():
    """As the reference's ``test_scan_grad``: d(last prefix)/dx = 1."""
    v = torch.ones(300, requires_grad=True)
    ts.tc_scan(v)[-1].backward()
    want = jax.grad(lambda u: js.tc_scan(u)[-1])(jnp.ones((300,)))
    np.testing.assert_allclose(v.grad.numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), rtol=1e-6)


# -------------------------------------------- tc_scan_ec, tc_cumprod


@pytest.mark.parametrize("words", [2, 3])
@pytest.mark.parametrize("inclusive", [True, False])
def test_tc_scan_ec_matches_the_reference(words, inclusive):
    x = np.random.default_rng(words).normal(size=5000).astype(np.float32)
    xj, xt = _pair(x)
    got = ts.tc_scan_ec(xt, split_words=words, inclusive=inclusive)
    want = js.tc_scan_ec(xj, split_words=words, inclusive=inclusive, m=M)
    scale = _running_abs(xt)
    _close_running(got, want, scale, EC_RTOL)
    _close_running(got, tref.ec_scan_ref(xt, split_words=words,
                                         inclusive=inclusive),
                   scale, EC_RTOL)


def test_tc_cumprod_matches_the_reference():
    x = np.random.default_rng(5).uniform(0.9, 1.0, size=(4, 600))
    x[1, 300] = 0.0                       # an exact zero floors the log
    xj, xt = _pair(x.astype(np.float32))
    for inclusive in (True, False):
        got = ts.tc_cumprod(xt, inclusive=inclusive)
        want = js.tc_cumprod(xj, inclusive=inclusive, m=M)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)
    assert torch.all(ts.tc_cumprod(xt)[1, 300:] == 0)


# ------------------------------------------- kernel B6 (plain version)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain,block_rows", [(1, 16), (2, 32), (4, 128)])
def test_b6_plain_matches_pallas(chain, block_rows, dtype):
    tile = chain * block_rows * M
    for n in (1, 129, tile + 13, 2 * tile + 13):
        x = np.random.default_rng(n).normal(size=n).astype(np.float32)
        xj, xt = _pair(x, dtype)
        for inclusive in (True, False):
            got = tops.mma_scan(xt, inclusive=inclusive, chain=chain,
                                block_rows=block_rows)
            want = jops.mma_scan(xj, inclusive=inclusive, chain=chain,
                                 block_rows=block_rows, m=M,
                                 interpret=True)
            assert got.dtype == torch.float32 and got.shape == (n,)
            _close_running(got, want, _running_abs(xt))
            _close_running(got, tref.scan_ref(xt, inclusive=inclusive),
                           _running_abs(xt))


def test_mma_scan_keeps_the_shape_and_resolves_auto(fresh_registries):
    x = np.random.default_rng(7).normal(size=(6, 50)).astype(np.float32)
    xj, xt = _pair(x)
    got = tops.mma_scan(xt, chain="auto", block_rows="auto")
    want = jops.mma_scan(xj, chain="auto", block_rows="auto", m=M,
                         interpret=True)
    assert got.shape == xt.shape
    _close_running(got.reshape(-1), want.reshape(-1),
                   _running_abs(xt.reshape(-1)))
    assert [k for k, _ in tat.default_registry().items()] \
        == [k for k, _ in jat.default_registry().items()] \
        == ["scan|512|float32|cpu|pallas"]


def test_b6_plain_counts_exactly():
    n = 2 * 4 * 128 * M + 13
    x = (np.random.default_rng(8).random(n) < 0.25).astype(np.float32)
    got = tms.scan_plain(torch.from_numpy(x), chain=4, block_rows=128)
    np.testing.assert_array_equal(_np(got), np.cumsum(x, dtype=np.float64))


def _fold_step(s, c, a):
    """One step of B6's compensated fold in f32: s takes in a, c the
    exact error of that add (TwoSum)."""
    f = np.float32
    t = f(s + a)
    bp = f(t - s)
    return t, f(c + f(f(s - f(t - bp)) + f(a - bp)))


def _carry(s, c):
    return s if np.isnan(c) else np.float32(s + c)


def test_b6_carries_fold_forward_from_any_look_back_start():
    """B6's tile carries are a compensated left fold over the tile
    totals in tile order.  A block's look-back folds the totals after
    the first published state S_j it meets forward from S_j, so every
    start j < i must give the carry of tile i bit for bit; those carries
    are ``scan_plain``'s, and they stay within a few roundings of the
    exact prefix of the totals (a plain f32 fold's error grows with the
    number of tiles)."""
    rng = np.random.default_rng(12)
    n = 400 * 16 * M + 5
    x = (rng.normal(size=n) * 2.0 ** rng.integers(-6, 7, size=n)).astype(
        np.float32) + np.float32(3.0)
    xt = torch.from_numpy(x)
    p, carry, totals = tms.scan_parts(xt, chain=1, block_rows=16)
    a = totals.numpy()
    states = [(np.float32(0.0), np.float32(0.0))]
    for v in a:
        states.append(_fold_step(*states[-1], v))
    want = np.array([_carry(*st) for st in states[:-1]], np.float32)
    got = tms.fold_carries(totals).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for i in rng.choice(np.arange(1, len(a)), size=40, replace=False):
        for j in rng.choice(np.arange(-1, i), size=min(i + 1, 12),
                            replace=False):
            s, c = states[j + 1]
            for v in a[j + 1:i]:
                s, c = _fold_step(s, c, v)
            assert np.float32(_carry(s, c)).view(np.uint32) \
                == want[i].view(np.uint32), (i, j)
    out = tms.assemble(p, carry, torch.from_numpy(want), n)
    plain = tms.scan_plain(xt, chain=1, block_rows=16)
    assert torch.equal(out, plain)
    exact = np.concatenate([[0.0], np.cumsum(a.astype(np.float64))[:-1]])
    scale = np.cumsum(np.abs(a.astype(np.float64)))
    assert np.all(np.abs(want - exact) <= 2.0 ** -24 * np.abs(exact)
                  + 1e-9 * scale)


# ----------------------------------------------------------- dispatch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", SCAN_OPS)
def test_every_scan_engine_and_alias_matches_the_oracle(op, dtype,
                                                        fresh_registries):
    """Every engine, the alias and 'auto', inclusive and exclusive,
    against ``OpSpec.reference`` and the JAX package's same method:
    2^-16 of the running sum|x| for the plain engines and the kernel,
    the reference's tolerance besides."""
    x = np.random.default_rng(9).normal(size=4097).astype(np.float32)
    xj, xt = _pair(x, dtype)
    spec = td.op_spec(op)
    scale = _running_abs(xt)
    for inclusive in (True, False):
        want = spec.reference(xt, inclusive=inclusive)
        np.testing.assert_allclose(
            _np(want), _np(jd.op_spec(op).reference(xj, inclusive=inclusive)),
            **_ref_tol(dtype, 4097))
        for method in spec.engine_names() + ("mma", "auto"):
            got = td.dispatch(op, xt, method=method, inclusive=inclusive)
            assert got.dtype == torch.float32 and got.shape == xt.shape
            _close_running(got, want, scale)
            if method != "auto":
                ref = jd.dispatch(op, xj, method=method, inclusive=inclusive)
                np.testing.assert_allclose(_np(got), _np(ref),
                                           **_ref_tol(dtype, 4097),
                                           err_msg=f"{op}/{method}")


@pytest.mark.parametrize("op", SCAN_OPS)
def test_pallas_refuses_a_batched_input_both_ways(op):
    x2 = np.ones((4, 32), np.float32)
    tx, jx = torch.from_numpy(x2), jnp.asarray(x2)
    for pkg, x in ((td, tx), (jd, jx)):
        with pytest.raises(ValueError, match="flattened input"):
            pkg.dispatch(op, x, method="pallas")
        assert not pkg.supported_method(op, x, "pallas")
        assert pkg.resolve_method(op, x, "pallas") == "vpu"
        assert pkg.supported_method(op, x, "mma", axis=0)
        assert pkg.supported_method(op, x[:1], "pallas")
        with pytest.raises(ValueError, match="unknown"):
            pkg.dispatch(op, x, method="bogus")
    for multi in (False, True):
        tctx = td.build_context(op, tx, multi_device=multi)
        jctx = jd.build_context(op, jx, multi_device=multi)
        assert td.legal_engines(td.op_spec(op), tctx) \
            == jd.legal_engines(jd.op_spec(op), jctx)


def test_chain_auto_resolves_through_a_fresh_registry(fresh_registries):
    x = np.random.default_rng(10).normal(size=(8, 300)).astype(np.float32)
    xj, xt = _pair(x)
    td.dispatch("scan", xt)
    jd.dispatch("scan", xj)
    td.dispatch("scan", xt[0], method="pallas", chain="auto")
    jd.dispatch("scan", xj[0], method="pallas", chain="auto")
    ts.tc_scan(xt[0], chain="auto")
    js.tc_scan(xj[0], chain="auto")
    port_keys = [k for k, _ in tat.default_registry().items()]
    ref_keys = [k for k, _ in jat.default_registry().items()]
    assert port_keys == ref_keys == [
        "scan|512|float32|cpu|mma_chained",
        "scan|512|float32|cpu|mma_chained+mma_ec+vpu",
        "scan|512|float32|cpu|pallas"]


# -------------------------------------------------------------- hooks


@pytest.mark.parametrize("method", ["mma", "mma_chained", "mma_ec",
                                    "pallas", "vpu", "auto"])
def test_hooks_match_the_reference(method, fresh_registries):
    rng = np.random.default_rng(11)
    x = rng.normal(size=3000).astype(np.float32)
    mask = (rng.random(3000) > 0.5).astype(np.float32)
    xj, xt = _pair(x)
    for inclusive in (True, False):
        got = ti.cumsum(xt, method=method, inclusive=inclusive)
        want = ji.cumsum(xj, method=method, inclusive=inclusive)
        np.testing.assert_allclose(_np(got), _np(want),
                                   **_ref_tol("float32", 3000))
        _close_running(got, want, _running_abs(xt))
        got = ti.masked_cumsum(xt, torch.from_numpy(mask), method=method,
                               inclusive=inclusive)
        want = ji.masked_cumsum(xj, jnp.asarray(mask), method=method,
                                inclusive=inclusive)
        np.testing.assert_allclose(_np(got), _np(want),
                                   **_ref_tol("float32", 3000))
        _close_running(got, want, _running_abs(xt))


def test_scan_costs_rank_like_their_bytes():
    """The scan family's model terms: the kernel and vpu move 8 bytes
    per f32 element and mma_chained 24; beside its bytes the kernel
    pays its triangular MMAs and its blocks, so at 2^28 vpu still scores
    cheapest in f32; the reduce family's costs do not see the scan
    terms."""
    n = 1 << 28
    vpu = tat.model_cost(tat.ReductionPlan(method="vpu"), n, "float32",
                         op="scan")
    pallas = tat.model_cost(tat.ReductionPlan(method="pallas", chain=4,
                                              block_rows=128), n,
                            "float32", op="scan")
    chained = tat.model_cost(tat.ReductionPlan(method="mma_chained",
                                               chain=4), n, "float32",
                             op="scan")
    assert vpu < pallas < chained
    for op in SCAN_OPS:
        methods = {p.method for p in tat.candidate_plans(4096, "float32",
                                                         op=op)}
        assert methods == {"mma_chained", "mma_ec", "pallas", "vpu"}
    assert tat.model_cost(tat.ReductionPlan(method="vpu"), n, "float32") \
        < vpu


def test_scan_cost_counts_the_f32_output_and_copy_of_a_16_bit_input():
    """The model prices a 16-bit scan from its runners: the input read
    scales with its itemsize, the f32 output does not, and vpu's f32
    copy of the input is written and reread.  So ``auto`` resolves to
    the kernel B6 for a bf16 scan at 2^28 (6 bytes an element against
    vpu's 14; on one H100, chip_smoke.py phase 6b, 0.79 ms against
    torch.cumsum's 1.85) and still to vpu in f32, where both move 8
    bytes an element and B6 pays its MMAs and blocks besides (1.08
    against 1.04 ms there)."""
    n = 1 << 28
    bytes_of = {m: tat._bytes_per_element(tat.ReductionPlan(method=m),
                                          "scan", "scan", 2)
                for m in ("vpu", "pallas", "mma_chained")}
    assert bytes_of == {"vpu": 14.0, "pallas": 6.0, "mma_chained": 22.0}
    assert tat._bytes_per_element(tat.ReductionPlan(method="pallas"),
                                  "scan", "scan", 4) == 8.0
    for op in SCAN_OPS:
        for dtype, want in (("bfloat16", "pallas"), ("float32", "vpu")):
            assert tat.autotune(n, dtype, op=op,
                                backend="cuda").method == want, (op, dtype)
            reg = tat.PlanRegistry()
            assert tat.get_plan(n, dtype, op=op, backend="cuda",
                                registry=reg).method == want
    # The segment family's int32 ids do not shrink with the values.
    assert tat._bytes_per_element(tat.ReductionPlan(method="pallas"),
                                  "segment_sum", "segment", 2) == 6.0
