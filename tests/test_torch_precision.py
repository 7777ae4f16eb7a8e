"""The PyTorch port's precision and theory modules against the JAX
reference, on shared numpy inputs.

The error-free transforms, the split-bf16 words and the harness's
inputs must agree bit for bit (both packages round to nearest even, one
operation at a time, on the CPU); the compensated sum may differ in the
order its second-order error terms are added, so it is held to 1 ulp.
"""

import math
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro.core import theory as jt
from repro_torch.core import precision as tp
from repro_torch.core import theory as tt


def _pair(x32: np.ndarray):
    return jnp.asarray(x32), torch.from_numpy(x32.copy())


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _inputs(seed: int, n: int = 4096):
    rng = np.random.default_rng(seed)
    scale = np.exp2(rng.integers(-30, 30, n)).astype(np.float32)
    a = (rng.normal(size=n).astype(np.float32) * scale)
    b = (rng.normal(size=n).astype(np.float32)
         * np.exp2(rng.integers(-30, 30, n)).astype(np.float32))
    return a, b


@pytest.mark.parametrize("fn", ["two_sum", "fast_two_sum", "two_prod"])
@pytest.mark.parametrize("seed", [0, 1])
def test_eft_bitwise(fn, seed):
    a, b = _inputs(seed)
    if fn == "fast_two_sum":   # requires |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), \
            np.where(np.abs(a) >= np.abs(b), b, a)
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    js, je = getattr(jp, fn)(ja, jb)
    ts, te = getattr(tp, fn)(ta, tb)
    np.testing.assert_array_equal(_bits(js), _bits(ts.numpy()))
    np.testing.assert_array_equal(_bits(je), _bits(te.numpy()))


def test_dd_add_bitwise():
    a, _ = _inputs(2)
    c, _ = _inputs(3)
    lo_a, lo_b = a * np.float32(2.0 ** -30), c * np.float32(2.0 ** -30)
    jr = jp.dd_add(*(jnp.asarray(v) for v in (a, lo_a, c, lo_b)))
    tr = tp.dd_add(*(torch.from_numpy(v.copy()) for v in (a, lo_a, c, lo_b)))
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(_bits(j), _bits(t.numpy()))


@pytest.mark.parametrize("words", [1, 2, 3])
def test_split_f32_words_bitwise(words):
    a, _ = _inputs(4)
    ja, ta = _pair(a)
    jw = jp.split_f32_words(ja, words)
    tw = tp.split_f32_words(ta, words)
    assert len(jw) == len(tw) == words
    for j, t in zip(jw, tw):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(j.astype(jnp.float32)), t.float().numpy())
    if words == 3:   # exact reconstruction for normal f32 values
        recon = sum(w.to(torch.float64) for w in tw)
        np.testing.assert_array_equal(recon.numpy(), a.astype(np.float64))


def test_split_f32_words_rejects_zero_words():
    with pytest.raises(ValueError):
        tp.split_f32_words(torch.ones(3), 0)


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4097])
def test_compensated_sum_within_one_ulp(n):
    v = np.random.default_rng(n).normal(size=n).astype(np.float32) * 1e3
    j = np.float32(jp.compensated_sum(jnp.asarray(v)))
    t = np.float32(tp.compensated_sum(torch.from_numpy(v)).item())
    # The pairwise TwoSum tree is the same; only the plain sum of the
    # second-order pair errors may be taken in another order.
    assert abs(int(_bits(j)) - int(_bits(t))) <= 1
    if n:
        assert abs(float(t) - float(np.sum(v, dtype=np.float64))) \
            <= 2 * np.spacing(np.float32(abs(t)) + np.float32(1e-30))


def test_dd_from_any_and_value():
    x64 = np.random.default_rng(5).normal(size=64)
    hi, lo = tp.dd_from_any(torch.from_numpy(x64))
    np.testing.assert_array_equal(hi.numpy(), x64.astype(np.float32))
    # hi + lo carries 48 of f64's 53 significand bits.
    np.testing.assert_allclose(hi.double().numpy() + lo.double().numpy(),
                               x64, rtol=2.0 ** -47, atol=0)
    h32, l32 = tp.dd_from_any(torch.from_numpy(x64.astype(np.float32)))
    assert float(l32.abs().max()) == 0.0
    pair = torch.tensor([1.0, 2.0 ** -30])
    assert tp.dd_value(pair) == jp.dd_value(np.asarray(pair)) \
        == 1.0 + 2.0 ** -30
    assert tp.dd_value(torch.tensor(3.5)) == 3.5


@pytest.mark.parametrize("kw", [
    {},
    {"split_words": 2, "error_budget_pct": 1e-4},
    {"input_dtype": "bfloat16"},
    {"input_dtype": "float16", "split_words": 3, "mma_precision": "highest"},
    {"accum_dtype": "float64", "error_budget_pct": 1e-10},
])
def test_signature_matches_reference(kw):
    jkw = {k: (jnp.dtype(v) if k.endswith("dtype") else v)
           for k, v in kw.items()}
    tkw = {k: (tp.as_dtype(v) if k.endswith("dtype") else v)
           for k, v in kw.items()}
    assert tp.MmaPolicy(**tkw).signature() \
        == jp.MmaPolicy(**jkw).signature()


def test_named_policies_and_as_policy():
    assert tp.MmaPolicy().signature() == "any.float32"
    assert tp.F64_EQUIVALENT.signature() == jp.F64_EQUIVALENT.signature()
    assert tp.EXACT_OFFSETS.signature() == jp.EXACT_OFFSETS.signature()
    assert tp.as_policy(None) is None
    pol = tp.MmaPolicy(split_words=2)
    assert tp.as_policy(pol) is pol
    assert tp.as_policy("HIGHEST") == tp.MmaPolicy(mma_precision="highest")
    with pytest.raises(TypeError):
        tp.as_policy(3)
    x = torch.ones(3)
    assert tp.MmaPolicy(input_dtype=torch.bfloat16).cast_in(x).dtype \
        == torch.bfloat16
    assert tp.ACCUM_DTYPE == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert tp.dtype_name(torch.bfloat16) == "bfloat16"
    assert tp.dtype_name(np.float32) == "float32"


@pytest.mark.parametrize("gen", ["normal_input", "uniform_input"])
@pytest.mark.parametrize("seed", [0, 7])
def test_harness_inputs_identical_bits(gen, seed):
    np.testing.assert_array_equal(getattr(tp, gen)(1000, seed=seed),
                                  getattr(jp, gen)(1000, seed=seed))


def test_percent_error_and_sweep_match_reference():
    x = tp.uniform_input(999, seed=3)
    assert tp.fp64_oracle(x) == jp.fp64_oracle(x)
    assert tp.percent_error(500.0, x) == jp.percent_error(500.0, x)
    fn = lambda v: float(np.sum(v.astype(np.float32)))  # noqa: E731
    assert tp.error_sweep(fn, [10, 100], dist="uniform") \
        == jp.error_sweep(fn, [10, 100], dist="uniform")


@pytest.mark.parametrize("n", [2.0, 1000.0, 2.0 ** 20, 2.0 ** 28])
@pytest.mark.parametrize("m", [4, 16, 128])
def test_theory_line_for_line(n, m):
    for chain in (1, 4, 5):
        assert tt.t_tc_chained(n, m, chain) == jt.t_tc_chained(n, m, chain)
        assert tt.speedup_chained(n, m, chain) \
            == jt.speedup_chained(n, m, chain)
        assert tt.t_tc_scan(n, m, chain) == jt.t_tc_scan(n, m, chain)
        for variant in ("single_pass", "recurrence"):
            assert astuple(tt.op_count(int(n), m, chain, variant)) \
                == astuple(jt.op_count(int(n), m, chain, variant))
            assert astuple(tt.op_count_scan(int(n), m, chain, variant)) \
                == astuple(jt.op_count_scan(int(n), m, chain, variant))
    assert tt.t_classic(n) == jt.t_classic(n)
    assert tt.t_tc(n, m) == jt.t_tc(n, m)
    assert tt.speedup(m) == jt.speedup(m)
    assert tt.optimal_chain(n, m) == jt.optimal_chain(n, m)


def test_theory_default_tile_is_the_papers_16():
    assert tt.speedup() == jt.speedup(16) == pytest.approx(
        0.8 * math.log2(256))
    assert astuple(tt.op_count(10 ** 6)) \
        == astuple(jt.op_count(10 ** 6, m=16))
