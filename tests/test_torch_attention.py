"""The port's attention path against the JAX package, on the CPU: kernel
B9's plain version, the ``attention`` op's engines and
``models.attention``.

  * ``attention_plain`` (reached through ``kernels.ops.mma_attention``
    on CPU tensors) against the reference's ``mma_attention`` run as its
    own tests run it here, in interpret mode: the reference's
    ``FUSED_CASES`` (``tests/test_attention_fused.py``), a hypothesis
    sweep with the reference's strategy, the softcap and per-row decode
    with ``kv_len``; tolerances are the reference's own, 1e-4 in f32
    and 6e-2 in bf16 (relative and absolute);
  * every engine of ``dispatch('attention', ...)`` against the
    reference's dispatch of the same engine, at the f32 tolerance above
    (f32: the engines differ only in the order of their f32 adds and,
    for B9, in its 3xTF32 products, ~2^-21 relative) and 2e-2 in bf16
    (one bf16 rounding of p and of the output, either side of a
    boundary);
  * a fully-masked query row is exactly 0 in every engine;
  * the capability predicates: ``unfused_mma`` refuses a dynamic
    kv_len, B9 refuses fp16 operands (naming B9) and head dims past the
    limit derived from its shared memory, and the stay-trainable
    resolver then takes ``vpu``;
  * ``auto`` under a 0.5 % and a 0.1 % error budget: the port's
    ``engine_bits`` are truthful (B9 21 bits in f32, the plain engines
    24), so both budgets admit B9 and its plan is taken; the reference's
    8-bit engines fell back to ``vpu`` under 0.1 % (ROADMAP queue C);
  * ``_mask``, ``_direct_attn``, ``_chunked_attn`` and
    ``_banded_local_attn`` against the reference's;
  * ``models.attention.attention`` at the SMOKE configs against
    ``repro.models.attention.attention``, parameters made by the
    reference and carried across with ``models.param.from_numpy`` (its
    zero-initialised QK-norm scales and biases drawn at random first):
    Gemma-2 2B's global and local layers, Gemma-3 27B (QK-norm), GLM-4
    9B (QKV bias) and Llama-3.2 Vision's cross layer; prefill, three
    scalar-``idx`` decode steps, per-row decode and a prefill past the
    cache's capacity, through each engine spelling.

The reference's ``test_fused_decode_over_paged_int8_store_bitwise``
(the continuous-batching server over the paged int8 KV store) has no
counterpart here yet: the paged cache and the server are ROADMAP item
12.  The card's own checks of kernel B9 are in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - depends on environment
    HAVE_HYPOTHESIS = False

from repro.configs import registry as jreg
from repro.core import dispatch as jd
from repro.models import attention as JA
from repro.models import param as JP
from repro_torch.configs import registry as treg
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as td
from repro_torch.core.precision import MmaPolicy
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import attention as TA
from repro_torch.models import param as TP

j_mma_attention = importlib.import_module(
    "repro.kernels.mma_attention").mma_attention
ma = importlib.import_module("repro_torch.kernels.mma_attention")

ENGINES = ("fused_pallas", "unfused_mma", "vpu")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _problem(seed, *, B=2, Sq=16, Sk=None, KV=1, G=1, hd=16, hd_v=None):
    """The reference's _problem: f32 numpy arrays from a seed."""
    Sk = Sq if Sk is None else Sk
    hd_v = hd if hd_v is None else hd_v
    rng = np.random.default_rng(seed)

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return t(B, Sq, KV, G, hd), t(B, Sk, KV, hd), t(B, Sk, KV, hd_v)


def _both(arrays, dtype: str):
    """The same arrays as (jax, torch) in ``dtype``."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _check_plain_matches_reference(seed, Sq, Sk, G, hd, hd_v, causal,
                                   window, dtype, chain=2, block_rows=128):
    arrays = _problem(seed, Sq=Sq, Sk=Sk, KV=2, G=G, hd=hd, hd_v=hd_v)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    qpos = np.arange(Sq, dtype=np.int32) + max(Sk - Sq, 0)
    kw = dict(causal=causal, window=window, scale=1.0 / np.sqrt(hd))
    want = j_mma_attention(jq, jk, jv, qpos=jnp.asarray(qpos), chain=chain,
                           block_rows=block_rows, **kw)
    got = ops.mma_attention(tq, tk, tv, qpos=torch.from_numpy(qpos), **kw)
    assert got.dtype == tv.dtype and got.shape == tuple(want.shape)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# tests/test_attention_fused.py FUSED_CASES (the reference's chain and
# block_rows shape its TPU grid, not the function).
FUSED_CASES = [
    # (Sq, Sk, G, hd, hd_v, causal, window, dtype, chain, block_rows)
    (1, 1, 1, 8, 8, True, None, "float32", 1, 128),
    (16, 16, 1, 16, 16, True, None, "float32", 2, 128),
    (24, 24, 2, 24, 16, True, None, "float32", 3, 128),
    (40, 40, 1, 16, 16, True, 8, "float32", 4, 128),
    (130, 130, 1, 8, 8, False, None, "float32", 2, 128),
    (9, 300, 2, 16, 16, True, None, "float32", 4, 128),
    (33, 160, 2, 16, 16, True, 32, "float32", 2, 256),
    (16, 16, 1, 16, 16, True, None, "bfloat16", 2, 128),
    (33, 160, 2, 16, 16, True, 32, "bfloat16", 2, 128),
]


@pytest.mark.parametrize(
    "Sq,Sk,G,hd,hd_v,causal,window,dtype,chain,block_rows", FUSED_CASES)
def test_attention_plain_matches_the_reference_kernel(
        Sq, Sk, G, hd, hd_v, causal, window, dtype, chain, block_rows):
    _check_plain_matches_reference(Sq * 1000 + Sk, Sq, Sk, G, hd, hd_v,
                                   causal, window, dtype, chain, block_rows)


if HAVE_HYPOTHESIS:

    @settings(max_examples=10, deadline=None)
    @given(st.integers(0, 2**31),
           st.integers(min_value=1, max_value=40),   # Sq
           st.integers(min_value=0, max_value=200),  # extra keys
           st.integers(min_value=1, max_value=3),    # GQA group
           st.sampled_from([8, 16, 24]),             # head dim
           st.booleans(),                            # causal
           st.sampled_from([None, 4, 16]),           # window
           st.sampled_from(["float32", "bfloat16"]),
           st.sampled_from([1, 2, 4]))               # chain
    def test_attention_plain_matches_the_reference_kernel_hypothesis(
            seed, sq, extra, g, hd, causal, window, dtype, chain):
        _check_plain_matches_reference(
            seed, sq, sq + extra, g, hd, hd, causal,
            window if causal else None, dtype, chain, 128)


def test_attention_plain_softcap_and_per_row_decode():
    """The reference's softcap and per-row decode cases: one query per
    row, each at its own position, kv_len masking the ring's tail."""
    arrays = _problem(7, Sq=20, KV=1, G=2, hd=16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    qpos = np.arange(20, dtype=np.int32)
    kw = dict(causal=True, scale=0.25, cap=30.0)
    np.testing.assert_allclose(
        _np(ops.mma_attention(tq, tk, tv, qpos=torch.from_numpy(qpos),
                              **kw)),
        _np(j_mma_attention(jq, jk, jv, qpos=jnp.asarray(qpos), chain=2,
                            **kw)), **F32_TOL)
    arrays = _problem(13, B=3, Sq=1, Sk=64, KV=2, G=2, hd=16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    qpos = np.asarray([[5], [17], [40]], np.int32)
    kv_len = np.asarray([6, 18, 41], np.int32)
    kw = dict(causal=True, scale=0.25)
    want = _np(j_mma_attention(jq, jk, jv, qpos=jnp.asarray(qpos),
                               kv_len=jnp.asarray(kv_len), chain=4, **kw))
    got = ops.mma_attention(tq, tk, tv, qpos=torch.from_numpy(qpos),
                            kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(_np(got), want, **F32_TOL)
    got = td.dispatch("attention", tq, method="fused_pallas", k=tk, v=tv,
                      qpos=torch.from_numpy(qpos),
                      kv_len=torch.from_numpy(kv_len), **kw)
    np.testing.assert_allclose(_np(got), want, **F32_TOL)


def test_attention_plain_walk_and_oracle():
    """The plain version's own structure: against the f32 oracle
    ``ref.attention_ref`` (mixed f32 q with a bf16 cache included), the
    same bits twice, and rows whose block walk skips blocks (a window,
    a short kv_len) unchanged by the rows beside them."""
    q, k, v = _problem(21, B=3, Sq=9, Sk=90, KV=2, G=2, hd=24)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    qpos = torch.from_numpy(np.arange(81, 90, dtype=np.int32))
    kw = dict(causal=True, window=40, scale=0.2, cap=20.0)
    got = ops.mma_attention(tq, tk, tv, qpos=qpos, **kw)
    np.testing.assert_allclose(
        _np(got), _np(tref.attention_ref(tq, tk, tv, qpos=qpos, **kw)),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.mma_attention(tq, tk, tv, qpos=qpos, **kw))
    # a row alone gives the bits it gives beside others
    alone = ops.mma_attention(tq[:, 4:5], tk, tv, qpos=qpos[4:5], **kw)
    np.testing.assert_allclose(_np(alone), _np(got[:, 4:5]), rtol=1e-6,
                               atol=1e-6)
    kb, vb = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    kv_len = torch.tensor([90, 33, 1], dtype=torch.int32)
    mixed = ops.mma_attention(tq, kb, vb, qpos=qpos, kv_len=kv_len, **kw)
    assert mixed.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(mixed), _np(tref.attention_ref(tq, kb, vb, qpos=qpos,
                                           kv_len=kv_len, **kw)),
        rtol=2e-2, atol=2e-2)


# ------------------------------------------------ the attention op


def _op_problem(dtype: str, *, seed=3, cap=None):
    arrays = _problem(seed, B=2, Sq=20, Sk=37, KV=2, G=2, hd=16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    qpos = np.arange(20, dtype=np.int32) + 17
    common = dict(causal=True, window=12, scale=0.25, cap=cap, chunk=16)
    return ((jq, dict(k=jk, v=jv, qpos=jnp.asarray(qpos), **common)),
            (tq, dict(k=tk, v=tv, qpos=torch.from_numpy(qpos), **common)))


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ENGINES + ("pallas", "mma", "auto"))
def test_every_engine_matches_the_reference_dispatch(method, dtype, cap,
                                                     fresh_registries):
    (jq, jkw), (tq, tkw) = _op_problem(dtype, cap=cap)
    engine = td.op_spec("attention").engine(method)
    jmethod = "vpu" if method == "auto" else engine.name
    want = jd.dispatch("attention", jq, method=jmethod, **jkw)
    got = td.dispatch("attention", tq, method=method, **tkw)
    assert got.dtype == tq.dtype and got.shape == tuple(want.shape)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), err_msg=method, **tol)
    oracle = td.op_spec("attention").reference(tq, **tkw)
    np.testing.assert_allclose(_np(got), _np(oracle), err_msg=method, **tol)


def test_fully_masked_row_is_zero_in_every_engine():
    """A query row whose mask admits no key (position -1 under a causal
    mask) is exactly zero in all three engines, the others agree with
    the reference's oracle."""
    q, k, v = _problem(17, B=1, Sq=4, Sk=8, KV=1, G=1, hd=8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    qpos = np.asarray([-1, 0, 3, 7], np.int32)
    kw = dict(k=tk, v=tv, qpos=torch.from_numpy(qpos), causal=True,
              scale=0.3, chunk=4)
    want = _np(JA._direct_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        qpos=jnp.asarray(qpos), kpos=jnp.arange(8, dtype=jnp.int32),
        causal=True, window=None, kv_len=None, scale=0.3, cap=None))
    for method in ENGINES:
        o = td.dispatch("attention", tq, method=method, **kw)
        assert torch.all(torch.isfinite(o)), method
        assert torch.equal(o[0, 0], torch.zeros_like(o[0, 0])), method
        np.testing.assert_allclose(_np(o)[0, 1:], want[0, 1:], rtol=1e-5,
                                   atol=1e-5, err_msg=method)


def test_predicates_refuse_and_the_resolver_falls_back():
    q, k, v = _problem(5, B=2, Sq=1, Sk=24, KV=2, G=2, hd=16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    decode = dict(k=tk, v=tv, qpos=torch.tensor([[4], [9]]),
                  kv_len=torch.tensor([5, 10], dtype=torch.int32))
    with pytest.raises(ValueError, match="dynamic valid-length"):
        td.dispatch("attention", tq, method="unfused_mma", **decode)
    assert td.resolve_method("attention", tq, "unfused_mma",
                             **decode) == "vpu"
    assert td.supported_method("attention", tq, "fused_pallas", **decode)
    # fp16 operands: B9 takes f32 and bf16 only, q and k / v alike
    half = dict(decode, k=tk.half(), v=tv.half())
    with pytest.raises(ValueError, match="kernel B9 takes f32 and bf16"):
        td.dispatch("attention", tq, method="fused_pallas", **half)
    with pytest.raises(ValueError, match="dtype float16"):
        td.dispatch("attention", tq.half(), method="fused_pallas", **decode)
    assert td.resolve_method("attention", tq.half(), "fused_pallas",
                             **decode) == "vpu"
    # f32 activations against a bf16 cache: B9 serves the mixed form
    mixed = dict(decode, k=tk.bfloat16(), v=tv.bfloat16())
    assert td.supported_method("attention", tq, "fused_pallas", **mixed)
    got = td.dispatch("attention", tq, method="fused_pallas", **mixed)
    assert got.dtype == torch.bfloat16
    # head dims past the limit derived from B9's shared memory
    wide = td._FUSED_MAX_HEAD + 32
    assert ma.refusal(td._FUSED_MAX_HEAD, 256, ("float32",) * 3) is None
    assert ma.refusal(wide, 256, ("float32",) * 3) is not None
    qw = torch.zeros(1, 2, 1, 1, wide)
    kwide = dict(k=torch.zeros(1, 3, 1, wide), v=torch.zeros(1, 3, 1, 16),
                 qpos=torch.arange(2))
    with pytest.raises(ValueError, match=f"head dim {wide}"):
        td.dispatch("attention", qw, method="fused_pallas", **kwide)
    assert td.resolve_method("attention", qw, "pallas", **kwide) == "vpu"
    for hd, hd_v in ((256, 256), (128, 128), (192, 128)):
        for dts in (("float32",) * 3, ("bfloat16",) * 3,
                    ("float32", "bfloat16", "bfloat16")):
            assert ma.refusal(hd, hd_v, dts) is None, (hd, hd_v, dts)
    assert ma.refusal(256, 512, ("float32",) * 3) is not None


def test_auto_error_budget_picks(fresh_registries):
    """The reference's budget test at its prefill size (S = 256, hd = 64,
    causal): under 0.5 % auto plans B9; under 0.1 % too, where the
    reference (8-bit fused engines) fell back to vpu: the port's B9
    carries 21 bits in f32, a model error of ~2e-5 %."""
    S, hd = 256, 64
    q, k, v = _problem(19, B=1, Sq=S, KV=1, G=1, hd=hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(k=tk, v=tv, qpos=torch.arange(S), causal=True,
              scale=1.0 / np.sqrt(hd))
    want = _np(tref.attention_ref(tq, tk, tv, qpos=kw["qpos"], causal=True,
                                  scale=kw["scale"]))
    for budget in (0.5, 0.1):
        tat.reset_default_registry()
        got = td.dispatch("attention", tq, method="auto",
                          precision=MmaPolicy(error_budget_pct=budget), **kw)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
        plans = dict(tat.default_registry().items())
        keys = [key for key in plans if key.startswith("attention")]
        assert len(keys) == 1 and "prec:" in keys[0] \
            and "|form:" in keys[0], plans
        assert plans[keys[0]].method == "fused_pallas", plans
        assert plans[keys[0]].error_pct < 1e-3
    # bf16 caps every engine at 8 bits, 0.195 %: inside 0.5 %, and under
    # 0.1 % no engine fits, so auto takes the most accurate (all tie at 8
    # bits; the first, B9)
    bits = {m: tat._multiplicand_bits(tat.ReductionPlan(method=m),
                                      torch.bfloat16, "attention")
            for m in ENGINES}
    assert bits == dict.fromkeys(ENGINES, 8)
    form = (("kv_dtype", "bfloat16"),)
    assert tat._multiplicand_bits(tat.ReductionPlan(method="vpu"),
                                  torch.float32, "attention", form) == 8


def test_cost_model_prices_the_layer_shapes():
    """The model's picks at Gemma-2 2B's attention shapes (phase 3i of
    chip_smoke.py): B9 at prefill and decode; the engines' order as the
    runners count it (vpu materialises the scores, unfused_mma passes
    over them per chunk)."""
    cases = [
        (4096 * 8 * 4096, torch.float32,
         dict(causal=1, window=0, has_kv_len=0, rows=8192, sk=4096)),
        (8192 * 8 * 8192, torch.bfloat16,
         dict(causal=1, window=4096, has_kv_len=0, rows=16384, sk=8192)),
        (128 * 8 * 32768, torch.float32,
         dict(causal=0, window=0, has_kv_len=1, rows=2, sk=32768,
              kv_dtype="bfloat16")),
    ]
    for n, dt, extra in cases:
        form = tuple(dict(hd=256, hd_v=256, cap=1, **extra).items())
        cost = {m: tat.model_cost(tat.ReductionPlan(method=m, block_rows=512),
                                  n, dt, op="attention", form=form)
                for m in ENGINES}
        assert min(cost, key=cost.get) == "fused_pallas", (extra, cost)
        assert cost["unfused_mma"] > cost["vpu"] or extra["has_kv_len"]
    share = tat._attn_live_share
    assert share({"causal": 1, "sk": 4096}) == pytest.approx(0.5)
    assert share({"causal": 1, "window": 4096, "sk": 8192}) \
        == pytest.approx(0.375)
    assert share({"causal": 0, "sk": 8192}) == 1.0


# ---------------------------------------------- models.attention


@pytest.mark.parametrize("per_row,kv_len", [(False, None), (False, 19),
                                            (True, None), (True, "rows")])
def test_mask_matches_the_reference(per_row, kv_len):
    qpos = np.asarray([[3, 7, 30], [0, 12, 25]], np.int32) if per_row \
        else np.asarray([3, 7, 30], np.int32)
    kl = np.asarray([20, 9], np.int32) if kv_len == "rows" else kv_len
    for causal, window in ((True, None), (True, 8), (False, None)):
        want = JA._mask(jnp.asarray(qpos), jnp.arange(32), causal=causal,
                        window=window,
                        kv_len=None if kl is None else jnp.asarray(kl))
        got = TA._mask(torch.from_numpy(qpos), torch.arange(32),
                       causal=causal, window=window,
                       kv_len=None if kl is None else torch.as_tensor(kl))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_direct_chunked_and_banded_match_the_reference(dtype):
    arrays = _problem(23, B=2, Sq=24, KV=2, G=2, hd=16, hd_v=8)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    qpos = np.arange(24, dtype=np.int32)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for cap in (None, 20.0):
        kw = dict(causal=True, window=8, scale=0.25, cap=cap)
        want = JA._direct_attn(jq, jk, jv, qpos=jnp.asarray(qpos),
                               kpos=jnp.arange(24), kv_len=None, **kw)
        got = TA._direct_attn(tq, tk, tv, qpos=torch.from_numpy(qpos),
                              kpos=torch.arange(24), kv_len=None, **kw)
        assert got.dtype == tv.dtype
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        want = JA._chunked_attn(jq, jk, jv, qpos=jnp.asarray(qpos),
                                chunk=10, **kw)
        got = TA._chunked_attn(tq, tk, tv, qpos=torch.from_numpy(qpos),
                               chunk=10, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        want = JA._banded_local_attn(jq, jk, jv, window=8, scale=0.25,
                                     cap=cap)
        got = TA._banded_local_attn(tq, tk, tv, window=8, scale=0.25,
                                    cap=cap)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        # the band is the masked form, as the reference says
        np.testing.assert_allclose(
            _np(got), _np(TA._direct_attn(
                tq, tk, tv, qpos=torch.from_numpy(qpos),
                kpos=torch.arange(24), kv_len=None, **kw)), **tol)


ARCHS = (("gemma2-2b", "global"), ("gemma2-2b", "local"),
         ("gemma3-27b", "global"), ("glm4-9b", "global"))


def _configs(arch: str, method: str):
    jcfg = dataclasses.replace(jreg.get_config(arch, smoke=True),
                               attn_method=method)
    tcfg = dataclasses.replace(treg.get_config(arch, smoke=True),
                               attn_method=method)
    return jcfg, tcfg


def _params(jcfg, seed: int, **kw):
    """The reference's parameters (zero-initialised norms and biases
    drawn at random), as (jax, torch on the CPU)."""
    jparams = JP.init_tree(jax.random.PRNGKey(seed),
                           JA.attn_specs(jcfg, **kw))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in jparams:
            jparams[name] = jnp.asarray(
                0.3 * rng.standard_normal(jparams[name].shape)
                .astype(np.float32))
    tparams = TP.from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                            device="cpu")
    return jparams, tparams


def _close(got, want, dtype, what):
    tol = F32_TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


@pytest.mark.parametrize("method", ["", "fused_pallas", "unfused_mma", "vpu",
                                    "auto"])
@pytest.mark.parametrize("arch,kind", ARCHS)
def test_attention_layer_matches_the_reference(arch, kind, method):
    """Prefill into a cache, three scalar-idx decode steps, then a
    prefill longer than a fresh cache's capacity (the rolled tail)."""
    jcfg, tcfg = _configs(arch, method)
    jparams, tparams = _params(jcfg, 31)
    B, S, cap, d = 2, 12, 16, jcfg.d_model
    rng = np.random.default_rng(41)
    x = rng.standard_normal((B, S + 3, d)).astype(np.float32)
    jcache = JA.make_cache(jcfg, B, cap, dtype=jnp.float32)
    tcache = TA.make_cache(tcfg, B, cap, dtype=torch.float32, device="cpu")
    kw = dict(kind=kind)
    jo, jcache = JA.attention(jparams, jcfg, jnp.asarray(x[:, :S]),
                              positions=jnp.arange(S), cache=jcache, **kw)
    to, tcache = TA.attention(tparams, tcfg, torch.from_numpy(x[:, :S]),
                              positions=torch.arange(S), cache=tcache, **kw)
    _close(to, jo, "float32", f"{arch} {kind} prefill")
    for step in range(S, S + 3):
        xs = x[:, step:step + 1]
        jo, jcache = JA.attention(jparams, jcfg, jnp.asarray(xs),
                                  positions=jnp.asarray([step]),
                                  cache=jcache, decode=True, **kw)
        to, tcache = TA.attention(tparams, tcfg, torch.from_numpy(xs),
                                  positions=torch.tensor([step]),
                                  cache=tcache, decode=True, **kw)
        _close(to, jo, "float32", f"{arch} {kind} decode {step}")
        assert int(tcache["idx"]) == int(jcache["idx"]) == step + 1
        np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]),
                                   rtol=1e-5, atol=1e-5)
    # prefill past the capacity: the cache keeps the rolled tail
    small = 8
    jc = JA.make_cache(jcfg, B, small, dtype=jnp.float32)
    tc = TA.make_cache(tcfg, B, small, dtype=torch.float32, device="cpu")
    jo, jc = JA.attention(jparams, jcfg, jnp.asarray(x[:, :S]),
                          positions=jnp.arange(S), cache=jc, **kw)
    to, tc = TA.attention(tparams, tcfg, torch.from_numpy(x[:, :S]),
                          positions=torch.arange(S), cache=tc, **kw)
    _close(to, jo, "float32", f"{arch} {kind} long prefill")
    np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["", "fused_pallas", "vpu", "auto"])
@pytest.mark.parametrize("arch,kind", ARCHS[:2])
def test_attention_per_row_decode_matches_the_reference(arch, kind, method,
                                                        dtype):
    """Continuous batching: every slot at its own position, one-hot ring
    writes, a bf16 cache beside f32 or bf16 activations."""
    jcfg, tcfg = _configs(arch, method)
    jparams, tparams = _params(jcfg, 37)
    B, cap, d = 3, 16, jcfg.d_model
    rng = np.random.default_rng(43)
    ck = rng.standard_normal((B, cap, jcfg.num_kv_heads, jcfg.head_dim))
    cv = rng.standard_normal(ck.shape)
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    pos = np.asarray([[2], [15], [21]], np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jcache = {"k": jnp.asarray(ck, jnp.float32).astype(jnp.bfloat16),
              "v": jnp.asarray(cv, jnp.float32).astype(jnp.bfloat16),
              "idx": jnp.zeros((), jnp.int32)}
    tcache = {"k": torch.from_numpy(ck).float().bfloat16(),
              "v": torch.from_numpy(cv).float().bfloat16(),
              "idx": torch.zeros((), dtype=torch.int32)}
    jo, jc = JA.attention(jparams, jcfg, jnp.asarray(x).astype(jdt),
                          positions=jnp.asarray(pos), cache=jcache,
                          decode=True, kind=kind)
    to, tc = TA.attention(tparams, tcfg, torch.from_numpy(x).to(tdt),
                          positions=torch.from_numpy(pos), cache=tcache,
                          decode=True, kind=kind)
    assert to.dtype == tdt
    _close(to, jo, "bfloat16", f"{arch} {kind} per-row decode {method}")
    assert torch.equal(tc["k"].float(),
                       torch.from_numpy(np.asarray(jc["k"], np.float32)))


@pytest.mark.parametrize("method", ["", "fused_pallas", "vpu"])
def test_cross_attention_matches_the_reference(method):
    """Llama-3.2 Vision's cross layer: keys and values from the vision
    memory, cached at prefill and read back at decode."""
    jcfg, tcfg = _configs("llama-3.2-vision-90b", method)
    jparams, tparams = _params(jcfg, 47)
    B, S, M, d = 2, 5, jcfg.vision_tokens, jcfg.d_model
    rng = np.random.default_rng(53)
    x = rng.standard_normal((B, S + 1, d)).astype(np.float32)
    mem = rng.standard_normal((B, M, d)).astype(np.float32)
    jo, jc = JA.attention(jparams, jcfg, jnp.asarray(x[:, :S]),
                          positions=jnp.arange(S), kind="cross",
                          memory=jnp.asarray(mem), cache={})
    to, tc = TA.attention(tparams, tcfg, torch.from_numpy(x[:, :S]),
                          positions=torch.arange(S), kind="cross",
                          memory=torch.from_numpy(mem), cache={})
    _close(to, jo, "float32", f"cross prefill {method}")
    jo, _ = JA.attention(jparams, jcfg, jnp.asarray(x[:, S:]),
                         positions=jnp.asarray([S]), kind="cross",
                         cache=jc, decode=True)
    to, _ = TA.attention(tparams, tcfg, torch.from_numpy(x[:, S:]),
                         positions=torch.tensor([S]), kind="cross",
                         cache=tc, decode=True)
    _close(to, jo, "float32", f"cross decode {method}")


def test_attention_layer_shapes_and_cache_defaults():
    """Specs and cache axes as the reference declares them; make_cache on
    no device raises here, as every entry point does without a card."""
    for arch in ("gemma2-2b", "glm4-9b", "gemma3-27b"):
        jcfg, tcfg = _configs(arch, "")
        jspecs, tspecs = JA.attn_specs(jcfg), TA.attn_specs(tcfg)
        assert sorted(jspecs) == sorted(tspecs)
        for name in jspecs:
            assert tuple(jspecs[name].shape) == tuple(tspecs[name].shape)
            assert jspecs[name].axes == tspecs[name].axes
    assert TA.cache_axes() == JA.cache_axes()
    cache = TA.make_cache(tcfg, 2, 8, device="cpu")
    assert cache["k"].dtype == torch.bfloat16 and cache["k"].shape == (
        2, 8, tcfg.num_kv_heads, tcfg.head_dim)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TA.make_cache(tcfg, 2, 8)


@pytest.mark.parametrize("has_kv_len", [0, 1])
def test_measured_autotune_builds_the_calls_form(has_kv_len,
                                                 fresh_registries):
    """The measured sweep (CPU timings here) builds its problem from the
    call's form (``dispatch._measure_attention``): the form's head dims,
    rows, keys and dynamic kv_len, and times every legal engine."""
    q, k, v = _problem(29, B=2, Sq=4 if has_kv_len else 12, Sk=12, KV=1,
                       G=1, hd=16, hd_v=8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(k=tk, v=tv, qpos=torch.arange(8, 12 if has_kv_len else 20)
              [:tq.shape[1]], causal=not has_kv_len, scale=0.25)
    if has_kv_len:
        kw["kv_len"] = torch.tensor([12, 7], dtype=torch.int32)
    spec = td.op_spec("attention")
    form = spec.problem_form(tq, kw)
    assert dict(form)["has_kv_len"] == has_kv_len
    x, mkw = td._measure_attention(spec.problem_size(tq, kw), "float32",
                                   np.random.default_rng(0), "cpu",
                                   **dict(form))
    assert spec.problem_form(x, mkw) == form
    engines = ("fused_pallas", "vpu") if has_kv_len else ENGINES
    plan = tat.get_plan(spec.problem_size(tq, kw), torch.float32,
                        op="attention", measure=True, backend="cpu",
                        engine=engines, form=form)
    assert plan.source == "measured" and plan.method in engines
