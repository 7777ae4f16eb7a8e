"""The port's model layers (``repro_torch.models.layers``), parameter
declaration (``models.param``) and one-device sharding
(``distributed.sharding``) against the JAX package's, on the CPU.

Parameters are made by ``repro.models.param.init_tree`` and carried
across with ``repro_torch.models.param.from_numpy``; inputs come from
numpy seeds.  Tolerances: f32 at rtol 1e-5 / atol 1e-5 (the reference's
own for its norm, ``tests/test_dispatch.py``: both packages round the
same f32 steps, a few of them in another order); bf16 outputs within one
bf16 ulp of the reference (the two may fall on either side of a
rounding boundary).  The ``global_norm`` repair sits here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integration as ji
from repro.distributed import sharding as jshd
from repro.models import layers as JL
from repro.models import param as JP
from repro_torch.core import integration as ti
from repro_torch.core import precision as tp
from repro_torch.distributed import sharding as tshd
from repro_torch.models import layers as TL
from repro_torch.models import param as TP

F32_TOL = dict(rtol=1e-5, atol=1e-5)
RMSNORM_SPELLINGS = ("mma", "vpu", "pallas", "mma_chained", "fused_pallas",
                     "unfused_mma", "auto")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _bridge(jtree):
    return TP.from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                         device="cpu")


def _within_bf16_ulp(got, want):
    got, want = _np(got), _np(want)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), \
        float(np.max(np.abs(got - want) / ulp))


def _close(got, want, dtype):
    if dtype == "bfloat16":
        _within_bf16_ulp(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def _pair(x: np.ndarray, dtype: str = "float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(
        tp.as_dtype(dtype))


def _norm_params(d: int, seed: int):
    rng = np.random.default_rng(seed)
    jparams = {"scale": jnp.asarray(
        (0.1 * rng.normal(size=d)).astype(np.float32))}
    return jparams, _bridge(jparams)


# ------------------------------------------------- global_norm repair


def test_global_norm_skips_none_leaves_as_the_reference():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    jtree = {"a": jnp.asarray(x[:10]), "b": [jnp.asarray(x[10:20]), None]}
    ttree = {"a": torch.from_numpy(x[:10]),
             "b": [torch.from_numpy(x[10:20]), None]}
    want = float(ji.global_norm(jtree))
    got = float(ti.global_norm(ttree))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, 3.8924124, rtol=1e-6)
    # A tree without a tensor has norm 0.
    assert float(ti.global_norm({"frozen": None, "b": []})) == 0.0


# ----------------------------------------------------------- param


def _specs():
    return {"norm": JL.rmsnorm_specs(24), "mlp": JL.mlp_specs(24, 40),
            "embed": JL.embed_specs(50, 24),
            "ln": JL.layernorm_specs(24)}


def _tspecs():
    return {"norm": TL.rmsnorm_specs(24), "mlp": TL.mlp_specs(24, 40),
            "embed": TL.embed_specs(50, 24),
            "ln": TL.layernorm_specs(24)}


def test_param_trees_match_the_reference():
    jspecs, tspecs = _specs(), _tspecs()
    assert TP.axes_tree(tspecs) == JP.axes_tree(jspecs)
    jshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                     JP.shapes_tree(jspecs))
    tshapes = TP._map(lambda sd: sd.shape, TP.shapes_tree(tspecs))
    assert tshapes == jshapes
    jstack, tstack = JP.stack_specs(jspecs, 3), TP.stack_specs(tspecs, 3)
    assert TP.axes_tree(tstack) == JP.axes_tree(jstack)
    gen = torch.Generator().manual_seed(0)
    tparams = TP.init_tree(gen, tspecs, device="cpu")
    jparams = JP.init_tree(jax.random.PRNGKey(0), jspecs)
    assert TP.count_params(tparams) == JP.count_params(jparams) \
        == 24 + 3 * 24 * 40 + 50 * 24 + 2 * 24
    assert TP.count_params(_bridge(jparams)) == JP.count_params(jparams)
    stacked = TP.init_stacked(gen, tspecs, 3, device="cpu")
    assert TP.count_params(stacked) == 3 * JP.count_params(jparams)
    assert stacked["mlp"]["wo"].shape == (3, 40, 24)


def test_param_init_draws_what_it_declares():
    specs = _tspecs()
    params = TP.init_tree(torch.Generator().manual_seed(1), specs,
                          device="cpu")
    assert torch.equal(params["norm"]["scale"], torch.zeros(24))
    assert torch.equal(params["ln"]["scale"], torch.ones(24))
    assert all(t.dtype == torch.float32 for t in
               (params["mlp"]["wo"], params["embed"]["table"]))
    # fan_in: std 1 / sqrt(24); embed: std 24^-0.5.
    for t in (params["mlp"]["wi_up"], params["embed"]["table"]):
        assert abs(float(t.std()) * 24 ** 0.5 - 1.0) < 0.15
    again = TP.init_tree(torch.Generator().manual_seed(1), specs,
                         device="cpu")
    assert torch.equal(again["mlp"]["wo"], params["mlp"]["wo"])


def test_from_numpy_bridges_bf16_and_casts():
    a = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3))
    got = TP.from_numpy({"a": np.asarray(a.astype(jnp.bfloat16)),
                         "b": [np.asarray(a)]}, device="cpu")
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"].float(), torch.from_numpy(np.array(a)))
    cast = TP.from_numpy({"b": [np.asarray(a)]}, device="cpu",
                         dtype=torch.bfloat16)
    assert cast["b"][0].dtype == torch.bfloat16


def test_from_numpy_without_a_device_needs_the_card():
    """The bridge's default is the card, and with no card it raises as
    ``dispatch.as_tensor`` does instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bare call lands on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.from_numpy({"a": np.zeros(3, np.float32)})


# -------------------------------------------------------- sharding


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.ones(2, 3, 4)
    assert tshd.current_mesh() is None
    assert tshd.constrain(x, ("batch", "seq", None)) is x
    with tshd.axis_rules(None):
        assert tshd.constrain(x, ("batch", "seq", None)) is x
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES


def test_axis_rules_with_a_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="item 14"):
        with tshd.axis_rules(object()):
            pass
    assert tshd.current_mesh() is None


# ---------------------------------------------------------- norms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", RMSNORM_SPELLINGS)
def test_rmsnorm_every_spelling_matches_the_reference(method, dtype,
                                                      fresh_plan_registry):
    x = np.random.default_rng(21).normal(size=(4, 16, 40)).astype(
        np.float32)
    jparams, tparams = _norm_params(40, 22)
    jx, tx = _pair(x, dtype)
    got = TL.rmsnorm(tparams, tx, method=method)
    want = JL.rmsnorm(jparams, jx, method=method)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)


def test_rmsnorm_ablation_engines_fall_back():
    # tests/test_dispatch.py: the flatten-only engines fall back to vpu.
    x = np.random.default_rng(21).normal(size=(4, 16, 32)).astype(
        np.float32)
    tx = torch.from_numpy(x)
    params = {"scale": torch.zeros(32)}
    want = TL.rmsnorm(params, tx, method="vpu")
    for ablation in ("pallas", "mma_chained"):
        np.testing.assert_allclose(_np(TL.rmsnorm(params, tx,
                                                  method=ablation)),
                                   _np(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(TL.rmsnorm(params, tx, method="mma")),
                               _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_fast_apply_and_apply_norm(dtype):
    x = np.random.default_rng(3).normal(size=(2, 5, 24)).astype(np.float32)
    jparams, tparams = _norm_params(24, 4)
    jx, tx = _pair(x, dtype)
    _close(TL.rmsnorm(tparams, tx, fast_apply=True),
           JL.rmsnorm(jparams, jx, fast_apply=True), dtype)
    _close(TL.apply_norm(tparams, tx), JL.apply_norm(jparams, jx), dtype)
    lp = {"scale": jnp.asarray(1.0 + 0.1 * np.random.default_rng(5)
                               .normal(size=24).astype(np.float32)),
          "bias": jnp.asarray(0.1 * np.random.default_rng(6)
                              .normal(size=24).astype(np.float32))}
    _close(TL.apply_norm(_bridge(lp), tx, kind="layernorm"),
           JL.apply_norm(lp, jx, kind="layernorm"), dtype)


def test_rmsnorm_refuses_a_policy_no_engine_can_honour():
    # tests/test_precision.py: split words on a per-row statistic.
    params = {"scale": torch.zeros(256)}
    with pytest.raises(ValueError, match="no engine"):
        TL.rmsnorm(params, torch.ones(4, 256),
                   precision=tp.MmaPolicy(split_words=2))


# ------------------------------------------------------------- MLP


def _mlp_params(d: int, d_ff: int, seed: int):
    jparams = JP.init_tree(jax.random.PRNGKey(seed), JL.mlp_specs(d, d_ff))
    return jparams, _bridge(jparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_the_reference(act, dtype):
    x = np.random.default_rng(7).normal(size=(2, 3, 24)).astype(np.float32)
    jp_, tp_ = _mlp_params(24, 40, 8)
    jx, tx = _pair(x, dtype)
    for bf16_out in (False, True):
        got = TL.mlp(tp_, tx, act=act, bf16_out=bf16_out)
        want = JL.mlp(jp_, jx, act=act, bf16_out=bf16_out)
        assert got.dtype == tx.dtype
        if dtype == "bfloat16":
            # The packages round the bf16 gate, act and product at other
            # places (torch's silu / gelu take one rounding, JAX's
            # several), so each hidden value h may differ by a couple of
            # bf16 ulps; the down projection then sums them: |diff| <=
            # 2^-6 * (|h| @ |wo|) per output, plus the output's own ulp.
            xf = x.astype(np.float32)
            g = xf @ np.asarray(jp_["wi_gate"])
            hmag = np.abs(g) * np.abs(xf @ np.asarray(jp_["wi_up"]))
            bound = 2.0 ** -6 * (hmag @ np.abs(np.asarray(jp_["wo"])))
            diff = np.abs(_np(got) - _np(want))
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                np.abs(_np(want)), 1e-30))) - 7)
            assert np.all(diff <= bound + ulp), float(np.max(diff - bound))
        else:
            np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("method", ["fused_pallas", "unfused_mma", "vpu",
                                    "auto"])
def test_fused_mlp_and_norm_matmul_match_the_reference(method,
                                                       fresh_plan_registry):
    x = np.random.default_rng(9).normal(size=(2, 3, 24)).astype(np.float32)
    jn, tn = _norm_params(24, 10)
    jm, tm = _mlp_params(24, 40, 11)
    jx, tx = _pair(x)
    got = TL.fused_mlp(tn, tm, tx, act="gelu", method=method)
    want = JL.fused_mlp(jn, jm, jx, act="gelu", method=method
                        if method != "auto" else "unfused_mma")
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # Drop-in for mlp(rmsnorm(x)).
    np.testing.assert_allclose(
        _np(got), _np(TL.mlp(tm, TL.rmsnorm(tn, tx), act="gelu")), **F32_TOL)
    got = TL.norm_matmul(tn, tx, tm["wi_up"], bias=tm["wo"][:, 0],
                         method=method)
    want = JL.norm_matmul(jn, jx, jm["wi_up"], bias=jm["wo"][:, 0],
                          method="vpu")
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# ---------------------------------------------------------- embeds


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("onehot", [False, True])
def test_embed_lookup_and_unembed_match_the_reference(onehot, compute):
    jparams = JP.init_tree(jax.random.PRNGKey(12), JL.embed_specs(50, 24))
    tparams = _bridge(jparams)
    tokens = np.random.default_rng(13).integers(0, 50, (2, 7)).astype(
        np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    for scale in (False, True):
        got = TL.embed_lookup(tparams, torch.from_numpy(tokens), scale=scale,
                              d=24, compute_dtype=tp.as_dtype(compute),
                              onehot=onehot)
        want = JL.embed_lookup(jparams, jnp.asarray(tokens), scale=scale,
                               d=24, compute_dtype=jdt, onehot=onehot)
        assert got.shape == (2, 7, 24) and got.dtype == tp.as_dtype(compute)
        _close(got, want, compute)
    x = np.random.default_rng(14).normal(size=(2, 7, 24)).astype(np.float32)
    jx, tx = _pair(x)
    for cap in (None, 5.0):
        np.testing.assert_allclose(
            _np(TL.unembed(tparams, tx, softcap=cap)),
            _np(JL.unembed(jparams, jx, softcap=cap)), **F32_TOL)


# ------------------------------------------------------------ RoPE


@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_apply_rope_matches_the_reference(fraction):
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(6), np.arange(6) + 100]).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta=10000.0, fraction=fraction)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0,
                         fraction=fraction)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    cos, sin = TL.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(_np(cos), _np(jcos), **F32_TOL)
    np.testing.assert_allclose(_np(sin), _np(jsin), **F32_TOL)
    assert TL.apply_rope(torch.from_numpy(x)[..., :1],
                         torch.from_numpy(pos), theta=1e4).shape \
        == (2, 6, 3, 1)


def test_softcap_matches_the_reference():
    x = np.random.default_rng(16).normal(size=(3, 9)).astype(np.float32) * 40
    np.testing.assert_allclose(_np(TL.softcap(torch.from_numpy(x), 30.0)),
                               _np(JL.softcap(jnp.asarray(x), 30.0)),
                               **F32_TOL)
    t = torch.from_numpy(x)
    assert TL.softcap(t, None) is t
