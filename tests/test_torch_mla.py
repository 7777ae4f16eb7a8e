"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's, on the CPU, at the reduced DeepSeek-V3 shape
(``configs/deepseek_v3_671b.py`` SMOKE).

Parameters come from the reference's ``init_tree`` and are carried across
with ``models.param.from_numpy``; inputs are numpy draws from a seed.
Covered: the expanded (prefill) form with and without a cache, the
absorbed (decode) form at a scalar and at per-row positions (one of them
past the cache, which writes nothing), each with the plain query chain
and with ``norm_matmul_method`` set ('unfused_mma', and 'fused_pallas':
the reference's kernel in interpret mode, the port's B10 plain version);
the cache's contents after every write; specs, caches and axes.

Tolerances: with ``compute_dtype`` f32 and f32 caches in both packages,
1e-4 of max|ref| (both round the same f32 steps, some in another
order); in bf16 the reference's own model bound, max|got - ref| <
0.05 (max|ref| + 1) (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import mla as JM
from repro.models import param as JP
from repro_torch.configs import registry as TR
from repro_torch.models import mla as TM
from repro_torch.models import param as TP

ARCH = "deepseek-v3-671b"
B, S, CAP = 2, 12, 16
NM_METHODS = ("", "unfused_mma", "fused_pallas")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _bridge(jtree):
    return TP.from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                         device="cpu")


def _cfgs(dtype: str, **kw):
    jcfg = dataclasses.replace(JR.get_config(ARCH, smoke=True),
                               compute_dtype=getattr(jnp, dtype), **kw)
    tcfg = dataclasses.replace(TR.get_config(ARCH, smoke=True),
                               compute_dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _close(got, want, dtype: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = float(np.max(np.abs(got - want)))
    if dtype == "float32":
        assert diff <= 1e-4 * float(np.max(np.abs(want))), diff
    else:
        assert diff < 0.05 * (float(np.max(np.abs(want))) + 1.0), diff


def _setup(dtype: str, nm: str, seed: int = 0):
    jcfg, tcfg = _cfgs(dtype, norm_matmul_method=nm)
    jparams = JP.init_tree(jax.random.PRNGKey(seed), JM.mla_specs(jcfg))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S + 1, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, _bridge(jparams), x


def _pair(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _caches(jcfg, tcfg, dtype: str):
    return (JM.make_cache(jcfg, B, CAP, dtype=getattr(jnp, dtype)),
            TM.make_cache(tcfg, B, CAP, dtype=getattr(torch, dtype),
                          device="cpu"))


def _same_cache(tc, jc, dtype: str):
    for key in ("ckv", "krope"):
        _close(tc[key], jc[key], dtype)
    assert int(tc["idx"]) == int(jc["idx"])


def test_specs_caches_and_axes_match_the_reference():
    jcfg, tcfg = _cfgs("float32")
    jspecs, tspecs = JM.mla_specs(jcfg), TM.mla_specs(tcfg)
    assert sorted(jspecs) == sorted(tspecs)
    for key in jspecs:
        assert tuple(tspecs[key].shape) == tuple(jspecs[key].shape)
        assert tspecs[key].axes == jspecs[key].axes
        assert tspecs[key].init == jspecs[key].init
    jc, tc = JM.make_cache(jcfg, B, CAP), TM.make_cache(tcfg, B, CAP,
                                                        device="cpu")
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
    assert tc["ckv"].dtype == torch.bfloat16
    assert TM.cache_axes() == JM.cache_axes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nm", NM_METHODS)
def test_expanded_form_matches_the_reference(dtype, nm):
    jcfg, tcfg, jp, tp, x = _setup(dtype, nm)
    jx, tx = _pair(x[:, :S], dtype)
    want, _ = JM.mla_attention(jp, jcfg, jx, positions=jnp.arange(S))
    got, cache = TM.mla_attention(tp, tcfg, tx, positions=torch.arange(S))
    assert cache is None and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nm", NM_METHODS)
def test_prefill_then_decode_at_a_scalar_position(dtype, nm):
    """Prefill writes the cache in place (the returned dict holds the
    same tensors); the absorbed decode step at position S matches."""
    jcfg, tcfg, jp, tp, x = _setup(dtype, nm, seed=1)
    jc, tc = _caches(jcfg, tcfg, dtype)
    jx, tx = _pair(x, dtype)
    want, jc = JM.mla_attention(jp, jcfg, jx[:, :S],
                                positions=jnp.arange(S), cache=jc)
    ckv = tc["ckv"]
    got, tc = TM.mla_attention(tp, tcfg, tx[:, :S],
                               positions=torch.arange(S), cache=tc)
    assert tc["ckv"] is ckv
    _close(got, want, dtype)
    _same_cache(tc, jc, dtype)
    want, jc = JM.mla_attention(jp, jcfg, jx[:, S:],
                                positions=jnp.asarray([S]), cache=jc,
                                decode=True)
    got, tc = TM.mla_attention(tp, tcfg, tx[:, S:],
                               positions=torch.tensor([S]), cache=tc,
                               decode=True)
    _close(got, want, dtype)
    _same_cache(tc, jc, dtype)


@pytest.mark.parametrize("nm", NM_METHODS)
@pytest.mark.parametrize("rows", [(S, 5), (CAP, 3)])
def test_decode_at_per_row_positions(nm, rows):
    """Continuous batching: each row writes its own slot; a row at a
    position past the cache writes nothing and still attends over its
    valid slots."""
    dtype = "float32"
    jcfg, tcfg, jp, tp, x = _setup(dtype, nm, seed=2)
    jc, tc = _caches(jcfg, tcfg, dtype)
    jx, tx = _pair(x, dtype)
    _, jc = JM.mla_attention(jp, jcfg, jx[:, :S], positions=jnp.arange(S),
                             cache=jc)
    _, tc = TM.mla_attention(tp, tcfg, tx[:, :S],
                             positions=torch.arange(S), cache=tc)
    pos = np.asarray(rows, np.int32)[:, None]
    want, jc = JM.mla_attention(jp, jcfg, jx[:, S:],
                                positions=jnp.asarray(pos), cache=jc,
                                decode=True)
    got, tc = TM.mla_attention(tp, tcfg, tx[:, S:],
                               positions=torch.from_numpy(pos), cache=tc,
                               decode=True)
    _close(got, want, dtype)
    _same_cache(tc, jc, dtype)


def test_per_row_positions_refused_at_prefill():
    _, tcfg, _, tp, x = _setup("float32", "")
    with pytest.raises(ValueError, match="per-row"):
        TM.mla_attention(tp, tcfg, torch.from_numpy(x[:, :S]),
                         positions=torch.zeros((B, S), dtype=torch.int32))


def test_absorbed_scores_accumulate_in_f32():
    """The absorbed form's score and context products return f32 for
    bf16 operands (the reference's preferred_element_type): a decode
    step in bf16 against an f32 cache reads the same as the reference's
    within the bf16 bound, and its output stays bf16."""
    dtype = "bfloat16"
    jcfg, tcfg, jp, tp, x = _setup(dtype, "", seed=3)
    jc = JM.make_cache(jcfg, B, CAP, dtype=jnp.float32)
    tc = TM.make_cache(tcfg, B, CAP, dtype=torch.float32, device="cpu")
    jx, tx = _pair(x, dtype)
    _, jc = JM.mla_attention(jp, jcfg, jx[:, :S], positions=jnp.arange(S),
                             cache=jc)
    _, tc = TM.mla_attention(tp, tcfg, tx[:, :S],
                             positions=torch.arange(S), cache=tc)
    want, _ = JM.mla_attention(jp, jcfg, jx[:, S:],
                               positions=jnp.asarray([S]), cache=jc,
                               decode=True)
    got, _ = TM.mla_attention(tp, tcfg, tx[:, S:],
                              positions=torch.tensor([S]), cache=tc,
                              decode=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, dtype)
