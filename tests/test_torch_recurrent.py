"""The port's recurrent mixers against the JAX package's, on the CPU:
RWKV-6's time mix and channel mix (``repro_torch.models.rwkv6``) with
both WKV forms, and RecurrentGemma's RG-LRU block
(``repro_torch.models.rglru``), at the reduced shapes of
``configs/rwkv6_7b.py`` and ``configs/recurrentgemma_2b.py`` (SMOKE).

Parameters come from the reference's ``init_tree`` (carried across with
``models.param.from_numpy``); inputs and states are numpy draws from a
seed.  Tolerances: the WKV recurrences, all f32, to 2e-5 relative and
absolute (the reference's own bound between its two forms,
``tests/test_rwkv_chunked.py``: the chunked form's prefix decays are a
log-space triangular-MMA scan); the mixers with ``compute_dtype`` f32 to
1e-4 of max|ref| (both round the same f32 steps, some in another
order); in bf16 the reference's model bound, max|got - ref| < 0.05
(max|ref| + 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import param as JP
from repro.models import rglru as JRG
from repro.models import rwkv6 as JRW
from repro_torch.configs import registry as TR
from repro_torch.models import param as TP
from repro_torch.models import rglru as TRG
from repro_torch.models import rwkv6 as TRW

WKV_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _t(a: np.ndarray, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(got, want, dtype: str = "float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = float(np.max(np.abs(got - want)))
    if dtype == "float32":
        assert diff <= 1e-4 * float(np.max(np.abs(want))), diff
    else:
        assert diff < 0.05 * (float(np.max(np.abs(want))) + 1.0), diff


def _cfgs(arch: str, dtype: str = "float32", **kw):
    return (dataclasses.replace(JR.get_config(arch, smoke=True),
                                compute_dtype=getattr(jnp, dtype), **kw),
            dataclasses.replace(TR.get_config(arch, smoke=True),
                                compute_dtype=getattr(torch, dtype), **kw))


def _params(specs_fn, jcfg, seed: int):
    jp = JP.init_tree(jax.random.PRNGKey(seed), specs_fn(jcfg))
    return jp, TP.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


def _wkv_inputs(seed: int, B=2, S=32, N=3, hs=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, N, hs)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.2, 0.999, size=(B, S, N, hs)).astype(np.float32)
    u = (rng.normal(size=(N, hs)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(B, N, hs, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


# ------------------------------------------------------------ RWKV-6


def test_wkv_scan_matches_the_reference():
    args = _wkv_inputs(0)
    jy, js = JRW._wkv_scan(*map(jnp.asarray, args), unroll_below=0)
    ty, ts = TRW._wkv_scan(*map(_t, args))
    np.testing.assert_allclose(_np(ty), _np(jy), **WKV_TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **WKV_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_wkv_chunked_matches_the_reference_and_the_scan(chunk):
    args = _wkv_inputs(chunk)
    jy, js = JRW._wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, ts = TRW._wkv_chunked(*map(_t, args), chunk=chunk)
    np.testing.assert_allclose(_np(ty), _np(jy), **WKV_TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **WKV_TOL)
    sy, ss = TRW._wkv_scan(*map(_t, args))
    np.testing.assert_allclose(_np(ty), _np(sy), **WKV_TOL)
    np.testing.assert_allclose(_np(ts), _np(ss), **WKV_TOL)


def _rwkv_state(cfg, B: int, seed: int):
    """A nonzero carried-in state (the reference's layout)."""
    rng = np.random.default_rng(seed)
    n, hs = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    return {"wkv": (rng.normal(size=(B, n, hs, hs)) * 0.1).astype(
                np.float32),
            "x_tm": rng.normal(size=(B, cfg.d_model)).astype(np.float32),
            "x_cm": rng.normal(size=(B, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("S,rwkv_chunk", [(16, 0), (16, 4), (1, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_the_reference(S, rwkv_chunk, dtype):
    """A prefill (sequential or chunked WKV) or a one-token decode step
    from a carried-in state: outputs and new states."""
    jcfg, tcfg = _cfgs("rwkv6-7b", dtype, rwkv_chunk=rwkv_chunk)
    B = 2
    x = np.random.default_rng(5).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    state = _rwkv_state(jcfg, B, 6)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    tst = {k: _t(v) for k, v in state.items()}

    jp, tp = _params(JRW.timemix_specs, jcfg, 1)
    jo, jns = JRW.time_mix(jp, jcfg, jnp.asarray(x, jdt), jst)
    to, tns = TRW.time_mix(tp, tcfg, _t(x, tdt), tst)
    assert to.dtype == tdt
    _close(to, jo, dtype)
    for key in ("wkv", "x_tm"):
        _close(tns[key], jns[key], dtype)

    jp, tp = _params(JRW.chanmix_specs, jcfg, 2)
    jo, jns = JRW.channel_mix(jp, jcfg, jnp.asarray(x, jdt), jst)
    to, tns = TRW.channel_mix(tp, tcfg, _t(x, tdt), tst)
    _close(to, jo, dtype)
    _close(tns["x_cm"], jns["x_cm"], dtype)


def test_group_norm_matches_the_reference():
    rng = np.random.default_rng(7)
    y = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3.0
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    want = JRW._group_norm(jnp.asarray(y), jnp.asarray(scale),
                           jnp.asarray(bias), 4)
    got = TRW._group_norm(_t(y), _t(scale), _t(bias), 4)
    _close(got, want)


@pytest.mark.parametrize("arch,mod_j,mod_t", [
    ("rwkv6-7b", JRW, TRW), ("recurrentgemma-2b", JRG, TRG)])
def test_states_and_axes_match_the_reference(arch, mod_j, mod_t):
    jcfg, tcfg = _cfgs(arch)
    js = mod_j.make_state(jcfg, 3, dtype=jnp.bfloat16)
    ts = mod_t.make_state(tcfg, 3, dtype=torch.bfloat16, device="cpu")
    assert sorted(js) == sorted(ts)
    for key in js:
        assert tuple(ts[key].shape) == tuple(js[key].shape)
        assert str(ts[key].dtype).removeprefix("torch.") \
            == str(js[key].dtype)
    assert mod_t.state_axes() == mod_j.state_axes()


# ------------------------------------------------------------ RG-LRU


def _rglru_state(cfg, B: int, seed: int):
    rng = np.random.default_rng(seed)
    g = cfg.rglru
    return {"h": rng.normal(size=(B, g.lru_width)).astype(np.float32),
            "conv": rng.normal(size=(B, g.conv_width - 1, g.lru_width))
            .astype(np.float32)}


@pytest.mark.parametrize("S", [16, 19, 1])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_matches_the_reference(S, carried, dtype):
    """From a zero state (a prefill) or a carried-in one; 19 steps end
    in a ragged chunk of the recurrence, one step is a decode step."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b", dtype)
    B = 2
    x = np.random.default_rng(8).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    if carried:
        state = _rglru_state(jcfg, B, 9)
        jst = {k: jnp.asarray(v) for k, v in state.items()}
        tst = {k: _t(v) for k, v in state.items()}
    else:
        jst = JRG.make_state(jcfg, B)
        tst = TRG.make_state(tcfg, B, device="cpu")
    jp, tp = _params(JRG.rglru_specs, jcfg, 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo, jns = JRG.rglru_apply(jp, jcfg, jnp.asarray(x, jdt), jst)
    to, tns = TRG.rglru_apply(tp, tcfg, _t(x, tdt), tst)
    assert to.dtype == tdt and tns["h"].dtype == torch.float32
    _close(to, jo, dtype)
    _close(tns["h"], jns["h"], dtype)
    _close(tns["conv"], jns["conv"], dtype)


def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(10)
    u = rng.normal(size=(2, 7, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    tail = rng.normal(size=(2, 3, 24)).astype(np.float32)
    jo, jt = JRG._causal_conv(*map(jnp.asarray, (u, w, b, tail)))
    to, tt = TRG._causal_conv(*map(_t, (u, w, b, tail)))
    _close(to, jo)
    np.testing.assert_array_equal(_np(tt), _np(jt))
