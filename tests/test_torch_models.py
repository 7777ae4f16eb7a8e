"""The port's model zoo (``repro_torch.models.transformer`` and
``model_zoo``) against the JAX package's, on the CPU, for each of the
ten architectures of ``configs/registry`` at its SMOKE size.

Parameters come from the reference's ``Model.init`` and are carried
across whole (the stacked tree included) with
``models.param.from_numpy``; batches are numpy draws from a seed.  Per
arch: the spec tree (keys, shapes, axes, init) and the parameter count;
``logits``, the ``loss`` value and its metrics; prefill then a decode
step at a scalar position and at per-row positions, with the caches
after each; the cache and input specs.  Also the stack plans of the FULL
configs, DeepSeek-V3's parameter count, and Gemma-2 2B with the three
``fused_pallas`` spellings in both packages (the reference's kernels in
interpret mode, the port's plain versions of B8, B9 and B10; ``loss`` is
left out there: ``masked_mean`` has no ``fused_pallas`` engine in either
package).

Tolerances: with ``compute_dtype`` f32 and f32 caches in both packages,
logits to 1e-4 of max|ref| and caches to 1e-4 of each leaf's max|ref|
(both round the same f32 steps, some in another order), the loss and its
metrics to 1e-5 relative; ``Model.prefill`` / ``decode_step`` as the
configs give them (bf16 activations and caches) within the reference's
model bound, max|got - ref| < 0.05 (max|ref| + 1)
(``tests/test_models.py``), against the reference's and against the
port's own full forward.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import ShapeConfig as JShape
from repro.models import model_zoo as JZ
from repro.models import param as JP
from repro.models import transformer as JT
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP
from repro_torch.models import transformer as TT

ARCHS = JR.list_archs()
B, S = 2, 12
FUSED = dict(reduce_method="fused_pallas", norm_matmul_method="fused_pallas",
             attn_method="fused_pallas")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tight: bool = True):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    if tight:
        assert diff <= 1e-4 * scale, (diff, scale)
    else:
        assert diff < 0.05 * (scale + 1.0), (diff, scale)


def _flat(tree, path=()):
    """{path: leaf} over nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _jflat(tree, **kw):
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree, **kw)}


def _cfgs(arch: str, dtype: str = "float32", **kw):
    """Both packages' SMOKE configs with ``kw`` and, unless ``dtype`` is
    empty, that compute dtype."""
    jkw, tkw = dict(kw), dict(kw)
    if dtype:
        jkw["compute_dtype"] = getattr(jnp, dtype)
        tkw["compute_dtype"] = getattr(torch, dtype)
    return (dataclasses.replace(JR.get_config(arch, smoke=True), **jkw),
            dataclasses.replace(TR.get_config(arch, smoke=True), **tkw))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    jcfg, _ = _cfgs(arch)
    jp = JZ.build(jcfg).init(jax.random.PRNGKey(0))
    return jp, TP.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


def _batch(cfg, seed: int = 0, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(
               np.int32),
           "mask": np.ones((B, s), np.float32)}
    if cfg.vision_tokens:
        out["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["src_embeds"] = rng.normal(size=(B, s, cfg.d_model)).astype(
            np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _prompt(batch):
    return {k: v for k, v in batch.items() if k not in ("labels", "mask")}


# ------------------------------------------------------------ structure


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_the_reference(arch):
    jcfg, tcfg = _cfgs(arch, "")
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jspecs = _jflat(jm.specs, is_leaf=JP.is_param)
    tspecs = _flat(tm.specs)
    assert sorted(jspecs) == sorted(tspecs)
    for path, p in jspecs.items():
        q = tspecs[path]
        assert (tuple(q.shape), q.axes, q.init, q.scale) \
            == (tuple(p.shape), p.axes, p.init, p.scale), path
    assert tm.num_params() == jm.num_params()
    assert _flat(tm.param_axes()) == {
        path: p.axes for path, p in jspecs.items()}
    full = TR.get_config(arch)
    assert TZ.build(full).num_params() == JZ.build(
        JR.get_config(arch)).num_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_plans_match_the_reference(arch):
    for smoke in (False, True):
        jp = JT.plan_stacks(JR.get_config(arch, smoke=smoke))
        tp = TT.plan_stacks(TR.get_config(arch, smoke=smoke))
        assert [(tuple((d.kind, d.mlp) for d in p.descs), p.repeats,
                 p.start) for p in tp] \
            == [(tuple((d.kind, d.mlp) for d in p.descs), p.repeats,
                 p.start) for p in jp]
        cfg = TR.get_config(arch, smoke=smoke)
        assert sum(len(p.descs) * p.repeats for p in tp) == cfg.num_layers
    unrolled = dataclasses.replace(TR.get_config(arch), scan_layers=False)
    assert all(p.repeats == 1 and len(p.descs) == 1
               for p in TT.plan_stacks(unrolled))


def test_gemma3_pattern_tail_and_ring_cache():
    plans = TT.plan_stacks(TR.get_config("gemma3-27b"))
    assert plans[0].repeats == 10 and len(plans[0].descs) == 6
    assert tuple(d.kind for d in plans[-1].descs) == ("local", "local")
    cfg = TR.get_config("recurrentgemma-2b")
    cache = TT.init_block_cache(cfg, TT.LayerDesc("local", "dense"),
                                batch=1, capacity=524_288, device="meta")
    assert cache["k"].shape[1] == cfg.window


def test_deepseek_param_count():
    """671B within 2 %, counted from the specs (nothing allocated)."""
    n = TZ.build(TR.get_config("deepseek-v3-671b")).num_params()
    assert abs(n - 671e9) / 671e9 < 0.02, n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_and_cache_specs_match_the_reference(arch, kind):
    jcfg, tcfg = _cfgs(arch, "")
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jspecs = _jflat(jm.input_specs(JShape("x", 24, 3, kind)))
    tspecs = _flat(tm.input_specs(TShape("x", 24, 3, kind)))
    assert sorted(jspecs) == sorted(tspecs)
    for path, sd in jspecs.items():
        assert tuple(tspecs[path].shape) == tuple(sd.shape), path
        assert str(tspecs[path].dtype).removeprefix("torch.") \
            == str(sd.dtype), path
    jc = jm.cache_specs(JShape("x", 24, 3, "decode"))
    tc = tm.cache_specs(TShape("x", 24, 3, "decode"))
    assert _flat(TT.cache_logical_axes(tc)) \
        == _jflat(JT.cache_logical_axes(jc),
                  is_leaf=lambda x: isinstance(x, tuple))


def test_init_runs_where_it_is_asked(monkeypatch):
    model = TZ.build(TR.get_config("gemma2-2b", smoke=True))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    leaves = list(_flat(params).values())
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    assert sum(t.numel() for t in leaves) == model.num_params()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    batch = _batch(jcfg)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    got = tm.logits(tp, _t(batch))
    assert got.dtype == torch.float32
    _close(got, jm.logits(jp, _j(batch)))
    jloss, jmet = jm.loss(jp, _j(batch))
    tloss, tmet = tm.loss(tp, _t(batch))
    assert sorted(tmet) == sorted(jmet)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)


def _prefill_decode(lib, T, Z, params, cfg, batch, nxt, pos, dtype):
    """Prefill into caches of ``dtype`` then one decode step, as
    ``Model.prefill`` / ``decode_step`` do; returns (prefill logits,
    decode logits, caches after prefill, caches after decode)."""
    tokens = batch["tokens"]
    memory = Z._memory(params, cfg, batch)
    mem_len = 0 if memory is None else memory.shape[1]
    kw = {} if lib is jnp else {"device": "cpu"}
    caches = T.init_decoder_cache(cfg, B, S + 4, mem_len, dtype=dtype, **kw)
    hidden, caches, _ = T.decoder_forward(params, cfg, tokens,
                                          caches=caches, memory=memory)
    first = T.logits_from_hidden(params, cfg, hidden[:, -1:])
    after_prefill = jax.tree_util.tree_map(np.asarray, caches) \
        if lib is jnp else {k: _np_tree(v) for k, v in caches.items()}
    hidden, caches, _ = T.decoder_forward(params, cfg, nxt, positions=pos,
                                          caches=caches, decode=True)
    return (first, T.logits_from_hidden(params, cfg, hidden),
            after_prefill, caches)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _np(tree).copy()


def _same_caches(tc, jc):
    jflat = _jflat(jc)
    tflat = _flat(tc)
    assert sorted(jflat) == sorted(tflat)
    for path, want in jflat.items():
        got = tflat[path]
        if path[-1] == "idx":
            np.testing.assert_array_equal(_np(got), _np(want), str(path))
        else:
            _close(got, want)


def _run_both(arch, pos_rows, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(arch)
    batch = _prompt(_batch(jcfg, seed=1))
    nxt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, 1))
    nxt = nxt.astype(np.int32)
    pos = np.asarray(pos_rows, np.int32)
    jpos = jnp.asarray(pos)[:, None] if pos.ndim else jnp.asarray(pos)[None]
    tpos = torch.from_numpy(pos)[:, None] if pos.ndim \
        else torch.from_numpy(pos)[None]
    jout = _prefill_decode(jnp, JT, JZ, jp, jcfg, _j(batch),
                           jnp.asarray(nxt), jpos, jnp.float32)
    tout = _prefill_decode(torch, TT, TZ, tp, tcfg, _t(batch),
                           torch.from_numpy(nxt), tpos, torch.float32)
    _close(tout[0], jout[0])
    _same_caches(tout[2], jout[2])
    _close(tout[1], jout[1])
    _same_caches(tout[3], jout[3])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """f32 activations and caches: prefill logits, caches, one decode
    step at the scalar position S, and the caches after it (each
    layer's own slice of its stack, each layer's own idx)."""
    _run_both(arch, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_at_per_row_positions_matches_the_reference(arch):
    """Continuous batching: each row at its own position."""
    _run_both(arch, [S, S - 3])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_then_decode_step(arch):
    """``Model.prefill`` / ``decode_step`` as the config gives them
    (bf16): against the reference's, and against the port's own full
    forward's last logits (the reference's test)."""
    jcfg, tcfg = _cfgs(arch, "")
    jp, tp = _params(arch)
    batch = _prompt(_batch(jcfg, seed=3))
    nxt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, 1))
    nxt = nxt.astype(np.int32)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    _, jc = jm.prefill(jp, _j(batch))
    want, _ = jm.decode_step(jp, {"token": jnp.asarray(nxt),
                                  "pos": jnp.asarray(S, jnp.int32),
                                  "caches": jc})
    _, tc = tm.prefill(tp, _t(batch))
    got, tc = tm.decode_step(tp, {"token": torch.from_numpy(nxt),
                                  "pos": S, "caches": tc})
    assert got.shape == (B, 1, tcfg.vocab_size)
    _close(got, want, tight=False)
    full = dict(batch, tokens=np.concatenate([batch["tokens"], nxt], 1))
    _close(got, tm.logits(tp, _t(full))[:, -1:], tight=False)


def test_fused_spellings_match_the_reference():
    """Gemma-2 2B with fused_pallas for the norms (B8), the MLPs (B10)
    and attention (B9): the reference's Pallas kernels in interpret
    mode, the port's plain versions; logits, and prefill then a decode
    step over f32 caches."""
    arch = "gemma2-2b"
    jcfg, tcfg = _cfgs(arch, **FUSED)
    jp, tp = _params(arch)
    batch = _batch(jcfg, seed=5)
    _close(TZ.build(tcfg).logits(tp, _t(batch)),
           JZ.build(jcfg).logits(jp, _j(batch)))
    _run_both(arch, S, **FUSED)
