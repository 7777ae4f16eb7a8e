"""The perf-variant fields of the model config keep their meaning in the
port: the forward-only counterparts of ``tests/test_chunked_ce.py``,
``test_onehot_embed.py``, ``test_rwkv_chunked.py`` and
``test_perf_variants.py``, on the CPU, at the SMOKE sizes.

Each variant is held to the port's own baseline with the reference
test's bound, and to the JAX package's run of the same variant.
Parameters come from the reference's ``Model.init`` (carried across with
``models.param.from_numpy``); batches are numpy draws from a seed.
Bounds against the baseline are the reference tests' own: chunked CE
1e-4 absolute, the one-hot gather 1e-6 (a lookup) and 5e-3 (a bf16
model's loss), the chunked WKV 1e-3, ``fast_norm`` and
``bf16_activation_ar`` 0.02, banded local attention and every ``remat``
policy equal bits.  Against the reference, with ``compute_dtype`` f32,
losses to 1e-5 relative and logits to 1e-4 of max|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import model_zoo as JZ
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _cfgs(arch: str, dtype: str = "", **kw):
    jkw, tkw = dict(kw), dict(kw)
    if dtype:
        jkw["compute_dtype"] = getattr(jnp, dtype)
        tkw["compute_dtype"] = getattr(torch, dtype)
    return (dataclasses.replace(JR.get_config(arch, smoke=True), **jkw),
            dataclasses.replace(TR.get_config(arch, smoke=True), **tkw))


def _params(jcfg, seed: int = 0):
    jp = JZ.build(jcfg).init(jax.random.PRNGKey(seed))
    return jp, TP.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")


def _batch(cfg, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "mask": np.ones((b, s), np.float32)}


def _tloss(cfg, tp, batch) -> float:
    b = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    return float(TZ.build(cfg).loss(tp, b)[0])


def _jloss(cfg, jp, batch) -> float:
    return float(JZ.build(cfg).loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})[0])


# ------------------------------------------------------------ chunked CE


# gemma2: tied embeddings + final softcap; glm4: untied lm_head.
@pytest.mark.parametrize("arch", ["gemma2-2b", "glm4-9b"])
@pytest.mark.parametrize("chunk", [64, 96, 512])
def test_chunked_ce_matches_full(arch, chunk):
    """chunk=96 does not divide vocab 512: a ragged last chunk."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(tcfg)
    full = _tloss(tcfg, tp, batch)
    chunked = _tloss(dataclasses.replace(tcfg, ce_vocab_chunk=chunk), tp,
                     batch)
    assert abs(full - chunked) < 1e-4, (full, chunked)
    jcfg, tcfg = _cfgs(arch, "float32", ce_vocab_chunk=chunk)
    np.testing.assert_allclose(_tloss(tcfg, tp, batch),
                               _jloss(jcfg, jp, batch), rtol=1e-5)


def test_chunked_ce_masked_positions_ignored():
    _, tcfg = _cfgs("gemma2-2b", ce_vocab_chunk=128)
    jcfg, _ = _cfgs("gemma2-2b")
    _, tp = _params(jcfg)
    batch = _batch(tcfg)
    full = _tloss(tcfg, tp, batch)
    mask = np.ones((2, 16), np.float32)
    mask[:, 8:] = 0.0
    labels = batch["labels"].copy()
    labels[:, 8:] = 0
    masked = _tloss(tcfg, tp, dict(batch, mask=mask, labels=labels))
    assert np.isfinite(masked) and abs(masked - full) < 2.0


# ------------------------------------------------------------ one-hot


def test_onehot_lookup_matches_take():
    rng = np.random.default_rng(0)
    table = {"table": torch.from_numpy(
        rng.normal(size=(64, 16)).astype(np.float32))}
    toks = torch.from_numpy(rng.integers(0, 64, (3, 7)).astype(np.int32))
    a = TL.embed_lookup(table, toks, scale=False, d=16)
    b = TL.embed_lookup(table, toks, scale=False, d=16, onehot=True)
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_onehot_model_loss_matches():
    jcfg, tcfg = _cfgs("gemma2-2b")
    jp, tp = _params(jcfg)
    batch = _batch(tcfg, seed=1)
    l0 = _tloss(tcfg, tp, batch)
    l1 = _tloss(dataclasses.replace(tcfg, onehot_embed=True), tp, batch)
    assert abs(l0 - l1) < 5e-3, (l0, l1)
    jcfg, tcfg = _cfgs("gemma2-2b", "float32", onehot_embed=True)
    np.testing.assert_allclose(_tloss(tcfg, tp, batch),
                               _jloss(jcfg, jp, batch), rtol=1e-5)


# ------------------------------------------------------------ chunked WKV


def test_rwkv_model_chunked_matches_sequential():
    jcfg, tcfg = _cfgs("rwkv6-7b")
    jp, tp = _params(jcfg)
    batch = _batch(tcfg, s=64)
    l0 = _tloss(tcfg, tp, batch)
    l1 = _tloss(dataclasses.replace(tcfg, rwkv_chunk=16), tp, batch)
    assert abs(l0 - l1) < 1e-3, (l0, l1)
    jcfg, tcfg = _cfgs("rwkv6-7b", "float32", rwkv_chunk=16)
    np.testing.assert_allclose(_tloss(tcfg, tp, batch),
                               _jloss(jcfg, jp, batch), rtol=1e-5)


# ------------------------------------------------------------ perf flags


def test_banded_local_attention_bit_exact():
    jcfg, tcfg = _cfgs("gemma3-27b", window=8)
    for seed in range(3):
        _, tp = _params(jcfg, seed)
        batch = _batch(tcfg, s=32, seed=seed)
        l0 = _tloss(dataclasses.replace(tcfg, local_banded=False), tp, batch)
        l1 = _tloss(dataclasses.replace(tcfg, local_banded=True), tp, batch)
        assert l0 == l1, (seed, l0, l1)


@pytest.mark.parametrize("flag", ["fast_norm", "bf16_activation_ar"])
def test_cheap_flags_numerically_close(flag):
    jcfg, tcfg = _cfgs("gemma2-2b")
    jp, tp = _params(jcfg)
    batch = _batch(tcfg, s=32)
    l0 = _tloss(tcfg, tp, batch)
    l1 = _tloss(dataclasses.replace(tcfg, **{flag: True}), tp, batch)
    assert abs(l0 - l1) < 0.02, (flag, l0, l1)
    jcfg, tcfg = _cfgs("gemma2-2b", "float32", **{flag: True})
    np.testing.assert_allclose(_tloss(tcfg, tp, batch),
                               _jloss(jcfg, jp, batch), rtol=1e-5)


def test_remat_policies_leave_the_forward_value():
    """remat picks what a backward pass recomputes; a forward pass is the
    same bits under every policy."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    _, tp = _params(jcfg)
    batch = _batch(tcfg, s=32)
    losses = {remat: _tloss(dataclasses.replace(tcfg, remat=remat), tp,
                            batch)
              for remat in ("none", "full", "dots", "dots_tagged")}
    assert len(set(losses.values())) == 1, losses


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-v3-671b"])
def test_unrolled_layers_match_the_reference(arch):
    """scan_layers=False: one stack a layer, as the reference plans it."""
    jcfg, tcfg = _cfgs(arch, "float32", scan_layers=False)
    jp, tp = _params(jcfg)
    batch = _batch(tcfg, s=12)
    want = JZ.build(jcfg).logits(jp, {"tokens": jnp.asarray(
        batch["tokens"])})
    got = TZ.build(tcfg).logits(tp, {"tokens": torch.from_numpy(
        batch["tokens"])})
    diff = float(np.max(np.abs(_np(got) - _np(want))))
    assert diff <= 1e-4 * float(np.max(np.abs(_np(want)))), diff
