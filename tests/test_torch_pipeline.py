"""The port's data pipeline (``repro_torch.data.pipeline``) against the
JAX package's (``repro.data.pipeline``), on the CPU.

  * ``synthetic_requests`` is numpy only: the same requests value for
    value, with and without a bucket policy;
  * ``SyntheticLMData.batch_at`` gives the reference's arrays (tokens,
    labels, mask, the modality inputs and the packed positions) array
    for array; the prefetching iterator resumes at a step and its worker
    joins when the iterator is abandoned;
  * ``RunningStats``: the summary and the cumulative token budget equal
    the reference's under ``mma``, ``vpu`` and ``mma_chained`` to f32
    rounding (2^-20 of the total: every count is an integer below 2^24,
    so the engines' different orders of f32 adds differ by a rounding of
    the squared sum at most), and the per-sequence fills survive the
    flatten-only engines (``mma_chained``, ``pallas``), as in
    ``tests/test_dispatch.py``;
  * ``mask_positions`` equals the reference's;
  * the device rule: batches go to the card unless the caller names the
    CPU, and a sharding is refused naming ROADMAP item 14.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.data import pipeline as tpipe

REQUEST_KW = (
    dict(n=8, seed=3, min_len=2, max_len=9, min_new=1, max_new=6,
         stagger=1),
    dict(n=48, seed=5, min_len=5, max_len=64, min_new=1, max_new=4),
    dict(n=48, seed=5, min_len=5, max_len=64, min_new=1, max_new=4,
         bucket="pow2"),
    dict(n=6, seed=0, min_len=64, max_len=960, min_new=8, max_new=32,
         stagger=1),
)


def _pipes(arch="gemma2-2b", b=4, s=32, seed=7, **kw):
    return (jpipe.SyntheticLMData(JR.get_config(arch, smoke=True),
                                  JShape("t", s, b, "train"), seed=seed,
                                  **kw),
            tpipe.SyntheticLMData(TR.get_config(arch, smoke=True),
                                  TShape("t", s, b, "train"), seed=seed,
                                  device="cpu", **kw))


@pytest.mark.parametrize("kw", REQUEST_KW)
def test_synthetic_requests_match_the_reference(kw):
    vocab = 97 if kw["max_len"] < 100 else 256000
    want = list(jpipe.synthetic_requests(vocab, **kw))
    got = list(tpipe.synthetic_requests(vocab, **kw))
    assert len(got) == len(want) == kw["n"]
    for g, w in zip(got, want):
        assert g["uid"] == w["uid"] and g["max_new"] == w["max_new"]
        assert g["prompt"].dtype == w["prompt"].dtype == np.int32
        np.testing.assert_array_equal(g["prompt"], w["prompt"])


@pytest.mark.parametrize("arch,with_positions", [
    ("gemma2-2b", False), ("gemma2-2b", True),
    ("llama-3.2-vision-90b", False), ("seamless-m4t-large-v2", False)])
def test_batch_at_matches_the_reference(arch, with_positions):
    jp, tp = _pipes(arch, b=3, s=16, with_positions=with_positions)
    for step in (0, 5):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "cpu", k
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_prefetch_iterator_resumes():
    _, p = _pipes()
    it = p.iter(start_step=5)
    try:
        first, second = next(it), next(it)
    finally:
        it.close()
    for got, step in ((first, 5), (second, 6)):
        want = p.batch_at(step)
        for k in want:
            assert torch.equal(got[k], want[k]), (step, k)


def test_prefetch_worker_joins_on_shutdown():
    """Abandoning the iterator with a full prefetch queue must stop and
    join its worker (the timed put re-checks the stop event)."""
    _, p = _pipes(b=2, s=8)
    before = set(threading.enumerate())
    it = p.iter(prefetch=1)
    next(it)
    time.sleep(0.3)                 # the worker refills and blocks in put
    spawned = [t for t in threading.enumerate() if t not in before]
    assert spawned, "prefetch worker did not start"
    it.close()
    deadline = time.monotonic() + 5.0
    while any(t.is_alive() for t in spawned):
        assert time.monotonic() < deadline, \
            "prefetch worker leaked after iterator close"
        time.sleep(0.05)


def _masks(seed=11, steps=6, b=4, s=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        m = np.ones((b, s), np.float32)
        for row in range(b):
            m[row, rng.integers(1, s + 1):] = 0.0
        out.append(m)
    return out


@pytest.mark.parametrize("method", ["mma", "vpu", "mma_chained"])
def test_running_stats_match_the_reference(method):
    masks = _masks()
    want = jpipe.RunningStats(method=method)
    got = tpipe.RunningStats(method=method)
    assert got.summary() == want.summary()
    assert got.cumulative_tokens().shape == (0,)
    for m in masks:
        assert got.update({"mask": torch.from_numpy(m)}) == \
            want.update({"mask": jnp.asarray(m)})
    # a flat mask takes the whole-array reduction
    flat = masks[0].reshape(-1)
    assert got.update({"mask": torch.from_numpy(flat)}) == \
        want.update({"mask": jnp.asarray(flat)})
    gs, ws = got.summary(), want.summary()
    assert sorted(gs) == sorted(ws)
    scale = ws["total_tokens"]
    for k in ws:
        assert abs(gs[k] - ws[k]) <= 2.0 ** -20 * max(scale, 1.0), (k, gs, ws)
    np.testing.assert_allclose(got.cumulative_tokens(),
                               want.cumulative_tokens(), rtol=2.0 ** -20)


@pytest.mark.parametrize("ablation", ["mma_chained", "pallas"])
def test_running_stats_survive_ablation_engines(ablation):
    stats = tpipe.RunningStats(method=ablation)
    mask = np.ones((4, 16), np.float32)
    mask[1, 8:] = 0.0
    assert stats.update({"mask": torch.from_numpy(mask)}) == 56.0
    s = stats.summary()
    assert s["min_seq_tokens"] == 8.0 and s["max_seq_tokens"] == 16.0
    np.testing.assert_array_equal(stats.cumulative_tokens(), [56.0])


def test_running_stats_on_the_data_stream():
    stats = tpipe.RunningStats()
    _, p = _pipes(b=4, s=32)
    for step in range(3):
        assert stats.update(p.batch_at(step)) == 4 * 32
    s = stats.summary()
    assert s["steps"] == 3 and s["total_tokens"] == 3 * 128
    assert s["mean_tokens"] == 128.0 and s["std_tokens"] == 0.0
    np.testing.assert_allclose(stats.cumulative_tokens(),
                               [128.0, 256.0, 384.0])


def test_mask_positions_match_the_reference():
    masks = _masks(seed=12, steps=2, b=3, s=17)
    masks.append(np.asarray([[1.0, 0.0, 1.0, 1.0]], np.float32))
    for m in masks:
        got = tpipe.mask_positions(torch.from_numpy(m))
        want = np.asarray(jpipe.mask_positions(jnp.asarray(m)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_device_rule_and_sharding_refusal():
    cfg = TR.get_config("gemma2-2b", smoke=True)
    shape = TShape("t", 8, 2, "train")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.SyntheticLMData(cfg, shape)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.RunningStats().update({"mask": np.ones((2, 8))})
    # a sharded batch: each rank keeps its rows of the global batch (a
    # fake (data 2, model 2) mesh at coordinate (1, 0); every leaf,
    # positions too)
    from repro_torch.distributed import sharding as tshd

    class _Fake:
        shape = {"data": 2, "model": 2}
        coordinate = {"data": 1, "model": 0}
    whole = tpipe.SyntheticLMData(cfg, shape, with_positions=True,
                                  device="cpu").batch_at(3)
    mine = tpipe.SyntheticLMData(
        cfg, shape, with_positions=True, device="cpu",
        sharding=tshd.NamedSharding(_Fake(), tshd.P(("data",)))).batch_at(3)
    assert sorted(mine) == sorted(whole)
    for k, v in whole.items():
        assert torch.equal(mine[k], v[1:]), k
