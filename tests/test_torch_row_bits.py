"""A batch item's bits do not depend on the items beside it, in the
port's projections and attention products that ``layers.dense`` did
not cover before: MLA's (query chain, latent, absorbed scores and
context, output), RWKV-6's (time-mix LoRAs and projections, channel
mix), RG-LRU's, and the ``vpu`` / ``unfused_mma`` attention's per-head
products over 1024 keys.  Item 0 is run at batch 1 and beside three
other items at batch 4 (the attention and ``bmm_items`` also beside 63,
the most slots ``ContinuousServer`` takes: ``pad_rows`` pads a step to
64 rows), and its outputs must be equal bit for bit.

Then the contract they serve: ``ContinuousServer`` at DeepSeek-V3 SMOKE
(MLA + MoE) and at RecurrentGemma SMOKE gives each request's logits
rows the bits of that request alone through ``Server.generate``
(``tests/test_serving.py``'s "continuous == one request at a time"),
and refuses more slots than the 64 rows a padded step holds (a
batched product gives an item other bits at batch 1 than at 72, on the
CPU and in cuBLAS's f32).

Everything runs on the CPU, in the port alone; inputs are numpy draws
from a seed.  Tolerance: none (``torch.equal``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.core import reduction as R
from repro_torch.data.pipeline import synthetic_requests
from repro_torch.launch import serve as TS
from repro_torch.models import attention as A
from repro_torch.models import mla as MLA
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW

CAP = 40


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _cfg(arch, dtype="float32", **kw):
    return dataclasses.replace(TR.get_config(arch, smoke=True),
                               compute_dtype=getattr(torch, dtype), **kw)


def _params(specs, seed):
    return TP.init_tree(torch.Generator().manual_seed(seed), specs,
                        device="cpu")


def _item0_equal(run, inputs4):
    """``run`` at the inputs' batch and at item 0 alone: every output
    tensor's row 0 must be equal."""
    four = run(*inputs4)
    one = run(*[None if t is None else t[:1] for t in inputs4])
    four = four if isinstance(four, (tuple, list)) else (four,)
    one = one if isinstance(one, (tuple, list)) else (one,)
    for a, b in zip(four, one):
        assert torch.equal(a[:1], b), (a[:1] - b).abs().max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["vpu", "unfused_mma"])
def test_attention_item_bits_over_1024_keys(dtype, method):
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    # a decode step's shape: two query rows a KV head (G x Sq)
    b, sq, sk, kv, g, hd = 4, 1, 1024, 2, 2, 256
    qg = _t(rng.normal(size=(b, sq, kv, g, hd)), dt)
    k = _t(rng.normal(size=(b, sk, kv, hd)), dt)
    v = _t(rng.normal(size=(b, sk, kv, hd)), dt)
    qpos = torch.arange(sk - sq, sk)
    run_one = {"vpu": lambda q, kk, vv: A._direct_attn(
        q, kk, vv, qpos=qpos, kpos=torch.arange(sk), causal=True,
        window=None, kv_len=None, scale=0.125, cap=30.0),
        "unfused_mma": lambda q, kk, vv: A._chunked_attn(
        q, kk, vv, qpos=qpos, causal=True, window=None, scale=0.125,
        cap=30.0, chunk=256)}[method]
    _item0_equal(run_one, (qg, k, v))


@pytest.mark.parametrize("n", [4, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bmm_items_bits_up_to_the_slot_bound(n, dtype):
    """``core.reduction.bmm_items`` (the per-head products above) at a
    decode step's shape over 1024 keys: the first and last items have
    the bits of their products alone up to ``ContinuousServer``'s most
    slots (64, ``_ROW_TILE``), where torch's batched product gives
    item 0 other bits (checked here too)."""
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    a = _t(rng.normal(size=(n, 2, 1024)), dt)
    b = _t(rng.normal(size=(n, 1024, 256)), dt)
    got = R.bmm_items(a, b)
    assert not torch.equal(R._bmm(a, b)[:1], R._bmm(a[:1], b[:1]))
    for i in (0, n - 1):
        assert torch.equal(got[i:i + 1], R._bmm(a[i:i + 1], b[i:i + 1]))


def test_attention_item_bits_at_64_slots():
    """The ``vpu`` attention at a 64-slot decode step over 1024 keys,
    the most slots ``ContinuousServer`` takes."""
    rng = np.random.default_rng(5)
    b, sq, sk, kv, g, hd = 64, 1, 1024, 1, 2, 256
    qg = _t(rng.normal(size=(b, sq, kv, g, hd)))
    k = _t(rng.normal(size=(b, sk, kv, hd)))
    v = _t(rng.normal(size=(b, sk, kv, hd)))
    _item0_equal(lambda q, kk, vv: A._direct_attn(
        q, kk, vv, qpos=torch.arange(sk - sq, sk), kpos=torch.arange(sk),
        causal=True, window=None, kv_len=None, scale=0.125, cap=30.0),
        (qg, k, v))


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("nm_method", ["", "unfused_mma"])
def test_mla_item_bits(decode, nm_method):
    cfg = _cfg("deepseek-v3-671b", "bfloat16",
               norm_matmul_method=nm_method)
    params = _params(MLA.mla_specs(cfg), 0)
    rng = np.random.default_rng(1)
    m = cfg.mla
    x = _t(rng.normal(size=(4, 1 if decode else 12, cfg.d_model)),
           torch.bfloat16)
    # a latent cache of 1024 slots, as the attention's keys above
    ckv = _t(rng.normal(size=(4, 1024, m.kv_lora_rank)), torch.bfloat16)
    kr = _t(rng.normal(size=(4, 1024, m.qk_rope_dim)), torch.bfloat16)
    pos = torch.tensor([[1000], [3], [611], [1023]])

    def run(x, ckv, kr, pos):
        if not decode:
            return MLA.mla_attention(params, cfg, x,
                                     positions=torch.arange(12))[0]
        cache = {"ckv": ckv.clone(), "krope": kr.clone(),
                 "idx": torch.tensor(1024, dtype=torch.int32)}
        out, new = MLA.mla_attention(params, cfg, x, positions=pos,
                                     cache=cache, decode=True)
        return out, new["ckv"], new["krope"]
    _item0_equal(run, (x, ckv, kr, pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_item_bits(dtype):
    cfg = _cfg("rwkv6-7b", dtype)
    tm = _params(RW.timemix_specs(cfg), 0)
    cm = _params(RW.chanmix_specs(cfg), 1)
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)
    x = _t(rng.normal(size=(4, 8, cfg.d_model)), dt)
    st = RW.make_state(cfg, 4, device="cpu")
    st = {k: _t(rng.normal(size=tuple(v.shape)) * 0.1, v.dtype)
          for k, v in st.items()}

    def run(x, wkv, x_tm, x_cm):
        state = {"wkv": wkv, "x_tm": x_tm, "x_cm": x_cm}
        y, s1 = RW.time_mix(tm, cfg, x, state)
        z, s2 = RW.channel_mix(cm, cfg, y, s1)
        return y, z, s1["wkv"], s2["x_cm"]
    _item0_equal(run, (x, st["wkv"], st["x_tm"], st["x_cm"]))


@pytest.mark.parametrize("seq", [1, 12])
def test_rglru_item_bits(seq):
    cfg = _cfg("recurrentgemma-2b", "bfloat16")
    params = _params(RG.rglru_specs(cfg), 0)
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(4, seq, cfg.d_model)), torch.bfloat16)
    st = RG.make_state(cfg, 4, device="cpu")
    h = _t(rng.normal(size=tuple(st["h"].shape)))
    conv = _t(rng.normal(size=tuple(st["conv"].shape)), st["conv"].dtype)

    def run(x, h, conv):
        out, new = RG.rglru_apply(params, cfg, x, {"h": h, "conv": conv})
        return out, new["h"], new["conv"]
    _item0_equal(run, (x, h, conv))


def _record_rows(eng):
    """Wrap the engine's samplers to record each (uid, index)'s logits
    row."""
    rows = {}
    pick, picks = eng._pick, eng._picks

    def one(row, uid, index):
        rows[(uid, index)] = row.clone()
        return pick(row, uid, index)

    def many(last, slots):
        for s, st in slots.items():
            rows[(st.uid, st.n_out)] = last[s].clone()
        return picks(last, slots)
    eng._pick, eng._picks = one, many
    return rows


def _one_at_a_time(model, params, reqs):
    out, rows = {}, {}
    for r in reqs:
        srv = TS.Server(model, extra_capacity=CAP - len(r.prompt))
        sample, seen = srv._sample, []

        def spy(logits, seed, step, sample=sample, seen=seen):
            seen.append(logits[0, -1].clone())
            return sample(logits, seed, step)
        srv._sample = spy
        out[r.uid] = srv.generate(params, r.prompt[None],
                                  max_new=r.max_new)[0]
        for i, row in enumerate(seen[:len(out[r.uid])]):
            rows[(r.uid, i)] = row
    return out, rows


def test_continuous_refuses_more_slots_than_the_row_tile():
    """A decode step of more than ``_ROW_TILE`` slots pads its rows to
    another count than one request alone: the engine refuses it."""
    model = TZ.build(TR.get_config("gemma2-2b", smoke=True))
    with pytest.raises(ValueError, match="num_slots=65"):
        TS.ContinuousServer(model, num_slots=R._ROW_TILE + 1,
                            capacity=CAP, page_size=8, device="cpu")
    eng = TS.ContinuousServer(model, num_slots=R._ROW_TILE, capacity=CAP,
                              page_size=8, device="cpu")
    assert eng.num_slots == 64


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "recurrentgemma-2b"])
def test_continuous_matches_one_at_a_time_bitwise(arch):
    cfg = TR.get_config(arch, smoke=True)
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    reqs = [TS.Request(**d) for d in synthetic_requests(
        cfg.vocab_size, n=5, seed=7, min_len=3, max_len=12, min_new=2,
        max_new=8, stagger=1)]
    eng = TS.ContinuousServer(model, num_slots=4, capacity=CAP,
                              page_size=8, device="cpu")
    rows = _record_rows(eng)
    got = eng.generate(params, reqs)
    want, want_rows = _one_at_a_time(eng.model, params, reqs)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)
    assert sorted(rows) == sorted(want_rows)
    for key in want_rows:
        assert torch.equal(rows[key], want_rows[key]), key
