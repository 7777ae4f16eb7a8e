"""The port's serving stack (``repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``), on the CPU, at Gemma-2 2B's
SMOKE size with the reference's parameters carried across
(``models.param.from_numpy``).

Against the reference:

  * the port's ``ContinuousServer`` streams the tokens the reference's
    streams on the same requests (greedy) under each engine spelling:
    ``quant='none'``; ``'int8'`` with ``MmaPolicy(split_words=2)``;
    ``norm_matmul_method='fused_pallas'``; ``attn_method='fused_pallas'``
    over the int8 store (the port's plain versions of B8, B9 and B10, the
    reference's kernels in interpret mode).  The reference runs once per
    spelling, in a module-scoped cache;
  * the streamed logprobs (``logprobs=True``) within the reference's
    model bound, max|got - ref| < 0.05 (max|ref| + 1)
    (``tests/test_models.py``): both packages run bf16 activations,
    which round apart;
  * the admit / evict trace of a recording store equals the
    reference's;
  * ``batched_logprobs`` and ``Server.score``'s reductions on the same
    logits within 1e-5 absolute, and ``Server.score`` against the f64
    oracle of ``tests/test_serving.py``.

The port's own contracts, from ``tests/test_serving.py``: continuous
batching gives the tokens and the logits rows (bit for bit) of one
request at a time through ``Server.generate``; the int8 store (codes and
a bf16 residual) gives the bits of the ``none`` store; the lazy, tagged
iterator; post-EOS pinning; refusal of oversized and enc-dec requests
and of a mesh that is not a live ``compat.Mesh``; warmup's scoring
shapes and prefills; the sweep worker attached and detached; with a
temperature, a request's stream depends on (seed, uid) only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.precision import MmaPolicy as JPolicy
from repro.data.pipeline import synthetic_requests as j_requests
from repro.launch import serve as JS
from repro.models import model_zoo as JZ
from repro.models.kv_cache import PagedKVCache as JStore
from repro_torch.configs import registry as TR
from repro_torch.core import autotune as tat
from repro_torch.core.precision import MmaPolicy as TPolicy
from repro_torch.data.pipeline import synthetic_requests
from repro_torch.launch import serve as TS
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP
from repro_torch.models.kv_cache import PagedKVCache

CAP = 40
MODEL_BOUND = 0.05
# Engine spellings held against the reference: (quant, split words,
# ContinuousServer knobs).
SPELLINGS = {
    "none": ("none", None, {}),
    "int8": ("int8", 2, {}),
    "norm_matmul_fused": ("none", None,
                          {"norm_matmul_method": "fused_pallas"}),
    "attn_fused_int8": ("int8", 2, {"attn_method": "fused_pallas"}),
}


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = JR.get_config("gemma2-2b", smoke=True)
    tcfg = TR.get_config("gemma2-2b", smoke=True)
    jm, tm = JZ.build(jcfg), TZ.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = TP.from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                       device="cpu")
    return tcfg, jm, jp, tm, tp


@pytest.fixture()
def served():
    cfg, _, _, tm, tp = _models()
    return cfg, tm, tp


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


def _requests(vocab, n=4, seed=0, max_new=10, make=TS.Request,
              stream=synthetic_requests):
    return [make(**d) for d in stream(vocab, n=n, seed=seed, min_len=3,
                                      max_len=12, min_new=2,
                                      max_new=max_new, stagger=1)]


def _engine(model, spelling="none", **kw):
    quant, words, knobs = SPELLINGS[spelling]
    pol = None if words is None else TPolicy(split_words=words)
    return TS.ContinuousServer(model, num_slots=2, capacity=CAP,
                               page_size=8, quant=quant, precision=pol,
                               device="cpu", **{**knobs, **kw})


@functools.lru_cache(maxsize=None)
def _reference_stream(spelling: str, seed: int, logprobs: bool = False):
    """The reference's TokenEvents for ``_requests(seed=seed)``."""
    _, jm, jp, _, _ = _models()
    quant, words, knobs = SPELLINGS[spelling]
    pol = None if words is None else JPolicy(split_words=words)
    eng = JS.ContinuousServer(jm, num_slots=2, capacity=CAP, page_size=8,
                              quant=quant, precision=pol,
                              logprobs=logprobs, **knobs)
    reqs = _requests(jm.cfg.vocab_size, seed=seed, make=JS.Request,
                     stream=j_requests)
    return tuple(eng.serve(jp, reqs))


def _tokens(events) -> dict:
    out: dict = {}
    for ev in events:
        out.setdefault(ev.uid, []).append(ev.token)
    return {uid: np.asarray(t, np.int32) for uid, t in out.items()}


@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_continuous_tokens_match_the_reference(served, spelling):
    cfg, model, params = served
    seed = 1
    want = _tokens(_reference_stream(spelling, seed))
    got = _engine(model, spelling).generate(
        params, _requests(cfg.vocab_size, seed=seed))
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)


def test_logprob_stream_matches_the_reference(served):
    cfg, model, params = served
    want = _reference_stream("none", 2, logprobs=True)
    got = list(_engine(model, logprobs=True).serve(
        params, _requests(cfg.vocab_size, seed=2)))
    assert [(e.uid, e.index, e.token, e.done) for e in got] == \
        [(e.uid, e.index, e.token, e.done) for e in want]
    g = np.asarray([e.logprob for e in got])
    w = np.asarray([e.logprob for e in want])
    assert np.all(np.isfinite(g)) and np.all(g <= 0.0)
    diff = float(np.max(np.abs(g - w)))
    assert diff < MODEL_BOUND * (float(np.max(np.abs(w))) + 1.0), diff


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
    """Each request alone through ``Server.generate`` at batch 1, with
    the engine's capacity: (tokens, logits rows by (uid, index))."""
    out, rows = {}, {}
    for r in reqs:
        srv = TS.Server(model, extra_capacity=CAP - len(r.prompt))
        sample = srv._sample
        seen = []

        def spy(logits, seed, step, sample=sample, seen=seen):
            seen.append(logits[0, -1].clone())
            return sample(logits, seed, step)
        srv._sample = spy
        out[r.uid] = srv.generate(params, r.prompt[None],
                                  max_new=r.max_new)[0]
        for i, row in enumerate(seen[:len(out[r.uid])]):
            rows[(r.uid, i)] = row
    return out, rows


@pytest.mark.parametrize("spelling", ["none", "norm_matmul_fused"])
def test_continuous_matches_one_at_a_time_bitwise(served, spelling,
                                                  fresh_registries):
    cfg, model, params = served
    reqs = _requests(cfg.vocab_size, n=5, seed=7)
    eng = _engine(model, spelling)
    rows = _record_rows(eng)
    got = eng.generate(params, reqs)
    if spelling == "norm_matmul_fused":
        assert eng.cfg.norm_matmul_method == "fused_pallas"
        eng.warmup()
        keys = [k for k, _ in tat.default_registry().items()]
        assert any(k.startswith("norm_matmul") for k in keys), keys
    # the rebuilt model of the engine: the knobs change no parameter
    want, want_rows = _one_at_a_time(eng.model, params, reqs)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)
    assert sorted(rows) == sorted(want_rows)
    for key in want_rows:
        assert torch.equal(rows[key], want_rows[key]), key


def test_fused_decode_over_paged_int8_store_bitwise(served):
    """The continuous engine on B9's plain version over the int8 store
    (codes and a bf16 residual) streams the tokens and logits rows of
    each request alone through a fixed-batch ``Server`` of the same
    fused config."""
    cfg, model, params = served
    reqs = _requests(cfg.vocab_size, n=3, seed=1, max_new=8)
    eng = _engine(model, "attn_fused_int8")
    assert eng.cfg.attn_method == "fused_pallas"
    assert eng.cfg.attn_precision.split_words == 1
    rows = _record_rows(eng)
    got = eng.generate(params, reqs)
    want, want_rows = _one_at_a_time(eng.model, params, reqs)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)
    for key in want_rows:
        assert torch.equal(rows[key], want_rows[key]), key


def test_row_bits_hold_for_the_port_own_parameters():
    """The case ``probes/row_count.py`` found: the port's own parameters
    (``init`` from seed 0) and the request stream of seed 7 with B9's
    plain version over the int8 store.  The CPU's bf16 product of the
    attention output by ``wo`` gave 3 of the 37 logits rows other bits
    at 2 rows than at 1 until the model's projections padded their rows
    (``layers.dense``)."""
    cfg = dataclasses.replace(TR.get_config("gemma2-2b", smoke=True),
                              attn_method="fused_pallas")
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    reqs = [TS.Request(**d) for d in synthetic_requests(
        cfg.vocab_size, n=6, seed=7, min_len=3, max_len=12, min_new=2,
        max_new=8, stagger=1)]
    eng = TS.ContinuousServer(model, num_slots=2, capacity=CAP,
                              page_size=8, quant="int8", device="cpu")
    rows = _record_rows(eng)
    got = eng.generate(params, reqs)
    want, want_rows = _one_at_a_time(eng.model, params, reqs)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=uid)
    assert sorted(rows) == sorted(want_rows)
    for key in want_rows:
        assert torch.equal(rows[key], want_rows[key]), key


def test_int8_paged_store_matches_dense_stream(served):
    """bf16 KV survives int8 + residual exactly, so the two stores give
    the same tokens and the same logprob bits."""
    cfg, model, params = served
    reqs = _requests(cfg.vocab_size, n=3, seed=1)
    a = list(_engine(model, "none", logprobs=True).serve(params, reqs))
    # no policy: the store keeps two words (the residual); the scoring
    # reduction over the vocabulary refuses a split_words >= 2 policy,
    # in both packages
    b = list(TS.ContinuousServer(model, num_slots=2, capacity=CAP,
                                 page_size=8, quant="int8", logprobs=True,
                                 device="cpu").serve(params, reqs))
    assert a == b


class _Recording:
    """Records a store's slot lifecycle into ``self._trace``."""

    def alloc_slot(self, slot):
        self._trace.append(("alloc", slot))
        return super().alloc_slot(slot)

    def free_slot(self, slot):
        self._trace.append(("free", slot))
        return super().free_slot(slot)


class _RecordingStore(_Recording, PagedKVCache):
    pass


class _JRecordingStore(_Recording, JStore):
    pass


def _record(eng, cls):
    trace = []
    base = eng._new_store

    def recording_store():
        store = base()
        store.__class__ = cls
        store._trace = trace
        return store
    eng._new_store = recording_store
    return trace


def _recorded_reference(reqs):
    _, jm, jp, _, _ = _models()
    eng = JS.ContinuousServer(jm, num_slots=2, capacity=CAP, page_size=8,
                              quant="none")
    trace = _record(eng, _JRecordingStore)
    jreqs = [JS.Request(r.uid, r.prompt, r.max_new) for r in reqs]
    return eng.generate(jp, jreqs), trace


def test_scheduler_admit_evict_matches_the_reference(served):
    cfg, model, params = served
    reqs = _requests(cfg.vocab_size, n=6, seed=2, max_new=6)
    eng = _engine(model)
    trace = _record(eng, _RecordingStore)
    events = []
    out = eng.generate(params, reqs, on_token=events.append)
    assert sorted(out) == [r.uid for r in reqs]
    seen = {}
    for ev in events:
        assert ev.index == seen.get(ev.uid, 0), (ev.uid, ev.index)
        seen[ev.uid] = ev.index + 1
    for r in reqs:
        assert seen[r.uid] == len(out[r.uid]) <= r.max_new
    live = set()
    for op, slot in trace:
        if op == "alloc":
            assert slot not in live, trace
            live.add(slot)
        else:
            assert slot in live, trace
            live.discard(slot)
        assert len(live) <= eng.num_slots
    assert not live
    assert sum(op == "alloc" for op, _ in trace) == len(reqs)
    want_out, want_trace = _recorded_reference(reqs)
    assert trace == want_trace
    for uid in want_out:
        np.testing.assert_array_equal(out[uid], np.asarray(want_out[uid]))


def test_streaming_iterator_is_lazy_and_tagged(served):
    cfg, model, params = served
    reqs = _requests(cfg.vocab_size, n=2, seed=3, max_new=4)
    eng = TS.ContinuousServer(model, num_slots=2, capacity=CAP,
                              quant="none", device="cpu")
    it = eng.serve(params, reqs)
    first = next(it)
    assert first.index == 0 and first.uid == reqs[0].uid
    rest = list(it)
    assert {ev.uid for ev in rest + [first] if ev.done} == \
        {r.uid for r in reqs}


def test_generate_pins_post_eos_positions(served):
    cfg, model, params = served
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    srv = TS.Server(model)
    free = srv.generate(params, prompts, max_new=8)
    eos = int(free[0, 1])
    toks = srv.generate(params, prompts, max_new=8, eos_id=eos)
    assert toks.shape[1] == 8 or np.all(toks[:, -1] == eos)
    stopped = [np.argmax(row == eos) if (row == eos).any() else None
               for row in toks]
    assert stopped[0] is not None
    for b, row in enumerate(toks):
        j = stopped[b]
        if j is None:
            np.testing.assert_array_equal(row, free[b, :len(row)])
            continue
        np.testing.assert_array_equal(row[:j + 1], free[b, :j + 1])
        assert np.all(row[j:] == eos), (b, row)
    assert len({(-1 if j is None else int(j)) for j in stopped}) >= 2


def _f64_score(logits, toks, mask):
    logits = np.asarray(logits, np.float64)
    m = logits.max(-1, keepdims=True)
    lse = np.log(np.sum(np.exp(logits - m), -1)) + m[..., 0]
    lp = np.take_along_axis(logits[:, :-1], toks[:, 1:, None],
                            axis=-1)[..., 0] - lse[:, :-1]
    return (lp * mask[:, 1:]).sum(-1)


def test_score_matches_the_reference_and_the_f64_oracle(served):
    cfg, model, params = served
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    mask = (rng.random((3, 10)) > 0.3).astype(np.float32)
    srv = TS.Server(model)
    got = srv.score(params, toks, mask=mask).numpy()
    logits = model.logits(params, {"tokens": torch.from_numpy(toks)}) \
        .to(torch.float32).numpy()
    np.testing.assert_allclose(got, _f64_score(logits, toks, mask),
                               rtol=2e-4, atol=2e-4)
    # the reference's scoring reductions on the same logits
    jl = jnp.asarray(logits)
    lp = JS.batched_logprobs(jl[:, :-1], jnp.asarray(toks[:, 1:]))
    lp = lp * jnp.asarray(mask)[:, 1:]
    from repro.core import integration as jci
    want = np.asarray(jci.reduce_sum(lp, axis=-1, method="auto"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    full = srv.score(params, toks).numpy()
    assert not np.allclose(got, full)


def test_batched_logprobs_match_the_reference():
    rng = np.random.default_rng(5)
    for shape in ((2, 3, 64), (4, 1, 512), (1, 7, 4099)):
        logits = rng.standard_normal(shape).astype(np.float32) * 4.0
        toks = rng.integers(0, shape[-1], shape[:2]).astype(np.int32)
        got = TS.batched_logprobs(torch.from_numpy(logits),
                                  torch.from_numpy(toks)).numpy()
        want = np.asarray(JS.batched_logprobs(jnp.asarray(logits),
                                              jnp.asarray(toks)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        ref = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
        oracle = np.take_along_axis(np.asarray(ref), toks[..., None],
                                    axis=-1)[..., 0]
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_engine_refuses_oversized_encdec_and_a_mesh(served):
    cfg, model, params = served
    eng = TS.ContinuousServer(model, num_slots=2, capacity=16,
                              quant="none", device="cpu")
    big = [TS.Request(uid=0, prompt=np.zeros(12, np.int32), max_new=8)]
    with pytest.raises(ValueError, match="capacity"):
        list(eng.serve(params, big))
    with pytest.raises(ValueError, match="max_new"):
        list(eng.serve(params, [TS.Request(0, np.zeros(2, np.int32), 0)]))
    enc = TZ.build(TR.get_config("seamless-m4t-large-v2", smoke=True))
    with pytest.raises(ValueError, match="text decoders"):
        TS.ContinuousServer(enc, device="cpu")
    # a mesh of several ranks must be a live compat.Mesh
    # (tests/test_torch_serve_mesh.py serves over one)
    with pytest.raises(TypeError, match="compat.Mesh"):
        TS.ContinuousServer(model, mesh="data2.model2", device="cpu")
    with pytest.raises(TypeError, match="compat.Mesh"):
        TS.Server(model, mesh="data2.model2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.ContinuousServer(model)


def test_server_serves_encdec_with_extras():
    """``Server`` takes the modality inputs ``ContinuousServer`` refuses:
    an enc-dec config generates from its source embeddings."""
    cfg = TR.get_config("seamless-m4t-large-v2", smoke=True)
    model = TZ.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    extras = TS._extras(cfg, rng, 2, 5, "cpu")
    out = TS.Server(model).generate(params, prompts, max_new=4,
                                    extras=extras)
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert np.all((out >= 0) & (out < cfg.vocab_size))


def test_warmup_and_background_sweeps(served, fresh_registries):
    cfg, model, params = served
    with TS.ContinuousServer(model, num_slots=2, capacity=16,
                             page_size=8, quant="none", device="cpu",
                             background_sweeps=True) as eng:
        assert tat.default_registry().sweep_worker is eng._sweeper
        out = eng.warmup(params)
        V = cfg.vocab_size
        assert out["scoring_shapes"] == ((1, 1, V), (2, 1, V))
        # pow-2 caps clamped to capacity - 1: {1, 2, 4, 8, 15}
        assert out["prefill_compiles"] == 5
        assert eng.warmup()["plans"] == 0
        reqs = [TS.Request(**d) for d in synthetic_requests(
            cfg.vocab_size, n=3, seed=3, min_len=3, max_len=8,
            min_new=2, max_new=4, bucket="pow2")]
        got = eng.generate(params, reqs)
        assert sorted(got) == [0, 1, 2]
        sweeper = eng._sweeper
    assert tat.default_registry().sweep_worker is None
    assert not sweeper._thread.is_alive()
    eng.close()


def test_temperature_stream_depends_on_seed_and_uid_only(served):
    cfg, model, params = served
    reqs = _requests(cfg.vocab_size, n=4, seed=5, max_new=8)

    def run(num_slots, seed):
        eng = TS.ContinuousServer(model, num_slots=num_slots, capacity=CAP,
                                  page_size=8, quant="none",
                                  temperature=1.0, seed=seed, device="cpu")
        return eng.generate(params, reqs)
    a, b, c = run(2, 11), run(1, 11), run(2, 12)
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=uid)
    assert any(not np.array_equal(a[u], c[u]) for u in a)
    # sampled, not greedy
    greedy = _engine(model).generate(params, reqs)
    assert any(not np.array_equal(a[u], greedy[u]) for u in a)
    srv = TS.Server(model, temperature=1.0, extra_capacity=16)
    prompts = np.stack([r.prompt[:3] for r in reqs])
    x = srv.generate(params, prompts, max_new=6, seed=3)
    np.testing.assert_array_equal(
        x, srv.generate(params, prompts, max_new=6, seed=3))
    assert not np.array_equal(
        x, srv.generate(params, prompts, max_new=6, seed=4))


def test_serve_cli_on_the_cpu(capsys, fresh_registries):
    TS.main(["--arch", "gemma2-2b", "--continuous", "--device", "cpu",
             "--batch", "2", "--prompt-len", "6", "--max-new", "3",
             "--capacity", "16", "--quant", "int8", "--warmup"])
    out = capsys.readouterr().out
    assert "continuous: 6 tokens from 2 requests" in out
    TS.main(["--arch", "rwkv6-7b", "--device", "cpu", "--batch", "2",
             "--prompt-len", "5", "--max-new", "3"])
    assert "generated (2, 3)" in capsys.readouterr().out


def test_serve_lm_example_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for arch in serve_lm.ARCHS:
        assert arch in out
    assert "continuous int8" in out
