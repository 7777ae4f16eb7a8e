"""The port's training path (``repro_torch.launch.train``,
``optim.adamw``, ``distributed.tc_collectives``,
``distributed.fault_tolerance``, the ``train_lm`` and ``quickstart``
examples) against the JAX package's, on the CPU: the counterparts of
``tests/test_train_and_checkpoint.py`` (``remesh`` is in
``tests/test_torch_mesh.py``) and more.

Tolerances, each stated where it is used:

  * AdamW against the numpy formula: rtol 1e-5 (the reference test's);
    against ``repro.optim.adamw.update`` over three steps (clip, weight
    decay, f32 and bf16 moments): rtol 1e-5, atol 1e-7 (f32 math on both
    sides, some of it fused on one);
  * the cosine schedule against the reference's: rtol 1e-6;
  * the collectives on one device against the reference's: rtol 1e-6
    (``vpu``, ``pallas``) and the port against the f64 norm within
    2e-6 under ``mma`` (the reference's ``mma`` sits ~4e-5 below it on
    the CPU, so port and reference agree there to 1e-4);
  * three train steps of Gemma-2 2B SMOKE with f32 activations against
    the reference's ``jit_train_step`` on the same parameters and batch:
    the loss within 1e-6 relative, ``grad_norm`` and ``param_norm``
    within 1e-4 (the reference's ``mma`` norm, above), every parameter
    within 5 % of the largest change the three steps made (the clip
    scale follows the norms, and Adam's normalised step carries it); at
    the config's bf16 activations the loss within 1e-3 and the norms
    within 5e-3;
  * microbatching: the reference test's rtol 2e-4 (loss), 2e-3 (norm);
  * the crash-resume run and ``reassign``: bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import autotune as jat
from repro.distributed import fault_tolerance as JF
from repro.distributed import tc_collectives as JC
from repro.launch import train as JT
from repro.launch.mesh import make_local_mesh
from repro.models import model_zoo as JZ
from repro.optim import adamw as JA
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import registry as TR
from repro_torch.configs.base import TrainConfig
from repro_torch.core import autotune
from repro_torch.core.integration import _leaves
from repro_torch.distributed import fault_tolerance as TF
from repro_torch.distributed import tc_collectives as TC
from repro_torch.launch import train as TT
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP
from repro_torch.optim import adamw


def _batch_np(vocab, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": np.ones((b, s), np.float32)}


def _state_leaves(st) -> list:
    return _leaves(st.params) + _leaves(st.opt.m) + _leaves(st.opt.v) \
        + [st.opt.count, st.step]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _setup(microbatches=1, b=4, s=16, **cfg_kw):
    cfg = dataclasses.replace(TR.get_config("gemma2-2b", smoke=True),
                              **cfg_kw)
    tconf = TrainConfig(microbatches=microbatches, total_steps=20,
                        warmup_steps=2)
    step, make_init = TT.make_train_step(TZ.build(cfg), tconf,
                                         device="cpu")
    return step, make_init, _t(_batch_np(cfg.vocab_size, b, s))


# --------------------------------------------------------------- adamw


def test_adamw_against_reference():
    """One AdamW step vs a hand-written numpy reference."""
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    st = adamw.init(p)
    p0 = p["w"].numpy().copy()
    keep = p["w"]
    newp, newst, _ = adamw.update(
        g, st, p, lr=0.1, beta1=0.9, beta2=0.999, eps=1e-8,
        weight_decay=0.0, grad_clip=None)
    gn = g["w"].numpy()
    m = 0.1 * gn
    v = 0.001 * gn * gn
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.999)
    want = p0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-5)
    # written in place: the parameters, the moments and the count
    assert newp["w"] is keep and newst is st
    np.testing.assert_allclose(st.m["w"].numpy(), m, rtol=1e-6)
    assert int(newst.count) == 1


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(moments):
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}
    grads = [{"a": rng.normal(size=(5, 7)).astype(np.float32) * s,
              "b": {"c": rng.normal(size=(11,)).astype(np.float32) * s}}
             for s in (3.0, 0.1, 1.0)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = JA.init(jp, moment_dtype=getattr(jnp, moments))
    tp = TP.from_numpy(params, device="cpu")
    tst = adamw.init(tp, moment_dtype=getattr(torch, moments))
    kw = dict(lr=0.01, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=1.0)
    for g in grads:
        jp, jst, jm = JA.update(jax.tree_util.tree_map(jnp.asarray, g),
                                jst, jp, **kw)
        tg = TP.from_numpy(g, device="cpu")
        tp, tst, tm = adamw.update(tg, tst, tp, **kw)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    for got, want in zip(
            _leaves(tp) + _leaves(tst.m) + _leaves(tst.v),
            jax.tree_util.tree_leaves((jp, jst.m, jst.v))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-7)
    assert int(tst.count) == int(jst.count) == 3
    assert all(m.dtype == getattr(torch, moments) for m in _leaves(tst.m))
    assert adamw.state_axes({"w": ("embed",)}).m == {"w": ("embed",)}


def test_cosine_schedule_shape_and_values():
    lrs = [float(adamw.cosine_schedule(s, base_lr=1.0, warmup_steps=10,
                                       total_steps=100))
           for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    for s in (0, 1, 3, 17, 64, 99, 150):
        want = float(JA.cosine_schedule(jnp.asarray(s), base_lr=3e-4,
                                        warmup_steps=7, total_steps=100))
        got = float(adamw.cosine_schedule(torch.tensor(s), base_lr=3e-4,
                                          warmup_steps=7, total_steps=100))
        assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("method", ["mma", "vpu", "pallas", "auto"])
def test_grad_clip_uses_mma_norm(method):
    g = {"a": torch.full((100,), 3.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0, method=method)
    np.testing.assert_allclose(float(norm), 30.0, rtol=1e-5)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-4)
    small, norm = adamw.clip_by_global_norm(g, 100.0, method=method)
    assert torch.equal(small["a"], g["a"])


# ---------------------------------------------------------- collectives


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb": rng.normal(size=(300, 17)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(4097,)).astype(np.float32)]}


@pytest.mark.parametrize("method", ["mma", "vpu", "pallas", "auto",
                                    "mma_chained", "fused_pallas"])
def test_collectives_match_the_reference_on_one_device(method):
    tree = _tree()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = TP.from_numpy(tree, device="cpu")
    oracle = np.sqrt(sum(np.sum(a.astype(np.float64) ** 2)
                         for a in jax.tree_util.tree_leaves(tree)))
    if method == "fused_pallas":                 # no such reduce engine
        for fn in (TC.tc_global_norm, JC.tc_global_norm):
            with pytest.raises(ValueError, match="unknown"):
                fn(jt if fn is JC.tc_global_norm else tt, method=method)
        return
    got = float(TC.tc_global_norm(tt, method=method))
    want = float(JC.tc_global_norm(jt, method=method))
    tol = 1e-4 if method in ("mma", "auto") else 1e-6
    assert got == pytest.approx(want, rel=tol)
    assert got == pytest.approx(oracle, rel=2e-6)
    sums = TC.tc_all_reduce(tt, method=method)
    jsums = JC.tc_all_reduce(jt, method=method)
    for a, b in zip(_leaves(sums), jax.tree_util.tree_leaves(jsums)):
        assert a.ndim == 0 and a.dtype == torch.float32
        assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-3)
    sq = TC.tc_psum(tt["emb"], op="squared_sum", method=method)
    assert float(sq) == pytest.approx(float(np.sum(
        tree["emb"].astype(np.float64) ** 2)), rel=2e-6)


def test_collectives_refuse_a_mesh_and_bad_arguments():
    """A mesh given as a signature names no ranks: over more than one
    it raises, naming the live mesh it needs.  ``via='gspmd'`` is served
    (with no mesh it is plain dispatch, as ``'shard_map'`` is)."""
    x = torch.ones(8)
    with pytest.raises(ValueError, match="needs a live mesh"):
        TC.tc_psum(x, mesh=(("data", 2),))
    with pytest.raises(ValueError, match="needs a live mesh"):
        TC.tc_global_norm({"x": x}, mesh="data2.model2")
    assert float(TC.tc_psum(x, mesh=(("data", 1),))) == 8.0
    with pytest.raises(ValueError, match="scalar reduce ops"):
        TC.tc_psum(x, op="scan")
    with pytest.raises(ValueError, match="unknown via"):
        TC.tc_psum(x, via="xla")
    assert float(TC.tc_psum(x, via="gspmd")) == 8.0
    assert float(TC.tc_global_norm({"x": x}, via="gspmd")) == \
        float(TC.tc_global_norm({"x": x}))
    assert float(TC.tc_global_norm({})) == 0.0


# ------------------------------------------------------------ training


def test_loss_decreases():
    step, make_init, batch = _setup()
    state = make_init(0)
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(v) for v in losses)
    assert int(state.step) == 5
    assert sorted(m) == ["ce", "grad_norm", "loss", "lr", "param_norm"]


def test_microbatch_equivalence():
    """k=2 gradient accumulation must match k=1 on a uniform mask."""
    step1, init1, batch = _setup(microbatches=1)
    step2, init2, _ = _setup(microbatches=2)
    _, m1 = step1(init1(0), batch)
    _, m2 = step2(init2(0), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=2e-3)


def test_microbatches_split_strided():
    batch = {"x": torch.arange(8)[:, None]}
    mbs = TT._split_microbatches(batch, 2)
    assert mbs[0]["x"][:, 0].tolist() == [0, 2, 4, 6]
    assert mbs[1]["x"][:, 0].tolist() == [1, 3, 5, 7]


def test_supervisor_crash_resume_bit_identical(tmp_path):
    """Train 4 steps with saves -> 'crash' -> resume -> the resumed state
    equals the uninterrupted run (the checkpoint/restart contract)."""
    step, make_init, batch = _setup()
    sup = TF.TrainSupervisor(str(tmp_path), save_every=2, async_save=False)
    ref = make_init(0)
    for _ in range(4):
        ref, _ = step(ref, batch)
    st = make_init(0)
    for _ in range(2):
        st, _ = step(st, batch)
    sup.maybe_save(2, st)
    sup.maybe_save(3, st)                        # not a multiple: no save
    assert ckpt.latest_step(str(tmp_path)) == 2
    st2, start = sup.restore_or_init(lambda: make_init(1))
    assert start == 2 and int(st2.step) == 2
    for _ in range(2):
        st2, _ = step(st2, batch)
    for a, b in zip(_state_leaves(ref), _state_leaves(st2)):
        assert torch.equal(a, b)
    sup.finalize(4, st2)
    assert ckpt.latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("f32", [True, False])
def test_train_steps_match_the_reference(f32):
    """Three steps of Gemma-2 2B SMOKE from the reference's initial state
    against its ``jit_train_step``."""
    kw = {"compute_dtype": jnp.float32} if f32 else {}
    jcfg = dataclasses.replace(JR.get_config("gemma2-2b", smoke=True), **kw)
    jm = JZ.build(jcfg)
    mesh = make_local_mesh(1, 1)
    jstep, jinit, s_shard, _ = JT.jit_train_step(
        jm, JTrainConfig(total_steps=20, warmup_steps=2), mesh,
        jm.input_specs(JShape("t", 16, 4, "train")))
    jst = jax.jit(jinit, out_shardings=s_shard)(jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(np.asarray, jst.params)
    bt = _batch_np(jcfg.vocab_size)
    step, make_init, _ = _setup(
        **({"compute_dtype": torch.float32} if f32 else {}))
    st = make_init(0)
    st.params = TP.from_numpy(p0, device="cpu")
    st.opt = adamw.init(st.params)
    for _ in range(3):
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in bt.items()})
        st, met = step(st, _t(bt))
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]),
                                                 rel=1e-6)
        for key, tol in (("loss", 1e-6 if f32 else 1e-3),
                         ("grad_norm", 1e-4 if f32 else 5e-3),
                         ("param_norm", 1e-4 if f32 else 5e-3)):
            assert float(met[key]) == pytest.approx(float(jmet[key]),
                                                    rel=tol), key
    if not f32:
        return
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst.params)]
    moved = max(np.max(np.abs(w - a)) for w, a in
                zip(want, jax.tree_util.tree_leaves(p0)))
    gap = max(np.max(np.abs(p.detach().numpy() - w))
              for p, w in zip(_leaves(st.params), want))
    assert gap <= 0.05 * moved, (gap, moved)


def test_state_axes_and_jit_train_step_shape():
    """Without a mesh ``jit_train_step`` returns the reference's shape
    with shardings of None (one card holds every leaf whole); on a fake
    (data 4, model 2) mesh the state's shardings follow the logical axes,
    a moment laid out as its parameter."""
    cfg = TR.get_config("gemma2-2b", smoke=True)
    model = TZ.build(cfg)
    shape = dataclasses.replace(TR.SHAPES["train_4k"], seq_len=8,
                                global_batch=2)
    step, make_init, s_shard, b_shard = TT.jit_train_step(
        model, TrainConfig(), None, model.input_specs(shape), device="cpu")
    assert b_shard == {"tokens": None, "labels": None, "mask": None}
    assert all(s is None for s in (*_leaves(s_shard.params),
                                   *_leaves(s_shard.opt.m),
                                   s_shard.opt.count, s_shard.step))
    assert TT.batch_axes(model.input_specs(shape))["tokens"] == \
        ("batch", None)
    s_axes = TT.state_logical_axes(model)
    assert s_axes.opt.m == s_axes.params == model.param_axes()
    state = make_init(0)
    assert all(p.device.type == "cpu" for p in _state_leaves(state))

    class _Fake:
        shape = {"data": 4, "model": 2}
    fake = TT.state_shardings(model, _Fake(),
                              TT._state_shapes(model, TrainConfig()))
    specs = [tuple(s.spec) for s in _leaves(fake.params)]
    assert [tuple(s.spec) for s in _leaves(fake.opt.v)] == specs
    assert ("data", "model") in {tuple(x for x in sp if x) for sp in specs}


def test_a_mesh_or_data_parallel_is_refused(tmp_path):
    """The CLI over a (data 2, model 2) mesh of four gloo ranks on the
    CPU (``--backend gloo``; its supervisor saving the sharded state at
    step 1 and at the end) logs the one-rank run's losses (rtol 1e-4),
    and its last checkpoint holds the one-rank run's parameters, whole
    (atol 2e-3: where the ranks' bf16 gradient sums flip a near-zero
    gradient's sign, Adam moves that element by up to 2 lr = 6e-4 the
    other way); what is still refused: a mesh of several ranks
    without a live process group and a mesh that is not a
    ``compat.Mesh``."""
    got = TT.main(["--arch", "gemma2-2b", "--steps", "2", "--batch", "4",
                   "--seq", "8", "--data-parallel", "2",
                   "--model-parallel", "2", "--backend", "gloo",
                   "--device", "cpu", "--timeout", "120",
                   "--ckpt-dir", str(tmp_path)])
    state, want = TT.run("gemma2-2b", steps=2, batch_override=4,
                         seq_override=8, device="cpu")
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    assert ckpt.latest_step(str(tmp_path)) == 2
    stored = np.load(os.path.join(str(tmp_path), "step_00000002",
                                  "arrays.npz"))
    for key, p in ckpt._flatten(state):
        if key.startswith(".params/"):
            np.testing.assert_allclose(stored[key], p.detach().numpy(),
                                       rtol=0, atol=2e-3, err_msg=key)
    with pytest.raises(RuntimeError, match="live torch.distributed"):
        TT.run("gemma2-2b", steps=1, data_parallel=2, device="cpu")
    with pytest.raises(RuntimeError, match="live torch.distributed"):
        TT.run("gemma2-2b", steps=1, model_parallel=2, device="cpu")

    class _Fake:
        shape = {"data": 2, "model": 1}
    model = TZ.build(TR.get_config("gemma2-2b", smoke=True))
    with pytest.raises(TypeError, match="compat.Mesh"):
        TT.make_train_step(model, TrainConfig(), mesh=_Fake())
    # the replan is served: a tuple names the geometry to keep
    reg = autotune.PlanRegistry()
    reg.put("reduce_sum|1024|float32|cpu|mesh:data8",
            autotune.ReductionPlan(method="vpu"))
    assert TF.replan_after_remesh((("data", 4),), registry=reg) == \
        ("reduce_sum|1024|float32|cpu|mesh:data8",)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    model = TZ.build(TR.get_config("gemma2-2b", smoke=True))
    _, make_init = TT.make_train_step(model, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.run("gemma2-2b", steps=1)


# ------------------------------------------------------ fault tolerance


@pytest.mark.parametrize("step,workers,shards", [(7, 4, 16), (12, 3, 9),
                                                 (0, 1, 5), (99, 8, 64)])
def test_reassign_bit_for_bit(step, workers, shards):
    got = TF.reassign(step, workers, shards)
    np.testing.assert_array_equal(got, JF.reassign(step, workers, shards))
    assert got.dtype == JF.reassign(step, workers, shards).dtype
    np.testing.assert_array_equal(got, TF.reassign(step, workers, shards))
    assert set(got) <= set(range(workers))
    counts = np.bincount(got, minlength=workers)
    assert counts.sum() == shards and counts.max() - counts.min() <= 1


def test_replan_after_remesh_drops_every_mesh_plan(fresh_plan_registry):
    reg = autotune.PlanRegistry()
    plan = autotune.ReductionPlan(method="mma")
    reg.put("reduce_sum|n1024|float32|cpu|mesh:data4.model2", plan)
    reg.put("reduce_sum|n1024|float32|cpu|mesh:data2", plan)
    reg.put("reduce_sum|n1024|float32|cpu", plan)
    reg.auto_memo["x"] = plan
    assert reg.mesh_signatures() == ("data2", "data4.model2")
    sup = TF.TrainSupervisor("unused")
    dead = sup.on_remesh(None, registry=reg)
    assert len(dead) == 2 and [k for k, _ in reg.items()] == [
        "reduce_sum|n1024|float32|cpu"]
    assert not reg.auto_memo
    assert TF.replan_after_remesh((("data", 1),), registry=reg) == ()
    # the reference drops the same keys for its single-device mesh
    jreg = jat.PlanRegistry()
    for key in ("reduce_sum|n1024|float32|cpu|mesh:data4.model2",
                "reduce_sum|n1024|float32|cpu|mesh:data2"):
        jreg.put(key, jat.ReductionPlan(method="mma"))
    assert sorted(JF.replan_after_remesh(None, registry=jreg)) == \
        sorted(dead)


# ------------------------------------------------------ CLI and examples


def test_train_cli_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = ["--arch", "gemma2-2b", "--steps", "3", "--batch", "2",
            "--seq", "8", "--ckpt-dir", d, "--device", "cpu"]
    TT.main(args)
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     2 loss" in out
    assert ckpt.latest_step(d) == 3
    # a restart resumes at the checkpoint: only step 3 runs
    TT.main(args[:2] + ["--steps", "4"] + args[4:])
    out = capsys.readouterr().out
    assert "step     3 loss" in out and "step     0" not in out
    assert ckpt.latest_step(d) == 4
    assert os.path.isfile(os.path.join(d, "step_00000004", "manifest.json"))


def test_train_lm_example_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The example at a tiny size (its config cut to 2 layers and a
    4096-token vocabulary): the config registers in the port's registry,
    the run trains, checkpoints and reports."""
    import sys
    from repro_torch.examples import train_lm
    # the example registers its config: keep that out of the registry
    # the other tests of this process read
    monkeypatch.setattr(TR, "_MODULES", dict(TR._MODULES))
    monkeypatch.setitem(sys.modules, "repro_torch.configs._train_lm_example",
                        None)
    full = train_lm.build_100m
    assert full().name == "gemma2-100m" and full().num_layers == 14
    monkeypatch.setattr(train_lm, "build_100m", lambda: dataclasses.replace(
        full(), num_layers=2, vocab_size=4096))
    history = train_lm.main(["--steps", "8", "--batch", "4", "--seq", "16",
                             "--ckpt-dir", str(tmp_path), "--device",
                             "cpu"])
    out = capsys.readouterr().out
    assert "training gemma2-100m" in out and "loss:" in out
    assert TR.get_config("gemma2-100m").num_layers == 2
    assert history[-1][0] == 7 and history[-1][1] < history[0][1]
    assert "(improved)" in out
    assert ckpt.latest_step(str(tmp_path)) == 8


def test_quickstart_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "fp64 oracle" in out and "method='auto'" in out
    lines = out.strip().splitlines()
    assert lines[-2].startswith("tiny-LM loss") \
        and lines[-1].startswith("grad global-norm")
    loss = float(lines[-2].split(":")[1])
    gnorm = float(lines[-1].split(":")[1])
    assert np.isfinite(loss) and 0 < gnorm < 1e3
    assert (loss, gnorm) == pytest.approx(
        quickstart.train_step_numbers("cpu"), rel=1e-4)
