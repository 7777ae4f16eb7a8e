"""The port's SPMD train step over a mesh of ranks (``launch.train``'s
mesh form, ``SyntheticLMData(sharding=)``, the sharded AdamW state,
``checkpoint.manager``'s gather and elastic restore) — the counterparts
of the reference's ``tests/test_sharding_multidevice.py`` programs, held
to what they hold the reference to, and more.

One world of eight gloo ranks on the CPU (``launch.mesh.run_ranks``),
started once by a module-scoped fixture, computes what the cases read on
a (data 4, model 2) mesh, and the port's one-rank steps they are held
to, those side by side on its ranks; a second world of four ranks
restores its checkpoint onto a (data 2, model 2) mesh.  The ranks import no JAX: this
module imports JAX only inside the fixture and the tests that compute
the reference's values, in the test process.

Tolerances, each stated where it is used:

  * Gemma-2 2B SMOKE, 3 steps, microbatches 2, 4 x 2, against the JAX
    package's single-device ``jit_train_step`` on the same parameters
    and batch: the losses within rtol 0.03 (the reference test's);
    against the port's one-rank step: loss and both norms within rtol
    0.03 too (6e-4 seen: at the config's bf16 activations a rank's
    gradient products are rounded to bf16 before the ranks' sum, and
    Adam's first steps turn a near-zero gradient's sign into a whole
    step; at f32 activations the two agree to 1.4e-7);
  * one mesh step of each dense arch against the port's one-rank step
    on the same draw and batch: loss and ``param_norm`` rtol 1e-5,
    ``grad_norm`` rtol 2e-4 (bf16 gradient products summed over ranks
    in another order);
  * a masked batch whose ranks hold different token counts, f32
    activations, microbatches 2: loss, ``grad_norm`` and ``param_norm``
    rtol 1e-5 of one rank (a rank's own mean would be off by tens of
    percent);
  * the MoE archs (``models.moe``'s expert-parallel body, the expert
    leaves never gathered): DeepSeek-V3 SMOKE, the oracle's program,
    against the JAX package's single-device step on the same parameters
    (the port's draw, bridged) within rtol 0.03; one mesh step of each
    MoE arch under each layout against the port's one-rank step with f32
    activations, aux weight 0 and a capacity factor of E / k (no token
    dropped on either side): the dense archs' tolerances; the mesh's
    reported aux the mean of ``_aux_loss`` on each rank's own tokens
    within rtol 1e-6; ``etp`` against ``ep2d`` at the reference's
    ``_EP2D_PROG`` settings within its rtol 0.02;
  * the elastic restore 4 x 2 -> 2 x 2: the reference test's rtol 2e-3;
  * the gathered initial state against the one-card draw, a checkpoint
    against the state it saved, the sharded batch against the
    reference's rows: bit for bit.
"""

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.integration import _leaves
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train as TT
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP

WORLD = 8
MESH = (4, 2)
SMALL = (2, 2)
SHAPE = ShapeConfig("t", 16, 8, "train")        # the reference test's
DENSE = ("gemma2-2b", "gemma3-27b", "glm4-9b", "mistral-large-123b",
         "llama-3.2-vision-90b", "seamless-m4t-large-v2", "rwkv6-7b",
         "recurrentgemma-2b")
MOE = ("deepseek-v3-671b", "arctic-480b")
LAYOUTS = ("etp", "ep2d")
TCONF = dict(total_steps=10, warmup_steps=2)
# which rank of the world computes each one-rank reference
ONE_RANK = {**{arch: rank for rank, arch in enumerate(DENSE)},
            "oracle": 3, "masked": 2,
            **{f"moe:{arch}": rank for rank, arch in zip((4, 5), MOE)}}


def _batch_np(vocab: int) -> dict:
    """The reference test's batch: (8, 16) tokens and labels from
    default_rng(0), every token counted."""
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (8, 16)).astype(np.int32),
            "labels": rng.integers(0, vocab, (8, 16)).astype(np.int32),
            "mask": np.ones((8, 16), np.float32)}


def _masked_batch_np(vocab: int) -> dict:
    """Row r counts 2 r + 1 tokens: the ranks of a 4-way data axis hold
    4, 12, 20 and 28 of them."""
    b = _batch_np(vocab)
    b["mask"] = (np.arange(16)[None, :] < 2 * np.arange(8)[:, None] + 1) \
        .astype(np.float32)
    return b


def _data_batch(cfg) -> dict:
    """A whole batch of SHAPE from the synthetic pipeline (modality
    inputs too)."""
    from repro_torch.data.pipeline import SyntheticLMData
    return SyntheticLMData(cfg, SHAPE, seed=3, device="cpu").batch_at(0)


def _metrics(m) -> list:
    return [float(m[k]) for k in ("loss", "grad_norm", "param_norm")]


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype=torch.float32)


def _no_drop(arch: str, layout: str = "etp"):
    """An MoE arch at SMOKE with f32 activations, aux weight 0 (a mesh's
    aux is the mean of each rank's own, which one rank's is not) and a
    capacity factor of E / k, so that no expert drops a token on one rank
    or on a mesh."""
    cfg = TR.get_config(arch, smoke=True)
    mc = cfg.moe
    return dataclasses.replace(
        cfg, compute_dtype=torch.float32, moe_layout=layout,
        moe=dataclasses.replace(mc, aux_loss_weight=0.0,
                                capacity_factor=mc.num_experts / mc.top_k))


def _moe_x(cfg) -> np.ndarray:
    """An (8, 16, d) input of moe_block: 8 rows over the 4-way data
    axis, 16 positions over the 2-way model axis."""
    rng = np.random.default_rng(11)
    return rng.normal(size=(8, 16, cfg.d_model)).astype(np.float32)


def _moe_params(cfg):
    from repro_torch.models import moe as TMOE
    return TP.init_tree(torch.Generator().manual_seed(4),
                        TMOE.moe_specs(cfg), device="cpu")


def _moe_aux_rank(mesh) -> dict:
    """moe_block on this rank's rows and expert blocks inside
    ``local_step``: the aux share of each arch and layout, folded over
    the batch axis as the train step folds its metrics."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tc_collectives import psum_scalar
    from repro_torch.models import moe as TMOE
    out = {}
    for arch in MOE:
        for layout in LAYOUTS:
            cfg = _no_drop(arch, layout)
            params = _moe_params(cfg)
            specs = TMOE.block_specs(cfg, dict(mesh.shape))
            local = {k: shd.local_shard(v, specs[k], mesh) if k in specs
                     else v for k, v in params.items()}
            x = shd.local_shard(torch.from_numpy(_moe_x(cfg)),
                                shd.P("data"), mesh)
            with torch.no_grad(), shd.local_step(mesh, ("data",)):
                _, aux = TMOE.moe_block(local, cfg, x)
            out[f"{arch}/{layout}"] = _gather(float(psum_scalar(
                aux, ("data",), mesh=mesh, method="vpu")))
    return out


def _gather(value):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _mesh_step(cfg, mesh, k: int = 1):
    model = TZ.build(cfg)
    return TT.jit_train_step(model, TrainConfig(microbatches=k, **TCONF),
                             mesh, model.input_specs(SHAPE), device="cpu")


def _cut(b_shard, batch) -> dict:
    return {k: b_shard[k].shard(torch.as_tensor(v)) for k, v in batch.items()}


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().contiguous().view(torch.int32).numpy().copy()


def _world_rank(tmp: str, p0: list) -> dict:
    """Everything the cases read, computed on each of the eight ranks;
    rank 0's dict comes back."""
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed import sharding as shd
    mesh = launch_mesh.make_local_mesh(*MESH, device="cpu")
    out = {}
    gemma = TR.get_config("gemma2-2b", smoke=True)

    # the oracle's own program: microbatches 2, the reference's
    # parameters carried across, 4 steps with a checkpoint after the
    # second (the elastic program's first half)
    step, init, s_shard, b_shard = _mesh_step(gemma, mesh, k=2)
    st = init(0)
    for x, w in zip(_leaves(st.params), p0):     # each rank's blocks
        shd.local(x).copy_(shd.dtensor_sharding(x).shard(torch.from_numpy(w)))
    batch = _cut(b_shard, _batch_np(gemma.vocab_size))
    out["oracle"] = []
    for i in range(4):
        st, m = step(st, batch)
        out["oracle"].append(_metrics(m))
        if i == 1:
            ckpt.save(os.path.join(tmp, "elastic"), 2, st)

    # the sharded draw gathers to the one-card draw, bit for bit; a
    # checkpoint of it holds the same bits, a zero's sign too
    st = init(0)
    ref = TZ.build(gemma).init(torch.Generator().manual_seed(0), device="cpu")
    out["init_bits"] = _gather(all(
        np.array_equal(_bits(shd.whole(a)), _bits(b))
        for a, b in zip(_leaves(st.params), _leaves(ref))))
    # a moment split over both axes, its blocks -0.0
    key, signed = next((key, leaf) for key, leaf in ckpt._flatten(st)
                       if key.startswith(".opt/.m/") and len(shd.spec_axes(
                           shd.dtensor_sharding(leaf).spec)) == 2)
    shd.local(signed).fill_(-0.0)
    ckpt.save(os.path.join(tmp, "bits"), 0, st)
    stored = np.load(os.path.join(tmp, "bits", "step_00000000",
                                  "arrays.npz"))
    out["saved_bits"] = _gather(all(
        np.array_equal(stored[k].view(np.int32), _bits(shd.whole(leaf)))
        for k, leaf in ckpt._flatten(st) if leaf.dtype == torch.float32))
    out["signed_zero_saved"] = bool(np.all(np.signbit(stored[key])))

    # one step of every dense arch on the pipeline's batch
    out["dense"] = {}
    for arch in DENSE:
        cfg = TR.get_config(arch, smoke=True)
        step, init, _, b_shard = _mesh_step(cfg, mesh)
        _, m = step(init(0), _cut(b_shard, _data_batch(cfg)))
        out["dense"][arch] = _metrics(m)

    # a masked batch whose ranks hold different token counts, f32
    # activations, microbatches 2
    step, init, _, b_shard = _mesh_step(_f32(gemma), mesh, k=2)
    batch = _cut(b_shard, _masked_batch_np(gemma.vocab_size))
    out["masked_counts"] = _gather(float(batch["mask"].sum()))
    _, m = step(init(0), batch)
    out["masked"] = _metrics(m)

    # the sharded pipeline: this rank's rows of the global batch
    data = SyntheticLMData(gemma, SHAPE, seed=7, device="cpu",
                           sharding=shd.NamedSharding(mesh, shd.P(("data",))))
    out["rows"] = _gather({k: v.numpy() for k, v in data.batch_at(1).items()})
    out["coords"] = _gather(mesh.coordinate)

    # the MoE archs: the oracle's program for DeepSeek-V3 from the
    # port's draw, which the JAX reference takes bridged
    ds = TR.get_config("deepseek-v3-671b", smoke=True)
    step, init, _, b_shard = _mesh_step(ds, mesh, k=2)
    st = init(0)
    batch = _cut(b_shard, _batch_np(ds.vocab_size))
    out["moe_oracle"] = []
    for _ in range(3):
        st, m = step(st, batch)
        out["moe_oracle"].append(_metrics(m))
    # one step of each MoE arch under each layout, no token dropped;
    # which leaves the step gathered
    out["moe"], out["moe_gathered"] = {}, {}
    for arch in MOE:
        for layout in LAYOUTS:
            cfg = _no_drop(arch, layout)
            step, init, _, b_shard = _mesh_step(cfg, mesh)
            TT.GATHERED.clear()
            _, m = step(init(0), _cut(b_shard, _data_batch(cfg)))
            out["moe"][f"{arch}/{layout}"] = _metrics(m)
            model = TZ.build(cfg)
            out["moe_gathered"][f"{arch}/{layout}"] = {
                "gathered": dict(TT.GATHERED),
                "paths": TT.leaf_paths(model.specs),
                "experts": TT.expert_leaves(model)}
    # the reference's _EP2D_PROG: DeepSeek-V3 with 8 experts, 3 steps
    out["ep2d_prog"] = {}
    for layout in LAYOUTS:
        cfg = dataclasses.replace(ds, moe_layout=layout, moe=dataclasses
                                  .replace(ds.moe, num_experts=8))
        step, init, _, b_shard = _mesh_step(cfg, mesh)
        st = init(0)
        batch = _cut(b_shard, _batch_np(cfg.vocab_size))
        out["ep2d_prog"][layout] = []
        for _ in range(3):
            st, m = step(st, batch)
            out["ep2d_prog"][layout].append(float(m["loss"]))
    out["moe_aux"] = _moe_aux_rank(mesh)
    # experts that do not split over data are refused, naming the shapes
    try:
        _mesh_step(dataclasses.replace(ds, moe=dataclasses.replace(
            ds.moe, num_experts=6)), mesh)
        out["moe_refused"] = None
    except ValueError as e:
        out["moe_refused"] = str(e)

    # the port's one-rank steps the cases hold these to, one a rank
    # (ONE_RANK), the ranks side by side
    import torch.distributed as dist
    mine = {}
    for job, rank in ONE_RANK.items():
        if rank != dist.get_rank():
            continue
        if job == "oracle":
            mine[job] = _one_rank(gemma, _batch_np(gemma.vocab_size), k=2,
                                  steps=3, p0=p0)
        elif job == "masked":
            (mine[job],) = _one_rank(_f32(gemma), _masked_batch_np(
                gemma.vocab_size), k=2)
        elif job.startswith("moe:"):
            cfg = _no_drop(job[4:])
            (mine[job],) = _one_rank(cfg, _data_batch(cfg))
        else:
            cfg = TR.get_config(job, smoke=True)
            (mine[job],) = _one_rank(cfg, _data_batch(cfg))
    out["one_rank"] = {k: v for got in _gather(mine) for k, v in got.items()}
    return out


def _tree(like, leaves: list):
    from repro_torch.core.integration import _tree_like
    return _tree_like(like, TP.from_numpy(leaves, device="cpu"))


def _restore_rank(tmp: str) -> list:
    """The elastic program's second half on a new world of four ranks:
    ``remesh`` keeps the model axis (2), restore, 2 steps."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import fault_tolerance as ft
    mesh = ft.remesh(model_parallel=SMALL[1], device="cpu")
    assert tuple(mesh.shape.values()) == SMALL, mesh
    gemma = TR.get_config("gemma2-2b", smoke=True)
    step, init, _, b_shard = _mesh_step(gemma, mesh, k=2)
    state, at = ckpt.restore(os.path.join(tmp, "elastic"), init(1))
    assert at == 2 and int(state.step) == 2
    batch = _cut(b_shard, _batch_np(gemma.vocab_size))
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def ref():
    """The JAX package's single-device program: its initial parameters
    (numpy leaves) and three steps' losses, microbatches 2."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as JR
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import train as JT
    from repro.launch.mesh import make_local_mesh
    from repro.models import model_zoo as JZ
    jcfg = JR.get_config("gemma2-2b", smoke=True)
    jm = JZ.build(jcfg)
    step, init, s_shard, _ = JT.jit_train_step(
        jm, JTrainConfig(microbatches=2, **TCONF), make_local_mesh(1, 1),
        jm.input_specs(JShape("t", 16, 8, "train")))
    st = jax.jit(init, out_shardings=s_shard)(jax.random.PRNGKey(0))
    p0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(st.params)]
    batch = {k: jnp.asarray(v) for k, v in _batch_np(jcfg.vocab_size).items()}
    losses = []
    for _ in range(3):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    return {"p0": p0, "losses": losses}


def _jax_moe_oracle() -> list:
    """The JAX package's single-device program for DeepSeek-V3 SMOKE
    (microbatches 2, three steps' losses) from the port's ``init(0)``,
    bridged leaf by leaf."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as JR
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import train as JT
    from repro.launch.mesh import make_local_mesh
    from repro.models import model_zoo as JZ
    arch = "deepseek-v3-671b"
    p0 = [x.numpy() for x in _leaves(TZ.build(TR.get_config(
        arch, smoke=True)).init(torch.Generator().manual_seed(0),
                                device="cpu"))]
    jcfg = JR.get_config(arch, smoke=True)
    jm = JZ.build(jcfg)
    step, init, s_shard, _ = JT.jit_train_step(
        jm, JTrainConfig(microbatches=2, **TCONF), make_local_mesh(1, 1),
        jm.input_specs(JShape("t", 16, 8, "train")))
    st = jax.jit(init, out_shardings=s_shard)(jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(st.params)
    assert treedef.num_leaves == len(p0)
    st = dataclasses.replace(st, params=jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in p0]))
    batch = {k: jnp.asarray(v) for k, v in _batch_np(jcfg.vocab_size).items()}
    losses = []
    for _ in range(3):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def run(ref, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spmd"))
    # the JAX package's DeepSeek-V3 program runs beside the ranks
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        moe_ref = pool.submit(_jax_moe_oracle)
        out = launch_mesh.run_ranks(_world_rank, WORLD, backend="gloo",
                                    args=(tmp, ref["p0"]), timeout=300)
        out["elastic"] = launch_mesh.run_ranks(_restore_rank, 4,
                                               backend="gloo", args=(tmp,),
                                               timeout=120)
        out["moe_ref"] = moe_ref.result()
    return out


def _one_rank(cfg, batch, *, k: int = 1, steps: int = 1, p0=None):
    """The port's one-rank step's metrics, from ``init(0)`` (or ``p0``)."""
    model = TZ.build(cfg)
    step, init = TT.make_train_step(model, TrainConfig(microbatches=k,
                                                       **TCONF),
                                    device="cpu")
    st = init(0)
    if p0 is not None:
        from repro_torch.optim import adamw
        st.params = _tree(st.params, p0)
        st.opt = adamw.init(st.params)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    rows = []
    for _ in range(steps):
        st, m = step(st, batch)
        rows.append(_metrics(m))
    return rows


# ------------------------------------------------------------------ cases


def test_state_shardings_match_the_reference_specs():
    """``state_shardings`` on a fake (data 4, model 2) mesh: the
    parameters' and both moments' specs are the reference's ``spec_for``
    over ``axes_tree``, leaf by leaf; the count and step replicated."""
    import jax
    from repro.distributed import sharding as jshd
    from repro.models.param import axes_tree as jaxes_tree

    class _Fake:
        shape = {"data": 4, "model": 2}

    from repro.configs import registry as JR
    from repro.models import model_zoo as JZ
    jm = JZ.build(JR.get_config("gemma2-2b", smoke=True))
    is_axes = lambda t: isinstance(t, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in t)
    jaxes = jax.tree_util.tree_leaves(jaxes_tree(jm.specs), is_leaf=is_axes)
    jshapes = jax.tree_util.tree_leaves(jm.param_shapes())
    want = [tuple(jshd.spec_for(s.shape, a, _Fake(), jshd.DEFAULT_RULES))
            for s, a in zip(jshapes, jaxes)]
    model = TZ.build(TR.get_config("gemma2-2b", smoke=True))
    s_shard = TT.state_shardings(model, _Fake(), TT._state_shapes(
        model, TrainConfig()))
    for tree in (s_shard.params, s_shard.opt.m, s_shard.opt.v):
        assert [tuple(s.spec) for s in _leaves(tree)] == want
    assert any(spec != (None,) * len(spec) for spec in want)
    assert tuple(s_shard.opt.count.spec) == tuple(s_shard.step.spec) == ()


def test_sharded_batch_rows_match_the_reference(run):
    """Each rank's ``SyntheticLMData(sharding=P(("data",)))`` rows are
    its data row's block of the reference's ``batch_at`` global batch,
    bit for bit; the ranks along model hold the same rows."""
    from repro.configs import registry as JR
    from repro.data.pipeline import SyntheticLMData as JData
    want = JData(JR.get_config("gemma2-2b", smoke=True), SHAPE,
                 seed=7).batch_at(1)
    rows = SHAPE.global_batch // MESH[0]
    for got, coord in zip(run["rows"], run["coords"]):
        lo = coord["data"] * rows
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[k])[lo:lo + rows])


def test_sharded_init_gathers_to_the_one_card_draw(run):
    assert run["init_bits"] == [True] * WORLD


def test_checkpoint_holds_the_gathered_state_bit_for_bit(run):
    """Every f32 leaf of a sharded state's checkpoint equals the state
    gathered on every rank, bit for bit; a moment of -0.0 blocks is
    stored as -0.0 (ROADMAP C1)."""
    assert run["saved_bits"] == [True] * WORLD
    assert run["signed_zero_saved"]


def test_spmd_train_matches_the_reference_single_device(run, ref):
    """The counterpart of the reference's
    ``test_spmd_train_matches_single_device`` for Gemma-2 2B: the port's
    4 x 2 losses against the JAX package's single-device step (rtol
    0.03, the reference test's), and the loss falls."""
    got = [row[0] for row in run["oracle"][:3]]
    np.testing.assert_allclose(got, ref["losses"], rtol=0.03)
    assert ref["losses"][-1] < ref["losses"][0]
    assert got[-1] < got[0]


def test_spmd_train_matches_one_rank(run):
    """The same 4 x 2 program against the port's one-rank step on the
    same parameters: loss, grad_norm and param_norm within the oracle's
    rtol 0.03 (see the module docstring)."""
    np.testing.assert_allclose(run["oracle"][:3], run["one_rank"]["oracle"],
                               rtol=0.03)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_mesh_step_matches_one_rank(run, arch):
    """One 4 x 2 step of each dense arch at SMOKE against the port's
    one-rank step on the same draw and batch: loss and param_norm rtol
    1e-5, grad_norm rtol 2e-4."""
    want = run["one_rank"][arch]
    got = run["dense"][arch]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=arch)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, err_msg=arch)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, err_msg=arch)


def test_masked_batch_takes_the_global_mean(run):
    """The ranks hold 4 to 28 tokens each (every model column the same;
    each of its two microbatches a different share), and the mesh step's
    loss, grad_norm and param_norm are one rank's within rtol 1e-5: a
    rank divides its masked sum by every rank's count."""
    counts = sorted(set(run["masked_counts"]))
    assert counts == [4.0, 12.0, 20.0, 28.0]
    np.testing.assert_allclose(run["masked"], run["one_rank"]["masked"],
                               rtol=1e-5)


def test_elastic_restore_onto_smaller_mesh(run):
    """The counterpart of the reference's
    ``test_elastic_restore_onto_smaller_mesh``: the oracle's program
    checkpointed on 4 x 2 after 2 steps, a new world of four ranks
    remeshed to 2 x 2, restore, 2 steps — the losses match the
    uninterrupted run's steps 3 and 4 (rtol 2e-3)."""
    np.testing.assert_allclose(run["elastic"],
                               [row[0] for row in run["oracle"][2:]],
                               rtol=2e-3)


def test_moe_spmd_train_matches_the_reference_single_device(run):
    """The DeepSeek-V3 half of the reference's
    ``test_spmd_train_matches_single_device``: the port's 4 x 2 losses
    (the expert-parallel body, etp) against the JAX package's
    single-device step on the same parameters and batch (rtol 0.03, the
    reference test's; a rank's capacity comes from its own tokens, as in
    the reference, so the mesh may drop other tokens than one device),
    and the loss falls."""
    got = [row[0] for row in run["moe_oracle"]]
    want = run["moe_ref"]
    np.testing.assert_allclose(got, want, rtol=0.03)
    assert want[-1] < want[0]
    assert got[-1] < got[0]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_arch_mesh_step_matches_one_rank(run, arch, layout):
    """One 4 x 2 step of each MoE arch under each layout against the
    port's one-rank step on the same draw and batch (f32 activations,
    aux weight 0, capacity factor E / k: no token dropped): loss and
    param_norm rtol 1e-5, grad_norm rtol 2e-4 (the dense archs')."""
    want = run["one_rank"][f"moe:{arch}"]
    got = run["moe"][f"{arch}/{layout}"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_mesh_step_never_gathers_an_expert_leaf(run, arch, layout):
    """Counted per leaf: the step gathers every other leaf once and no
    expert leaf (``wi_gate``, ``wi_up``, ``wo`` of each MoE layer)."""
    got = run["moe_gathered"][f"{arch}/{layout}"]
    experts = [p for p, kind in zip(got["paths"], got["experts"]) if kind]
    assert len(experts) == 3
    assert {p: got["gathered"].get(p, 0) for p in experts} == \
        {p: 0 for p in experts}
    assert got["gathered"] == {p: 1 for p in got["paths"]
                               if p not in experts}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", MOE)
def test_moe_reported_aux_is_the_mean_over_the_shards(run, arch, layout):
    """``moe_block`` inside ``local_step`` returns this rank's share of
    the aux loss; folded over the batch axis it is the mean of
    ``_aux_loss`` on each rank's own tokens (etp: a data row's block,
    ep2d: its model slice of the sequence too) within rtol 1e-6, the
    same on every rank."""
    from repro_torch.models import moe as TMOE
    cfg = _no_drop(arch, layout)
    params = _moe_params(cfg)
    x = _moe_x(cfg)
    pieces = [x[r:r + 2] for r in range(0, 8, 2)]
    if layout == "ep2d":
        pieces = [p[:, m:m + 8] for p in pieces for m in (0, 8)]
    auxes = []
    for p in pieces:
        flat = torch.from_numpy(p).reshape(-1, cfg.d_model)
        ids, _, probs = TMOE._route(cfg, params["router"], flat)
        auxes.append(float(TMOE._aux_loss(cfg, probs, ids)))
    got = run["moe_aux"][f"{arch}/{layout}"]
    assert len(set(got)) == 1
    np.testing.assert_allclose(got[0], np.mean(auxes), rtol=1e-6)


def test_moe_ep2d_layout_matches_etp(run):
    """The counterpart of the reference's
    ``test_moe_ep2d_layout_matches_etp``: DeepSeek-V3 SMOKE with 8
    experts on 4 x 2, three steps' losses under ep2d within rtol 0.02 of
    etp."""
    np.testing.assert_allclose(run["ep2d_prog"]["ep2d"],
                               run["ep2d_prog"]["etp"], rtol=0.02)


def test_moe_experts_that_do_not_split_are_refused(run):
    """Six experts over a 4-way data axis: the step is refused when it is
    built, naming the shapes."""
    msg = run["moe_refused"]
    assert msg is not None and "E 6" in msg and "data (4)" in msg
