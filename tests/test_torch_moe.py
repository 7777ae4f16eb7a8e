"""The port's Mixture-of-Experts (``repro_torch.models.moe``) and
``compat`` against the JAX package's, on the CPU, at the reduced
DeepSeek-V3 (sigmoid router, top-2 of 8, one shared expert) and Arctic
(softmax router, top-2 of 8, a dense residual MLP) shapes.

Parameters come from the reference's ``init_tree`` (carried across with
``models.param.from_numpy``); inputs are numpy draws from a seed, chosen
so that no token's k-th and (k+1)-th router scores lie within 1e-4 (a
one-ulp difference in the router logits could otherwise flip an expert,
which no tolerance should hide; each test asserts it first).  Then, in
order: the expert ids are equal, the counts and buffer offsets (the
triangular-MMA scan under EXACT_OFFSETS) and every slot are equal
exactly, and the outputs match — with ``compute_dtype`` f32 to 1e-4 of
max|ref| (the aux loss to 1e-5 relative), in bf16 within the reference's
model bound, max|got - ref| < 0.05 (max|ref| + 1).  A capacity factor of
0.25 makes experts overflow, so tokens are dropped.

The expert-parallel body over a mesh (``moe_block`` under
``axis_rules``, both layouts) runs on one world of eight gloo ranks on
the CPU (``launch.mesh.run_ranks``), started by a module fixture; it is
held to the JAX package's single-device ``moe_block`` at a capacity that
drops nothing, out within 1e-5 of max|ref|.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs import registry as TR
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import moe as TMOE
from repro_torch.models import param as TP

# The JAX package, imported by the ``_jax_package`` fixture in the test
# process only: the mesh test's ranks import this module, and no JAX.
jax = jnp = JR = ji = J_EXACT = JMOE = JP = None

ARCHS = ("deepseek-v3-671b", "arctic-480b")
LAYOUTS = ("etp", "ep2d")
GAP = 1e-4
MESH = (4, 2)
# the mesh test's input: 4 rows over data, 16 positions over model
MESH_X = (4, 16)


@pytest.fixture(scope="module", autouse=True)
def _jax_package():
    global jax, jnp, JR, ji, J_EXACT, JMOE, JP
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as JR
    from repro.core import integration as ji
    from repro.core.precision import EXACT_OFFSETS as J_EXACT
    from repro.models import moe as JMOE
    from repro.models import param as JP


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _cfgs(arch: str, dtype: str = "float32", **moe_kw):
    jcfg = JR.get_config(arch, smoke=True)
    tcfg = TR.get_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, compute_dtype=getattr(jnp, dtype),
                               moe=dataclasses.replace(jcfg.moe, **moe_kw))
    tcfg = dataclasses.replace(tcfg, compute_dtype=getattr(torch, dtype),
                               moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def _setup(arch: str, seed: int, tokens: int = 32, dtype="float32",
           **moe_kw):
    jcfg, tcfg = _cfgs(arch, dtype, **moe_kw)
    jp = JP.init_tree(jax.random.PRNGKey(seed), JMOE.moe_specs(jcfg))
    tp = TP.from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed).normal(
        size=(2, tokens // 2, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _assert_no_near_ties(jcfg, jp, x):
    """The precondition: every token's k-th and (k+1)-th scores (the
    sigmoid scores or the softmax probabilities, as the router ranks
    them) lie more than GAP apart."""
    logits = x.reshape(-1, x.shape[-1]) @ np.asarray(jp["router"])
    if jcfg.moe.router == "sigmoid":
        scores = 1.0 / (1.0 + np.exp(-logits))
    else:
        scores = np.exp(logits - logits.max(-1, keepdims=True))
        scores /= scores.sum(-1, keepdims=True)
    top = -np.sort(-scores, axis=-1)
    k = jcfg.moe.top_k
    assert float(np.min(top[:, k - 1] - top[:, k])) > GAP


def _close(got, want, dtype: str = "float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = float(np.max(np.abs(got - want)))
    if dtype == "float32":
        assert diff <= 1e-4 * float(np.max(np.abs(want))), diff
    else:
        assert diff < 0.05 * (float(np.max(np.abs(want))) + 1.0), diff


def _ref_slots(ids, e: int, cap: int):
    """The reference's dispatch plan, as ``repro.models.moe``'s
    ``_dispatch_combine`` computes it."""
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.zeros((e,), jnp.int32).at[flat_e].add(1)
    starts = jnp.round(ji.cumsum(counts, inclusive=False, method="mma",
                                 chain=1, precision=J_EXACT)).astype(
                                     jnp.int32)
    pos = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - starts[sorted_e]
    keep = pos < cap
    slot = jnp.where(keep, sorted_e * cap + pos, e * cap)
    return order, slot, keep, counts, starts


# Seeds whose draws keep every token's k-th and (k+1)-th scores apart.
SEEDS = {"deepseek-v3-671b": 1, "arctic-480b": 3}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_routing_then_offsets_then_outputs(arch, capacity_factor):
    jcfg, tcfg, jp, tp, x = _setup(arch, SEEDS[arch],
                                   tokens=64 if capacity_factor < 1 else 32,
                                   capacity_factor=capacity_factor)
    _assert_no_near_ties(jcfg, jp, x)
    xf = x.reshape(-1, jcfg.d_model)
    jids, jw, jprobs = JMOE._route(jcfg, jp["router"], jnp.asarray(xf))
    tids, tw, tprobs = TMOE._route(tcfg, tp["router"], torch.from_numpy(xf))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(tprobs), _np(jprobs), rtol=1e-5,
                               atol=1e-7)

    mc = jcfg.moe
    t = xf.shape[0]
    cap = max(8, int(math.ceil(mc.capacity_factor * t * mc.top_k
                               / mc.num_experts)))
    got = TMOE._slots(tids, mc.num_experts, cap)
    want = _ref_slots(jids, mc.num_experts, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if capacity_factor < 1:
        assert int((~got[2]).sum()) > 0      # tokens dropped by capacity

    jy, jaux = JMOE.moe_block(jp, jcfg, jnp.asarray(x))
    ty, taux = TMOE.moe_block(tp, tcfg, torch.from_numpy(x))
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_outputs_within_the_model_bound(arch):
    jcfg, tcfg, jp, tp, x = _setup(arch, SEEDS[arch], dtype="bfloat16")
    _assert_no_near_ties(jcfg, jp, x)
    jy, jaux = JMOE.moe_block(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    ty, taux = TMOE.moe_block(tp, tcfg,
                              torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, "bfloat16")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_repeats_its_bits(arch):
    """The combine sums a token's k contributions in a fixed order, so
    two calls give the same bits."""
    _, tcfg, _, tp, x = _setup(arch, SEEDS[arch])
    tx = torch.from_numpy(x)
    a, _ = TMOE.moe_block(tp, tcfg, tx)
    b, _ = TMOE.moe_block(tp, tcfg, tx)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["etp", "ep2d"])
def test_specs_match_the_reference(arch, layout):
    jcfg, tcfg = _cfgs(arch)
    jspecs = JMOE.moe_specs(dataclasses.replace(jcfg, moe_layout=layout))
    tspecs = TMOE.moe_specs(dataclasses.replace(tcfg, moe_layout=layout))
    jleaves = jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=JP.is_param)
    tflat = {}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            tflat[path] = tree
    walk(tspecs)
    assert len(jleaves) == len(tflat)
    for path, p in jleaves:
        q = tflat[tuple(k.key for k in path)]
        assert (tuple(q.shape), q.axes, q.init, q.scale) \
            == (tuple(p.shape), p.axes, p.init, p.scale)


@pytest.mark.parametrize("spelling", ["pallas", "fused_pallas", "vpu"])
def test_aux_counts_resolve_every_spelling(spelling):
    """expert_counts declares only the contraction and vpu engines: any
    other reduce_method spelling maps to the MMA row reduction, and the
    aux loss is the same."""
    arch = "deepseek-v3-671b"
    _, tcfg, _, tp, x = _setup(arch, SEEDS[arch])
    tx = torch.from_numpy(x)
    _, base = TMOE.moe_block(tp, tcfg, tx)
    _, aux = TMOE.moe_block(tp, dataclasses.replace(
        tcfg, reduce_method=spelling), tx)
    np.testing.assert_allclose(float(aux), float(base), rtol=1e-6)


def _no_drop(cfg):
    """A capacity factor of E / k: every expert takes every token, on one
    device and on each rank."""
    mc = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=mc.num_experts / mc.top_k))


def _mesh_rank(cases: dict) -> dict:
    """Entry (b): ``moe_block`` under ``axis_rules`` of a 4 x 2 mesh on
    whole tensors, for each case (arch, layout); every rank's out and
    aux."""
    import torch.distributed as dist
    mesh = compat.make_mesh(MESH, ("data", "model"), device="cpu")
    out = {}
    for key, (arch, layout, params, x) in cases.items():
        cfg = _no_drop(dataclasses.replace(
            TR.get_config(arch, smoke=True), compute_dtype=torch.float32,
            moe_layout=layout))
        tp = TP.from_numpy(params, device="cpu")
        with torch.no_grad(), tshd.axis_rules(mesh):
            y, aux = TMOE.moe_block(tp, cfg, torch.from_numpy(x))
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (y.numpy(), float(aux)))
        out[key] = got
    return out


# Seeds whose (4, 16) draws keep every token's k-th and (k+1)-th scores
# apart.
MESH_SEEDS = {"deepseek-v3-671b": 1, "arctic-480b": 3}


def _mesh_case(arch: str):
    jcfg, _ = _cfgs(arch)
    jcfg = _no_drop(jcfg)
    seed = MESH_SEEDS[arch]
    jp = JP.init_tree(jax.random.PRNGKey(seed), JMOE.moe_specs(jcfg))
    x = np.random.default_rng(seed).normal(
        size=(*MESH_X, jcfg.d_model)).astype(np.float32)
    return jcfg, jax.tree_util.tree_map(np.asarray, jp), x


@pytest.fixture(scope="module")
def mesh_run():
    cases = {}
    for arch in ARCHS:
        _, params, x = _mesh_case(arch)
        for layout in LAYOUTS:
            cases[f"{arch}/{layout}"] = (arch, layout, params, x)
    return launch_mesh.run_ranks(_mesh_rank, MESH[0] * MESH[1],
                                 backend="gloo", args=(cases,), timeout=120)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_under_a_mesh_matches_one_device(mesh_run, arch, layout):
    """Entry (b): ``moe_block`` under ``axis_rules`` of a (data 4, model
    2) mesh of gloo ranks, on whole tensors, through ``shard_map`` with
    the reference's specs, against the JAX package's single-device
    ``moe_block`` on the same numpy parameters and x at a capacity that
    drops nothing: out within f32 rtol 1e-5 of max|ref| on every rank;
    aux, the reference's pmean of each shard's, within rtol 1e-6 of the
    mean of the JAX package's ``_aux_loss`` on each shard's tokens
    (etp: a data row's block; ep2d: its model slice of the sequence
    too)."""
    jcfg, params, x = _mesh_case(arch)
    _assert_no_near_ties(jcfg, params, x)
    jy, _ = JMOE.moe_block(params, jcfg, jnp.asarray(x))
    rows = MESH_X[0] // MESH[0]
    pieces = [x[r:r + rows] for r in range(0, MESH_X[0], rows)]
    if layout == "ep2d":
        cols = MESH_X[1] // MESH[1]
        pieces = [p[:, c:c + cols] for p in pieces
                  for c in range(0, MESH_X[1], cols)]
    auxes = []
    for p in pieces:
        ids, _, probs = JMOE._route(jcfg, params["router"], jnp.asarray(
            p.reshape(-1, jcfg.d_model)))
        auxes.append(float(JMOE._aux_loss(jcfg, probs, ids)))
    ranks = mesh_run[f"{arch}/{layout}"]
    assert len(ranks) == MESH[0] * MESH[1]
    for y, aux in ranks:
        np.testing.assert_allclose(y, np.asarray(jy), rtol=0,
                                   atol=1e-5 * float(np.max(np.abs(jy))))
        np.testing.assert_allclose(aux, np.mean(auxes), rtol=1e-6)


def test_a_mesh_refuses_experts_that_do_not_split(monkeypatch):
    """Six experts over a 4-way data axis (etp's split; ep2d needs them
    over data x model): refused before any collective, naming the
    shapes, as the reference's ``shard_map`` fails there too."""
    arch = "arctic-480b"
    _, tcfg, _, tp, x = _setup(arch, SEEDS[arch])
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_experts=6))

    class _Fake:
        shape = {"data": 4, "model": 2}
    monkeypatch.setattr(tshd._CTX, "mesh", _Fake())
    for layout in LAYOUTS:
        with pytest.raises(ValueError, match=r"E 6.*data \(4\)"):
            TMOE.moe_block(tp, dataclasses.replace(tcfg, moe_layout=layout),
                           torch.from_numpy(x))


def test_compat_on_one_card():
    """Without a mesh ``shard_map`` is the plain call; a mesh needs a
    live process group, which this process has not started."""
    def f(a):
        return a + 1
    assert compat.shard_map(f, mesh=None, in_specs=(), out_specs=()) is f
    with pytest.raises(RuntimeError, match="process group"):
        compat.shard_map(f, mesh=object(), in_specs=(), out_specs=())
    with pytest.raises(RuntimeError, match="process group"):
        compat.make_mesh((2, 2), ("data", "model"))
