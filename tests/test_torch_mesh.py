"""The port's mesh path on eight ranks: ``compat.make_mesh`` /
``shard_map``, ``distributed.collectives``, the mesh forms of
``distributed.tc_collectives``, ``sharding``'s shardings, measured mesh
sweeps, ``remesh`` and the replan after it — the counterparts of the
reference's multi-device tests (``tests/test_tc_collectives.py``'s
mesh program, ``tests/test_fault_tolerance.py``'s remesh programs), held
to what they hold the reference to.

One run of eight gloo ranks on the CPU (``launch.mesh.run_ranks``, its
own 120 s timeout) computes every result in a module-scoped fixture, and
the cases below assert on it.  The ranks import no JAX: this module
imports JAX only inside the tests that compute the reference's values,
in the test process.

Tolerances (the reference test's, for the same quantities):
``tc_psum`` against the psum oracle rtol 1e-6; the norms against the
f64 norm rtol 1e-5; each local engine against the psum oracle rtol
1e-5, atol 1e-3; 8 identical shards through ``compressed_psum`` within
0.3 of 8 g; ``compressed_grad_allreduce`` within one f32 ulp of the sum
of the ranks' codes times the mean scale, its residuals bit for bit; the
Gemma-2 2B SMOKE tree's norm within rtol 1e-5 of the reference's.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.core.integration import _leaves, _tree_like
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import model_zoo as TZ

WORLD = 8
ENGINES = ("pallas", "mma_chained", "mma", "auto")
VIAS = ("shard_map", "gspmd")
# (survivors, model_parallel, pod_size) -> the reference test's shapes
REMESH = {
    "pod_lt_model": ((8, 4, 2), (["data", "model"], [2, 4])),
    "pod_ragged_model": ((8, 4, 6), (["data", "model"], [2, 4])),
    "pod_untiled": ((8, 2, 6), (["data", "model"], [4, 2])),
    "pod_ok": ((8, 2, 4), (["pod", "data", "model"], [2, 2, 2])),
    "ragged_survivors": ((7, 2, None), (["data", "model"], [3, 2])),
    "flat": ((8, 2, None), (["data", "model"], [4, 2])),
}


def _gemma_smoke_tree():
    """The Gemma-2 2B SMOKE parameter tree as numpy, drawn from a seed
    leaf by leaf (sorted keys)."""
    model = TZ.build(TR.get_config("gemma2-2b", smoke=True))
    shapes = model.param_shapes()
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal(s.shape).astype(np.float32)
              for s in _leaves(shapes)]
    return model, shapes, leaves


def _grad_tree(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"a": rng.standard_normal((64, 33)).astype(np.float32),
            "b": (rng.standard_normal(100) * 30).astype(np.float32)}


def _gather(value):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _keys(reg=None):
    from repro_torch.core import autotune
    reg = autotune.default_registry() if reg is None else reg
    return sorted(k for k, _ in reg.items())


def _autograd_collectives(mesh) -> dict:
    """The autograd collectives over the two ranks of a model line (and
    the all-to-all over data and data x model), each gradient against
    the one-rank gradient of the same function; beside ``reduce_from``
    the library's all_reduce in its place.  Every value is an integer,
    so each comparison is exact."""
    import torch.distributed.nn.functional as dfn
    from repro_torch.distributed import collectives as coll
    m = mesh.coordinate["model"]
    group = mesh.get_group("model")
    g = torch.arange(1.0, 7.0).reshape(2, 3)      # every rank's cotangent
    out = {}

    # copy_to -> rank m's part c_m x -> reduce_from: y = (c_0 + c_1) x on
    # one rank, so dx = (c_0 + c_1) g
    c = (2.0, 5.0)
    for name, reduce in (("ours", lambda t: coll.reduce_from(t, "model",
                                                             mesh=mesh)),
                         ("library", lambda t: dfn.all_reduce(t,
                                                              group=group))):
        x = torch.ones(2, 3, requires_grad=True)
        y = reduce(coll.copy_to(x, "model", mesh=mesh) * c[m])
        (y * g).sum().backward()
        out[f"reduce_y_{name}"] = y.tolist()
        out[f"reduce_dx_{name}"] = x.grad.tolist()
    out["reduce_want"] = ((c[0] + c[1]) * g).tolist()

    # gather_from of rank m's block: dx is its block of g, once (the
    # library's all_gather, whose backward is a sum, cannot run its
    # backward on a subgroup under gloo)
    x = torch.full((1, 3), float(m + 1), requires_grad=True)
    y = coll.gather_from(x, "model", 0, mesh=mesh)
    (y * g).sum().backward()
    out["gather_y"] = y.tolist() == [[1.0] * 3, [2.0] * 3]
    out["gather_dx"] = x.grad.tolist() == g[m:m + 1].tolist()

    # scatter_to: rank m keeps column block m of x; dx is all of g
    x = torch.ones(3, 2, requires_grad=True)
    y = coll.scatter_to(x, "model", 1, mesh=mesh)
    (y * g.T[:, m:m + 1]).sum().backward()
    out["scatter_y"] = y.shape == (3, 1)
    out["scatter_dx"] = torch.equal(x.grad, g.T)

    # all_to_all: expert e of rank r holds 100 r + e; after the exchange
    # this rank holds its experts' blocks from every rank in rank order,
    # and the backward is the reverse exchange
    rank = mesh.coordinate["data"] * 2 + m
    for axes in ("data", ("data", "model")):
        names = (axes,) if isinstance(axes, str) else axes
        n = 4 if axes == "data" else 8
        x = (100.0 * rank + torch.arange(8.0))[:, None, None] \
            .expand(8, 2, 3).clone().requires_grad_(True)
        y = coll.all_to_all(x, axes, 0, 1, mesh=mesh)
        me = mesh.coordinate["data"] if n == 4 else rank
        srcs = [(j * 2 + m) if n == 4 else j for j in range(n)]
        e = 8 // n
        want = torch.cat([(100.0 * s + torch.arange(me * e, me * e + e))
                          [:, None, None].expand(e, 2, 3) for s in srcs],
                         dim=1)
        w = torch.arange(float(y.numel())).reshape(y.shape) + rank
        (y * w).sum().backward()
        back = coll.all_to_all(w, axes, 1, 0, mesh=mesh)
        out[f"a2a_{'x'.join(names)}"] = [
            list(y.shape), torch.equal(y, want), torch.equal(x.grad, back),
            torch.equal(coll.all_to_all(y, axes, 1, 0, mesh=mesh), x)]
    return out


def _mesh_rank(ckpt_dir: str) -> dict:
    """Everything the cases read, computed on each of the eight ranks;
    rank 0's dict comes back."""
    import torch.distributed as dist
    from repro_torch import compat
    from repro_torch.core import autotune
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import fault_tolerance as ft
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tc_collectives as tcc
    rank = dist.get_rank()
    mesh = compat.make_mesh((4, 2), ("data", "model"), device="cpu")
    out = {"coordinate": _gather(mesh.coordinate)}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32))

    # The psum oracle: this rank's block (rank r of the row-major 4 x 2
    # grid holds block r) summed by torch, folded data then model.
    part = torch.sum(x.view(WORLD, -1)[rank], dtype=torch.float32)
    for axis in ("data", "model"):
        dist.all_reduce(part, group=mesh.get_group(axis))
    out["psum_oracle"] = float(part)
    out["tc_psum"] = float(tcc.tc_psum(x, mesh=mesh))
    out["single_key"] = autotune.plan_key("reduce_sum", 4096,
                                          torch.float32, "cpu")
    out["mesh_key"] = autotune.plan_key("reduce_sum", 4096, torch.float32,
                                        "cpu", mesh=mesh)

    tree = {"w": torch.from_numpy(rng.normal(size=(64, 48))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(37,)).astype(np.float32)),
            "s": torch.tensor(2.5)}
    out["norm_oracle"] = float(np.sqrt(sum(
        np.sum(v.numpy().astype(np.float64) ** 2) for v in tree.values())))
    out["norm"] = {via: float(tcc.tc_global_norm(tree, mesh=mesh, via=via))
                   for via in VIAS}
    out["all_reduce"] = {via: [float(v) for v in _leaves(tcc.tc_all_reduce(
        tree, mesh=mesh, via=via))] for via in VIAS}
    out["all_reduce_want"] = [float(np.sum(tree[k].numpy().astype(np.float64)))
                              for k in sorted(tree)]
    out["engines"] = {m: float(tcc.tc_psum(x, mesh=mesh, method=m))
                      for m in ENGINES}
    # method='pallas' runs the kernel's wrapper (B1 on the card, its
    # plain version here) on every rank, under either via
    import repro_torch.kernels as kernels
    calls, real = [], kernels.mma_reduce

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    kernels.mma_reduce = counted
    try:
        pallas = {}
        for via in VIAS:
            calls.clear()
            value = float(tcc.tc_psum(x, mesh=mesh, method="pallas", via=via))
            pallas[via] = {"value": value, "wrapper_calls": len(calls)}
    finally:
        kernels.mma_reduce = real
    out["pallas_by_via"] = _gather(pallas)
    with shd.axis_rules(mesh):
        from repro_torch.core import dispatch
        out["auto_under_mesh"] = float(dispatch.dispatch(
            "reduce_sum", x, method="auto"))
    with shd.axis_rules(mesh):
        out["ambient"] = float(tcc.tc_psum(x))
    out["mesh_keys"] = [k for k in _keys() if "mesh:" in k]

    # a leaf whose leading dim splits over data (4) but not model (2)
    x4 = torch.from_numpy(rng.normal(size=(4, 33)).astype(np.float32))
    out["partial"] = float(tcc.tc_psum(x4, mesh=mesh))
    out["partial_want"] = float(np.sum(x4.numpy().astype(np.float64)))
    out["partial_keys"] = [k for k in _keys() if k.endswith("|mesh:data4")]

    # int8 with error feedback: 8 identical shards
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    red, _ = coll.compressed_psum(g, ("data", "model"), torch.zeros_like(g),
                                  mesh=mesh)
    out["compressed"] = red.tolist()
    out["compressed_want"] = (g * 8.0).tolist()

    # the leaf-wise form over data, each rank's own tree
    grads = {k: torch.from_numpy(v) for k, v in _grad_tree(rank).items()}
    errors = {k: torch.full_like(v, 1e-3) for k, v in grads.items()}
    red, res = coll.compressed_grad_allreduce(grads, errors, mesh,
                                              axes=("data",))
    mine = {}
    for k in sorted(grads):
        xf = grads[k] + errors[k]
        q, scale = coll._quantise_int8(xf)
        mine[k] = {"q": q.numpy(), "scale": float(scale),
                   "reduced": red[k].numpy(), "residual": res[k].numpy()}
    out["compressed_tree"] = _gather(mine)

    # the fold order on a (pod 2, data 2, model 2) mesh
    mesh3 = compat.make_mesh((2, 2, 2), ("pod", "data", "model"),
                             device="cpu")
    seen, real = [], dist.all_reduce

    def recording(t, *a, group=None, **kw):
        seen.append(dist.get_process_group_ranks(group))
        return real(t, *a, group=group, **kw)

    dist.all_reduce = recording
    try:
        got = coll.hierarchical_psum(torch.tensor(float(rank)), mesh=mesh3)
    finally:
        dist.all_reduce = real
    out["hier"] = {"groups": seen, "value": float(got)}

    # shard_map with sharded in- and out-specs
    x2 = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    f = compat.shard_map(lambda a: a * 2 + 1, mesh=mesh,
                         in_specs=(shd.P("data", "model"),),
                         out_specs=shd.P("data", "model"))
    out["shard_map_2d"] = bool(torch.equal(f(x2), x2 * 2 + 1))
    f1 = compat.shard_map(lambda a: a.flip(0), mesh=mesh,
                          in_specs=(shd.P(("data", "model")),),
                          out_specs=shd.P(("data", "model")))
    out["shard_map_1d"] = bool(torch.equal(
        f1(x), x.view(WORLD, -1).flip(1).reshape(-1)))
    # ROADMAP C1: a sharded out-spec keeps the sign of a zero
    mesh2 = compat.make_mesh((2,), ("data",), ranks=[0, 1], device="cpu")
    if mesh2.coordinate is not None:
        z = torch.tensor([-0.0, 1.0, -0.0, 2.0])
        got = compat.shard_map(lambda b: b * 1.0, mesh=mesh2,
                               in_specs=(shd.P("data"),),
                               out_specs=shd.P("data"))(z)
        out["signed_zero"] = torch.signbit(got).tolist()
    c = shd.NamedSharding(mesh, shd.P("data", "model"))
    with shd.axis_rules(mesh):
        # a layout annotation, as the reference's (C2): a tensor this
        # rank holds whole comes back as it is
        out["constrain"] = shd.constrain(x2, (None, "mlp")) is x2
        dx2 = c.distribute(x2)
        out["constrain_same"] = shd.constrain(dx2, ("batch", "mlp")) is dx2
        try:
            shd.constrain(dx2, (None, "mlp"))
            out["constrain_other"] = None
        except ValueError as e:
            out["constrain_other"] = str(e)
    try:
        tcc.tc_psum(c.distribute(x2))
        out["no_mesh"] = None
    except ValueError as e:
        out["no_mesh"] = str(e)

    # Gemma-2 2B SMOKE, sharded by tree_shardings, as DTensors
    model, shapes, leaves = _gemma_smoke_tree()
    shardings = _leaves(shd.tree_shardings(shapes, model.param_axes(), mesh))
    dtree = _tree_like(shapes, [s.distribute(torch.from_numpy(v))
                                for s, v in zip(shardings, leaves)])
    out["gemma_specs"] = [tuple(s.spec) for s in shardings]
    out["gemma"] = {via: float(tcc.tc_global_norm(dtree, mesh=mesh, via=via))
                    for via in VIAS}

    # a measured mesh sweep; every rank must record the same plan
    plan = autotune.get_plan(1 << 16, torch.float32, mesh=mesh, measure=True,
                             registry=autotune.PlanRegistry(), backend="cpu")
    out["measured"] = _gather(plan.to_dict())
    try:
        autotune.get_plan(1 << 16, torch.float32, mesh="data16",
                          measure=True, registry=autotune.PlanRegistry(),
                          backend="cpu")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)

    # A mesh plan is measured by its ranks together, never by one rank's
    # background worker, and never on a mesh built from a signature.
    reg = autotune.PlanRegistry()
    with autotune.SweepWorker(reg, iters=1) as worker:
        reg.sweep_worker = worker
        served = autotune.get_plan(1 << 12, torch.float32, mesh=mesh,
                                   registry=reg, backend="cpu")
        out["worker"] = {"source": served.source,
                         "pending": worker.pending(),
                         "upgraded": worker.upgraded,
                         "failed": worker.failed,
                         "keys": _keys(reg)}
    try:
        autotune.get_plan(1 << 16, torch.float32,
                          mesh=(("data", 4), ("model", 2)), measure=True,
                          registry=autotune.PlanRegistry(), backend="cpu")
        out["refused_tuple"] = None
    except ValueError as e:
        out["refused_tuple"] = str(e)

    out["autograd"] = _gather(_autograd_collectives(mesh))

    out["values"] = _gather([out["tc_psum"], out["norm"], out["engines"],
                             out["gemma"], out["partial"]])
    out["keys_by_rank"] = _gather(out["mesh_keys"])

    # remesh geometries, built by every rank
    out["remesh"] = {}
    for case, ((n, mp, pod), _) in REMESH.items():
        m = ft.remesh(range(n), model_parallel=mp, pod_size=pod,
                      device="cpu")
        out["remesh"][case] = {
            "shape": [list(m.shape), list(m.shape.values())],
            "inside": _gather(m.coordinate is not None)}

    # the 8 -> 4 replan sequence
    reg = autotune.PlanRegistry()
    mesh8 = ft.remesh(model_parallel=1, device="cpu")
    autotune.get_plan(1 << 16, torch.float32, registry=reg, mesh=mesh8,
                      backend="cpu")
    replan = {"keys8": _keys(reg)}
    mesh4 = ft.remesh(range(4), model_parallel=1, device="cpu")
    sup = ft.TrainSupervisor(ckpt_dir=ckpt_dir)
    replan["dead"] = sorted(sup.on_remesh(mesh4, registry=reg))
    replan["after_invalidate"] = _keys(reg)
    if mesh4.coordinate is not None:
        x4r = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32))
        replan["value"] = float(tcc.tc_psum(x4r, mesh=mesh4))
        replan["want"] = float(np.sum(x4r.numpy().astype(np.float64)))
        autotune.get_plan(1 << 16, torch.float32, registry=reg, mesh=mesh4,
                          backend="cpu")
    replan["keys4"] = _keys(reg)
    replan["dead2"] = sorted(sup.on_remesh(mesh4, registry=reg))
    out["replan"] = _gather(replan)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    return launch_mesh.run_ranks(_mesh_rank, WORLD, backend="gloo",
                                 args=(ckpt,), timeout=120)


# ------------------------------------------------------------------ cases


def test_mesh_coordinates_are_row_major(run):
    assert run["coordinate"] == [{"data": r // 2, "model": r % 2}
                                 for r in range(WORLD)]


def test_tc_psum_matches_the_psum_oracle(run):
    np.testing.assert_allclose(run["tc_psum"], run["psum_oracle"], rtol=1e-6)


@pytest.mark.parametrize("via", VIAS)
def test_tc_global_norm_matches_the_f64_norm(run, via):
    np.testing.assert_allclose(run["norm"][via], run["norm_oracle"],
                               rtol=1e-5)


@pytest.mark.parametrize("via", VIAS)
def test_tc_all_reduce_leaf_by_leaf(run, via):
    np.testing.assert_allclose(run["all_reduce"][via],
                               run["all_reduce_want"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ENGINES)
def test_local_engines_match_the_psum_oracle(run, method):
    np.testing.assert_allclose(run["engines"][method], run["psum_oracle"],
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("via", VIAS)
def test_pallas_runs_its_kernel_on_every_rank(run, via):
    """``method='pallas'`` is each rank's engine under both vias: the
    kernel's wrapper ran on every rank, and the sum is the psum
    oracle's."""
    for got in run["pallas_by_via"]:
        assert got[via]["wrapper_calls"] > 0, got
        np.testing.assert_allclose(got[via]["value"], run["psum_oracle"],
                                   rtol=1e-5, atol=1e-3)


def test_auto_under_a_live_mesh(run):
    np.testing.assert_allclose(run["auto_under_mesh"], run["psum_oracle"],
                               rtol=1e-5, atol=1e-3)


def test_the_ambient_mesh_serves_tc_psum(run):
    np.testing.assert_allclose(run["ambient"], run["psum_oracle"],
                               rtol=1e-6)


def test_a_dtensor_without_its_mesh_is_refused(run):
    assert "pass it as mesh=" in run["no_mesh"]


def test_mesh_keys_end_in_the_mesh_signature(run):
    assert run["mesh_keys"], "no mesh-keyed plan was resolved"
    assert all(k.endswith("|mesh:data4.model2") for k in run["mesh_keys"])
    assert run["mesh_key"] == run["single_key"] + "|mesh:data4.model2"


def test_a_leaf_split_over_data_alone_keys_by_data4(run):
    np.testing.assert_allclose(run["partial"], run["partial_want"],
                               rtol=1e-5, atol=1e-3)
    assert run["partial_keys"]


def test_every_rank_holds_the_same_values_and_keys(run):
    assert all(v == run["values"][0] for v in run["values"])
    assert all(k == run["keys_by_rank"][0] for k in run["keys_by_rank"])


def test_compressed_psum_of_identical_shards(run):
    np.testing.assert_allclose(run["compressed"], run["compressed_want"],
                               atol=0.3)


def test_compressed_grad_allreduce_against_the_codes(run):
    """Each data group (the ranks of one model column) gets the sum of
    its members' int8 codes times their mean scale; the codes are the
    reference's quantiser's on each rank's own input."""
    import jax.numpy as jnp
    from repro.distributed import collectives as JCOLL
    per_rank = run["compressed_tree"]
    for rank, mine in enumerate(per_rank):
        members = [r for r in range(WORLD) if r % 2 == rank % 2]
        src = _grad_tree(rank)
        for k, leaf in mine.items():
            xf = src[k] + np.float32(1e-3)
            jq, jscale = JCOLL._quantise_int8(jnp.asarray(xf))
            np.testing.assert_array_equal(leaf["q"], np.asarray(jq))
            assert np.float32(leaf["scale"]) == np.asarray(jscale)
            np.testing.assert_array_equal(
                leaf["residual"],
                xf - leaf["q"].astype(np.float32) * np.float32(leaf["scale"]))
            codes = sum(per_rank[r][k]["q"].astype(np.int64) for r in members)
            scales = np.float32(0.0)
            for r in members:
                scales = np.float32(scales + np.float32(per_rank[r][k]["scale"]))
            want = codes.astype(np.float32) * (scales / np.float32(len(members)))
            np.testing.assert_array_max_ulp(leaf["reduced"], want, maxulp=1)


def test_hierarchical_psum_folds_data_before_pod(run):
    # rank 0 sits at (pod 0, data 0, model 0): its data line is ranks
    # {0, 2}, its pod line {0, 4}
    assert run["hier"]["groups"] == [[0, 2], [0, 4]]
    assert run["hier"]["value"] == 0 + 2 + 4 + 6


def test_shard_map_with_sharded_out_specs(run):
    assert run["shard_map_2d"] and run["shard_map_1d"]


def test_shard_map_keeps_the_sign_of_a_zero(run):
    """ROADMAP C1: f32 [-0.0, 1.0, -0.0, 2.0] through ``b * 1.0`` on a
    (2,) data mesh, P("data") in and out, keeps each zero's sign, as the
    reference's shard_map (blocks side by side) does."""
    assert run["signed_zero"] == [True, False, True, False]


def test_copy_to_and_reduce_from_give_the_one_rank_gradient(run):
    """``copy_to``, a part a rank, then ``reduce_from`` over the two ranks
    of a model line: the library all_reduce's forward, and the gradient
    of the same function on one rank; the library's ``all_reduce`` in
    place of ``reduce_from`` gives twice that (its backward sums the
    model ranks' identical cotangents)."""
    for got in run["autograd"]:
        assert got["reduce_y_ours"] == got["reduce_y_library"]
        assert got["reduce_dx_ours"] == got["reduce_want"]
        assert got["reduce_dx_library"] == (
            2 * np.asarray(got["reduce_want"])).tolist()


def test_gather_from_keeps_its_slice_of_the_gradient(run):
    for got in run["autograd"]:
        assert got["gather_y"] and got["gather_dx"]


def test_scatter_to_gathers_its_gradient(run):
    for got in run["autograd"]:
        assert got["scatter_y"] and got["scatter_dx"]


@pytest.mark.parametrize("axes", ["data", "dataxmodel"])
def test_all_to_all_blocks_and_its_reverse(run, axes):
    """The tiled all-to-all over data (4 ranks) and over data x model (8,
    data major): each rank holds its experts' blocks from every rank in
    rank order, the reverse exchange gives x back, and the backward is
    the reverse exchange of the cotangent."""
    shape = [2, 8, 3] if axes == "data" else [1, 16, 3]
    for got in run["autograd"]:
        assert got[f"a2a_{axes}"] == [shape, True, True, True]


def test_constrain_under_a_mesh(run):
    # identity on a whole tensor (C2); a DTensor checked against the
    # spec and returned as it is, or refused when its layout differs
    assert run["constrain"] is True
    assert run["constrain_same"]
    assert "does not meet the spec" in run["constrain_other"]


@pytest.mark.parametrize("via", VIAS)
def test_gemma_smoke_norm_equals_the_reference(run, via):
    """The sharded tree's norm against the reference's single-device
    ``tc_global_norm`` of the same numpy tree."""
    import jax.numpy as jnp
    from repro.distributed import sharding as jshd
    from repro.distributed import tc_collectives as JTC
    model, shapes, leaves = _gemma_smoke_tree()
    want = float(JTC.tc_global_norm([jnp.asarray(v) for v in leaves]))
    np.testing.assert_allclose(run["gemma"][via], want, rtol=1e-5)

    class _Fake:
        shape = {"data": 4, "model": 2}
    jspecs = [tuple(jshd.spec_for(s.shape, a, _Fake(), jshd.DEFAULT_RULES))
              for s, a in zip(_leaves(shapes),
                              _axes_leaves(model.param_axes()))]
    assert run["gemma_specs"] == jspecs
    assert any(spec != (None,) * len(spec) for spec in jspecs)


def _axes_leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _axes_leaves(tree[k])]
    return [tree]


def test_measured_mesh_sweep_agrees_on_every_rank(run):
    plans = run["measured"]
    assert plans[0]["source"] == "measured"
    assert all(p == plans[0] for p in plans)


def test_measured_sweep_refused_without_the_ranks(run):
    assert "cannot measure mesh 'data16'" in run["refused"]


def test_a_signature_is_never_measured_even_with_the_ranks(run):
    assert "cannot measure mesh 'data4.model2'" in run["refused_tuple"]


def test_sweep_worker_leaves_mesh_plans_to_the_ranks(run):
    got = run["worker"]
    assert got["source"] == "model"
    assert (got["pending"], got["upgraded"], got["failed"]) == (0, 0, 0)
    assert got["keys"] == ["reduce_sum|4096|float32|cpu|mesh:data4.model2"]


@pytest.mark.parametrize("case", sorted(REMESH))
def test_remesh_on_ranks(run, case):
    (n, mp, _), want = REMESH[case]
    got = run["remesh"][case]
    assert got["shape"] == [want[0], want[1]]
    used = int(np.prod(want[1]))
    assert got["inside"] == [r < used for r in range(WORLD)]


def test_replan_8_to_4_resolves_a_fresh_mesh_key(run):
    k8 = "reduce_sum|65536|float32|cpu|mesh:data8.model1"
    k4 = "reduce_sum|65536|float32|cpu|mesh:data4.model1"
    for rank, replan in enumerate(run["replan"]):
        assert replan["keys8"] == [k8]
        assert replan["dead"] == [k8]
        assert replan["after_invalidate"] == []
        assert replan["dead2"] == []
        if rank < 4:
            assert replan["keys4"] == [k4]
            np.testing.assert_allclose(replan["value"], replan["want"],
                                       rtol=1e-5, atol=1e-3)
        else:
            assert replan["keys4"] == [] and "value" not in replan
