"""The port's mesh layer against the JAX package's, in one process and
without ranks: the sharding rule walk (``spec_for``, ``sharding_for``,
``tree_shardings``, ``data_axis_names``) over the ten SMOKE parameter
trees on fake meshes, the mesh-keyed plan grammar (``shardable_axes``,
``mesh_device_count``, ``plan_key``, ``dispatch.local_plan``,
``autotune`` for a shard), the combine cost, the int8 quantiser and
``compressed_psum``'s quantise-and-residual step, ``remesh``'s
geometries, ``replan_after_remesh`` and ``examples.reduce_demo``.

Tolerances: specs, plan keys and plan fields are equal; the quantiser's
codes, scales and residuals equal bit for bit; ``reduce_demo``'s sums
within 2^-20 of sum|x| of the reference's ``tc_reduce`` at the port's
16-wide tile (the reference's example runs its TPU tile of 128).  The multi-rank half is
``tests/test_torch_mesh.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import autotune as jat
from repro.core import dispatch as jdisp
from repro.core import tc_reduce as j_tc_reduce
from repro.core.precision import normal_input, percent_error, uniform_input
from repro.distributed import collectives as JCOLL
from repro.distributed import fault_tolerance as JF
from repro.distributed import sharding as jshd
from repro.distributed import tc_collectives as JTC
from repro.models import model_zoo as JZ
from repro_torch.configs import registry as TR
from repro_torch.core import autotune as tat
from repro_torch.core import dispatch as tdisp
from repro_torch.core.integration import _leaves
from repro_torch.distributed import collectives as TCOLL
from repro_torch.distributed import fault_tolerance as TF
from repro_torch.distributed import sharding as tshd
from repro_torch.distributed import tc_collectives as TTC
from repro_torch.examples import reduce_demo
from repro_torch.models import model_zoo as TZ


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
}


def _jleaves(tree):
    """The reference tree's leaves in sorted-key order, tuples of axes
    kept whole."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _jleaves(tree[k])]
    if isinstance(tree, list):
        return [t for item in tree for t in _jleaves(item)]
    return [tree]


# ------------------------------------------------------------ sharding


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", JR.list_archs())
def test_specs_of_the_smoke_trees_equal_the_reference(arch, mesh_name):
    mesh = _FakeMesh(MESHES[mesh_name])
    jmodel = JZ.build(JR.get_config(arch, smoke=True))
    tmodel = TZ.build(TR.get_config(arch, smoke=True))
    jshapes = _jleaves(jmodel.param_shapes())
    jaxes = _jleaves(jmodel.param_axes())
    want = [tuple(jshd.spec_for(s.shape, a, mesh, jshd.DEFAULT_RULES))
            for s, a in zip(jshapes, jaxes)]
    shardings = _leaves(tshd.tree_shardings(
        tmodel.param_shapes(), tmodel.param_axes(), mesh))
    got = [tuple(s.spec) for s in shardings]
    assert got == want
    assert all(s.mesh is mesh for s in shardings)
    tshapes = _leaves(tmodel.param_shapes())
    for s, a, w in zip(tshapes, jaxes, want):
        assert tuple(tshd.spec_for(s.shape, a, mesh)) == w
        assert tuple(tshd.sharding_for(s.shape, a, mesh).spec) == w
    assert tshd.data_axis_names(mesh) == jshd.data_axis_names(mesh)


def test_specs_without_a_mesh_and_under_axis_rules():
    assert tshd.spec_for((8, 4), ("batch", None)) == tshd.P()
    assert tshd.sharding_for((8, 4), ("batch", None)) is None
    assert tshd.data_axis_names() == ()
    mesh = _FakeMesh(MESHES["2x16x16"])
    with tshd.axis_rules(mesh):
        assert tshd.current_mesh() is mesh
        assert tshd.spec_for((256, 4096), ("batch", None)) == \
            tshd.P(("pod", "data"), None)
        assert tshd.data_axis_names() == ("pod", "data")
    assert tshd.current_mesh() is None
    assert repr(tshd.P("data", None)) == "P('data', None)"


# ----------------------------------------------------------- plan keys


MESH_FORMS = {
    "tuple-4x2": (("data", 4), ("model", 2)),
    "str-4x2": "data4.model2",
    "str-data4": "data4",
    "fake-2x16x16": _FakeMesh(MESHES["2x16x16"]),
    "one-device": (("data", 1),),
}


@pytest.mark.parametrize("form", sorted(MESH_FORMS))
def test_mesh_counts_and_plan_keys_equal_the_reference(form):
    mesh = MESH_FORMS[form]
    assert tat.mesh_device_count(mesh) == jat.mesh_device_count(mesh)
    assert tat.mesh_signature(mesh) == jat.mesh_signature(mesh)
    for op, n, dt in (("reduce_sum", 4096, "float32"),
                      ("squared_sum", 3000, "bfloat16")):
        got = tat.plan_key(op, n, getattr(torch, dt), "cpu", mesh=mesh)
        want = jat.plan_key(op, n, getattr(jnp, dt), "cpu", mesh=mesh)
        assert got == want


@pytest.mark.parametrize("dim", [1, 4, 33, 64, 4096])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_shardable_axes_equal_the_reference(mesh_name, dim):
    mesh = _FakeMesh(MESHES[mesh_name])
    assert TTC.shardable_axes(mesh, dim) == JTC.shardable_axes(mesh, dim)
    assert TTC.shardable_axes(None, dim) == ()


@pytest.mark.parametrize("method", ["auto", "mma", "pallas",
                                    "mma_chained", "vpu"])
@pytest.mark.parametrize("mesh", ["data4", "data4.model2",
                                  (("data", 4), ("model", 2))])
def test_local_plan_equals_the_reference(mesh, method, fresh_registries):
    n = 1 << 16
    got = tdisp.local_plan("squared_sum", n, torch.float32, method,
                           mesh=mesh, backend="cpu")
    want = jdisp.local_plan("squared_sum", n, jnp.float32, method,
                            mesh=mesh)
    if method != "auto":
        assert (got.method, got.chain, got.split_words) == \
            (want.method, want.chain, want.split_words)
    else:
        # The two cost models are each their hardware's, so the engines
        # they pick may differ; the key each tuned under is the same.
        keys = [k for k, _ in tat.default_registry().items()]
        assert keys == [k for k, _ in jat.default_registry().items()]
        assert keys[0].endswith("|mesh:" + tat.mesh_signature(mesh))
        assert tat.default_registry().get(keys[0]) is got
    with pytest.raises(ValueError, match="unknown"):
        tdisp.local_plan("squared_sum", n, torch.float32, "nope",
                         mesh=mesh)


@pytest.fixture
def fresh_registries():
    tat.reset_default_registry()
    jat.reset_default_registry()
    yield
    tat.reset_default_registry()
    jat.reset_default_registry()


def test_combine_model_cost():
    assert tat.combine_model_cost(None) == 0.0
    assert tat.combine_model_cost((("data", 1),)) == 0.0
    d2, d4 = (tat.combine_model_cost(f"data{s}") for s in (2, 4))
    assert d2 > 0 and d4 == pytest.approx(2 * d2)
    both = tat.combine_model_cost("data4.model2")
    assert both == pytest.approx(d4 + tat.combine_model_cost("model2"))
    assert tat.combine_model_cost("pod2") > tat.combine_model_cost("data2")
    assert tat.combine_model_cost("data4.model1") == d4


@pytest.mark.parametrize("mesh", ["data2", "data4.model2", "pod2.data2"])
def test_autotune_for_a_shard_equals_the_reference(mesh):
    n = 1 << 20
    got = tat.autotune(n, torch.float32, mesh=mesh, backend="cpu")
    want = jat.autotune(n, jnp.float32, mesh=mesh)
    local = tat.autotune(n // tat.mesh_device_count(mesh), torch.float32,
                         backend="cpu")
    assert (got.method, got.chain, got.block_rows) == \
        (local.method, local.chain, local.block_rows)
    assert got.cost == pytest.approx(
        local.cost + tat.combine_model_cost(mesh))
    jlocal = jat.autotune(n // jat.mesh_device_count(mesh), jnp.float32)
    assert (want.method, want.chain, want.block_rows) == \
        (jlocal.method, jlocal.chain, jlocal.block_rows)
    assert want.cost == pytest.approx(
        jlocal.cost + jat.combine_model_cost(mesh))
    assert want.source == got.source == "model"


# -------------------------------------------------- compressed all-reduce


def _quant_inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "normal":
        return rng.standard_normal(4099).astype(np.float32)
    # amax 127 makes the scale exactly 1: every k + 0.5 is a tie
    ties = (rng.integers(-120, 120, 4096) + 0.5).astype(np.float32)
    ties[0] = 127.0
    return ties


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_quantise_int8_bit_for_bit(kind):
    x = _quant_inputs(kind)
    q, scale = TCOLL._quantise_int8(torch.from_numpy(x))
    jq, jscale = JCOLL._quantise_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(scale).tobytes() == np.asarray(jscale).tobytes()
    if kind == "ties":
        assert float(scale) == 1.0
        # round half to even
        np.testing.assert_array_equal(q.numpy(),
                                      np.clip(np.round(x), -127, 127))


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_compressed_psum_step_bit_for_bit(kind):
    """Over no axis the psum is the identity (both packages), so the
    call runs in one process: the quantise-and-residual step and the
    dequantised value, bit for bit."""
    x = _quant_inputs(kind)
    err = (np.random.default_rng(3).standard_normal(x.shape) * 1e-3) \
        .astype(np.float32)
    red, res = TCOLL.compressed_psum(torch.from_numpy(x), (),
                                     torch.from_numpy(err))
    jred, jres = JCOLL.compressed_psum(jnp.asarray(x), (), jnp.asarray(err))
    np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


# -------------------------------------------------------------- remesh


# The shapes tests/test_fault_tolerance.py asserts for the reference.
REMESH_CASES = {
    "pod_lt_model": (dict(n=8, model_parallel=4, pod_size=2),
                     (("data", "model"), (2, 4))),
    "pod_ragged_model": (dict(n=8, model_parallel=4, pod_size=6),
                         (("data", "model"), (2, 4))),
    "pod_untiled": (dict(n=8, model_parallel=2, pod_size=6),
                    (("data", "model"), (4, 2))),
    "pod_ok": (dict(n=8, model_parallel=2, pod_size=4),
               (("pod", "data", "model"), (2, 2, 2))),
    "ragged_survivors": (dict(n=7, model_parallel=2),
                         (("data", "model"), (3, 2))),
    "flat": (dict(n=8, model_parallel=2), (("data", "model"), (4, 2))),
}


@pytest.mark.parametrize("case", sorted(REMESH_CASES))
def test_remesh_geometries(case):
    kw, (names, shape) = REMESH_CASES[case]
    kw = dict(kw)
    n = kw.pop("n")
    arr, got_names = TF._remesh_layout(range(n), kw["model_parallel"],
                                       kw.get("pod_size"))
    assert (got_names, arr.shape) == (names, shape)
    assert arr.ravel().tolist() == list(range(arr.size))


def test_remesh_with_no_usable_rank_raises():
    with pytest.raises(RuntimeError, match="no usable devices"):
        TF._remesh_layout(range(1), 2, None)


def test_replan_keeps_the_new_mesh_plans():
    """The reference test's keys, through both packages' registries."""
    keep = "reduce_sum|1024|float32|cpu|mesh:data4"
    stale8 = "reduce_sum|1024|float32|cpu|mesh:data8"
    stale2 = "scan|1024|float32|cpu|mma+vpu|mesh:data2.model4"
    plain = "reduce_sum|1024|float32|cpu"
    regs = (tat.PlanRegistry(), jat.PlanRegistry())
    for reg, mod in zip(regs, (tat, jat)):
        for k in (keep, stale8, stale2, plain):
            reg.put(k, mod.ReductionPlan(method="vpu"))
    dead = TF.replan_after_remesh("data4", registry=regs[0])
    jdead = JF.replan_after_remesh("data4", registry=regs[1])
    assert sorted(dead) == sorted(jdead) == sorted([stale2, stale8])
    assert sorted(k for k, _ in regs[0].items()) == [plain, keep]
    # the tuple form names the same geometry
    assert TF.replan_after_remesh((("data", 4),), registry=regs[0]) == ()


# ---------------------------------------------------------- reduce_demo


def test_reduce_demo_against_the_reference(capsys):
    """Each printed error is the port's ``tc_reduce`` on the bf16 input,
    whose sum is the reference's at the 16-wide tile to 2^-20 of
    sum|x| (the two add the group scalars in other orders)."""
    from repro_torch.core import tc_reduce as t_tc_reduce
    errors = reduce_demo.main(device="cpu")
    out = capsys.readouterr().out
    assert "normal inputs" in out and "uniform inputs" in out
    assert len(errors) == 2 * len(reduce_demo.SIZES) * len(reduce_demo.CASES)
    gens = {"normal": normal_input, "uniform": uniform_input}
    for (dist, case, n), err in errors.items():
        x = gens[dist](n, seed=1)
        kw = reduce_demo.CASES[case]
        xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        got = float(t_tc_reduce(xb, **kw))
        assert err == percent_error(got, x)
        want = float(j_tc_reduce(jnp.asarray(x.astype(np.float32))
                                 .astype(jnp.bfloat16), m=16, **kw))
        scale = float(xb.double().abs().sum())
        assert abs(got - want) <= 2.0 ** -20 * scale, (dist, case, n)
    # the paper's finding on uniform inputs
    for n in reduce_demo.SIZES:
        assert errors[("uniform", "recurrence/bf16(bf16 partials)", n)] > \
            errors[("uniform", "single_pass/bf16", n)]
