"""The port's autotuner (``repro_torch.core.autotune``) against the JAX
package's: the plan-key grammar, the bucket policies, the candidate
space, the selection rules, and the plan-store JSON, which each package
must read from the other.
"""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from repro.core import autotune as jat
from repro.core import precision as jp
from repro_torch.core import autotune as tat
from repro_torch.core import precision as tp


@pytest.fixture()
def fresh_registries(fresh_plan_registry):
    tat.reset_default_registry()
    yield
    tat.reset_default_registry()


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4096, 4097, 1 << 20,
                               (1 << 28) + 5])
def test_buckets_match_the_reference(n):
    assert tat.bucket_n(n) == jat.bucket_n(n)
    for bucket in ("pow2", None):
        assert tat.bucket_cap(n, bucket) == jat.bucket_cap(n, bucket)
        assert tat.bucket_floor(n, bucket) == jat.bucket_floor(n, bucket)
    # 'geom' aligns to the tile: the paper's 16 here, the MXU's 128 there.
    assert tat.bucket_cap(n, "geom") == jat._cap_geom(n, m=16)
    with pytest.raises(ValueError, match="unknown bucket"):
        tat.bucket_cap(n, "octave")


@pytest.mark.parametrize("kw", [
    {},
    {"engine": "pallas"},
    {"engine": ("mma", "vpu")},
    {"mesh": "data4.model2"},
    {"mesh": (("data", 1),)},
    {"objective": 0.25},
    {"objective": "slo1.5ms", "bucket": None},
    {"policy": "budget", "engine": "mma_chained", "mesh": "data2",
     "objective": 2},
])
@pytest.mark.parametrize("backend", ["cpu", "cuda", "tpu"])
def test_plan_key_grammar_matches_the_reference(kw, backend):
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("policy") == "budget":
        tkw["policy"] = tp.MmaPolicy(input_dtype=torch.bfloat16,
                                     error_budget_pct=1e-3)
        jkw["policy"] = jp.MmaPolicy(input_dtype=jnp.bfloat16,
                                     error_budget_pct=1e-3)
    for n in (777, 1 << 20):
        assert tat.plan_key("squared_sum", n, torch.bfloat16, backend,
                            **tkw) \
            == jat.plan_key("squared_sum", n, jnp.bfloat16, backend, **jkw)


def test_mesh_and_objective_helpers_match_the_reference():
    for mesh in ("data4.model2", (("data", 2), ("model", 1)), None):
        assert tat.mesh_signature(mesh) == jat.mesh_signature(mesh)
    with pytest.raises(ValueError, match="ambiguous"):
        tat.mesh_axes((("stage1", 2),))
    obj = tat.as_objective("slo0.25ms")
    assert obj == tat.LatencyObjective(0.25)
    assert obj.signature() == jat.LatencyObjective(0.25).signature()
    with pytest.raises(ValueError, match="positive"):
        tat.LatencyObjective(0.0)
    with pytest.raises(TypeError):
        tat.as_objective([1])


def test_default_backend_is_the_card_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tat.default_backend() == "cpu"
    assert tat.plan_key("reduce_sum", 10, torch.float32) \
        == "reduce_sum|16|float32|cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tat.plan_key("reduce_sum", 10, torch.float32) \
        == "reduce_sum|16|float32|cuda"


def test_candidates_offer_only_geometries_the_kernels_take():
    from repro_torch.kernels.mma_reduce import block_rows_ok
    cands = list(tat.candidate_plans(1 << 22, torch.float32))
    methods = [c.method for c in cands]
    assert methods.count("mma") == methods.count("vpu") == 1
    assert sorted(c.chain for c in cands if c.method == "mma_chained") \
        == list(tat.CHAINS)
    pallas = [(c.chain, c.block_rows) for c in cands if c.method == "pallas"]
    assert len(pallas) == len(tat.CHAINS) * len(tat.BLOCK_ROWS)
    assert all(block_rows_ok(b) for _, b in pallas)
    assert all(c.m == 16 for c in cands)
    # Tiles strictly more padding than a smaller one are dropped.
    small = [c for c in tat.candidate_plans(100, torch.float32,
                                            engine="pallas")]
    assert [(c.chain, c.block_rows) for c in small] == [(1, 32)]
    split = list(tat.candidate_plans(
        10, torch.float32, policy=tp.MmaPolicy(split_words=2)))
    assert {c.method for c in split} == {"mma_ec", "pallas_ec"}
    assert {c.split_words for c in split} == {2}


def test_model_scores_the_plain_engines():
    for dtype in (torch.float32, torch.bfloat16):
        for cand in tat.candidate_plans(1 << 24, dtype):
            cost = tat.model_cost(cand, 1 << 24, dtype)
            err = tat.model_percent_error(cand, 1 << 24, dtype)
            assert cost > 0.0 and err > 0.0
    pallas = tat.ReductionPlan(method="pallas", chain=4)
    vpu = tat.ReductionPlan(method="vpu")
    # The kernels carry 22 significand bits of an f32 input (two TF32
    # words), the vpu baseline all 24; a bf16 input caps both at 8.
    assert tat.model_percent_error(pallas, 1024, torch.float32) \
        > tat.model_percent_error(vpu, 1024, torch.float32)
    assert tat.model_percent_error(pallas, 1024, torch.bfloat16) \
        == tat.model_percent_error(vpu, 1024, torch.bfloat16)
    # Streaming the input from device memory is a floor under every plan.
    assert tat.model_cost(vpu, 1 << 28, torch.float32) \
        >= (1 << 30) / tat._HBM_BYTES_PER_US


def test_pallas_reduce_cost_follows_the_walks_blocks(monkeypatch):
    # B1 and B3 launch walk(...) blocks, so the pallas reduce engine's
    # grid term moves with _WALK_BLOCK_US by the walk's grid over the
    # SMs; the engines whose kernels take one block a tile (pallas_ec,
    # pallas_dd, B6's scan, B7's segment sum) keep _GRID_STEP_OVERHEAD
    # by their tile count, and do not see _WALK_BLOCK_US.
    import importlib
    mr = importlib.import_module("repro_torch.kernels.mma_reduce")
    P = tat._PARALLELISM

    def slope(name, plan, n, dtype, op="reduce_sum"):
        monkeypatch.setattr(tat, name, 0.0)
        low = tat.model_cost(plan, n, dtype, op=op)
        monkeypatch.setattr(tat, name, 1.0)
        high = tat.model_cost(plan, n, dtype, op=op)
        monkeypatch.undo()
        return high - low

    for n in (1, 1 << 20, (1 << 28) + 5):
        for chain, block_rows in ((1, 32), (4, 128), (5, 512)):
            tiles = max(-(-n // (chain * block_rows * 16)), 1)
            for dtype in mr.DTYPES:
                for op in ("reduce_sum", "squared_sum"):
                    plan = tat.ReductionPlan(method="pallas", chain=chain,
                                             block_rows=block_rows)
                    grid, _ = mr.walk(n, chain, block_rows)
                    assert slope("_WALK_BLOCK_US", plan, n, dtype, op) \
                        == pytest.approx(grid / P)
                    assert slope("_GRID_STEP_OVERHEAD", plan, n, dtype,
                                 op) == 0.0
                split = tat.ReductionPlan(method="pallas", variant="split",
                                          chain=chain,
                                          block_rows=block_rows)
                grid, _ = mr.walk(n, 1, block_rows)
                assert slope("_WALK_BLOCK_US", split, n, dtype) \
                    == pytest.approx(grid / P)
            # The engines that keep one block a tile (a scan costs at
            # least its host time a call, which 2^28 elements exceed).
            scan = (("pallas", "scan", {}),) if n > 1 << 20 else ()
            for method, op, kw in scan + (("pallas_ec", "reduce_sum", {}),
                                   ("pallas_dd", "reduce_sum", {}),
                                   ("pallas", "segment_sum", {}),
                                   ("pallas", "reduce_sum",
                                    {"variant": "recurrence"})):
                plan = tat.ReductionPlan(method=method, chain=chain,
                                         block_rows=block_rows, **kw)
                assert slope("_WALK_BLOCK_US", plan, n, torch.float32,
                             op) == 0.0
                assert slope("_GRID_STEP_OVERHEAD", plan, n, torch.float32,
                             op) == pytest.approx(tiles / P)
    # A block walks 8 links a lane: at R1 B32 the pallas term counts one
    # block for 8 tiles.
    plan = tat.ReductionPlan(method="pallas", chain=1, block_rows=32)
    assert slope("_WALK_BLOCK_US", plan, 1 << 28, torch.bfloat16) \
        == pytest.approx((1 << 28) / (32 * 16 * mr.WALK_UNITS) / P)


def test_selection_rules(fresh_registries):
    n = 1 << 16
    fastest = tat.autotune(n, torch.float32, backend="cpu")
    assert fastest.source == "model"
    costs = [tat.model_cost(c, n, torch.float32)
             for c in tat.candidate_plans(n, torch.float32)]
    assert fastest.cost == min(costs)
    budget = tp.MmaPolicy(error_budget_pct=1e-5)
    within = tat.autotune(n, torch.float32, policy=budget, backend="cpu")
    assert within.error_pct is not None
    assert within.error_pct == min(
        tat.model_percent_error(c, n, torch.float32)
        for c in tat.candidate_plans(n, torch.float32))
    slo = tat.autotune(n, torch.float32, objective=1e3, backend="cpu")
    assert slo.latency_ms <= 1e3 and slo.error_pct is not None
    # a mesh tunes the local shard: n / 2 elements a rank on data2, plus
    # the combine's constant cost, as the reference does
    shard = tat.autotune(n, torch.float32, mesh="data2", backend="cpu")
    half = tat.autotune(n // 2, torch.float32, backend="cpu")
    assert (shard.method, shard.chain, shard.block_rows) == \
        (half.method, half.chain, half.block_rows)
    assert shard.cost == pytest.approx(
        half.cost + tat.combine_model_cost("data2"))
    jshard = jat.autotune(n, jnp.float32, mesh="data2")
    jhalf = jat.autotune(n // 2, jnp.float32)
    assert (jshard.method, jshard.chain, jshard.block_rows) == \
        (jhalf.method, jhalf.chain, jhalf.block_rows)
    with pytest.raises(ValueError, match="no reduction candidates"):
        tat.autotune(n, torch.float32, engine="fused_pallas")


def test_get_plan_caches_and_measures_on_this_host(fresh_registries):
    reg = tat.PlanRegistry()
    plan = tat.get_plan(3000, torch.float32, registry=reg, backend="cpu",
                        engine="pallas")
    assert tat.get_plan(3000, torch.float32, registry=reg, backend="cpu",
                        engine="pallas") is plan
    timed = tat.get_plan(3000, torch.float32, registry=reg, backend="cpu",
                         engine="pallas", measure=True)
    assert timed.source == "measured" and timed.cost > 0.0
    assert reg.get("reduce_sum|4096|float32|cpu|pallas") == timed
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="cannot measure"):
            tat.get_plan(3000, torch.float32, backend="cuda", measure=True,
                         registry=reg)
        with pytest.raises(ValueError, match="cannot measure"):
            tat.measure_cost(plan, 3000, torch.float32, backend="cuda")
    err = tat.measured_percent_error(timed, 3000, torch.float32,
                                     backend="cpu")
    assert 0.0 <= err < 5e-3


def _ref_store(path):
    reg = jat.PlanRegistry()
    reg.put("reduce_sum|4096|float32|cpu",
            jat.ReductionPlan(method="pallas", chain=5, block_rows=32,
                              source="measured", cost=3.5))
    reg.put("squared_sum|1024|bfloat16|tpu|pallas|prec:any.float32.b0.001",
            jat.ReductionPlan(method="pallas", chain=2, error_pct=1e-4))
    reg.save(str(path))


def test_the_port_reads_the_reference_store(tmp_path):
    path = tmp_path / "plans.json"
    _ref_store(path)
    reg = tat.PlanRegistry.load(str(path))
    ref = jat.PlanRegistry.load(str(path))
    assert [k for k, _ in reg.items()] == [k for k, _ in ref.items()]
    for (_, tplan), (_, jplan) in zip(reg.items(), ref.items()):
        assert tplan.to_dict() == jplan.to_dict()
    assert reg.get("reduce_sum|4096|float32|cpu").m == 128


def test_the_reference_reads_the_port_store(tmp_path):
    path = tmp_path / "plans.json"
    reg = tat.PlanRegistry(str(path))
    plan = tat.ReductionPlan(method="pallas", chain=4, block_rows=512,
                             source="measured", cost=380.0)
    reg.put(tat.plan_key("reduce_sum", 1 << 28, torch.bfloat16, "cuda"),
            plan)
    reg.save()
    data = json.loads(path.read_text())
    assert data["version"] == tat.SCHEMA_VERSION == jat.SCHEMA_VERSION
    ref = jat.PlanRegistry.load(str(path))
    got = ref.get("reduce_sum|268435456|bfloat16|cuda")
    assert got.to_dict() == plan.to_dict() and got.m == 16


def test_foreign_backend_plans_never_resolve_on_the_card(tmp_path,
                                                         fresh_registries):
    path = tmp_path / "plans.json"
    _ref_store(path)
    reg = tat.PlanRegistry.load(str(path))
    reg.put("reduce_sum|4096|float32|tpu",
            tat.ReductionPlan(method="pallas", chain=3, cost=-1.0))
    plan = tat.get_plan(4000, torch.float32, backend="cuda", registry=reg)
    assert plan.source == "model" and plan.cost > 0.0
    assert reg.get("reduce_sum|4096|float32|cuda") == plan
    assert tat.get_plan(4000, torch.float32, backend="cpu",
                        registry=reg).cost == 3.5


def test_save_merges_locks_and_refuses_future_schemas(tmp_path):
    path = str(tmp_path / "plans.json")
    a, b = tat.PlanRegistry(path), tat.PlanRegistry(path)
    a.put("k1", tat.ReductionPlan(method="vpu", cost=2.0))
    b.put("k1", tat.ReductionPlan(method="mma", source="measured",
                                  cost=9.0))
    b.put("k2", tat.ReductionPlan(method="mma"))
    a.save()
    b.save()
    merged = tat.PlanRegistry.load(path)
    assert merged.get("k1").method == "mma" and merged.get("k2") is not None
    assert os.path.exists(path + ".lock")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    c = tat.PlanRegistry(path)
    assert c.reload() == 2
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"k": {"method": "vpu"}}))
    assert tat.PlanRegistry.load(str(legacy)).get("k").method == "vpu"
    future = tmp_path / "future.json"
    future.write_text(json.dumps({"version": 99, "plans": {}}))
    with pytest.raises(ValueError, match="schema version"):
        tat.PlanRegistry.load(str(future))
    with pytest.raises(ValueError, match="no path"):
        tat.PlanRegistry().save()


def test_default_registry_is_seeded_from_the_environment(
        tmp_path, monkeypatch, fresh_registries):
    path = tmp_path / "seed.json"
    _ref_store(path)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    tat.reset_default_registry()
    assert tat.default_registry().get("reduce_sum|4096|float32|cpu").chain \
        == 5
    bound = tat.bind_default_registry(str(tmp_path / "other.json"))
    assert bound is tat.default_registry()


# ---------------------------------------------------------------------
# Warmup and background sweeps (the serving pieces), against the
# reference's tests/test_plan_store.py
# ---------------------------------------------------------------------


def test_warmup_counts_match_the_reference(fresh_registries):
    shapes = [1000, 1024, 1700, 2048]
    ops = ("reduce_sum", "squared_sum")
    treg, jreg = tat.PlanRegistry(), jat.PlanRegistry()
    got = tat.warmup(ops, shapes, registry=treg)
    want = jat.warmup(ops, shapes, registry=jreg)
    assert (got["resolved"], got["tuned"]) == \
        (want["resolved"], want["tuned"]) == (4, 4)
    assert got["keys"] == want["keys"]
    assert len(treg) == len(jreg) == 4
    again = tat.warmup(ops, shapes, registry=treg)
    assert (again["resolved"], again["tuned"]) == (4, 0)
    mixed = tat.warmup("reduce_sum", [(1000, torch.float32),
                                      (1000, torch.bfloat16)],
                       registry=tat.PlanRegistry())
    jmixed = jat.warmup("reduce_sum", [(1000, jnp.float32),
                                       (1000, jnp.bfloat16)],
                        registry=jat.PlanRegistry())
    assert mixed["keys"] == jmixed["keys"] == (
        "reduce_sum|1024|float32|cpu", "reduce_sum|1024|bfloat16|cpu")
    assert mixed["tuned"] == jmixed["tuned"] == 2


def test_sweep_worker_upgrades_model_plan_off_hot_path(fresh_registries):
    import time
    reg = tat.PlanRegistry()
    with tat.SweepWorker(reg, iters=1) as worker:
        reg.sweep_worker = worker
        t0 = time.perf_counter()
        plan = tat.get_plan(512, torch.float32, registry=reg)
        assert plan.source == "model"            # served at once
        assert time.perf_counter() - t0 < 5.0
        # the same key again while it is in flight is not queued twice
        tat.get_plan(512, torch.float32, registry=reg)
        assert worker.drain(timeout_s=120.0)
        key = tat.plan_key("reduce_sum", 512, torch.float32)
        assert reg.get(key).source == "measured"
        assert worker.upgraded == 1 and worker.failed == 0
        assert tat.get_plan(512, torch.float32,
                            registry=reg).source == "measured"
        # a swap clears dispatch's memo of auto plans under the lock
        reg.auto_memo["stale"] = plan
        reg.put(key, reg.get(key))
        assert not reg.auto_memo


def test_sweep_worker_dedups_and_close_never_deadlocks(fresh_registries):
    import time
    reg = tat.PlanRegistry()
    worker = tat.SweepWorker(reg, iters=1)
    spec = dict(n=512, dtype=torch.float32, op="reduce_sum")
    key = tat.plan_key("reduce_sum", 512, torch.float32)
    assert worker.submit(key, dict(spec))
    assert not worker.submit(key, dict(spec))   # in-flight dedup
    t0 = time.perf_counter()
    worker.close(timeout_s=10.0)
    assert time.perf_counter() - t0 < 30.0
    assert not worker._thread.is_alive()
    assert not worker.submit(key, dict(spec))   # closed: refuses
    worker.close()                               # idempotent


def test_sweep_worker_ignores_a_foreign_backend(fresh_registries):
    reg = tat.PlanRegistry()
    with tat.SweepWorker(reg) as worker:
        reg.sweep_worker = worker
        tat.get_plan(1024, torch.float32, registry=reg, backend="tpu")
        assert worker.pending() == 0


def test_sweep_worker_counts_a_failed_sweep(fresh_registries):
    reg = tat.PlanRegistry()
    with tat.SweepWorker(reg, iters=1) as worker:
        assert worker.submit("k", dict(n=512, dtype=torch.float32,
                                       op="no_such_op"))
        assert worker.drain(timeout_s=60.0)
        assert worker.failed == 1 and worker.upgraded == 0
        assert reg.get("k") is None


def test_autotune_cancel_raises_sweep_cancelled():
    with pytest.raises(tat.SweepCancelled, match="cancelled"):
        tat.autotune(512, torch.float32, measure=True, backend="cpu",
                     cancel=lambda: True)
    calls = []

    def after_two():
        calls.append(1)
        return len(calls) > 2
    with pytest.raises(tat.SweepCancelled):
        tat.autotune(512, torch.float32, cancel=after_two)
    assert len(calls) == 3
    assert issubclass(tat.SweepCancelled, RuntimeError)


def test_reset_default_registry_closes_the_worker(fresh_registries):
    reg = tat.default_registry()
    worker = tat.SweepWorker(reg)
    reg.sweep_worker = worker
    tat.reset_default_registry()
    assert not worker._thread.is_alive()
    assert tat.default_registry() is not reg
    assert tat.default_registry().sweep_worker is None
