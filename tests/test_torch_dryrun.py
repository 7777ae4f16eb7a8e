"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) and against real ranks.

The reference runs in one subprocess (its module sets ``XLA_FLAGS`` to
512 host devices when it is imported, so this process never imports
it): its constants, ``cell_is_runnable``'s skip reason, and
``compile_cell``'s argument bytes and ``num_params`` for Gemma-2 2B and
DeepSeek-V3 at SMOKE size, train / prefill / decode cut to batch 4 and
32 positions, on a (2, 2) mesh of its host devices.  Beside it, one
spawned world of four gloo ranks on the CPU (``launch.mesh.run_ranks``)
runs the same SMOKE train cells for real, under the dry run's recorder,
``FlopCounterMode`` and ``CommDebugMode``, and the port dry-runs every
cell here on a fake world of 4.  Held to:

  (i) the constants, the production meshes' shapes and names, a live
      group refused and none left behind;
  (ii) the six cells' argument bytes equal to the reference's, the
      parameter trees' leaves and ``num_params`` too;
  (iii) the fake world against the real ranks: the collectives (kind,
      count, bytes, group sizes) equal to the recorder's on the real
      step and to ``CommDebugMode``'s counts with each c10d op's operand
      bytes read from its schema, argument bytes and flops equal, for
      Gemma-2 2B and DeepSeek-V3 under etp;
  (iv) ``accounting``'s base plus the per-kind flops times their layer
      counts equal to the full-depth step's flops; ``seq_scale``'s rule;
  (v) ``run_cell`` and the CLI: the reference's keys and file names, a
      SMOKE cell on fake worlds of 256 and 512 ranks, the skip record,
      a file read back, a bad override recorded as ``ok: false``;
  (vi) B1, B8, B9 and B10 on fake CUDA tensors (no card is needed): the
      shapes and dtypes of their plain versions; every other launch
      raises on a fake tensor before it reads a pointer.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.core import autotune
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import model_zoo
from repro_torch.models import moe

ARCHS = ("gemma2-2b", "deepseek-v3-671b")
CELLS = ("train_4k", "prefill_32k", "decode_32k")
BATCH, SEQ = 4, 32
WORLD = 4
MESH = (2, 2)
TIMEOUT = 240
# the kernel modules (the package's names are their entries' functions)
mma_attention, mma_norm_matmul, mma_reduce, mma_rmsnorm = (
    importlib.import_module(f"repro_torch.kernels.{m}") for m in (
        "mma_attention", "mma_norm_matmul", "mma_reduce", "mma_rmsnorm"))

_REF_PROG = textwrap.dedent("""
    import dataclasses
    import json
    import sys
    from repro.launch import dryrun as D   # 512 host devices
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.configs.base import SHAPES
    from repro.models import model_zoo
    from repro.models.param import shapes_tree

    archs, cells, batch, seq = json.loads(sys.argv[2])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    out = {"TRAIN_MICROBATCHES": D.TRAIN_MICROBATCHES,
           "_DTYPE_BYTES": D._DTYPE_BYTES,
           "COLLECTIVE_OPS": list(D.COLLECTIVE_OPS),
           "STRUCTURAL_OPS": list(D.STRUCTURAL_OPS),
           "skip": registry.cell_is_runnable("gemma2-2b", "long_500k"),
           "cells": {}, "leaves": {}, "num_params": {}}
    for arch in archs:
        cfg = registry.get_config(arch, smoke=True)
        model = model_zoo.build(cfg)
        out["num_params"][arch] = model.num_params()
        out["leaves"][arch] = sorted(
            "/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                shapes_tree(model.specs))[0])
        for cell in cells:
            sc = dataclasses.replace(SHAPES[cell], global_batch=batch,
                                     seq_len=seq)
            r = D.compile_cell(cfg, sc, mesh, want_hlo=False)
            out["cells"][f"{arch}/{cell}"] = \\
                r["memory_analysis"]["argument_size_in_bytes"]
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


# The reference's collective kinds by the c10d op ``CommDebugMode``
# counts: written here apart from the dry run's own table.
_C10D_KINDS = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
               "allgather_": "all-gather",
               "_reduce_scatter_base_": "reduce-scatter",
               "reduce_scatter_": "reduce-scatter",
               "alltoall_base_": "all-to-all", "alltoall_": "all-to-all"}


class _Comms(CommDebugMode):
    """``CommDebugMode``, which counts the collectives, and each c10d
    op's operand bytes and group size read from its schema: the
    arguments named ``input...``, else the tensors it reduces in
    place."""

    def __init__(self):
        super().__init__()
        self.operands: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            named = dict(zip((a.name for a in func._schema.arguments),
                             args), **(kwargs or {}))
            inputs = [v for k, v in named.items() if k.startswith("input")]
            tensors = list(pytree.tree_leaves(inputs or named["tensors"]))
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            size = dist.ProcessGroup.unbox(named["process_group"]).size()
            rec = self.operands.setdefault(func.overloadpacket.__name__,
                                           {"bytes": 0, "group_sizes": {}})
            rec["bytes"] += nbytes
            sizes = rec["group_sizes"]
            sizes[str(size)] = sizes.get(str(size), 0) + nbytes
        return super().__torch_dispatch__(func, types, args, kwargs)

    def by_kind(self) -> dict:
        """{kind: {count, bytes, group_sizes}}: the counts
        ``CommDebugMode``'s, the bytes this mode's."""
        out: dict = {}
        for packet, n in self.get_comm_counts().items():
            name = str(packet).split(".")[-1]
            rec = out.setdefault(_C10D_KINDS[name], {
                "count": 0, "bytes": 0, "group_sizes": {}})
            rec["count"] += n
            rec["bytes"] += self.operands[name]["bytes"]
            for size, b in self.operands[name]["group_sizes"].items():
                rec["group_sizes"][size] = rec["group_sizes"].get(size, 0) + b
        return out


def _shape(cell: str):
    return dataclasses.replace(SHAPES[cell], global_batch=BATCH, seq_len=SEQ)


def _real_cells() -> dict:
    """On every rank: the SMOKE train cells run for real on a (2, 2)
    mesh, rank 0's step under the dry run's recorder,
    ``FlopCounterMode`` and ``_Comms``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as trainlib
    torch.manual_seed(0)
    mesh = launch_mesh.make_local_mesh(*MESH, device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = registry.get_config(arch, smoke=True)
        model = model_zoo.build(cfg)
        specs = model.input_specs(_shape("train_4k"))
        step, make_init, _, b_shard = trainlib.jit_train_step(
            model, TrainConfig(microbatches=1), mesh, specs, device="cpu")
        rng = np.random.default_rng(0)
        batch = {k: b_shard[k].shard(torch.from_numpy(
            rng.integers(0, cfg.vocab_size, v.shape)).to(v.dtype)).clone()
            for k, v in specs.items()}
        state = make_init(0)
        rec = D._Recorder()
        rec.hold((state, batch))
        args = rec.live
        with _Comms() as comms, FlopCounterMode(display=False) as flops, \
                rec.mode():
            step(state, batch)
        out[arch] = {"collectives": rec.collectives, "args": args,
                     "comms": comms.by_kind(),
                     "flops": flops.get_total_flops(),
                     "recorded_flops": rec.flops}
    return out


def _port_cells() -> dict:
    """The port's records of every cell on a fake world of 4, and the
    accounting of Gemma-2 2B's train cell."""
    out = {}
    with D.fake_world(WORLD):
        mesh = launch_mesh.make_local_mesh(*MESH, device="cpu")
        for arch in ARCHS:
            cfg = registry.get_config(arch, smoke=True)
            for cell in CELLS:
                out[f"{arch}/{cell}"] = D.compile_cell(
                    cfg, _shape(cell), mesh, device="cpu")
        cfg = registry.get_config("gemma2-2b", smoke=True)
        out["accounting"] = D.accounting(
            cfg, _shape("train_4k"), mesh, out["gemma2-2b/train_4k"],
            device="cpu")
    assert not dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the real ranks run while this
    process dry-runs the port's cells."""
    tmp = tmp_path_factory.mktemp("dryrun")
    got = os.path.join(tmp, "reference.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_PROG, got,
         json.dumps([ARCHS, CELLS, BATCH, SEQ])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    real = {}

    def ranks():
        try:
            real["out"] = launch_mesh.run_ranks(
                _real_cells, WORLD, backend="gloo", timeout=TIMEOUT)
        except Exception as e:          # raised below, in the test
            real["error"] = e
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        port = _port_cells()
        thread.join()
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        thread.join()
    if "error" in real:
        raise real["error"]
    assert ref.returncode == 0, err[-4000:]
    with open(got) as f:
        return {"reference": json.load(f), "real": real["out"],
                "port": port}


@pytest.fixture(scope="module")
def world(runs):
    return runs


@pytest.fixture(scope="module")
def port(runs):
    return runs["port"]


# ------------------------------------------------ (i) constants, meshes


@pytest.mark.parametrize("name", ["TRAIN_MICROBATCHES", "_DTYPE_BYTES",
                                  "COLLECTIVE_OPS", "STRUCTURAL_OPS"])
def test_constants_are_the_references(world, name):
    got = getattr(D, name)
    want = world["reference"][name]
    assert (list(got) if isinstance(got, tuple) else got) == want


@pytest.mark.parametrize("kind,shape,names", [
    ("pod", (16, 16), ("data", "model")),
    ("multipod", (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh(kind, shape, names):
    with D.fake_world(int(np.prod(shape))):
        mesh = D.production_mesh(kind, device="cpu")
        assert mesh.axis_names == names
        assert tuple(mesh.shape.values()) == shape
        assert mesh.coordinate == dict.fromkeys(names, 0)
    assert not dist.is_initialized()


def test_a_live_group_is_refused_and_none_is_left():
    with D.fake_world(4):
        with pytest.raises(RuntimeError, match="process group is live"):
            with D.fake_world(4):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="boom"):
        with D.fake_world(4):
            raise ValueError("boom")
    assert not dist.is_initialized()


def test_the_fake_backend_takes_cuda_tensors_directly():
    """``collectives._staged``: under the fake backend a CUDA tensor goes
    straight to the collective, as under NCCL."""
    with D.fake_world(4):
        mesh = launch_mesh.make_local_mesh(*MESH, device="cpu")
        with FakeTensorMode():
            x = torch.empty(8, device="cuda")
        assert not collectives._staged(x, mesh.get_group("data"), "test")


def test_model_plans_only_refuses_a_timed_sweep():
    reg = autotune.default_registry()
    with autotune.model_plans_only("the test"):
        assert autotune.default_registry() is not reg
        plan = autotune.get_plan(1 << 20, torch.float32, backend="cpu")
        assert plan.source == "model"
        with pytest.raises(RuntimeError, match="the test takes its plans"):
            autotune.warmup("reduce_sum", [1 << 12], backend="cpu",
                            measure=True)
    assert autotune.default_registry() is reg


def test_moe_counts_are_bincounts():
    """``moe._slots`` counts the tokens per expert with a scatter of ones,
    whose shape does not depend on the ids: the bincount's values."""
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 8, (64, 2)))
    counts = moe._slots(ids, 8, 16)[3]
    assert torch.equal(counts, torch.bincount(ids.reshape(-1), minlength=8))


# ------------------------------------------------ (ii) the reference's bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_leaves_and_counts_are_the_references(world, arch):
    from repro_torch.launch.train import leaf_paths
    model = model_zoo.build(registry.get_config(arch, smoke=True))
    want = set(world["reference"]["leaves"][arch])
    got = set(leaf_paths(model.specs))
    assert got == want, (f"only in the port: {sorted(got - want)}; only "
                         f"in the reference: {sorted(want - got)}")
    assert model.num_params() == world["reference"]["num_params"][arch]


def _serving_bytes(arch: str, top: str) -> int:
    """Rank 0's bytes of the parameter leaves under ``top`` in the
    compute dtype, laid out by the logical rules on the (2, 2) mesh."""
    from repro_torch.core.integration import _leaves
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.param import axes_tree, shapes_tree
    cfg = registry.get_config(arch, smoke=True)
    specs = model_zoo.build(cfg).specs.get(top, {})
    with D.fake_world(WORLD):
        mesh = launch_mesh.make_local_mesh(*MESH, device="cpu")
        shards = shd.tree_shardings(shapes_tree(specs), axes_tree(specs),
                                    mesh)
        return sum(s.shard(torch.empty(x.shape, device="meta")).numel()
                   for x, s in zip(_leaves(shapes_tree(specs)),
                                   _leaves(shards))) * \
            cfg.compute_dtype.itemsize


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_references(world, port, arch, cell):
    """Equal, but for one subtree: a serving step of the reference never
    reads the MTP head's leaves (``mtp/...``, DeepSeek-V3), which its
    ``jax.jit`` then drops from the arguments; the port's server gathers
    every leaf it is given, so they are the port's arguments."""
    got = port[f"{arch}/{cell}"]["memory_analysis"]["argument_size_in_bytes"]
    unread = 0 if cell == "train_4k" else _serving_bytes(arch, "mtp")
    assert (unread > 0) == (arch == "deepseek-v3-671b" and cell != "train_4k")
    assert got - unread == world["reference"]["cells"][f"{arch}/{cell}"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cells_write_their_state_in_place(port, arch):
    mem = port[f"{arch}/train_4k"]["memory_analysis"]
    assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cells_write_their_caches_in_place(port, arch):
    rec = port[f"{arch}/decode_32k"]
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0


# ------------------------------------------------ (iii) fake against real


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_world_equals_the_real_ranks(world, port, arch):
    real = world["real"][arch]
    fake = port[f"{arch}/train_4k"]
    assert fake["collectives"] == real["collectives"] == real["comms"]
    assert fake["memory_analysis"]["argument_size_in_bytes"] == real["args"]
    assert fake["cost_analysis"]["flops"] == real["flops"] > 0
    assert real["recorded_flops"] == real["flops"]


def test_deepseek_trains_under_etp_with_its_all_to_alls(port):
    assert registry.get_config("deepseek-v3-671b", smoke=True) \
        .moe_layout == "etp"
    assert port["deepseek-v3-671b/train_4k"]["collectives"][
        "all-to-all"]["count"] > 0


def test_the_train_cell_splits_the_vocabulary_over_model():
    """Gemma-2 2B SMOKE's train cell on a fake world of 4 (2, 2), its step
    on rank 0's rows (2 of the batch's 4, 32 positions): the rules split
    the 512-token vocabulary over model, so no tensor the step makes has
    the whole vocabulary beside those rows (as (2, 32, V) or 64 rows by
    V); the logits and their gradients have 256 there."""
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg = registry.get_config("gemma2-2b", smoke=True)
    rows = {(BATCH // MESH[0], SEQ), (BATCH // MESH[0] * SEQ,)}
    widths: set = set()

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.ndim >= 2:
                    lead = tuple(t.shape[:2]) if t.ndim == 3 \
                        else tuple(t.shape[:1])
                    if lead in rows:
                        widths.add(int(t.shape[-1]))
            return out

    with D.fake_world(WORLD):
        mesh = launch_mesh.make_local_mesh(*MESH, device="cpu")
        with autotune.model_plans_only("the test"), D._fake_mode():
            step, args = D._cell_step(cfg, _shape("train_4k"), mesh,
                                      device="cpu")
            with Shapes():
                step(*args)
    assert cfg.vocab_size == 512
    assert 256 in widths and 512 not in widths, sorted(widths)


# ------------------------------------------------ (iv) accounting


def test_accounting_adds_up_to_the_full_depth_step(port):
    acc = port["accounting"]
    cfg = registry.get_config("gemma2-2b", smoke=True)
    counts = D._distinct_kinds(cfg)
    assert len(counts) == 2                    # local and global layers
    total = acc["base_flops"] + sum(
        n * acc["per_kind_flops"][f"{k}/{m}"] for (k, m), n in counts.items())
    direct = port["gemma2-2b/train_4k"]["cost_analysis"]["flops"]
    assert acc["flops_per_device"] == direct
    assert total == pytest.approx(direct, rel=1e-12)
    assert acc["seq_scale"] == 1.0


@pytest.mark.parametrize("arch,cell,scale", [
    ("rwkv6-7b", "train_4k", 64.0), ("rwkv6-7b", "prefill_32k", 512.0),
    ("rwkv6-7b", "decode_32k", 1.0), ("gemma2-2b", "prefill_32k", 1.0)])
def test_seq_scale_follows_the_references_rule(arch, cell, scale):
    sc, got = D.seq_scale(registry.get_config(arch), SHAPES[cell])
    assert got == scale
    assert sc.seq_len == (64 if scale > 1 else SHAPES[cell].seq_len)


# ------------------------------------------------ (v) run_cell and the CLI


REFERENCE_KEYS = {"arch", "shape", "mesh", "runnable", "tag", "overrides",
                  "lower_s", "compile_s", "cost_analysis",
                  "memory_analysis", "collectives", "structural_bytes",
                  "microbatches", "ok", "num_params", "total_s"}


def _smoke_overrides(arch: str) -> dict:
    full, smoke = registry.get_config(arch), \
        registry.get_config(arch, smoke=True)
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(full)
            if getattr(full, f.name) != getattr(smoke, f.name)}


def test_the_cli_runs_a_smoke_cell_on_256_and_512_ranks(tmp_path):
    recs = D.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                   "--mesh", "both", "--device", "cpu", "--out-dir",
                   str(tmp_path), "--no-accounting", "--tag", "smoke",
                   "--overrides", json.dumps(_smoke_overrides("gemma2-2b"))])
    assert [r["world"] for r in recs] == [256, 512]
    for rec, mesh in zip(recs, ("pod", "multipod")):
        assert rec["ok"], rec.get("traceback")
        assert REFERENCE_KEYS <= set(rec)
        path = tmp_path / f"gemma2-2b__decode_32k__{mesh}__smoke.json"
        assert json.loads(path.read_text())["mesh"] == mesh
        assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert not dist.is_initialized()


def test_the_skip_record_has_the_references_reason(world, tmp_path):
    rec = D.run_cell("gemma2-2b", "long_500k", "pod", str(tmp_path),
                     device="cpu")
    assert rec["runnable"] is False
    assert rec["skip_reason"] == world["reference"]["skip"][1]
    assert (tmp_path / "gemma2-2b__long_500k__pod.json").exists()


def test_an_existing_record_is_read_back_without_running(tmp_path):
    path = tmp_path / "gemma2-2b__train_4k__pod.json"
    path.write_text(json.dumps({"sentinel": 1}))
    assert D.run_cell("gemma2-2b", "train_4k", "pod", str(tmp_path),
                      device="cpu") == {"sentinel": 1}


@pytest.mark.parametrize("overrides", [{"no_such_field": 1}, "{not json"])
def test_a_bad_override_is_recorded_as_a_failure(tmp_path, overrides):
    rec = D.run_cell("gemma2-2b", "train_4k", "pod", str(tmp_path),
                     overrides=overrides, tag="bad", device="cpu")
    assert rec["ok"] is False and rec["error"] and rec["traceback"]
    assert not dist.is_initialized()


# ------------------------------------------------ (vi) kernels, fake tensors


def _entries(dev: str) -> dict:
    """Each kernel entry's call on small inputs made on ``dev`` (on the
    CUDA device only under ``FakeTensorMode``: no values are read)."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    bf16 = torch.bfloat16
    qpos = t(2, 8, dtype=torch.int32)
    return {
        "b1_reduce": lambda: ops.mma_reduce(t(1000), chain=4,
                                            block_rows=128),
        "b1_squares": lambda: ops.mma_squared_sum(t(1000, dtype=bf16)),
        "b8": lambda: ops.mma_rmsnorm(t(3, 5, 64, dtype=bf16), t(64)),
        "b10": lambda: ops.mma_norm_matmul(t(6, 64), t(64), t(64, 48)),
        "b10_gate": lambda: ops.mma_norm_matmul(
            t(6, 64, dtype=bf16), t(64), t(64, 48), w_gate=t(64, 48),
            act="gelu"),
        "b9": lambda: ops.mma_attention(
            t(2, 8, 2, 2, 16, dtype=bf16), t(2, 12, 2, 16, dtype=bf16),
            t(2, 12, 2, 16, dtype=bf16), qpos=qpos, causal=True, window=4,
            cap=50.0),
    }


@pytest.mark.parametrize("entry", ["b1_reduce", "b1_squares", "b8", "b10",
                                   "b10_gate", "b9"])
def test_kernel_entries_take_fake_cuda_tensors(entry):
    want = _entries("cpu")[entry]()
    with FakeTensorMode():
        with FlopCounterMode(display=False) as flops:
            got = _entries("cuda")[entry]()
    assert got.device.type == "cuda"
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    names = {str(k) for k in flops.get_flop_counts().get("Global", {})}
    if entry.startswith("b9"):
        assert "repro_torch.b9_attention" in names
    if entry.startswith("b10"):
        assert "repro_torch.b10_norm_matmul" in names


def _launches() -> dict:
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="cuda")
    x, ids = t(1024), t(1024, dtype=torch.int32)
    return {
        "b2": lambda: ops.mma_reduce_partials(x),
        "b2_recurrence": lambda: ops.mma_reduce(x, variant="recurrence",
                                                chain=1, block_rows=16),
        "b3": lambda: ops.mma_reduce(x, variant="split"),
        "b4": lambda: ops.mma_ec_reduce(x),
        "b5": lambda: ops.mma_dd_reduce(x),
        "b6": lambda: ops.mma_scan(x),
        "b7": lambda: ops.mma_segment_sum(x, ids, 4),
        "b1_wrapper": lambda: mma_reduce.single_pass_cuda(
            x, chain=1, block_rows=16),
        "b8_wrapper": lambda: mma_rmsnorm.rmsnorm_cuda(t(32, 32), t(32)),
        "b10_wrapper": lambda: mma_norm_matmul.norm_matmul_cuda(
            t(32, 32), t(32), t(32, 32)),
        "b9_wrapper": lambda: mma_attention.attention_cuda(
            t(2, 8, 2, 2, 16), t(2, 8, 2, 16), t(2, 8, 2, 16),
            qpos=t(2, 8, dtype=torch.int32), scale=0.25),
    }


@pytest.mark.parametrize("site", ["b2", "b2_recurrence", "b3", "b4", "b5",
                                  "b6", "b7", "b1_wrapper", "b8_wrapper",
                                  "b10_wrapper", "b9_wrapper"])
def test_every_other_launch_refuses_a_fake_tensor(site):
    with FakeTensorMode():
        call = _launches()[site]
        with pytest.raises(RuntimeError, match="holds no memory"):
            call()


def test_out_dtype_products_are_counted():
    """On the card ``core.reduction._product`` calls the ``out_dtype``
    overloads, which ``FlopCounterMode``'s formulas took for the output
    shape; the dry run's module wraps them to count the product."""
    from repro_torch.core.reduction import _bmm, _mm
    with FakeTensorMode():
        def t(*shape):
            return torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        rec = D._Recorder()
        with FlopCounterMode(display=False) as flops, rec.mode():
            _bmm(t(2, 8, 16), t(2, 16, 4))
            _mm(t(8, 16), t(16, 4))
    want = 2 * (2 * 8 * 16 * 4) + 2 * (8 * 16 * 4)
    assert flops.get_total_flops() == rec.flops == want
