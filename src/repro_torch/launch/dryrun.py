"""The dry run of the production meshes — the counterpart of
``repro.launch.dryrun``: one step of every (arch x shape x mesh) cell as
the port runs it, recorded for rank 0 of a world the size of the mesh,
with no device memory allocated and no kernel launched.

    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
        --mesh pod --out-dir experiments/dryrun
    python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's memory and cost analyses and the collectives of
the compiled HLO.  The port compiles nothing.  It opens a ``fake``
process group of 256 (``pod``: 16 x 16, ``data`` x ``model``) or 512
(``multipod``: 2 x 16 x 16) ranks for rank 0 (``fake_world``; the
backend moves nothing), builds the reference's mesh over it, and runs
the cell's step eagerly under ``FakeTensorMode`` (``_fake_mode``):
every tensor has a shape, a dtype and a device and no memory.  The step is the port's own:

  * a train cell is ``launch.train.jit_train_step``'s step on the
    state's ``DTensor`` blocks (``make_init_state``'s leaves, laid out by
    the logical rules) and rank 0's rows, with the reference's
    ``TRAIN_MICROBATCHES``: every non-expert leaf gathered once a step
    (a tensor-parallel body's block over ``model`` over its other axes
    only, every other leaf whole), the products split over ``model``
    where the rules split them, the gradients summed over the batch
    axes;
  * a prefill or decode cell is a step of ``launch.serve``'s server over
    the mesh: the parameters in ``cfg.compute_dtype``, laid out by the
    logical rules, gathered once (``serve._MeshShare``), the model run
    on rank 0's rows (``sharding.batch_rows``) inside
    ``sharding.local_step``, the last logits gathered over the batch
    axes.  A decode cell's caches are laid out as the reference lays
    them out (``transformer.cache_logical_axes``); the server decodes
    its rows with whole heads, so each cache leaf is gathered over the
    axes that split it past its rows and rank 0's block of the new cache
    is written back in place.

The kernels' entries take fake tensors through their ``torch.library``
ops (``kernels.ops``), and ``auto`` takes its plans from the cost model
alone (``autotune.model_plans_only``).  A record holds the reference's
keys, computed from what rank 0's step dispatches (``_Recorder``, a
``TorchDispatchMode`` with ``FlopCounterMode``'s formulas):

  * ``memory_analysis``: ``argument_size_in_bytes``, the local bytes of
    every input leaf (exact); ``output_size_in_bytes``;
    ``temp_size_in_bytes``, the peak of the live storages during the
    step less the arguments; ``alias_size_in_bytes``, the argument bytes
    written in place (AdamW's state, a decode step's caches).
    ``generated_code_size_in_bytes`` has no counterpart: nothing is
    generated;
  * ``cost_analysis``: ``flops`` (``FlopCounterMode``'s: products and
    attention, with B9's and B10's own formulas; XLA also counts
    elementwise flops), ``bytes_accessed`` (operand and result bytes of
    every op that is not a view) and ``transcendentals`` (elements of
    ``_TRANSCENDENTAL``'s ops);
  * ``collectives``: per kind, ``count``, ``bytes`` (operand bytes) and
    ``group_sizes`` (bytes by group size), under the reference's
    ``COLLECTIVE_OPS`` names; a c10d op of no such kind keeps its name;
  * ``structural_bytes``: operand and result bytes of the reference's
    ``STRUCTURAL_OPS`` classes as aten ops (``_STRUCTURAL``);
  * ``launches``: the kernels' ops by name (``repro_torch::...``).

The reference's ``parse_collectives``, ``parse_structural_bytes`` and
``_shape_bytes`` read HLO text, which the port does not have: they have
no counterpart.  ``lower_s`` is the time to build the cell's step and
arguments, ``compile_s`` the time of the step.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.core import autotune
from repro_torch.core.dispatch import default_device
from repro_torch.core.integration import _leaves, _tree_like
from repro_torch.distributed import sharding as shd
from repro_torch.launch import serve as servelib
from repro_torch.launch import train as trainlib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.models import transformer as T
from repro_torch.models.param import _map, axes_tree, shapes_tree

# Per-arch baseline knobs for the train step (gradient accumulation):
# the reference's, copied.
TRAIN_MICROBATCHES = {
    "deepseek-v3-671b": 8,
    "arctic-480b": 4,
    "mistral-large-123b": 4,
    "llama-3.2-vision-90b": 4,
    "gemma3-27b": 2,
}

# The reference's table of HLO element types, copied.
_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
    "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

# The reference's structural HLO ops (bytes that move through memory
# whatever fuses) ...
STRUCTURAL_OPS = ("dot", "convolution", "scatter", "gather",
                  "dynamic-slice", "dynamic-update-slice",
                  "all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute", "sort")

# ... as aten ops (by overload packet name; the collectives are every c10d
# op): dot, gather / scatter, sort.
_STRUCTURAL = frozenset((
    "mm", "bmm", "addmm", "baddbmm", "convolution",
    "index", "index_select", "gather", "embedding",
    "embedding_dense_backward", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "index_add", "index_add_", "index_copy",
    "index_copy_", "index_put", "index_put_",
    "sort", "topk"))

# Ops that evaluate a transcendental function once an output element.
_TRANSCENDENTAL = frozenset((
    "exp", "exp_", "log", "log_", "tanh", "tanh_", "rsqrt", "rsqrt_",
    "sin", "sin_", "cos", "cos_"))

# c10d ops (``c10d::`` and the functional ``_c10d_functional::``) by the
# reference's kind, and the argument holding each one's operand.
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
}
_OPERAND = {"allgather_": 1, "_allgather_base_": 1,
            "allgather_into_tensor_coalesced_": 1, "reduce_scatter_": 1,
            "_reduce_scatter_base_": 1, "alltoall_": 1, "alltoall_base_": 1}

MESH_SHAPES = {"pod": (16, 16), "multipod": (2, 16, 16)}


def _count_out_dtype_products() -> None:
    """``FlopCounterMode``'s formulas for the products take (a, b,
    out_shape=...): the ``out_dtype`` overloads (``aten.mm.dtype``,
    ``aten.bmm.dtype``), which ``core.reduction._product`` calls on the
    card, pass their dtype third and the formula raises.  Each formula is
    wrapped, once, to drop a dtype argument; the others are unchanged."""
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    for packet in (aten.mm, aten.bmm, aten.addmm, aten.baddbmm):
        f = flop_registry.get(packet)
        if f is None or getattr(f, "drops_dtype", False):
            continue

        def count(*args, _f=f, **kwargs):
            kwargs.pop("out_dtype", None)
            return _f(*(a for a in args if not isinstance(a, torch.dtype)),
                      **kwargs)
        count.drops_dtype = True
        flop_registry[packet] = count


_count_out_dtype_products()


# ------------------------------------------------------------ meshes


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` process group of ``size`` ranks, this process its rank
    0, destroyed on the way out (an error or not).  Refuses to start
    while a process group is live."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run opens a fake world of its own: a process group "
            "is live in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(kind: str, *, device=None):
    """The reference's mesh of ``kind`` (``pod`` or ``multipod``) over the
    live (fake) world, for tensors on ``device`` (the card unless the
    CPU is named)."""
    if kind not in MESH_SHAPES:
        raise ValueError(f"unknown mesh {kind!r} (know {list(MESH_SHAPES)})")
    return make_production_mesh(multi_pod=kind == "multipod",
                                device=default_device(device))


# ------------------------------------------------------------ recording


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses,
    each ``DTensor`` as its local block."""
    if isinstance(tree, torch.Tensor):
        return [shd.local(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args, kwargs) -> int | None:
    import torch.distributed as dist
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(args[-1]).size()
    return None


def _flat(values) -> list:
    """The tensors among an op's arguments (lists of them too)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(_flat(v))
    return out


@functools.cache
def _written(func) -> tuple:
    """The (index, name) of each argument ``func`` writes in place."""
    return tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


class _Recorder:
    """What a step dispatches, op by op, below every ``DTensor``: the
    flops (``FlopCounterMode``'s formulas, read here: a second mode
    would double the step's time), operand and result bytes,
    transcendentals, structural bytes, the collectives, the kernels'
    ops, the argument storages written, and the live storages (their
    peak)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.live = self.peak = self.flops = 0
        self.bytes_accessed = self.transcendentals = self.structural = 0
        self.collectives: dict = {}
        self.launches: collections.Counter = collections.Counter()
        self.args: dict = {}        # id(storage) -> bytes, arguments
        self.written: dict = {}     # the same, written in place
        self._held: dict = {}       # id(storage) -> weakref of it

    def _track(self, t) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._held:
            n = st.nbytes()

            def gone(_, key=key, n=n):
                self._held.pop(key, None)
                self.live -= n
            self._held[key] = weakref.ref(st, gone)
            self.live += n
            self.peak = max(self.peak, self.live)
        return key

    def hold(self, args) -> None:
        """Register the step's arguments (their storages live
        throughout)."""
        for t in _tensors(args):
            self.args[self._track(t)] = t.untyped_storage().nbytes()

    @staticmethod
    def storage_bytes(tree) -> int:
        seen = {}
        for t in _tensors(tree):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
        return sum(seen.values())

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if func.namespace != "prim":
                    rec.record(func, args, kwargs, out)
                return out
        return Mode()

    def record(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        outs = _flat((out,))
        if packet in self._flops:
            self.flops += self._flops[packet](*args, **kwargs, out_val=out)
        moved = 0
        if not func.is_view:
            moved = sum(_nbytes(t) for t in _flat(args)) + \
                sum(_nbytes(t) for t in _flat(kwargs.values())) + \
                sum(_nbytes(t) for t in outs)
        self.bytes_accessed += moved
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if func.namespace == "repro_torch" and name != "checkpoint_name":
            self.launches[name] += 1
        if func.namespace in ("c10d", "_c10d_functional"):
            self.structural += moved
            self._collective(func, name, args, kwargs)
        elif name in _STRUCTURAL:
            self.structural += moved
        for i, key in _written(func):
            value = args[i] if i < len(args) else kwargs.get(key)
            for t in _flat((value,)):
                sid = id(t.untyped_storage())
                if sid in self.args:
                    self.written[sid] = self.args[sid]
        for t in outs:
            self._track(t)

    def _collective(self, func, name, args, kwargs) -> None:
        kind = _KINDS.get(name, name)
        nbytes = sum(_nbytes(t) for t in _flat((args[_OPERAND.get(name, 0)],)))
        size = _group_size(func, args, kwargs)
        rec = self.collectives.setdefault(
            kind, {"count": 0, "bytes": 0, "group_sizes": {}})
        rec["count"] += 1
        rec["bytes"] += nbytes
        if size:
            sizes = rec["group_sizes"]
            sizes[str(size)] = sizes.get(str(size), 0) + nbytes


# ------------------------------------------------------------ the step


def _fake_mode():
    """``FakeTensorMode`` as it runs on a host without a card, on any
    host: where a card is present it runs ``torch.tensor(...,
    device='cuda')`` and a host constant's copy to the card for real
    (small copies and allocations on the card, which the dry run must not
    make); ``avoid_device_init`` keeps both fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Mode(FakeTensorMode):
        @property
        def avoid_device_init(self) -> bool:
            return True
    return Mode(allow_non_fake_inputs=True)


def _fresh(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _block(whole: torch.Tensor, sharding) -> torch.Tensor:
    """Rank 0's block of ``whole`` in a storage of its own."""
    return whole if sharding is None else sharding.shard(whole).clone()


def _past_rows(spec, row_axes: tuple):
    """A cache leaf's spec without the axes of the batch's rows."""
    return shd.P(*(None if not shd.spec_axes((e,)) or
                   set(shd.spec_axes((e,))) <= set(row_axes) else e
                   for e in spec))


def _serving_step(model, cfg, shape_cfg, mesh, device):
    share = servelib._share(model, mesh)
    specs = model.input_specs(shape_cfg)
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    rows = servelib._WHOLE if share is None else share.rows(b)
    p_shapes = _map(lambda x: type(x)(x.shape, cfg.compute_dtype),
                    shapes_tree(model.specs))
    p_shard = shd.tree_shardings(p_shapes, axes_tree(model.specs), mesh)
    params = shd._tree_map2(
        lambda x, sh: sh.distribute(_fresh(x.shape, x.dtype, device)),
        p_shapes, p_shard)

    if shape_cfg.kind == "prefill":
        batch = {k: _fresh(v.shape, v.dtype, device)[rows.part].clone()
                 for k, v in specs.items()}

        def prefill(params, batch):
            logits, caches = servelib._run(share, model.prefill, params,
                                           batch, rows, s)
            return servelib._whole(share, logits, rows), caches
        return prefill, (params, batch)

    c_specs = specs["caches"]
    c_shard = shd.tree_shardings(c_specs, T.cache_logical_axes(c_specs),
                                 mesh)
    caches = shd._tree_map2(
        lambda x, sh: _block(_fresh(x.shape, x.dtype, device), sh),
        c_specs, c_shard)
    # each leaf's layout past the rows: what the server holds whole
    past = [_past_rows(sh.spec, rows.axes) for sh in _leaves(c_shard)]
    batch = {"token": _fresh((b, 1), torch.int32, device)[rows.part].clone(),
             "pos": _fresh((), torch.int32, device), "caches": caches}

    def decode(params, batch):
        held = _leaves(batch["caches"])
        whole = _tree_like(batch["caches"], [
            shd.gather_shard(c, sp, mesh) for c, sp in zip(held, past)])
        logits, new = servelib._run(share, model.decode_step, params,
                                    dict(batch, caches=whole), rows, s)
        for c, n, sp in zip(held, _leaves(new), past):
            block = shd.local_shard(n, sp, mesh)
            if block is not c:
                c.copy_(block)
        return servelib._whole(share, logits, rows), batch["caches"]
    return decode, (params, batch)


def _cell_step(cfg, shape_cfg, mesh, *, microbatches: int = 1,
               device=None):
    """(step, its arguments) of one cell on rank 0, made on fake tensors
    (call it under ``FakeTensorMode``).  Nothing is compiled: the step
    runs eagerly when called."""
    device = default_device(device)
    model = model_zoo.build(cfg)
    if shape_cfg.kind != "train":
        return _serving_step(model, cfg, shape_cfg, mesh, device)
    tconf = TrainConfig(microbatches=microbatches)
    specs = model.input_specs(shape_cfg)
    step, make_init, _, b_shard = trainlib.jit_train_step(
        model, tconf, mesh, specs, device=device)
    batch = {k: _block(_fresh(v.shape, v.dtype, device), b_shard[k])
             for k, v in specs.items()}
    return step, (make_init(0), batch)


def compile_cell(cfg, shape_cfg, mesh, *, microbatches: int = 1,
                 device=None) -> dict:
    """One cell's step on rank 0, run on fake tensors; returns its
    record (see the module docstring).  Nothing is compiled: the name is
    the reference's.  The reference's ``want_hlo`` switch skipped an HLO
    dump; the recorder counts the collectives and structural bytes as the
    step runs, so every record holds them."""
    t0 = time.time()
    with autotune.model_plans_only("the dry run"), _fake_mode():
        step, args = _cell_step(cfg, shape_cfg, mesh,
                                microbatches=microbatches, device=device)
        t_lower = time.time() - t0
        rec = _Recorder()
        rec.hold(args)
        arg_bytes = rec.live
        with rec.mode():
            out = step(*args)
        t_step = time.time() - t0 - t_lower
        res = {"lower_s": round(t_lower, 1), "compile_s": round(t_step, 1)}
        res["cost_analysis"] = {
            "flops": float(rec.flops),
            "bytes_accessed": float(rec.bytes_accessed),
            "transcendentals": float(rec.transcendentals)}
        res["memory_analysis"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": rec.storage_bytes(out),
            "temp_size_in_bytes": max(rec.peak - arg_bytes, 0),
            "alias_size_in_bytes": sum(rec.written.values())}
        res["collectives"] = rec.collectives
        res["structural_bytes"] = rec.structural
        res["launches"] = dict(rec.launches)
        del out, args
    return res


# --------------------------------------------------- FLOP accounting


def _distinct_kinds(cfg):
    """Distinct (layer-kind, mlp-kind) pairs with their counts."""
    counts: dict[tuple, int] = {}
    for d in T.layer_descs(cfg):
        counts[(d.kind, d.mlp)] = counts.get((d.kind, d.mlp), 0) + 1
    return counts


def _microcost_cfg(cfg, kind_mlp, n_layers, shape_cfg):
    """Config with n_layers of exactly one (kind, mlp) (the reference's:
    unrolled, attention unchunked)."""
    kind, mlp = kind_mlp
    moe = cfg.moe
    if moe is not None:
        first_dense = 0 if mlp == "moe" else n_layers
        moe = dataclasses.replace(moe, first_dense_layers=first_dense)
    seq = shape_cfg.seq_len
    return dataclasses.replace(
        cfg, num_layers=n_layers, pattern=(kind,), moe=moe,
        scan_layers=False, attn_chunk=max(seq, cfg.attn_chunk),
        encoder_layers=min(cfg.encoder_layers, 1))


def seq_scale(cfg, shape_cfg) -> tuple:
    """(the shape the layer microcosts run at, the factor their costs are
    scaled by): RWKV's time loop runs a step per position, too slow on
    fake tensors past 64 positions, so an RWKV arch (``rwkv6-7b``) at a
    longer train or prefill shape is counted at 64 and scaled (its costs
    are linear in S); every other cell as it is."""
    if cfg.rwkv is not None and shape_cfg.kind != "decode" \
            and shape_cfg.seq_len > 64:
        return (dataclasses.replace(shape_cfg, seq_len=64),
                shape_cfg.seq_len / 64)
    return shape_cfg, 1.0


def _costs(r: dict) -> np.ndarray:
    coll = sum(v["bytes"] for v in r["collectives"].values())
    ca = r["cost_analysis"]
    return np.array([ca["flops"], ca["bytes_accessed"], float(coll),
                     float(r["structural_bytes"])])


def accounting(cfg, shape_cfg, mesh, direct: dict, *,
               device=None) -> dict:
    """Per-device totals and per-layer-kind costs.  The eager step counts
    every layer, so the totals are the full-depth step's own (``direct``,
    its record).  The per-kind costs and the base come from the
    reference's one- and two-layer configs (at ``seq_scale``'s shape,
    scaled back), so a record reads as the reference's does."""
    counts = _distinct_kinds(cfg)
    sc, scale = seq_scale(cfg, shape_cfg)

    def costs_of(c):
        return _costs(compile_cell(c, sc, mesh, device=device)) * scale

    kinds = list(counts)
    f1 = {km: costs_of(_microcost_cfg(cfg, km, 1, sc)) for km in kinds}
    f2_first = costs_of(_microcost_cfg(cfg, kinds[0], 2, sc))
    g = {kinds[0]: f2_first - f1[kinds[0]]}
    base = f1[kinds[0]] - g[kinds[0]]
    for km in kinds[1:]:
        g[km] = f1[km] - base
    total = _costs(direct)
    return {
        "flops_per_device": float(total[0]),
        "bytes_per_device": float(total[1]),
        "collective_bytes_per_device": float(total[2]),
        "structural_bytes_per_device": float(total[3]),
        "seq_scale": scale,
        "per_kind_flops": {f"{k[0]}/{k[1]}": float(v[0])
                           for k, v in g.items()},
        "per_kind_structural_bytes": {f"{k[0]}/{k[1]}": float(v[3])
                                      for k, v in g.items()},
        "base_flops": float(base[0]),
    }


# --------------------------------------------------------------- CLI


def _with_overrides(cfg, overrides):
    """``cfg`` with the fields of ``overrides`` (a dict, or its JSON): a
    dtype field given by its torch name ('bfloat16'), a nested config
    (``moe``, ``mla``, ...) by a dict of its fields."""
    if isinstance(overrides, str):
        overrides = json.loads(overrides)
    def value(old, new):
        if isinstance(old, torch.dtype):
            return getattr(torch, new)
        if dataclasses.is_dataclass(old) and isinstance(new, dict):
            return dataclasses.replace(old, **new)
        return new
    return dataclasses.replace(cfg, **{
        k: value(getattr(cfg, k, None), v) for k, v in overrides.items()})


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, with_accounting: bool = True, force: bool = False,
             overrides=None, tag: str = "", device=None) -> dict:
    """Dry-run one cell into ``{arch}__{shape}__{mesh}[__{tag}].json``
    under ``out_dir`` (read back, without running, when it exists and
    ``force`` is off); returns the record.  A cell that fails records
    ``ok: false`` with its error and traceback."""
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(path) and not force:
        print(f"[skip existing] {path}")
        with open(path) as f:
            return json.load(f)
    runnable, reason = registry.cell_is_runnable(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "runnable": runnable}
    if tag:
        rec["tag"] = tag
        rec["overrides"] = overrides
    if not runnable:
        rec["skip_reason"] = reason
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skipped] {arch} x {shape_name}: {reason}")
        return rec
    shape_cfg = SHAPES[shape_name]
    mb = TRAIN_MICROBATCHES.get(arch, 1) if shape_cfg.kind == "train" \
        else 1
    t0 = time.time()
    try:
        cfg = registry.get_config(arch)
        if overrides:
            cfg = _with_overrides(cfg, overrides)
        rec["world"] = int(np.prod(MESH_SHAPES[mesh_kind]))
        with fake_world(rec["world"]):
            mesh = production_mesh(mesh_kind, device=device)
            rec.update(compile_cell(cfg, shape_cfg, mesh, microbatches=mb,
                                    device=device))
            rec["microbatches"] = mb
            rec["ok"] = True
            rec["num_params"] = model_zoo.build(cfg).num_params()
            if with_accounting and mesh_kind == "pod":
                rec["accounting"] = accounting(cfg, shape_cfg, mesh, rec,
                                               device=device)
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec.get("ok") else "FAIL"
    print(f"[{status}] {arch} x {shape_name} x {mesh_kind} "
          f"({rec['total_s']}s)")
    return rec


def main(argv=None) -> list:
    """The CLI; returns the cells' records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--no-accounting", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ModelConfig fields (perf knobs)")
    ap.add_argument("--tag", default="",
                    help="suffix for the output file (perf variants)")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors name (cuda | cpu); "
                         "nothing is allocated on it")
    args = ap.parse_args(argv)

    archs = registry.list_archs() if args.all or not args.arch \
        else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    return [run_cell(arch, shape, mk, args.out_dir,
                     with_accounting=not args.no_accounting,
                     force=args.force, overrides=args.overrides,
                     tag=args.tag, device=args.device)
            for arch in archs for shape in shapes for mk in meshes]


if __name__ == "__main__":
    main()
