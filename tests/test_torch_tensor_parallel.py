"""The tensor-parallel bodies of the SPMD train step over ``model``
(``models.layers``' gated MLP, embedding and logits,
``models.attention.attention``, ``models.transformer``'s cross-entropies,
``launch.train``'s leaf classification) against the JAX package's
single-device functions and the port's one-rank step.

One spawned world of four gloo ranks on the CPU (``launch.mesh.
run_ranks``), started once by a module-scoped fixture, builds a (data 2,
model 2) and a (data 1, model 4) mesh from it and computes what the cases
read; the JAX package's values are computed in this process beside the
ranks, which import no JAX.  Inputs come from numpy with a seed.

  (a) each body inside ``sharding.local_step`` with the model axis, its
      weights this rank's blocks by the rules (``spec_for`` over
      ``DEFAULT_RULES``), every rank holding the same rows, against the
      reference's function on the whole weights, forward and ``jax.grad``
      of sum(out * cotangent) (of the loss for the cross-entropies), in
      f32: the values within rtol 1e-5, the gradients within rtol 2e-4,
      each with an absolute floor of rtol x max|reference| (a gradient's
      entries that cancel to near zero); a rank's gradient of a block is
      held to that block of the reference's gradient.  Gemma-2 2B's
      attention on (1, 4) splits its 4 heads and keeps its 2 KV heads
      whole (the GQA case), GLM-4 9B's does so with its biases;
  (b) Gemma-2 2B and GLM-4 9B SMOKE, two steps on (2, 2) against the
      port's one-rank step on the same draw and batch: loss and
      param_norm rtol 1e-5, grad_norm rtol 2e-4 (the dense archs'
      tolerances of ``tests/test_torch_spmd_train.py``); after them every
      leaf the rules do not split over ``model`` holds the same bits on
      the two ``model`` ranks of each data row, parameters and both
      moments (a tensor whole on every rank whose gradient missed a
      ``copy_to`` would differ);
  (c) the step gathers every non-expert leaf once and no block of a
      tensor-parallel body over ``model`` (``launch.train.GATHERED``,
      ``GATHERED_OVER``); the bytes a rank gathers equal the sum of the
      leaves as the model reads them (a body's leaf split over ``model``
      at its block's size).
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.integration import _leaves
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train as TT
from repro_torch.models import model_zoo as TZ

WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
VALUE_RTOL, GRAD_RTOL = 1e-5, 2e-4
B, S = 2, 16
SHAPE = ShapeConfig("t", 16, 8, "train")
STEP_ARCHS = ("gemma2-2b", "glm4-9b")
ONE_RANK = {"gemma2-2b": 2, "glm4-9b": 3}
TCONF = dict(total_steps=10, warmup_steps=2)
CHUNK = 96                       # ragged against every block of 512

# (case, arch of its config, attention kind, meshes)
ATTENTION = (("attention/gemma2", "gemma2-2b", "local", ("2x2", "1x4")),
             ("attention/glm4", "glm4-9b", "global", ("1x4",)),
             ("attention/gemma3", "gemma3-27b", "global", ("2x2",)))
BODIES = ("mlp", "fused_mlp", "embed", "embed_onehot", "unembed_ce",
          "chunked_ce")


def _cfg(arch: str):
    return dataclasses.replace(TR.get_config(arch, smoke=True),
                               compute_dtype=torch.float32)


def _rng(name: str):
    return np.random.default_rng(sum(map(ord, name)))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _case(name: str) -> dict:
    """A case's numpy inputs: ``params`` (name -> (array, logical axes)),
    ``args`` and the cotangent ``cot`` (None for a loss)."""
    cfg = _cfg("gemma2-2b")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    rng = _rng(name)
    x = _normal(rng, B, S, d)
    if name in ("mlp", "fused_mlp"):
        params = {"wi_gate": (_normal(rng, d, f, scale=0.1), ("embed", "mlp")),
                  "wi_up": (_normal(rng, d, f, scale=0.1), ("embed", "mlp")),
                  "wo": (_normal(rng, f, d, scale=0.1), ("mlp", "embed"))}
        if name == "fused_mlp":
            params["scale"] = (_normal(rng, d, scale=0.1), ("embed_no_fsdp",))
        return {"params": params, "x": x, "cot": _normal(rng, B, S, d)}
    if name.startswith("attention/"):
        arch = next(a for c, a, _, _ in ATTENTION if c == name)
        from repro_torch.models import attention as TA
        specs = TA.attn_specs(_cfg(arch))
        params = {k: (_normal(rng, *p.shape, scale=0.1), p.axes)
                  for k, p in specs.items()}
        return {"params": params, "x": x, "cot": _normal(rng, B, S, d)}
    table = (_normal(rng, v, d, scale=d ** -0.5), ("vocab", "embed"))
    tokens = rng.integers(0, v, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    if name.startswith("embed"):
        return {"params": {"table": table}, "tokens": tokens,
                "cot": _normal(rng, B, S, d)}
    return {"params": {"table": table}, "x": x, "labels": tokens,
            "mask": mask, "cot": None}


def _model_dims(params: dict, mesh) -> dict:
    """Each leaf's dimension the rules split over ``model``, or None."""
    out = {}
    for k, (a, axes) in params.items():
        spec = shd.spec_for(a.shape, axes, mesh, shd.DEFAULT_RULES)
        out[k] = next((i for i, e in enumerate(spec) if e == "model"), None)
    return out


def _block(a: np.ndarray, dim, index: int, count: int) -> np.ndarray:
    if dim is None:
        return a
    n = a.shape[dim] // count
    return np.take(a, range(index * n, (index + 1) * n), axis=dim)


# ------------------------------------------------------------ the port


def _port_body(name: str, p: dict, inp: dict):
    """The port's body on this rank's ``p``: its output, or the loss
    for the cross-entropies."""
    from repro_torch.models import attention as TA
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as TT_
    cfg = _cfg("gemma2-2b")
    if name == "mlp":
        return TL.mlp(p, inp["x"], act="gelu", d_ff=cfg.d_ff)
    if name.startswith("fused_mlp"):
        method = "fused_pallas" if name.endswith("pallas") else "unfused_mma"
        return TL.fused_mlp({"scale": p["scale"]}, p, inp["x"], act="gelu",
                            method=method, d_ff=cfg.d_ff)
    if name.startswith("attention/"):
        _, arch, kind, _ = next(c for c in ATTENTION if c[0] == name)
        out, _ = TA.attention(p, _cfg(arch), inp["x"],
                              positions=torch.arange(S), kind=kind)
        return out
    if name.startswith("embed"):
        return TL.embed_lookup(p, inp["tokens"], scale=True, d=cfg.d_model,
                               compute_dtype=torch.float32,
                               onehot=name == "embed_onehot",
                               vocab=cfg.vocab_size)
    if name == "unembed_ce":
        logits = TL.unembed(p, inp["x"], softcap=cfg.final_softcap,
                            vocab=cfg.vocab_size)
        return TT_.cross_entropy(logits, inp["labels"], inp["mask"],
                                 vocab=cfg.vocab_size)
    return TT_.chunked_cross_entropy({"embed": p}, cfg, inp["x"],
                                     inp["labels"], inp["mask"], chunk=CHUNK)


def _run_body(name: str, mesh) -> dict:
    """One body on this rank: its output (or loss) and the gradients of
    sum(out * cot) (or of the loss) by x and by this rank's blocks."""
    case = _case(name.replace("_pallas", ""))
    dims = _model_dims(case["params"], mesh)
    m, r = mesh.shape["model"], mesh.coordinate["model"]
    p = {k: torch.from_numpy(_block(a, dims[k], r, m)).requires_grad_(True)
         for k, (a, _) in case["params"].items()}
    inp = {k: torch.from_numpy(v) for k, v in case.items()
           if k not in ("params", "cot") and v is not None}
    if "x" in inp:
        inp["x"].requires_grad_(True)
    grads = name != "fused_mlp_pallas"
    with shd.local_step(mesh, (), "model"), torch.set_grad_enabled(grads):
        out = _port_body(name, p, inp)
        if grads:
            loss = out if case["cot"] is None else \
                (out * torch.from_numpy(case["cot"])).sum()
            loss.backward()
    got = {"out": out.detach().numpy(), "dims": dims,
           "coord": (r, m), "grads": {}}
    if grads:
        got["grads"] = {k: t.grad.numpy() for k, t in p.items()
                        if t.grad is not None}
        if "x" in inp:
            got["grads"]["x"] = inp["x"].grad.numpy()
    return got


def _data_batch(cfg) -> dict:
    from repro_torch.data.pipeline import SyntheticLMData
    return SyntheticLMData(cfg, SHAPE, seed=3, device="cpu").batch_at(0)


def _metrics(m) -> list:
    return [float(m[k]) for k in ("loss", "grad_norm", "param_norm")]


def _bits(x: torch.Tensor) -> bytes:
    return x.detach().contiguous().view(torch.int32).numpy().tobytes()


def _mesh_steps(arch: str, mesh) -> dict:
    """Two steps of ``arch`` at SMOKE on ``mesh``: the metrics, each
    leaf's bits and spec (parameters and both moments), and the first
    step's gathers."""
    cfg = TR.get_config(arch, smoke=True)
    model = TZ.build(cfg)
    step, init, _, b_shard = TT.jit_train_step(
        model, TrainConfig(**TCONF), mesh, model.input_specs(SHAPE),
        device="cpu")
    batch = {k: b_shard[k].shard(torch.as_tensor(v))
             for k, v in _data_batch(cfg).items()}
    st = init(0)
    rows = []
    for i in range(2):
        TT.GATHERED.clear()
        TT.GATHERED_OVER.clear()
        st, m = step(st, batch)
        rows.append(_metrics(m))
        if i == 0:
            gathered = (dict(TT.GATHERED), dict(TT.GATHERED_OVER))
    leaves = [(f"{tree}/{p}", x) for tree, t in (
        ("params", st.params), ("m", st.opt.m), ("v", st.opt.v))
        for p, x in zip(TT.leaf_paths(t), _leaves(t))]
    return {"rows": rows, "gathered": gathered,
            "bits": {k: (_bits(shd.local(x)), shd.spec_axes(
                shd.dtensor_sharding(x).spec)) for k, x in leaves}}


def _one_rank(arch: str) -> list:
    cfg = TR.get_config(arch, smoke=True)
    step, init = TT.make_train_step(TZ.build(cfg), TrainConfig(**TCONF),
                                    device="cpu")
    st = init(0)
    batch = {k: torch.as_tensor(v) for k, v in _data_batch(cfg).items()}
    rows = []
    for _ in range(2):
        st, m = step(st, batch)
        rows.append(_metrics(m))
    return rows


def _world_rank() -> list:
    """Everything the cases read, on each of the four ranks; every
    rank's dict comes back (rank 0's list)."""
    import torch.distributed as dist
    meshes = {k: launch_mesh.make_local_mesh(*v, device="cpu")
              for k, v in MESHES.items()}
    out = {"bodies": {}, "coord": dict(meshes["2x2"].coordinate)}
    for key, mesh in meshes.items():
        for name in BODIES + ("fused_mlp_pallas",):
            out["bodies"][f"{name}@{key}"] = _run_body(name, mesh)
        for name, _, _, on in ATTENTION:
            if key in on:
                out["bodies"][f"{name}@{key}"] = _run_body(name, mesh)
    out["steps"] = {arch: _mesh_steps(arch, meshes["2x2"])
                    for arch in STEP_ARCHS}
    out["one_rank"] = {arch: _one_rank(arch) for arch, rank
                       in ONE_RANK.items() if rank == dist.get_rank()}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return gathered


# ------------------------------------------------------------ the reference


def _jax_body(name: str):
    """(the JAX package's function of (params, x) -> out or loss, the
    case) for ``name``."""
    import jax.numpy as jnp
    from repro.configs import registry as JR
    from repro.models import attention as JA
    from repro.models import layers as JL
    from repro.models import transformer as JT

    def jcfg(arch):
        return dataclasses.replace(JR.get_config(arch, smoke=True),
                                   compute_dtype=jnp.float32)
    case = _case(name)
    g = jcfg("gemma2-2b")
    if name == "mlp":
        return lambda p, x: JL.mlp(p, x, act="gelu"), case
    if name == "fused_mlp":
        return (lambda p, x: JL.fused_mlp({"scale": p["scale"]}, p, x,
                                          act="gelu", method="unfused_mma"),
                case)
    if name.startswith("attention/"):
        _, arch, kind, _ = next(c for c in ATTENTION if c[0] == name)
        cfg = jcfg(arch)
        return (lambda p, x: JA.attention(p, cfg, x, positions=jnp.arange(S),
                                          kind=kind)[0], case)
    if name.startswith("embed"):
        tokens = jnp.asarray(case["tokens"])
        return (lambda p, x: JL.embed_lookup(
            p, tokens, scale=True, d=g.d_model, compute_dtype=jnp.float32,
            onehot=name == "embed_onehot"), case)
    labels, mask = jnp.asarray(case["labels"]), jnp.asarray(case["mask"])
    if name == "unembed_ce":
        return (lambda p, x: JT.cross_entropy(
            JL.unembed(p, x, softcap=g.final_softcap), labels, mask), case)
    return (lambda p, x: JT.chunked_cross_entropy(
        {"embed": p}, g, x, labels, mask, chunk=CHUNK), case)


def _jax_reference() -> dict:
    """Each body's output and gradients (by every parameter and by x)
    from the JAX package on the whole weights."""
    import jax
    import jax.numpy as jnp
    out = {}
    for name in BODIES + tuple(c for c, _, _, _ in ATTENTION):
        fn, case = _jax_body(name)
        p = {k: jnp.asarray(a) for k, (a, _) in case["params"].items()}
        x = jnp.asarray(case["x"]) if "x" in case else jnp.zeros(())
        cot = None if case["cot"] is None else jnp.asarray(case["cot"])

        def loss(p, x):
            o = fn(p, x)
            return o if cot is None else jnp.sum(o * cot)
        value = fn(p, x)
        gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
        grads = {k: np.asarray(v) for k, v in gp.items()}
        if "x" in case:
            grads["x"] = np.asarray(gx)
        out[name] = {"out": np.asarray(value), "grads": grads}
    return out


@pytest.fixture(scope="module")
def run():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_reference)
        ranks = launch_mesh.run_ranks(_world_rank, WORLD, backend="gloo",
                                      timeout=240)
        return {"ranks": ranks, "ref": ref.result()}


def _close(got, want, rtol: float, what: str) -> None:
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))),
                               err_msg=what)


# ------------------------------------------------------------------ (a)


_BODY_CASES = [(n, k) for n in BODIES for k in MESHES] + \
    [(n, k) for n, _, _, on in ATTENTION for k in on]


@pytest.mark.parametrize("name,mesh", _BODY_CASES)
def test_body_matches_the_reference(run, name, mesh):
    """Every rank's output (the replicated output of the body, the same
    on every rank) within rtol 1e-5 of the reference's, its gradient of x
    and of each of its blocks within rtol 2e-4 of the reference's
    gradient (that block of it)."""
    want = run["ref"][name]
    for rank, got in enumerate(r["bodies"][f"{name}@{mesh}"]
                               for r in run["ranks"]):
        _close(got["out"], want["out"], VALUE_RTOL, f"{name} rank {rank}")
        index, count = got["coord"]
        assert set(got["grads"]) == set(want["grads"])
        for k, g in got["grads"].items():
            ref = _block(want["grads"][k], got["dims"].get(k), index, count)
            _close(g, ref, GRAD_RTOL, f"{name} rank {rank} d{k}")


@pytest.mark.parametrize("mesh", MESHES)
def test_bodies_split_where_the_rules_split(run, mesh):
    """Gemma-2 2B's widths divide both meshes' model axes: the MLP, the
    table and the heads are blocks; on (1, 4) its 2 KV heads stay whole
    while the 4 heads split."""
    got = {k: v for k, v in run["ranks"][0]["bodies"].items()
           if k.endswith(f"@{mesh}")}
    assert got[f"mlp@{mesh}"]["dims"] == {"wi_gate": 1, "wi_up": 1, "wo": 0}
    assert got[f"embed@{mesh}"]["dims"] == {"table": 0}
    m = MESHES[mesh][1]
    assert got[f"embed@{mesh}"]["grads"]["table"].shape == (512 // m, 64)
    if mesh == "1x4":
        dims = got[f"attention/gemma2@{mesh}"]["dims"]
        assert dims["wq"] == 1 and dims["wo"] == 0
        assert dims["wk"] is None and dims["wv"] is None


@pytest.mark.parametrize("mesh", MESHES)
def test_fused_mlp_through_b10s_plain_version(run, mesh):
    """``fused_mlp`` under ``fused_pallas`` (B10's plain version on the
    CPU, no gradient: B10 has no backward) on each rank's blocks: the
    reference's output within rtol 1e-5."""
    want = run["ref"]["fused_mlp"]["out"]
    for r in run["ranks"]:
        _close(r["bodies"][f"fused_mlp_pallas@{mesh}"]["out"], want,
               VALUE_RTOL, "fused_pallas")


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_mesh_step_matches_one_rank(run, arch):
    """Two steps on (2, 2): loss and param_norm within rtol 1e-5 of the
    port's one-rank step, grad_norm within 2e-4, the same on every
    rank."""
    want = next(r["one_rank"][arch] for r in run["ranks"]
                if arch in r["one_rank"])
    rows = [r["steps"][arch]["rows"] for r in run["ranks"]]
    assert all(row == rows[0] for row in rows)
    got = np.array(rows[0])
    want = np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=2e-4)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_replicated_leaves_keep_the_same_bits_on_the_model_ranks(run, arch):
    """After two steps, each leaf (parameter, first and second moment)
    that the rules do not split over ``model`` has the same bits on the
    two ``model`` ranks of each data row; a block over ``model`` differs
    between them."""
    by_row: dict = {}
    for r in run["ranks"]:
        by_row.setdefault(r["coord"]["data"], []).append(
            r["steps"][arch]["bits"])
    replicated = split = 0
    for pair in by_row.values():
        assert len(pair) == 2
        for key, (bits, axes) in pair[0].items():
            if "model" in axes:
                split += 1
                assert bits != pair[1][key][0], key
            else:
                replicated += 1
                assert bits == pair[1][key][0], key
    assert replicated > 0 and split > 0


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_no_block_of_a_body_is_gathered_whole(run, arch):
    """The first step gathers every leaf once; a leaf of a
    tensor-parallel body that the rules split over ``model`` only over
    its other axes, every other leaf over all of its axes; the bytes a
    rank gathers are the sum of the leaves at the size the model reads
    them (a body's block over ``model`` at 1 / 2)."""
    model = TZ.build(TR.get_config(arch, smoke=True))
    paths = TT.leaf_paths(model.specs)
    tp = dict(zip(paths, TT.model_blocks(model)))
    shapes = dict(zip(paths, _leaves(model.param_shapes())))

    class _Mesh:
        shape = {"data": 2, "model": 2}
    specs = dict(zip(paths, (shd.spec_axes(s.spec) for s in _leaves(
        TT.state_shardings(model, _Mesh(), TT._state_shapes(
            model, TrainConfig())).params))))
    for r in run["ranks"]:
        counts, over = r["steps"][arch]["gathered"]
        assert counts == {p: 1 for p in paths}
        want_bytes = 0
        for p in paths:
            axes, nbytes = over[p]
            split = tp[p] and "model" in specs[p]
            assert ("model" in axes) == ("model" in specs[p] and not split)
            assert set(axes) == set(specs[p]) - ({"model"} if split else set())
            size = int(np.prod(shapes[p].shape)) * 4 // (2 if split else 1)
            assert nbytes == size, p
            want_bytes += size
        assert sum(n for _, n in over.values()) == want_bytes
    assert any(tp[p] and "model" in specs[p] for p in paths)


# ------------------------------------------------------------ no ranks


class _FakeMesh:
    shape = {"data": 2, "model": 4}
    coordinate = {"data": 1, "model": 3}


def test_model_share_follows_the_local_size():
    """Outside a train step a body runs whole; inside one a dimension is
    this rank's block where it is whole / count, whole where it is whole,
    and any other size (or a body that does not say the whole size)
    raises."""
    assert shd.model_share(8, 32) is None
    assert shd.model_axis() is None
    with shd.local_step(_FakeMesh(), ("data",), "model"):
        assert shd.model_axis() == "model"
        share = shd.model_share(8, 32)
        assert (share.axis, share.index, share.count) == ("model", 3, 4)
        assert share.start(8) == 24
        assert shd.model_share(32, 32) is None
        with pytest.raises(ValueError, match="neither whole nor a block"):
            shd.model_share(16, 32)
        with pytest.raises(ValueError, match="whole size"):
            shd.model_share(8, None)
    with shd.local_step(_FakeMesh(), ("data",)):
        assert shd.model_share(8, 32) is None
    assert shd.model_axis() is None


def test_the_context_carries_the_model_axis_to_another_thread():
    """``current_context`` / ``installed`` carry the model axis, as a
    remat's recompute on the autograd engine's thread needs it."""
    import threading
    with shd.local_step(_FakeMesh(), ("data",), "model"):
        context = shd.current_context()
    seen = []

    def other():
        seen.append(shd.model_axis())
        with shd.installed(context):
            seen.append(shd.model_axis())
        seen.append(shd.model_axis())
    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == [None, "model", None]


@pytest.mark.parametrize("arch,kept", [
    ("deepseek-v3-671b", "stacks/S0/L0/attn/wq_b"),
    ("rwkv6-7b", "stacks/S0/L0/mlp/wk"),
    ("recurrentgemma-2b", "stacks/S0/L0/attn/wx")])
def test_leaves_without_a_body_stay_whole(arch, kept):
    """MLA's, RWKV-6's and RG-LRU's leaves have no tensor-parallel body
    in this slice (ROADMAP 14c(iii)): ``model_blocks`` leaves them to the
    whole gather, and an expert leaf to the MoE body; the embedding table
    is a body's block in every arch."""
    model = TZ.build(TR.get_config(arch, smoke=True))
    blocks = dict(zip(TT.leaf_paths(model.specs), TT.model_blocks(model)))
    assert blocks[kept] is False
    assert blocks["embed/table"] is True
    for path, kind in zip(TT.leaf_paths(model.specs),
                          TT.expert_leaves(model)):
        if kind:
            assert blocks[path] is False


def test_heads_that_straddle_a_kv_group_are_refused():
    """6 heads in groups of 3 over 3 ranks, the 2 KV heads whole: rank
    1's heads 2 and 3 read two groups, which the body refuses to run
    (before any collective) instead of reading the wrong KV head."""
    from repro_torch.models import attention as TA

    class _Three:
        shape = {"data": 1, "model": 3}
        coordinate = {"data": 0, "model": 1}
    cfg = dataclasses.replace(_cfg("gemma2-2b"), num_heads=6,
                              num_kv_heads=2)
    specs = TA.attn_specs(cfg)
    p = {k: torch.zeros(v.shape) for k, v in specs.items()}
    p["wq"], p["wo"] = p["wq"][:, 2:4], p["wo"][2:4]
    with shd.local_step(_Three(), (), "model"):
        with pytest.raises(ValueError, match="straddle a group of 3"):
            TA.attention(p, cfg, torch.zeros(1, 4, cfg.d_model),
                         positions=torch.arange(4))
