"""The port's servers over a mesh of ranks (``launch.serve``'s ``Server``
and ``ContinuousServer`` with ``mesh=``), and the repair of
``sharding.constrain`` on whole tensors (ROADMAP queue C, C2).

One world of four gloo ranks on the CPU (``launch.mesh.run_ranks``), a
(data 2, model 2) mesh, started once by a module-scoped fixture,
computes what the cases read, and the port's one-card runs they are held
to, side by side on its ranks.  The reference runs beside it in one
subprocess over four host devices as a (2, 2) mesh, as
``tests/test_sharding_multidevice.py`` runs its programs.  The ranks
import no JAX, and this module imports it only in that subprocess and in
the test of C2.  Every run takes its parameters from one numpy draw:
the port's ``init`` from seed 0, bridged to the ranks and to the
reference through ``models.param.from_numpy`` and ``jnp.asarray``.

Held to, at Gemma-2 2B's SMOKE size (bf16 activations):

  * the port's one-card servers, bit for bit on every rank: the tokens
    and every sampled logits row of ``Server.generate`` (greedy, at
    temperature 0.8 with seed 3, and a batch of 3 rows that splits over
    no axis), ``Server.score``'s sums under a mask, and
    ``ContinuousServer``'s event streams (logprobs included) and logits
    rows over the ``none`` and ``int8`` stores;
  * the reference's ``Server`` over its (2, 2) mesh: the greedy tokens;
  * a SPMD train state's ``DTensor`` tree, served before and after a
    train step: the tokens of the whole tree on one card, each
    non-expert leaf gathered once while it is unchanged.

At DeepSeek-V3's SMOKE size with f32 activations: the meshed prefill
logits within ``tests/test_torch_moe.py``'s mesh tolerance, 1e-5 of
max|ref|, of the reference's meshed ``Server``, both sides' capacity
taken from each data shard's tokens; the same bits from the train
state's ``DTensor`` tree as from the whole tree, no expert leaf
gathered; ``ContinuousServer`` refused on every rank, as the reference
refuses it.  C2's input under ``axis_rules``: ``layers.mlp`` gives the
single-device values (bits of the port, f32 rtol 1e-5 of the
reference's).
"""

import collections
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.integration import _leaves, _tree_like
from repro_torch.core.reduction import _ROW_TILE
from repro_torch.data.pipeline import synthetic_requests
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import serve as TS
from repro_torch.models import model_zoo as TZ
from repro_torch.models import param as TP

WORLD = 4
MESH = (2, 2)
GEMMA = "gemma2-2b"
DEEPSEEK = "deepseek-v3-671b"
PROMPTS = (8, 12)
MOE_PROMPTS = (4, 12)
MAX_NEW = 6
TEMPERATURE = 0.8
TEMP_SEED = 3
ODD_ROWS = 3
SLOTS, CAP, PAGE = 4, 40, 8
QUANTS = ("none", "int8")
MESH_ATOL = 1e-5        # of max|ref|: tests/test_torch_moe.py's mesh bound
SHAPE = ShapeConfig("t", 16, 8, "train")
C2_X = (4, 16, 64)
TIMEOUT = 240
# which rank of the world computes each one-card run
ONE_CARD = {"server": 0, "none": 1, "int8": 2, "c2": 3}

_REF_PROG = textwrap.dedent("""
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.launch import serve
    from repro.models import model_zoo

    draws = np.load(sys.argv[1])
    max_new = int(sys.argv[3])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))

    def built(arch, f32):
        cfg = registry.get_config(arch, smoke=True)
        if f32:
            cfg = dataclasses.replace(cfg, compute_dtype=jnp.float32)
        model = model_zoo.build(cfg)
        treedef = jax.tree_util.tree_structure(
            jax.eval_shape(model.init, jax.random.PRNGKey(0)))
        leaves = [jnp.asarray(draws[f"{arch}/{i}"])
                  for i in range(treedef.num_leaves)]
        return model, jax.tree_util.tree_unflatten(treedef, leaves)

    out = {}
    model, params = built("gemma2-2b", False)
    out["gemma"] = np.asarray(serve.Server(model, mesh=mesh).generate(
        params, draws["prompts"], max_new=max_new))
    model, params = built("deepseek-v3-671b", True)
    logits, _ = serve.Server(model, mesh=mesh)._prefill(
        params, {"tokens": jnp.asarray(draws["moe_prompts"])})
    out["deepseek"] = np.asarray(logits)
    np.savez(sys.argv[2], **out)
""")


def _cfg(arch: str):
    """Gemma-2 2B at its SMOKE config; DeepSeek-V3 with f32 activations,
    where the mesh tolerance is stated."""
    cfg = TR.get_config(arch, smoke=True)
    if arch == DEEPSEEK:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    return cfg


def _draws() -> dict:
    """The numpy draw every run takes: each arch's ``init`` from seed 0
    leaf by leaf, the prompts from ``default_rng(0)``."""
    out = {}
    for arch in (GEMMA, DEEPSEEK):
        tree = TZ.build(_cfg(arch)).init(torch.Generator().manual_seed(0),
                                         device="cpu")
        out.update({f"{arch}/{i}": leaf.numpy()
                    for i, leaf in enumerate(_leaves(tree))})
    rng = np.random.default_rng(0)
    vocab = _cfg(GEMMA).vocab_size
    out["prompts"] = rng.integers(0, vocab, PROMPTS).astype(np.int32)
    out["moe_prompts"] = rng.integers(0, _cfg(DEEPSEEK).vocab_size,
                                      MOE_PROMPTS).astype(np.int32)
    out["mask"] = (np.arange(PROMPTS[1])[None, :] < rng.integers(
        2, PROMPTS[1] + 1, (PROMPTS[0], 1))).astype(np.float32)
    return out


def _built(arch: str, draws) -> tuple:
    model = TZ.build(_cfg(arch))
    n = len(_leaves(model.param_shapes()))
    leaves = TP.from_numpy([draws[f"{arch}/{i}"] for i in range(n)],
                           device="cpu")
    return model, _tree_like(model.param_shapes(), leaves)


def _requests(vocab: int) -> list:
    """``tests/test_serving.py``'s four staggered requests."""
    return [TS.Request(**d) for d in synthetic_requests(
        vocab, n=4, seed=0, min_len=3, max_len=12, min_new=2, max_new=10,
        stagger=1)]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().contiguous().view(torch.int32).numpy().copy()


def _generate(model, params, prompts, mesh=None, **kw) -> tuple:
    """(tokens, the bits of every (B, V) row set ``_sample`` drew from)."""
    gen_kw = {"seed": kw.pop("seed")} if "seed" in kw else {}
    srv = TS.Server(model, mesh=mesh, **kw)
    sample, seen = srv._sample, []

    def spy(logits, seed, step):
        seen.append(_bits(logits[:, -1]))
        return sample(logits, seed, step)
    srv._sample = spy
    return srv.generate(params, prompts, max_new=MAX_NEW, **gen_kw), seen


def _server_runs(model, params, draws, mesh=None) -> dict:
    prompts = draws["prompts"]
    srv = TS.Server(model, mesh=mesh)
    return {
        "greedy": _generate(model, params, prompts, mesh),
        "temperature": _generate(model, params, prompts, mesh,
                                 temperature=TEMPERATURE, seed=TEMP_SEED),
        "odd": _generate(model, params, prompts[:ODD_ROWS], mesh),
        "score": _bits(srv.score(params, prompts, mask=draws["mask"]))}


def _continuous(model, params, quant: str, mesh=None) -> dict:
    """A stream of the four requests over SLOTS slots of CAP: its events
    (logprobs too), each sampled logits row's bits by (uid, index), and
    the bytes of the store's page pools on this rank."""
    eng = TS.ContinuousServer(model, num_slots=SLOTS, capacity=CAP,
                              page_size=PAGE, quant=quant, logprobs=True,
                              device="cpu", mesh=mesh)
    rows = {}
    pick, picks = eng._pick, eng._picks

    def one(row, uid, index):
        rows[(uid, index)] = _bits(row)
        return pick(row, uid, index)

    def many(last, slots):
        for s, st in slots.items():
            rows[(st.uid, st.n_out)] = _bits(last[s])
        return picks(last, slots)
    eng._pick, eng._picks = one, many
    stores = []
    new_store = eng._new_store

    def spy_store():
        stores.append(new_store())
        return stores[-1]
    eng._new_store = spy_store
    events = list(eng.serve(params, _requests(model.cfg.vocab_size)))
    pages = sum(t.numel() * t.element_size()
                for pl in stores[0]._paged.values()
                for t in (pl.codes, pl.scale, pl.resid) if t is not None)
    return {"events": events, "rows": rows, "page_bytes": pages}


def _c2_input() -> tuple:
    """C2's input: DeepSeek-V3 SMOKE's shared-expert params and an f32 x
    of C2_X."""
    from repro_torch.models import moe
    cfg = _cfg(DEEPSEEK)
    params = TP.init_tree(torch.Generator().manual_seed(5),
                          moe.moe_specs(cfg)["shared"], device="cpu")
    x = np.random.default_rng(5).normal(size=C2_X).astype(np.float32)
    return cfg, params, x


def _c2(mesh=None) -> np.ndarray:
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers
    cfg, params, x = _c2_input()
    with torch.no_grad(), shd.axis_rules(mesh):
        return layers.mlp(params, torch.from_numpy(x), act=cfg.act).numpy()


def _gather(value) -> list:
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _trained_state(model, mesh, draws) -> dict:
    """A SPMD train state's DTensor tree served before and after a train
    step: the tokens, the whole tree's tokens on one card and the
    gathers by leaf."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as TT
    step, init, _, b_shard = TT.jit_train_step(
        model, TrainConfig(total_steps=10, warmup_steps=2), mesh,
        model.input_specs(SHAPE), device="cpu")
    st = init(0)
    srv = TS.Server(model, mesh=mesh)
    prompts = draws["prompts"]
    TS.GATHERED.clear()
    out = {"before": [srv.generate(st.params, prompts, max_new=MAX_NEW)
                      for _ in range(2)]}
    out["gathered_before"] = dict(TS.GATHERED)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, model.cfg.vocab_size, (8, 16))
             .astype(np.int32),
             "labels": rng.integers(0, model.cfg.vocab_size, (8, 16))
             .astype(np.int32),
             "mask": np.ones((8, 16), np.float32)}
    st, _ = step(st, {k: b_shard[k].shard(torch.as_tensor(v))
                      for k, v in batch.items()})
    out["after"] = srv.generate(st.params, prompts, max_new=MAX_NEW)
    out["gathered_after"] = dict(TS.GATHERED)
    whole = _tree_like(st.params, [shd.whole(p) for p in _leaves(st.params)])
    out["whole_after"] = TS.Server(model).generate(whole, prompts,
                                                   max_new=MAX_NEW)
    out["paths"] = TT.leaf_paths(model.specs)
    return out


def _moe_runs(mesh, draws) -> dict:
    """DeepSeek-V3 over the mesh: the prefill logits from the whole tree
    and from the train state's DTensor tree, the gathers, and
    ContinuousServer's refusal."""
    from repro_torch.launch import train as TT
    model, params = _built(DEEPSEEK, draws)
    prompts = draws["moe_prompts"]
    out = {"prefill": _generate(model, params, prompts, mesh)[1][0]}
    _, init, _, _ = TT.jit_train_step(
        model, TrainConfig(total_steps=10, warmup_steps=2), mesh,
        model.input_specs(SHAPE), device="cpu")
    TS.GATHERED.clear()
    out["prefill_dtensor"] = _generate(model, init(0).params, prompts,
                                       mesh)[1][0]
    out["gathered"] = dict(TS.GATHERED)
    out["paths"] = TT.leaf_paths(model.specs)
    out["experts"] = TT.expert_leaves(model)
    try:
        list(TS.ContinuousServer(model, num_slots=SLOTS, capacity=CAP,
                                 device="cpu", mesh=mesh).serve(
            params, _requests(model.cfg.vocab_size)))
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def _world_rank(path: str) -> dict:
    """Everything the cases read, on each of the four ranks; the one-card
    runs one a rank (ONE_CARD).  Rank 0's dict comes back."""
    import torch.distributed as dist
    mesh = launch_mesh.make_local_mesh(*MESH, device="cpu")
    draws = dict(np.load(path))
    model, params = _built(GEMMA, draws)
    mine = {"coord": mesh.coordinate,
            "server": _server_runs(model, params, draws, mesh),
            "continuous": {q: _continuous(model, params, q, mesh)
                           for q in QUANTS},
            "trained": _trained_state(model, mesh, draws),
            "moe": _moe_runs(mesh, draws),
            "c2": _c2(mesh)}
    # a rank's own rows bound num_slots: 2 _ROW_TILE slots over data 2
    TS.ContinuousServer(model, num_slots=MESH[0] * _ROW_TILE, device="cpu",
                        mesh=mesh)
    one = {}
    for job, rank in ONE_CARD.items():
        if rank != dist.get_rank():
            continue
        if job == "server":
            one[job] = _server_runs(model, params, draws)
        elif job == "c2":
            one[job] = _c2()
        else:
            one[job] = _continuous(model, params, job)
    return {"ranks": _gather(mine),
            "one": {k: v for got in _gather(one) for k, v in got.items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    draws = os.path.join(tmp, "draws.npz")
    got = os.path.join(tmp, "reference.npz")
    np.savez(draws, **_draws())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_PROG, draws, got, str(MAX_NEW)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = launch_mesh.run_ranks(_world_rank, WORLD, backend="gloo",
                                    args=(draws,), timeout=TIMEOUT)
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    out["reference"] = dict(np.load(got))
    return out


def test_every_rank_holds_its_place(run):
    assert sorted(tuple(r["coord"].values()) for r in run["ranks"]) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("kind", ["greedy", "temperature", "odd"])
def test_generate_over_a_mesh_is_one_card_bit_for_bit(run, kind):
    """``Server.generate`` over the mesh: the one card's tokens and, on
    every rank, the bits of every logits row it sampled from (gathered
    over data; the odd batch is replicated on every rank)."""
    want_toks, want_rows = run["one"]["server"][kind]
    for got in run["ranks"]:
        toks, rows = got["server"][kind]
        np.testing.assert_array_equal(toks, want_toks)
        assert len(rows) == len(want_rows)
        for a, b in zip(rows, want_rows):
            np.testing.assert_array_equal(a, b)


def test_score_over_a_mesh_is_one_card_bit_for_bit(run):
    want = run["one"]["server"]["score"]
    assert want.shape == (PROMPTS[0],)
    for got in run["ranks"]:
        np.testing.assert_array_equal(got["server"]["score"], want)


@pytest.mark.parametrize("quant", QUANTS)
def test_continuous_over_a_mesh_is_one_card_bit_for_bit(run, quant):
    """``ContinuousServer`` over the mesh: every rank yields the one
    card's events (tokens, done flags, logprobs) and the bits of the
    logits rows it sampled from; each rank's store holds the pages of
    its two slots of four, half the one card's bytes."""
    want = run["one"][quant]
    assert len(want["events"]) > 4
    for got in run["ranks"]:
        c = got["continuous"][quant]
        assert c["events"] == want["events"]
        assert sorted(c["rows"]) == sorted(want["rows"])
        for key, row in want["rows"].items():
            np.testing.assert_array_equal(c["rows"][key], row, err_msg=key)
        assert c["page_bytes"] * MESH[0] == want["page_bytes"]


def test_gemma_tokens_over_a_mesh_equal_the_reference_mesh(run):
    """The reference's ``Server`` over its (2, 2) host mesh, greedy, on the
    same numpy parameters and prompts."""
    want = run["reference"]["gemma"]
    for got in run["ranks"]:
        np.testing.assert_array_equal(got["server"]["greedy"][0], want)


def test_a_train_state_served_over_a_mesh(run):
    """The SPMD train state's DTensor tree: the one card's tokens on the
    whole draw; each non-expert leaf gathered once over two calls; after
    a train step (in place), once more, and the tokens of the stepped
    tree gathered whole on one card."""
    want = run["one"]["server"]["greedy"][0]
    for got in run["ranks"]:
        t = got["trained"]
        for toks in t["before"]:
            np.testing.assert_array_equal(toks, want)
        assert t["gathered_before"] == {p: 1 for p in t["paths"]}
        assert t["gathered_after"] == {p: 2 for p in t["paths"]}
        np.testing.assert_array_equal(t["after"], t["whole_after"])


def test_deepseek_prefill_over_a_mesh_matches_the_reference_mesh(run):
    """DeepSeek-V3's meshed prefill logits (etp: experts over data, their
    ffn over model) within 1e-5 of max|ref| of the reference's meshed
    ``Server``: both sides take the capacity from each data shard's 24
    tokens."""
    want = run["reference"]["deepseek"][:, -1]
    for got in run["ranks"]:
        rows = got["moe"]["prefill"].view(np.float32)
        assert rows.shape == want.shape
        np.testing.assert_allclose(rows, want, rtol=0,
                                   atol=MESH_ATOL * float(np.abs(want).max()))


def test_deepseek_served_from_a_train_state_gathers_no_expert_leaf(run):
    for got in run["ranks"]:
        m = got["moe"]
        np.testing.assert_array_equal(m["prefill_dtensor"], m["prefill"])
        counts = collections.Counter(m["gathered"])
        for path, kind in zip(m["paths"], m["experts"]):
            assert counts[path] == (0 if kind else 1), path
        assert sum(1 for k in m["experts"] if k) > 0


def test_continuous_over_a_mesh_refuses_moe_on_every_rank(run):
    """A batch-1 admission splits over no axis, and the expert-parallel
    body takes each rank's own rows: every rank raises, before any
    collective (a hang would outlive the world's timeout)."""
    for got in run["ranks"]:
        msg = got["moe"]["refusal"]
        assert msg is not None and "do not divide over the batch axes" in msg


def test_c2_mlp_under_a_mesh_gives_the_single_device_values(run):
    """C2's input under ``axis_rules`` of the (2, 2) mesh: ``layers.mlp``
    gives the one-device bits, and the reference's values within f32
    rtol 1e-5 of max|ref|."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    cfg, params, x = _c2_input()
    jy = np.asarray(JL.mlp({k: jnp.asarray(v.numpy())
                            for k, v in params.items()},
                           jnp.asarray(x), act=cfg.act))
    want = run["one"]["c2"]
    for got in run["ranks"]:
        np.testing.assert_array_equal(got["c2"], want)
    np.testing.assert_allclose(want, jy, rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
