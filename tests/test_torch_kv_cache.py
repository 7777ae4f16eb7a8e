"""The port's paged KV cache (``repro_torch.models.kv_cache``) against
the JAX package's (``repro.models.kv_cache``), on the CPU.

Both stores get the same template (the nested-dict geometry
``init_decoder_cache`` makes: a stacked GQA block, an MLA block, an
enc-dec block whose cross-attention memory stays dense, a recurrent
state) and the same numpy contents.  Checked:

  * which leaves page, and the dense leaves' batch axes;
  * ``quant='none'``: a slot round-trips exactly, free slots read 0;
  * ``quant='int8'``: codes, scales and bf16 residuals equal the
    reference's bit for bit (f32 and bf16 caches, with and without the
    residual word), and so does ``as_dense``, also after
    ``write_token``;
  * the int8 error budget of ``tests/test_kv_cache.py`` (f32 caches),
    and int8 codes plus the residual rebuild a bf16 cache exactly;
  * the allocator: slot lifecycle errors, disjoint tables, page
    recycling, an exhausted pool, and the same page ids as the
    reference's through a sequence of admissions and evictions;
  * the port's own contracts: ``as_dense`` never aliases a pool (the
    decode step writes in place), a ``"meta"`` template (the real
    decoder cache of Gemma-2 2B at SMOKE size, its ``idx`` counters
    with a repeats axis) makes pools on the device asked for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import MmaPolicy as JPolicy
from repro.models import kv_cache as jkv
from repro_torch.configs import registry as TR
from repro_torch.core.precision import MmaPolicy as TPolicy
from repro_torch.models import kv_cache as tkv
from repro_torch.models import transformer as TT

NUM_SLOTS = 3
CAP = 24
PAGE = 8
R = 2

# (path, shape without the batch dim at index `batch_at`, batch axis)
_LEAVES = (
    (("S0", "L0", "k"), (R, None, CAP, 2, 4)),
    (("S0", "L0", "v"), (R, None, CAP, 2, 4)),
    (("S0", "L0", "idx"), (R,)),
    (("S1", "L0", "ckv"), (1, None, CAP, 6)),
    (("S1", "L0", "krope"), (1, None, CAP, 3)),
    (("S1", "L0", "idx"), (1,)),
    (("S2", "L0", "cross", "k"), (1, None, 5, 2, 4)),
    (("S2", "L0", "cross", "v"), (1, None, 5, 2, 4)),
    (("S2", "L0", "self", "k"), (1, None, CAP, 2, 4)),
    (("S2", "L0", "self", "v"), (1, None, CAP, 2, 4)),
    (("S2", "L0", "self", "idx"), (1,)),
    (("S3", "L0", "wkv"), (1, None, 2, 4, 4)),
    (("S3", "L0", "x_tm"), (1, None, 8)),
)

J_DTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
T_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _numpy_tree(dtype: str, batch: int, seed=None) -> dict:
    """{path: (numpy f32 or int32 values, is_float)}: zeros, or random
    floats and idx = 7 with a seed."""
    rng = None if seed is None else np.random.default_rng(seed)
    out = {}
    for path, shape in _LEAVES:
        shape = tuple(batch if d is None else d for d in shape)
        if path[-1] == "idx":
            out[path] = (np.full(shape, 0 if rng is None else 7, np.int32),
                         False)
        elif rng is None:
            out[path] = (np.zeros(shape, np.float32), True)
        else:
            out[path] = (rng.standard_normal(shape).astype(np.float32),
                         True)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _trees(dtype="bfloat16", batch=NUM_SLOTS, seed=None):
    """The same tree for both packages: (jax tree, torch tree)."""
    flat = _numpy_tree(dtype, batch, seed)
    jt = _nest({p: jnp.asarray(a, J_DTYPES[dtype] if f else jnp.int32)
                for p, (a, f) in flat.items()})
    tt = _nest({p: torch.from_numpy(a).to(T_DTYPES[dtype] if f
                                          else torch.int32)
                for p, (a, f) in flat.items()})
    return jt, tt


def _stores(quant="none", dtype="bfloat16", words=None):
    jt, tt = _trees(dtype)
    jpol = None if words is None else JPolicy(split_words=words)
    tpol = None if words is None else TPolicy(split_words=words)
    return (jkv.PagedKVCache(jt, num_slots=NUM_SLOTS, page_size=PAGE,
                             quant=quant, precision=jpol),
            tkv.PagedKVCache(tt, num_slots=NUM_SLOTS, page_size=PAGE,
                             quant=quant, precision=tpol))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _assert_trees_equal(got, want):
    gl, _ = tkv._leaf_paths(got)
    wl, _ = jkv._leaf_paths(want)
    assert sorted(gl) == sorted(wl)
    for path in wl:
        g, w = _np(gl[path]), _np(wl[path])
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg="/".join(path))


def _assert_pools_equal(tstore, jstore):
    for path, jpl in jstore._paged.items():
        tpl = tstore._paged[path]
        for name in ("codes", "scale", "resid"):
            j, t = getattr(jpl, name), getattr(tpl, name)
            assert (j is None) == (t is None), (path, name)
            if j is not None:
                np.testing.assert_array_equal(_np(t), _np(j),
                                              err_msg=f"{path} {name}")
        np.testing.assert_array_equal(tpl.table, np.asarray(jpl.table))


def test_paged_leaf_selection_matches_the_reference():
    jstore, tstore = _stores()
    assert set(tstore._paged) == set(jstore._paged) == {
        ("S0", "L0", "k"), ("S0", "L0", "v"), ("S1", "L0", "ckv"),
        ("S1", "L0", "krope"), ("S2", "L0", "self", "k"),
        ("S2", "L0", "self", "v")}
    assert tstore._dense_batch_axis == jstore._dense_batch_axis
    for path, jpl in jstore._paged.items():
        tpl = tstore._paged[path]
        assert (tpl.batch_axis, tpl.token_axis, tpl.capacity,
                tpl.pages_per_slot, tpl.feat_shape) == \
            (jpl.batch_axis, jpl.token_axis, jpl.capacity,
             jpl.pages_per_slot, jpl.feat_shape)


def test_round_trip_bit_exact_quant_none():
    jstore, tstore = _stores()
    _, src = _trees(batch=1, seed=1)
    tstore.alloc_slot(2)
    tstore.write_slot(2, src)
    dense = tstore.as_dense()
    leaves, paged = tkv._leaf_paths(src)
    for path in paged:
        pl = tstore._paged[path]
        got = tkv._tree_get(dense, path)
        assert torch.equal(got.select(pl.batch_axis, 2),
                           leaves[path].select(pl.batch_axis, 0)), path
        assert not torch.any(got.select(pl.batch_axis, 0))


@pytest.mark.parametrize("dtype,words", [
    ("bfloat16", None), ("float32", 2), ("float32", 1), ("float32", 3),
    ("bfloat16", 1)])
@pytest.mark.parametrize("quant", ["int8", "none"])
def test_writes_and_dense_view_match_the_reference_bitwise(quant, dtype,
                                                           words):
    jstore, tstore = _stores(quant, dtype, words)
    assert tstore.residual == jstore.residual
    for slot, seed in ((1, 3), (0, 4)):
        jsrc, tsrc = _trees(dtype, batch=1, seed=seed)
        jstore.alloc_slot(slot)
        tstore.alloc_slot(slot)
        jstore.write_slot(slot, jsrc)
        tstore.write_slot(slot, tsrc)
    _assert_pools_equal(tstore, jstore)
    _assert_trees_equal(tstore.as_dense(), jstore.as_dense())
    # one decode step's tree, then single-token writes (one inside the
    # ring, one wrapping past the capacity)
    jstep, tstep = _trees(dtype, batch=NUM_SLOTS, seed=5)
    for slot, pos in ((0, 10), (1, CAP + 3)):
        jstore.write_token(jstep, slot, pos)
        tstore.write_token(tstep, slot, pos)
    _assert_pools_equal(tstore, jstore)
    _assert_trees_equal(tstore.as_dense(), jstore.as_dense())
    for slot in (0, 1):
        jr, tr = jstore.read_slot(slot), tstore.read_slot(slot)
        for path in jr:
            np.testing.assert_array_equal(_np(tr[path]), _np(jr[path]))


def test_write_token_updates_single_position():
    _, tstore = _stores()
    tstore.alloc_slot(0)
    _, first = _trees(batch=1, seed=4)
    tstore.write_slot(0, first)
    before = tstore.as_dense()
    _, step = _trees(batch=NUM_SLOTS, seed=5)
    POS = 10
    tstore.write_token(step, 0, POS)
    after = tstore.as_dense()
    leaves, paged = tkv._leaf_paths(step)
    for path in paged:
        pl = tstore._paged[path]
        got = tkv._tree_get(after, path).select(pl.batch_axis, 0)
        old = tkv._tree_get(before, path).select(pl.batch_axis, 0)
        new = leaves[path].select(pl.batch_axis, 0)
        tok_ax = pl.token_axis - 1
        for t in range(pl.capacity):
            want = (new if t == POS else old).select(tok_ax, t)
            assert torch.equal(got.select(tok_ax, t), want), (path, t)


def test_int8_split_words_within_error_budget():
    policy = TPolicy(split_words=2, error_budget_pct=1e-2)
    _, tt = _trees("float32")
    store = tkv.PagedKVCache(tt, num_slots=NUM_SLOTS, page_size=PAGE,
                             quant="int8", precision=policy)
    _, src = _trees("float32", batch=1, seed=2)
    store.alloc_slot(0)
    store.write_slot(0, src)
    dense = store.as_dense()
    leaves, paged = tkv._leaf_paths(src)
    for path in paged:
        pl = store._paged[path]
        got = tkv._tree_get(dense, path).select(pl.batch_axis, 0)
        ref = leaves[path].select(pl.batch_axis, 0)
        rel = 100.0 * float(torch.max(torch.abs(got - ref))
                            / torch.max(torch.abs(ref)))
        assert rel <= policy.error_budget_pct, (path, rel)
    bare = tkv.PagedKVCache(tt, num_slots=NUM_SLOTS, page_size=PAGE,
                            quant="int8",
                            precision=TPolicy(split_words=1))
    assert bare.residual is False and store.residual is True


def test_int8_residual_exactly_recovers_bf16():
    _, tstore = _stores("int8")
    _, src = _trees(batch=1, seed=3)
    tstore.alloc_slot(1)
    tstore.write_slot(1, src)
    dense = tstore.as_dense()
    leaves, paged = tkv._leaf_paths(src)
    for path in paged:
        pl = tstore._paged[path]
        got = tkv._tree_get(dense, path).select(pl.batch_axis, 1)
        assert torch.equal(got, leaves[path].select(pl.batch_axis, 0)), \
            path


def test_dense_view_never_aliases_a_pool():
    """The decode step writes caches in place: writing into a view
    ``as_dense`` returned must leave the store as it was."""
    for quant in ("none", "int8"):
        _, tstore = _stores(quant)
        _, src = _trees(batch=1, seed=6)
        tstore.alloc_slot(0)
        tstore.write_slot(0, src)
        first = tstore.as_dense()
        keep = tkv._leaf_paths(tstore.as_dense())[0]
        for leaf in tkv._leaf_paths(first)[0].values():
            leaf.fill_(3)
        for path, leaf in tkv._leaf_paths(tstore.as_dense())[0].items():
            assert torch.equal(leaf, keep[path]), (quant, path)


def test_allocator_slot_lifecycle_invariants():
    _, store = _stores()
    store.alloc_slot(0)
    with pytest.raises(RuntimeError, match="live"):
        store.alloc_slot(0)
    with pytest.raises(RuntimeError, match="not live"):
        store.free_slot(1)
    with pytest.raises(RuntimeError, match="not allocated"):
        store.write_slot(1, _trees(batch=1)[1])
    with pytest.raises(RuntimeError, match="not allocated"):
        store.write_token(_trees(batch=NUM_SLOTS)[1], 1, 0)
    with pytest.raises(RuntimeError, match="not allocated"):
        store.read_slot(1)
    with pytest.raises(IndexError):
        store.alloc_slot(NUM_SLOTS)
    store.alloc_slot(1)
    pages0, pages1 = store.slot_pages(0), store.slot_pages(1)
    for path in pages0:
        assert not (set(pages0[path]) & set(pages1[path]))
        assert -1 not in pages0[path]
    assert all(p == -1 for p in store.slot_pages(2)[next(iter(pages0))])
    assert store.live_slots == frozenset({0, 1})


def test_pages_recycle_exactly():
    _, store = _stores()
    baseline = store.free_pages()
    store.alloc_slot(0)
    for path, n in store.free_pages().items():
        assert n == baseline[path] - store._paged[path].pages_per_slot
    store.free_slot(0)
    assert store.free_pages() == baseline
    for s in range(NUM_SLOTS):
        store.alloc_slot(s)
    _, small = _stores()
    small._paged[next(iter(small._paged))].free = []
    with pytest.raises(RuntimeError, match="exhausted"):
        small.alloc_slot(0)


def test_page_ids_follow_the_reference():
    """The free lists pop from the end of a descending list, so a run of
    admissions and evictions maps the reference's page ids."""
    jstore, tstore = _stores()
    for op, slot in (("alloc", 1), ("alloc", 0), ("free", 1),
                     ("alloc", 2), ("alloc", 1), ("free", 0),
                     ("free", 2), ("alloc", 0)):
        getattr(jstore, f"{op}_slot")(slot)
        getattr(tstore, f"{op}_slot")(slot)
        for s in range(NUM_SLOTS):
            assert tstore.slot_pages(s) == jstore.slot_pages(s), (op, slot)
        assert tstore.free_pages() == jstore.free_pages()


def test_meta_template_of_a_real_decoder_cache():
    """The engine's template: ``init_decoder_cache`` on ``"meta"``
    (Gemma-2 2B at SMOKE size: a local ring of ``window`` slots beside
    the global cache, ``idx`` counters with a repeats axis)."""
    cfg = TR.get_config("gemma2-2b", smoke=True)
    template = TT.init_decoder_cache(cfg, NUM_SLOTS, 40, 0, device="meta")
    store = tkv.PagedKVCache(template, num_slots=NUM_SLOTS, page_size=8,
                             quant="int8", device="cpu")
    assert store.device == torch.device("cpu")
    caps = sorted({pl.capacity for pl in store._paged.values()})
    assert caps == [cfg.window, 40]
    for path, axis in store._dense_batch_axis.items():
        assert path[-1] == "idx" and axis is None
        assert store._dense[path].shape == (cfg.num_layers // 2,)
    dense = store.as_dense()
    for leaf in tkv._leaf_paths(dense)[0].values():
        assert leaf.device.type == "cpu" and leaf.is_contiguous()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tkv.PagedKVCache(template, num_slots=NUM_SLOTS)
