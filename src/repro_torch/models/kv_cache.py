"""Paged KV cache: fixed-size pages and per-slot page tables, with
quantize-on-write and a compensated dequant — the counterpart of
``repro.models.kv_cache``.

The continuous-batching engine (``repro_torch.launch.serve``) keeps
every slot's decoder KV state here instead of in one dense tree:

  * each **paged leaf** (a float cache leaf beside an ``idx`` counter:
    the positional buffers ``k`` / ``v`` of GQA and ``ckv`` / ``krope``
    of MLA) owns a pool of fixed-size pages and a per-slot **page table**
    mapping the slot's token positions onto pool pages.  Capacities
    differ per leaf (a local ring holds ``window`` slots), so tables and
    pages per slot are per leaf, and so is the free list;
  * **quantize-on-write**: with ``quant='int8'`` a token's feature
    vector is stored as int8 codes and one f32 scale per (page, token),
    plus, when the precision policy keeps ``split_words >= 2``, a bf16
    **residual** word (the split-word decomposition of the ``mma_ec``
    engines).  Dequant recombines the words through
    ``core.precision.two_sum``; int8 codes and the bf16 residual rebuild
    a bf16 cache exactly.  ``quant='none'`` stores the raw values;
  * every other leaf (cross-attention memory, RWKV / RG-LRU state, the
    ``idx`` counters) stays **dense**, written per slot on admission.

Layout of one paged leaf (dense shape ``(layers, B, cap, *feat)``):

  codes  (num_pages, page_size, F)   int8 | leaf dtype   F = prod(feat')
  scale  (num_pages, page_size)      f32                 int8 only
  resid  (num_pages, page_size, F)   bf16                split_words>=2
  table  (num_slots, ceil(cap / page_size))  int32 on the host, -1 unmapped

where ``feat'`` are the slot view's dims after the token axis
(``(cap, layers, *feat)``): token ``t`` of slot ``s`` lives at
``(table[s, t // page_size], t % page_size)``.

The pools live on one device (the template's, or the card when the
template is a ``"meta"`` tree); the page tables and free lists are host
state.  The port's decode step writes caches in place, so ``as_dense``
builds new tensors on every call and never hands out a pool.

The allocator enforces the scheduler's slot lifecycle (``alloc_slot`` on
a live slot, ``free_slot`` or a write on a free one raise).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.dispatch import default_device
from repro_torch.core.precision import as_policy, two_sum
from repro_torch.models.transformer import _CACHE_LEAF_AXES

# Cache-dict float leaves with one entry per token position: pageable
# when an ``idx`` sibling marks the dict as a positional cache
# (cross-attention memory has k / v but no idx, and stays dense).
PAGED_LEAF_NAMES = frozenset({"k", "v", "ckv", "krope"})

_INT8_MAX = 127.0


def _leaf_paths(tree):
    """(path -> leaf) plus the set of paths eligible for paging."""
    leaves, paged = {}, set()

    def rec(node, path):
        if isinstance(node, dict):
            has_idx = "idx" in node
            for key in sorted(node):
                sub = path + (key,)
                child = node[key]
                if isinstance(child, dict):
                    rec(child, sub)
                else:
                    leaves[sub] = child
                    if has_idx and key in PAGED_LEAF_NAMES and \
                            child.dtype.is_floating_point:
                        paged.add(sub)
        else:
            leaves[path] = node
    rec(tree, ())
    return leaves, paged


def _tree_set(tree, path, value):
    """A copy of a nested-dict tree with ``tree[*path] = value``."""
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _tree_set(tree[path[0]], path[1:], value)
    return out


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@dataclasses.dataclass
class _PagedLeaf:
    """Pools and table of one paged leaf."""
    codes: torch.Tensor              # (P, page, F)
    scale: Optional[torch.Tensor]    # (P, page) f32, int8 only
    resid: Optional[torch.Tensor]    # (P, page, F) bf16, two-word quant
    table: np.ndarray                # (num_slots, pages_per_slot) int32
    free: list                       # free page ids, popped from the end
    shape: tuple                     # dense leaf shape
    dtype: torch.dtype               # dense leaf dtype
    batch_axis: int
    token_axis: int
    capacity: int
    pages_per_slot: int
    feat_shape: tuple                # slot-view feature dims


def _axes_of(name: str, ndim: int) -> tuple:
    """(batch_axis, token_axis) of a paged leaf from its name, allowing
    leading stacked-layer axes."""
    # Every paged leaf's base layout is (batch, token, *feat); stacked
    # leaves carry `extra` leading layer axes.
    base_ndim = {"k": 4, "v": 4, "ckv": 3, "krope": 3}[name]
    extra = ndim - base_ndim
    if extra < 0:
        raise ValueError(f"cache leaf {name!r} has rank {ndim}, "
                         f"expected >= {base_ndim}")
    return extra, extra + 1


def _template_device(leaves: dict, device):
    """``device`` when given, else the template's device, or the card
    for a ``"meta"`` template."""
    if device is not None:
        return torch.device(device)
    found = {leaf.device for leaf in leaves.values()}
    if len(found) > 1:
        raise ValueError(f"cache template spans devices "
                         f"{sorted(map(str, found))}")
    dev = found.pop() if found else None
    if dev is None or dev.type == "meta":
        return torch.device(default_device())
    return dev


class PagedKVCache:
    """Slot-addressed paged storage for one decoder cache geometry.

    ``template`` is a dense cache tree (as ``init_decoder_cache`` builds
    it, on a device or on ``"meta"``) whose batch dim is ``num_slots``;
    its paged leaves become page pools, every other leaf dense per-slot
    storage, on ``device`` (default: the template's, the card for a meta
    template).  ``quant='int8'`` quantizes on write (codes and scale,
    and a bf16 residual word when the policy keeps ``split_words >=
    2``); ``quant='none'`` stores raw values.
    """

    def __init__(self, template, *, num_slots: int, page_size: int = 16,
                 quant: str = "int8", precision=None, device=None):
        if quant not in ("int8", "none"):
            raise ValueError(f"quant must be 'int8' or 'none', "
                             f"got {quant!r}")
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.quant = quant
        self.policy = as_policy(precision)
        words = 2 if self.policy is None else int(self.policy.split_words)
        self.residual = quant == "int8" and words >= 2
        self._live: set = set()
        leaves, paged_paths = _leaf_paths(template)
        self.device = _template_device(leaves, device)
        self._paged: dict = {}
        self._dense: dict = {}
        self._dense_batch_axis: dict = {}
        for path, leaf in leaves.items():
            shape = tuple(leaf.shape)
            if path in paged_paths:
                self._paged[path] = self._make_pool(path[-1], shape,
                                                    leaf.dtype)
            else:
                self._dense[path] = torch.zeros(shape, dtype=leaf.dtype,
                                                device=self.device)
                base = _CACHE_LEAF_AXES.get(path[-1], ())
                if "batch" in base:
                    extra = len(shape) - len(base)
                    self._dense_batch_axis[path] = \
                        extra + base.index("batch")
                else:
                    self._dense_batch_axis[path] = None
        self._template = template  # structure reference only

    # ------------------------------------------------------- pools

    def _make_pool(self, name: str, shape: tuple, dtype) -> _PagedLeaf:
        batch_axis, token_axis = _axes_of(name, len(shape))
        if shape[batch_axis] != self.num_slots:
            raise ValueError(
                f"cache leaf {name!r} batch dim {shape[batch_axis]} "
                f"!= num_slots {self.num_slots}")
        cap = shape[token_axis]
        pps = math.ceil(cap / self.page_size)
        feat = tuple(d for i, d in enumerate(shape)
                     if i not in (batch_axis, token_axis))
        f = math.prod(feat) if feat else 1
        num_pages = self.num_slots * pps
        code_dtype = torch.int8 if self.quant == "int8" else dtype
        dev = self.device
        return _PagedLeaf(
            codes=torch.zeros((num_pages, self.page_size, f),
                              dtype=code_dtype, device=dev),
            scale=(torch.zeros((num_pages, self.page_size),
                               dtype=torch.float32, device=dev)
                   if self.quant == "int8" else None),
            resid=(torch.zeros((num_pages, self.page_size, f),
                               dtype=torch.bfloat16, device=dev)
                   if self.residual else None),
            table=np.full((self.num_slots, pps), -1, np.int32),
            free=list(range(num_pages - 1, -1, -1)),
            shape=shape, dtype=dtype, batch_axis=batch_axis,
            token_axis=token_axis, capacity=cap, pages_per_slot=pps,
            feat_shape=feat)

    # --------------------------------------------------- allocator

    @property
    def nbytes(self) -> int:
        """Bytes the store holds on its device: the page pools (codes,
        scales, residuals) and the dense per-slot leaves."""
        parts = [t for pl in self._paged.values()
                 for t in (pl.codes, pl.scale, pl.resid) if t is not None]
        parts += list(self._dense.values())
        return sum(t.numel() * t.element_size() for t in parts)

    @property
    def live_slots(self) -> frozenset:
        return frozenset(self._live)

    def slot_pages(self, slot: int) -> dict:
        """{leaf path: page-id list}: page-table inspection."""
        return {path: [int(p) for p in pl.table[slot]]
                for path, pl in self._paged.items()}

    def free_pages(self) -> dict:
        return {path: len(pl.free) for path, pl in self._paged.items()}

    def alloc_slot(self, slot: int) -> None:
        """Map every leaf's pages for ``slot`` (which must be free)."""
        if slot in self._live:
            raise RuntimeError(
                f"slot {slot} is live; evict (free_slot) before "
                f"re-admitting — slots are never reused in place")
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} out of range "
                             f"[0, {self.num_slots})")
        for pl in self._paged.values():
            if len(pl.free) < pl.pages_per_slot:
                raise RuntimeError("page pool exhausted")
            pl.table[slot] = [pl.free.pop()
                              for _ in range(pl.pages_per_slot)]
        self._live.add(slot)

    def free_slot(self, slot: int) -> None:
        """Evict ``slot``: its pages go back to the free lists."""
        if slot not in self._live:
            raise RuntimeError(f"slot {slot} is not live")
        for pl in self._paged.values():
            pl.free.extend(int(p) for p in pl.table[slot])
            pl.table[slot] = -1
        self._live.discard(slot)

    # ------------------------------------------------------ writes

    def _quantize(self, x):
        """(T, F) -> (codes, scale, resid) per the write policy."""
        if self.quant == "none":
            return x, None, None
        xf = x.to(torch.float32)
        amax = torch.amax(torch.abs(xf), dim=-1)
        scale = torch.clamp(amax / _INT8_MAX, min=1e-20)
        # torch.round, like jnp.round, rounds half to even.
        codes = torch.clamp(torch.round(xf / scale[..., None]),
                            -_INT8_MAX, _INT8_MAX).to(torch.int8)
        hi = codes.to(torch.float32) * scale[..., None]
        resid = (xf - hi).to(torch.bfloat16) if self.residual else None
        return codes, scale, resid

    def _slot_view(self, pl: _PagedLeaf, leaf, slot_in_leaf: int):
        """One slot's (cap, F) token-major view of a dense leaf."""
        sv = leaf.select(pl.batch_axis, slot_in_leaf)
        sv = torch.movedim(sv, pl.batch_axis, 0)  # token axis now first
        return sv.reshape(pl.capacity, -1)

    def _pages(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64),
                               device=self.device)

    def write_slot(self, slot: int, caches) -> None:
        """Admit one request's cache into ``slot``.

        ``caches`` is a dense cache tree of batch 1 (an admission prefill
        with ``extra_capacity`` topping the prompt up to this store's
        capacities): each paged leaf is quantized page by page; dense
        leaves copy their batch row.
        """
        if slot not in self._live:
            raise RuntimeError(f"slot {slot} not allocated")
        leaves, _ = _leaf_paths(caches)
        for path, pl in self._paged.items():
            leaf = leaves[path]
            if leaf.shape[pl.token_axis] != pl.capacity:
                raise ValueError(
                    f"leaf {'/'.join(path)}: capacity "
                    f"{leaf.shape[pl.token_axis]} != {pl.capacity} "
                    f"(prefill with matching extra_capacity)")
            sv = self._slot_view(pl, leaf.to(self.device), 0)
            pad = pl.pages_per_slot * self.page_size - pl.capacity
            if pad:
                sv = torch.nn.functional.pad(sv, (0, 0, 0, pad))
            codes, scale, resid = self._quantize(sv)
            pages = self._pages(pl.table[slot])
            shape = (pl.pages_per_slot, self.page_size, -1)
            pl.codes[pages] = codes.reshape(shape).to(pl.codes.dtype)
            if scale is not None:
                pl.scale[pages] = scale.reshape(shape[:2])
            if resid is not None:
                pl.resid[pages] = resid.reshape(shape)
        for path, arr in self._dense.items():
            src = leaves[path].to(self.device)
            axis = self._dense_batch_axis[path]
            if axis is None:
                # step counters (and any batchless state) are shared
                self._dense[path] = torch.broadcast_to(
                    src, arr.shape).to(arr.dtype).clone()
                continue
            # a dense per-slot leaf (cross-attention memory, recurrent
            # state): the admission batch row goes to the slot row
            arr.select(axis, slot).copy_(src.select(axis, 0))

    def write_token(self, caches, slot: int, position: int) -> None:
        """Write one freshly decoded token's KV for ``slot``.

        ``caches`` is the whole dense tree a decode step returned (batch
        = num_slots); only the page entry holding ``position`` (per leaf
        ``position % cap``, a ring) is touched, so earlier tokens are
        never quantized again and the quantization error does not grow
        over steps.
        """
        if slot not in self._live:
            raise RuntimeError(f"slot {slot} not allocated")
        leaves, _ = _leaf_paths(caches)
        for path, pl in self._paged.items():
            w = int(position) % pl.capacity
            # the slot's token w alone: with the batch axis taken, the
            # token axis sits where the batch axis was
            x = leaves[path].select(pl.batch_axis, slot) \
                .select(pl.batch_axis, w).reshape(1, -1)
            codes, scale, resid = self._quantize(x)
            page = int(pl.table[slot, w // self.page_size])
            off = w % self.page_size
            pl.codes[page, off] = codes[0].to(pl.codes.dtype)
            if scale is not None:
                pl.scale[page, off] = scale[0]
            if resid is not None:
                pl.resid[page, off] = resid[0]
        # recurrent / dense per-slot state advances every step too: this
        # slot's batch row of the step's tree
        for path, arr in self._dense.items():
            axis = self._dense_batch_axis[path]
            if axis is None:
                continue
            arr.select(axis, slot).copy_(leaves[path].select(axis, slot))

    # ------------------------------------------------------- reads

    def _dequant_pages(self, gathered, scale, resid):
        x = gathered.to(torch.float32)
        if scale is not None:
            x = x * scale[..., None]
        if resid is not None:
            # compensated two-word recombination (the mma_ec form)
            hi, lo = two_sum(x, resid.to(torch.float32))
            x = hi + lo
        return x

    def as_dense(self):
        """The dense cache tree (gather and dequant) a decode step
        consumes, in new tensors; free slots read as zeros."""
        out = self._template
        for path, pl in self._paged.items():
            valid = torch.as_tensor(pl.table >= 0, device=self.device)
            safe = self._pages(np.maximum(pl.table, 0))   # (S, pps)
            gathered = pl.codes[safe]                     # (S,pps,pg,F)
            scale = None if pl.scale is None else pl.scale[safe]
            resid = None if pl.resid is None else pl.resid[safe]
            if self.quant == "none":
                x = gathered.to(torch.float32)
            else:
                x = self._dequant_pages(gathered, scale, resid)
            x = torch.where(valid[..., None, None], x, 0.0)
            x = x.reshape(self.num_slots, -1,
                          x.shape[-1])[:, :pl.capacity]
            x = x.reshape((self.num_slots, pl.capacity) + pl.feat_shape)
            x = torch.movedim(x, (0, 1), (pl.batch_axis, pl.token_axis))
            out = _tree_set(out, path, x.to(
                pl.dtype, memory_format=torch.contiguous_format))
        for path, arr in self._dense.items():
            out = _tree_set(out, path, arr.clone())
        return out

    # --------------------------------------------------- utilities

    def read_slot(self, slot: int) -> dict:
        """{leaf path: (cap, F) f32}: one live slot's dequantized
        token-major content (tests / debugging)."""
        if slot not in self._live:
            raise RuntimeError(f"slot {slot} not allocated")
        dense = self.as_dense()
        return {path: self._slot_view(pl, _tree_get(dense, path), slot)
                .to(torch.float32)
                for path, pl in self._paged.items()}
