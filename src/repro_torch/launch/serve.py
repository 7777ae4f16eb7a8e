"""Serving: fixed-batch and continuous-batching decode loops — the
counterpart of ``repro.launch.serve``.

``Server`` runs prefill and decode for a fixed batch: greedy or
temperature sampling, with every position after a row's EOS pinned to
the stop id, so a batch of heterogeneous requests drains correctly.

``ContinuousServer`` is the production decode loop: a slot scheduler
admits requests into freed slots mid-stream and evicts finished ones,
the KV state lives in a paged store (``models.kv_cache.PagedKVCache``:
fixed-size pages, per-slot page tables, quantize-on-write), and tokens
stream back per step through an iterator (``serve``) or a callback
(``generate``).

Scoring (``Server.score`` / ``batched_logprobs``) normalises the logits
through ``integration.reduce_sum``: the log-softmax normaliser's sum
over the vocabulary and the per-sequence fold.  Both take an
``objective`` (an ``autotune.LatencyObjective`` or an SLO in ms): under
``method='auto'`` the vocabulary reduction resolves a latency-keyed plan
for its logits shape.

Nothing is traced or compiled: each call runs the model eagerly where
its parameters lie.  ``ContinuousServer`` keeps its store on ``device``
(the card unless the caller names another).

Over a mesh of ranks (``compat.Mesh``; every rank a process of a live
``torch.distributed`` group, every rank making the same calls) both
servers follow the SPMD train step's design (``launch.train``):

  * a batch's rows split over the mesh's batch axes where they divide
    (``sharding.batch_rows``: ``pod``, ``data``), else every rank takes
    every row; the ranks along ``model`` repeat their rows' work;
  * the model runs on this rank's rows with no mesh installed
    (``sharding.local_step``), so ``dispatch`` keeps its one-card plans
    and a row's bits are those of one card (a decode row's bits do not
    depend on the rows beside it);
  * the parameters are a tree of whole tensors or the SPMD train
    state's ``DTensor`` leaves: each non-expert ``DTensor`` leaf is
    gathered whole once and kept while the leaf is unchanged
    (``GATHERED`` counts the gathers); an expert leaf is never gathered:
    ``models.moe``'s body takes this rank's blocks;
  * the last position's logits are gathered over the batch axes before
    sampling, so every rank draws the one card's tokens, pins EOS and
    yields the same ``TokenEvent`` stream;
  * ``ContinuousServer``'s store holds this rank's slots alone; its
    batch-1 admission prefill runs on every rank, and the slot's owner
    writes the pages.  An MoE arch refuses that replicated batch, as the
    reference does.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core import integration as ci
from repro_torch.core.dispatch import default_device
from repro_torch.core.integration import _leaves, _tree_like
from repro_torch.core.precision import dtype_name
from repro_torch.core.reduction import _ROW_TILE
from repro_torch.distributed import sharding as shd
from repro_torch.launch.train import expert_leaves, leaf_paths, live_mesh
from repro_torch.models import model_zoo
from repro_torch.models import transformer as T
from repro_torch.models.kv_cache import PagedKVCache


def batched_logprobs(logits, tokens, *, method: str = "auto",
                     precision=None, objective=None,
                     bucket: str = "pow2") -> torch.Tensor:
    """Per-token log-probabilities: (B, S, V) logits and (B, S) ids ->
    (B, S) f32.

    logZ = log sum_v exp(l_v - m) + m; the sum over the vocabulary goes
    through ``integration.reduce_sum(..., axis=-1)`` with ``method``,
    ``precision`` (an ``MmaPolicy`` bounding the normaliser's error),
    ``objective`` (a latency SLO for the auto plan) and ``bucket`` (the
    plan key's shape bucket policy).  Accumulation is f32; the max shift
    keeps exp in range.
    """
    lf = logits.to(torch.float32)
    shift = torch.amax(lf, dim=-1, keepdim=True).detach()
    z = ci.reduce_sum(torch.exp(lf - shift), axis=-1, method=method,
                      precision=precision, objective=objective,
                      bucket=bucket)
    logz = torch.log(z) + shift[..., 0]
    idx = torch.as_tensor(tokens, device=lf.device).long()[..., None]
    tok = torch.gather(lf, -1, idx)[..., 0]
    return tok - logz


def _generator(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` alone."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _categorical(logits, temperature: float, gen: torch.Generator):
    """One sample per row of (B, V) logits / temperature, by the Gumbel
    maximum (the way ``jax.random.categorical`` draws)."""
    lf = logits.to(torch.float32) / temperature
    u = torch.rand(lf.shape, generator=gen, device=lf.device)
    gumbel = -torch.log(-torch.log(
        torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(lf + gumbel, dim=-1)


# Gathers of each parameter leaf by a server over a mesh, by path
# (``launch.train.leaf_paths``): an expert leaf is never gathered.
GATHERED: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class _Rows:
    """A batch's rows on this rank: the mesh axes they split over (()
    when every rank takes every row) and this rank's slice of them."""
    axes: tuple
    part: slice


_WHOLE = _Rows((), slice(None))


class _MeshShare:
    """What a server over a mesh of several ranks does beside the model:
    split a batch's rows, hand the model this rank's parameters, gather
    the rows' results."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        self.kinds = expert_leaves(model)
        self.paths = leaf_paths(model.specs)
        self._held: dict = {}

    def rows(self, n: int) -> _Rows:
        axes, lo, hi = shd.batch_rows(self.mesh, n)
        return _Rows(axes, slice(lo, hi))

    def local(self, rows: _Rows):
        return shd.local_step(self.mesh, rows.axes)

    def whole(self, x, rows: _Rows):
        """Every rank's rows of ``x`` (rows first) in place."""
        if not rows.axes:
            return x
        return shd.gather_shard(x.contiguous(), shd.P(rows.axes), self.mesh)

    def params(self, params, seq_len: int):
        """The tree the model takes on this rank for a batch of
        ``seq_len`` positions (the MoE body's layout may depend on it)."""
        specs = None
        if any(self.kinds):
            from repro_torch.models import moe
            specs = moe.block_specs(self.model.cfg, dict(self.mesh.shape),
                                    seq_len)
        return _tree_like(params, [
            self._leaf(leaf, kind, path, specs) for leaf, kind, path
            in zip(_leaves(params), self.kinds, self.paths)])

    def _leaf(self, leaf, kind: str, path: str, specs):
        dtensor = shd.is_dtensor(leaf)
        if not kind and not dtensor:
            return leaf
        spec = None
        if kind:
            want = specs[kind]
            spec = shd.P(*(None,) * (leaf.ndim - len(want)), *want)
        version = shd.local(leaf)._version
        held = self._held.get((path, spec))
        if held is not None and held[0] is leaf and held[1] == version:
            return held[2]
        if kind and dtensor:
            have = shd.dtensor_sharding(leaf).spec
            if tuple(have) != tuple(spec):
                raise ValueError(
                    f"the expert leaf {path} is laid out {have}, and the "
                    f"MoE body over {self.mesh} takes {spec}: an expert "
                    f"leaf is never gathered")
            value = shd.local(leaf)
        elif kind:
            value = shd.local_shard(leaf, spec, self.mesh).contiguous()
        else:
            GATHERED[path] += 1
            value = shd.whole(leaf)
        self._held[(path, spec)] = (leaf, version, value)
        return value


def _share(model, mesh) -> Optional[_MeshShare]:
    mesh = live_mesh(mesh, "a server")
    return None if mesh is None else _MeshShare(model, mesh)


def _run(share, call, params, batch: dict, rows: _Rows, seq_len: int):
    """``call(params, batch)``: on one card as it is, over a mesh on this
    rank's rows (``batch`` holds them) and parameters."""
    if share is None:
        return call(params, batch)
    with share.local(rows):
        return call(share.params(params, seq_len), batch)


def _whole(share, x, rows: _Rows):
    return x if share is None else share.whole(x, rows)


def _device_of(params) -> torch.device:
    return params["embed"]["table"].device


@dataclasses.dataclass
class Server:
    """Prefill and decode for a fixed batch, where the parameters lie;
    over a mesh of several ranks, each rank's rows on that rank (see the
    module docstring)."""
    model: object
    mesh: Optional[object] = None
    temperature: float = 0.0
    extra_capacity: int = 64   # decode headroom the prefill allocates

    def __post_init__(self):
        self._mesh = _share(self.model, self.mesh)

    def _rows(self, n: int) -> _Rows:
        return _WHOLE if self._mesh is None else self._mesh.rows(n)

    def score(self, params, tokens, *, mask=None,
              extras: Optional[dict] = None,
              method: str = "auto", precision=None,
              objective=None, bucket: str = "pow2") -> torch.Tensor:
        """Total log-probability of each sequence under the model
        (teacher forcing): one full-sequence forward (``logits``),
        ``batched_logprobs`` over the vocabulary, then a per-row fold of
        the token logprobs, both through ``reduce_sum``.  ``mask`` ((B,
        S), 1 = scored) zeroes padding before the fold; ``extras``
        carries the modality inputs of enc-dec / vision configs.
        Returns (B,) f32 (over a mesh: every rank's rows, on every
        rank).
        """
        dev = _device_of(params)
        toks = torch.as_tensor(tokens, device=dev).to(torch.int32)
        b, s = toks.shape
        rows = self._rows(b)
        toks = toks[rows.part]
        batch = {"tokens": toks}
        if extras:
            batch.update({k: v[rows.part] for k, v in extras.items()})
        logits = _run(self._mesh, self.model.logits, params, batch, rows, s)
        lp = batched_logprobs(logits[:, :-1], toks[:, 1:],
                              method=method, precision=precision,
                              objective=objective, bucket=bucket)
        if mask is not None:
            lp = lp * torch.as_tensor(mask, device=dev).to(
                torch.float32)[rows.part, 1:]
        total = ci.reduce_sum(lp, axis=-1, method=method,
                              precision=precision, objective=objective,
                              bucket=bucket)
        return _whole(self._mesh, total, rows)

    def _sample(self, logits, seed: int, step: int) -> np.ndarray:
        last = logits[:, -1, :]
        if self.temperature <= 0.0:
            # ties go to the first index, as jnp.argmax's do
            tok = torch.argmax(last, dim=-1)
        else:
            tok = _categorical(last, self.temperature,
                               _generator(last.device, seed, step))
        return tok.to(torch.int32).cpu().numpy()

    def generate(self, params, prompts: np.ndarray, *, max_new: int = 32,
                 eos_id: Optional[int] = None, seed: int = 0,
                 extras: Optional[dict] = None) -> np.ndarray:
        """prompts: (B, S) int32. Returns (B, <=max_new) generated ids.

        Rows that hit ``eos_id`` before the rest of the batch stay
        pinned to ``eos_id``: every position after a row's stop is
        overwritten before it is emitted or fed back.  With a
        temperature, step i samples from a generator seeded by (seed,
        i), over the whole batch (over a mesh too: the last position's
        logits are gathered first).
        """
        dev = _device_of(params)
        b, s = np.shape(prompts)
        rows = self._rows(b)
        batch = {"tokens": torch.as_tensor(
            np.asarray(prompts, np.int32)[rows.part], device=dev)}
        if extras:
            batch.update({k: v[rows.part] for k, v in extras.items()})

        def prefill(p, bt):
            return self.model.prefill(p, bt,
                                      extra_capacity=self.extra_capacity)
        logits, caches = _run(self._mesh, prefill, params, batch, rows, s)
        out = []
        done = np.zeros((b,), bool)
        tok = self._sample(_whole(self._mesh, logits, rows), seed, 0)
        for i in range(max_new):
            t = tok
            if eos_id is not None:
                t = np.where(done, np.int32(eos_id), t)
                done |= t == eos_id
            out.append(t)
            if eos_id is not None and done.all():
                break
            step_batch = {"token": torch.as_tensor(t[rows.part, None],
                                                   device=dev),
                          "pos": s + i, "caches": caches}
            logits, caches = _run(self._mesh, self.model.decode_step,
                                  params, step_batch, rows, 1)
            tok = self._sample(_whole(self._mesh, logits, rows), seed,
                               i + 1)
        return np.stack(out, axis=1)


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request for the continuous engine."""
    uid: int
    prompt: np.ndarray          # (S,) int32 token ids
    max_new: int = 32


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token: request ``uid`` emitted its ``index``-th
    output token.  ``done`` marks the request's last token (EOS or
    ``max_new`` reached); ``logprob`` is filled when the engine runs
    with ``logprobs=True``."""
    uid: int
    index: int
    token: int
    done: bool
    logprob: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    """Scheduler state of one live slot."""
    uid: int
    last_tok: int               # feeds the next decode step
    next_pos: int               # absolute position it will occupy
    n_out: int                  # tokens emitted so far
    max_new: int


class ContinuousServer:
    """Continuous-batching decode engine over a paged KV store.

    A bank of ``num_slots`` decode slots steps in lock-step (one batched
    decode per iteration, each slot at its own absolute position); the
    scheduler admits pending requests into free slots between steps (a
    request finishing at step t frees its slot for step t + 1) and
    evicts finished ones, returning their pages to the pool.

    Admission runs the prompt as a batch-1 prefill whose
    ``extra_capacity`` tops it up to ``capacity``, then writes the whole
    prompt's KV into the slot's pages (``PagedKVCache.write_slot``).
    Each decode step reads the store (``as_dense``: gather and
    compensated dequant), runs the model's per-row decode, and writes
    back only each live slot's new token (``write_token``).  With
    ``quant='none'`` the streamed tokens have the bits of draining the
    same requests one at a time through ``Server.generate`` (greedy);
    ``'int8'`` stores codes and scales (and a bf16 residual word under a
    ``split_words >= 2`` policy), which rebuild a bf16 cache exactly.

    Sampling is per request: temperature 0 is greedy; otherwise the
    sample of output ``index`` of request ``uid`` comes from a generator
    seeded by (seed, uid, index), whatever slot or step served it.

    Over a mesh of several ranks (``mesh``) every rank runs the same
    scheduler and yields the same events; a decode step's ``num_slots``
    rows split over the batch axes where they divide (at most
    ``_ROW_TILE`` a rank), this rank's store holds its own slots' pages,
    and each step's logits are gathered before the picks.

    ``latency_slo_ms`` keys the scoring reductions' plans
    (``logprobs=True``) and, with ``attn_method`` or
    ``norm_matmul_method``, the plans of the rebuilt model's attention
    and fused rmsnorm -> matmul boundary.  ``bucket`` is the plan key's
    shape bucket policy; ``warmup`` resolves the serving hot set before
    traffic; ``background_sweeps=True`` attaches an
    ``autotune.SweepWorker`` to the default registry, which ``close()``
    (or leaving the ``with`` block) detaches and stops without ever
    waiting on a sweep in flight.
    """

    def __init__(self, model, *, num_slots: int = 4, capacity: int = 128,
                 page_size: int = 16, quant: str = "none",
                 precision=None, mesh=None, temperature: float = 0.0,
                 latency_slo_ms: Optional[float] = None,
                 logprobs: bool = False, seed: int = 0,
                 attn_method: Optional[str] = None,
                 norm_matmul_method: Optional[str] = None,
                 bucket: str = "pow2",
                 background_sweeps: bool = False, device=None):
        cfg = model.cfg
        if cfg.is_encdec or cfg.vision_tokens:
            raise ValueError(
                "ContinuousServer serves text decoders; enc-dec and "
                "vision configs need per-request memory (use Server)")
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots}: at least one slot")
        if attn_method is not None or norm_matmul_method is not None:
            # The engines take whole (dequantized) tensors, so their
            # policy never splits words: split_words is capped at 1; the
            # residual words belong to the store's quantizer, which keeps
            # the caller's ``precision``.
            pol = precision
            if pol is not None and getattr(pol, "split_words", 1) != 1:
                pol = dataclasses.replace(pol, split_words=1)
            repl: dict = {}
            if attn_method is not None:
                repl.update(attn_method=attn_method, attn_precision=pol,
                            attn_slo_ms=latency_slo_ms)
            if norm_matmul_method is not None:
                repl.update(norm_matmul_method=norm_matmul_method,
                            norm_matmul_precision=pol,
                            norm_matmul_slo_ms=latency_slo_ms)
            cfg = dataclasses.replace(cfg, **repl)
            model = model_zoo.build(cfg)
        self.model = model
        self.cfg = cfg
        self._mesh = _share(model, mesh)
        # this rank's slots: a decode step's rows over the batch axes
        self._slots = _WHOLE if self._mesh is None \
            else self._mesh.rows(int(num_slots))
        self._first, self._last = self._slots.part.indices(int(num_slots))[:2]
        if self._last - self._first > _ROW_TILE:
            # A step's rows are padded to _ROW_TILE (layers.dense); more
            # rows would send the matrix library another row count than
            # one request alone does, and the bits could differ.
            raise ValueError(
                f"num_slots={num_slots}: a decode step keeps each slot's "
                f"bits those of its request alone for 1 to {_ROW_TILE} "
                f"slots a rank (core.reduction._ROW_TILE)")
        self.device = torch.device(default_device(device))
        self.num_slots = int(num_slots)
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self.quant = quant
        self.precision = precision
        self.temperature = float(temperature)
        self.objective = latency_slo_ms
        self.logprobs = bool(logprobs)
        self.seed = int(seed)
        self.bucket = bucket
        self._sweeper = None
        if background_sweeps:
            reg = autotune.default_registry()
            self._sweeper = autotune.SweepWorker(reg)
            reg.sweep_worker = self._sweeper

    # ----------------------------------------------- warmup/lifecycle

    def warmup(self, params=None, *, prompt_lens=None) -> dict:
        """Resolve the serving hot set before traffic arrives.

        Plans (always): the scoring reductions' two hot shapes, the
        admission's (1, 1, V) logits and a decode step's (num_slots, 1,
        V), run once through the scoring path; with a
        ``norm_matmul_method``, the fused MLP's plans at a decode step's
        and a full-capacity prefill's rows.

        Prefill (with ``params``): one batch-1 prefill a prompt length,
        by default each ``bucket`` cap below ``capacity``, so a bucketed
        request stream (``data.pipeline.synthetic_requests`` with the
        same ``bucket``) meets only shapes already run.

        Returns ``{"plans", "scoring_shapes", "prefill_compiles"}``:
        ``plans`` counts the plans this warmup added to the default
        registry; ``prefill_compiles`` the prefills run (the reference's
        name: nothing is compiled here).
        """
        reg = autotune.default_registry()
        before = len(reg)
        V = self.cfg.vocab_size
        shapes = ((1, 1, V), (self.num_slots, 1, V))
        for shape in shapes:
            self._lp(torch.zeros(shape, dtype=torch.float32,
                                 device=self.device),
                     torch.zeros(shape[:2], dtype=torch.int32,
                                 device=self.device))
        if self.cfg.norm_matmul_method:
            d = self.cfg.d_model
            # The fused MLP's call form: (d, d_ff, gated) and the
            # parameters' dtype beside the activations'.
            form = (("d", d), ("dout", self.cfg.d_ff), ("gate", 1))
            if self.cfg.param_dtype != self.cfg.compute_dtype:
                form += (("w_dtype", dtype_name(self.cfg.param_dtype)),)
            autotune.warmup(
                "norm_matmul",
                ((self.num_slots * d, self.cfg.compute_dtype),
                 (self.capacity * d, self.cfg.compute_dtype)),
                registry=reg, backend=self.device.type,
                policy=self.cfg.norm_matmul_precision,
                objective=self.objective, bucket=self.bucket, form=form)
        lens: tuple = ()
        if params is not None:
            if prompt_lens is None:
                caps = {min(autotune.bucket_cap(L, self.bucket),
                            self.capacity - 1)
                        for L in range(1, self.capacity)}
                lens = tuple(sorted(caps))
            else:
                lens = tuple(sorted(set(int(L) for L in prompt_lens)))
            for L in lens:
                tokens = torch.zeros((1, L), dtype=torch.int32,
                                     device=self.device)
                self._prefill(params, tokens, self.capacity - L)
        return {"plans": len(reg) - before, "scoring_shapes": shapes,
                "prefill_compiles": len(lens)}

    def close(self) -> None:
        """Detach and stop the background sweep worker (idempotent; safe
        with sweeps in flight)."""
        if self._sweeper is None:
            return
        reg = autotune.default_registry()
        if reg.sweep_worker is self._sweeper:
            reg.sweep_worker = None
        self._sweeper.close()
        self._sweeper = None

    def __enter__(self) -> "ContinuousServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ pieces

    def _prefill(self, params, tokens, extra_capacity: int):
        """An admission's prefill; over a mesh every rank runs it whole
        (a batch of 1 splits over no axis)."""
        def call(p, batch):
            return self.model.prefill(p, batch,
                                      extra_capacity=extra_capacity)
        return _run(self._mesh, call, params, {"tokens": tokens}, _WHOLE,
                    tokens.shape[1])

    def _decode(self, params, batch: dict):
        """One decode step on this rank's slots: (every slot's (num_slots,
        1, V) logits, this rank's caches)."""
        logits, caches = _run(self._mesh, self.model.decode_step, params,
                              batch, self._slots, 1)
        return _whole(self._mesh, logits, self._slots), caches

    def _local_slot(self, s: int) -> Optional[int]:
        """Slot ``s``'s index in this rank's store, or None on a rank that
        does not hold it."""
        return s - self._first if self._first <= s < self._last else None

    def _new_store(self) -> PagedKVCache:
        """The paged store of this rank's slots."""
        n = self._last - self._first
        template = T.init_decoder_cache(self.cfg, n, self.capacity, 0,
                                        device="meta")
        return PagedKVCache(template, num_slots=n,
                            page_size=self.page_size, quant=self.quant,
                            precision=self.precision, device=self.device)

    def _pick(self, row_logits, uid: int, index: int) -> int:
        """Sample one token from a (V,) logits row."""
        if self.temperature <= 0.0:
            return int(torch.argmax(row_logits))
        gen = _generator(row_logits.device, self.seed, uid, index)
        return int(_categorical(row_logits[None], self.temperature,
                                gen)[0])

    def _picks(self, last, slots: dict) -> dict:
        """{slot: token} from a step's (num_slots, V) last logits."""
        if self.temperature <= 0.0:
            # one argmax and one copy to the host for the whole step
            toks = torch.argmax(last, dim=-1).tolist()
            return {s: toks[s] for s in slots}
        return {s: self._pick(last[s], st.uid, st.n_out)
                for s, st in slots.items()}

    def _lp(self, logits, tokens) -> torch.Tensor:
        """(B,) logprob of each row's token under its (B, 1, V) or (1,
        S, V) logits: the latency-objective scoring reduction."""
        lp = batched_logprobs(logits, tokens, method="auto",
                              precision=self.precision,
                              objective=self.objective,
                              bucket=self.bucket)
        return lp[:, -1]

    # -------------------------------------------------------- loop

    def serve(self, params, requests, *,
              eos_id: Optional[int] = None) -> Iterator[TokenEvent]:
        """Stream tokens for ``requests`` (``Request`` objects or the
        equivalent dicts ``data.pipeline.synthetic_requests`` yields).

        Yields one ``TokenEvent`` per generated token in scheduler
        order: admissions (slot order), then the step's decode results
        (slot order), each step.  The iterator drives the engine, so
        consuming it lazily holds the decode loop back.
        """
        pending = deque(r if isinstance(r, Request) else Request(**r)
                        for r in requests)
        for r in pending:
            need = len(r.prompt) + r.max_new
            if r.max_new < 1:
                raise ValueError(f"request {r.uid}: max_new must be >= 1")
            if need > self.capacity:
                raise ValueError(
                    f"request {r.uid}: prompt {len(r.prompt)} + "
                    f"max_new {r.max_new} exceeds capacity "
                    f"{self.capacity}")
        store = self._new_store()
        slots: dict[int, _Slot] = {}

        while pending or slots:
            # --- admission: fill every free slot from the queue
            for s in range(self.num_slots):
                if not pending or s in slots:
                    continue
                req = pending.popleft()
                prompt = torch.as_tensor(
                    np.asarray(req.prompt, np.int32)[None],
                    device=self.device)
                L = prompt.shape[1]
                logits, caches = self._prefill(params, prompt,
                                               self.capacity - L)
                own = self._local_slot(s)
                if own is not None:
                    store.alloc_slot(own)
                    store.write_slot(own, caches)
                tok = self._pick(logits[0, -1], req.uid, 0)
                lp = None
                if self.logprobs:
                    lp = float(self._lp(logits, torch.tensor(
                        [[tok]], dtype=torch.int32,
                        device=self.device))[0])
                done = (eos_id is not None and tok == eos_id) \
                    or req.max_new == 1
                yield TokenEvent(req.uid, 0, tok, done, lp)
                if done:
                    if own is not None:
                        store.free_slot(own)
                else:
                    slots[s] = _Slot(req.uid, tok, L, 1, req.max_new)
            if not slots:
                continue

            # --- one batched per-row decode step for the live slots
            toks = np.zeros((self.num_slots, 1), np.int32)
            pos = np.zeros((self.num_slots,), np.int32)
            for s, st in slots.items():
                toks[s, 0] = st.last_tok
                pos[s] = st.next_pos
            mine = self._slots.part
            logits, caches = self._decode(params, {
                "token": torch.as_tensor(toks[mine], device=self.device),
                "pos": torch.as_tensor(pos[mine], device=self.device),
                "caches": store.as_dense()})
            picks = self._picks(logits[:, -1], slots)
            lps = None
            if self.logprobs:
                lpt = np.zeros((self.num_slots, 1), np.int32)
                for s, t in picks.items():
                    lpt[s, 0] = t
                lps = self._lp(logits, torch.as_tensor(
                    lpt, device=self.device)).cpu().numpy()
            for s in sorted(slots):
                st = slots[s]
                own = self._local_slot(s)
                if own is not None:
                    store.write_token(caches, own, st.next_pos)
                t = picks[s]
                idx = st.n_out
                st.n_out += 1
                done = (eos_id is not None and t == eos_id) \
                    or st.n_out >= st.max_new
                yield TokenEvent(st.uid, idx, t, done,
                                 None if lps is None else float(lps[s]))
                if done:
                    if own is not None:
                        store.free_slot(own)
                    del slots[s]
                else:
                    st.last_tok = t
                    st.next_pos += 1

    def generate(self, params, requests, *,
                 eos_id: Optional[int] = None,
                 on_token: Optional[Callable] = None) -> dict:
        """Drain ``requests``; returns {uid: (n,) int32 tokens}.

        ``on_token`` (optional) is called with every ``TokenEvent`` as it
        is produced: the callback form of the streaming API.
        """
        out: dict[int, list] = {}
        for ev in self.serve(params, requests, eos_id=eos_id):
            out.setdefault(ev.uid, []).append(ev.token)
            if on_token is not None:
                on_token(ev)
        return {uid: np.asarray(toks, np.int32)
                for uid, toks in out.items()}


def _extras(cfg, rng, batch: int, prompt_len: int, device) -> dict:
    """The modality inputs of vision and enc-dec configs, bf16."""
    extras = {}
    if cfg.vision_tokens:
        extras["vision_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.vision_tokens, cfg.d_model)),
            device=device).to(torch.bfloat16)
    if cfg.is_encdec:
        extras["src_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, prompt_len, cfg.d_model)),
            device=device).to(torch.bfloat16)
    return extras


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine (paged KV store)")
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--quant", choices=("none", "int8"), default="none")
    ap.add_argument("--latency-slo-ms", type=float, default=None)
    ap.add_argument("--attn-method", default=None,
                    help="attention registry engine for the continuous "
                         "engine (fused_pallas | unfused_mma | vpu | "
                         "auto)")
    ap.add_argument("--norm-matmul-method", default=None,
                    help="norm_matmul registry engine for the fused "
                         "rmsnorm->matmul block boundary "
                         "(fused_pallas | unfused_mma | vpu | auto)")
    ap.add_argument("--warmup", action="store_true",
                    help="resolve the scoring plans and run the "
                         "bucketed prefill shapes before serving")
    ap.add_argument("--background-sweeps", action="store_true",
                    help="upgrade model-cost plans to measured plans "
                         "in a background sweep worker")
    ap.add_argument("--plan-store", default=None,
                    help="shared autotune plan-store JSON: merged in "
                         "at startup, saved (atomic, file-locked, "
                         "merge-on-save) at exit")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda | cpu)")
    args = ap.parse_args(argv)

    if args.plan_store:
        autotune.bind_default_registry(args.plan_store)

    from repro_torch.configs import registry
    cfg = registry.get_config(args.arch, smoke=not args.full)
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device=args.device).manual_seed(0),
                        args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)

    if args.continuous:
        eng = ContinuousServer(
            model, num_slots=args.num_slots, capacity=args.capacity,
            quant=args.quant, latency_slo_ms=args.latency_slo_ms,
            logprobs=args.latency_slo_ms is not None,
            attn_method=args.attn_method,
            norm_matmul_method=args.norm_matmul_method,
            background_sweeps=args.background_sweeps, device=args.device)
        with eng:
            if args.warmup:
                t0 = time.time()
                info = eng.warmup(params)
                print(f"warmup: {info['plans']} plans tuned, "
                      f"{info['prefill_compiles']} prefill shapes run "
                      f"in {time.time() - t0:.2f}s")
            reqs = [Request(uid=i, prompt=prompts[i],
                            max_new=args.max_new)
                    for i in range(args.batch)]
            t0 = time.time()
            outs = eng.generate(params, reqs)
            dt = time.time() - t0
        n = sum(len(t) for t in outs.values())
        print(f"continuous: {n} tokens from {len(reqs)} requests in "
              f"{dt:.2f}s ({n / dt:.1f} tok/s) on {args.device}")
        for uid in sorted(outs)[:2]:
            print(uid, outs[uid])
        if args.plan_store:
            autotune.default_registry().save(args.plan_store)
        return

    extras = _extras(cfg, rng, args.batch, args.prompt_len, args.device)
    srv = Server(model)
    t0 = time.time()
    toks = srv.generate(params, prompts, max_new=args.max_new,
                        extras=extras)
    dt = time.time() - t0
    print(f"generated {toks.shape} in {dt:.2f}s "
          f"({toks.size / dt:.1f} tok/s) on {args.device}")
    print(toks[:2])


if __name__ == "__main__":
    main()
