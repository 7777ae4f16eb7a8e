"""Synthetic deterministic data pipeline — the counterpart of
``repro.data.pipeline``.

Batches come from a counter-based generator (stateless in ``step``), so
any worker can regenerate any step's batch, and a background thread
prefetches them.  ``RunningStats`` tracks stream-level statistics on the
ones-MMA path (``integration.reduce_sum`` / ``squared_sum``) and the
cumulative token budget on the triangular-MMA scan
(``integration.cumsum``); ``mask_positions`` derives packed position ids
from a mask with ``integration.masked_cumsum``.  ``synthetic_requests``
is numpy only and yields the reference's requests value for value.

Batches go to one device (the card unless the caller names another).
Given a ``sharding`` (a ``distributed.sharding.NamedSharding`` over a
mesh of ranks; the train CLI passes ``P(("data",))``) each rank draws
the same global batch from the seed and keeps its rows of it: the
reference's host-sharded loading.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core import integration as ci
from repro_torch.core.autotune import bucket_cap
from repro_torch.distributed import sharding as shd


class RunningStats:
    """Streaming statistics over the batch stream, on the MMA path.

    A step's valid tokens and each sequence's fill come from one per-row
    reduction of the mask (``reduce_sum(mask, axis=-1)``; an engine that
    cannot serve an axis subset falls back to ``vpu``); the summary sums
    the per-step history and its squares with ``method``, and the
    cumulative budget is its prefix scan.  Accumulators are f32.
    """

    def __init__(self, *, method: str = "mma"):
        self.method = method
        self._tokens_per_step: list[float] = []
        self._min_fill: float = float("inf")
        self._max_fill: float = 0.0
        self._device = None

    @property
    def steps(self) -> int:
        return len(self._tokens_per_step)

    def update(self, batch: dict) -> float:
        """Record one batch; returns its valid-token count."""
        mask = dispatch.as_tensor(batch["mask"])
        self._device = mask.device
        if mask.ndim >= 2:
            row_method = dispatch.resolve_method(
                "reduce_sum", mask, self.method, fallback="vpu",
                axis=(mask.ndim - 1,))
            fills = ci.reduce_sum(mask, axis=-1, method=row_method) \
                .cpu().numpy()
            self._min_fill = min(self._min_fill, float(fills.min()))
            self._max_fill = max(self._max_fill, float(fills.max()))
            tokens = float(fills.sum())
        else:
            tokens = float(ci.reduce_sum(mask, method=self.method))
        self._tokens_per_step.append(tokens)
        return tokens

    def _history(self) -> torch.Tensor:
        return torch.tensor(np.asarray(self._tokens_per_step, np.float32),
                            device=self._device)

    def cumulative_tokens(self) -> np.ndarray:
        """Inclusive running token budget after each recorded step."""
        if not self._tokens_per_step:
            return np.zeros((0,), np.float32)
        return ci.cumsum(self._history(), method=self.method).cpu().numpy()

    def summary(self) -> dict:
        """Totals and mean / std of tokens per step (f32 accumulators)."""
        if not self._tokens_per_step:
            return {"steps": 0, "total_tokens": 0.0,
                    "mean_tokens": 0.0, "std_tokens": 0.0}
        hist = self._history()
        total = float(ci.reduce_sum(hist, method=self.method))
        mean = total / self.steps
        sq = float(ci.squared_sum(hist, method=self.method))
        var = max(sq / self.steps - mean * mean, 0.0)
        out = {"steps": self.steps, "total_tokens": total,
               "mean_tokens": mean, "std_tokens": float(np.sqrt(var))}
        if self._max_fill > 0.0:
            out["min_seq_tokens"] = self._min_fill
            out["max_seq_tokens"] = self._max_fill
        return out


def synthetic_requests(vocab_size: int, *, n: int, seed: int = 0,
                       min_len: int = 4, max_len: int = 16,
                       min_new: int = 1, max_new: int = 16,
                       stagger: int = 0,
                       bucket: Optional[str] = None) -> Iterator[dict]:
    """Deterministic ragged request stream for the serving engine.

    Yields ``n`` dicts ``{"uid", "prompt", "max_new"}``: prompt lengths
    uniform in [min_len, max_len], output budgets in [min_new, max_new];
    ``stagger`` shifts each budget by its uid (modulo the range) so that
    neighbours finish at different steps.  Request ``uid`` regenerates
    its payload from (seed, uid).  ``bucket`` (an autotune bucket
    policy, e.g. ``'pow2'``) rounds each prompt length up to its bucket
    cap, clamped to ``max_len``, so prefill shapes land on tuned
    buckets.  Consumed directly by
    ``repro_torch.launch.serve.ContinuousServer.serve``.
    """
    for uid in range(n):
        rng = np.random.default_rng(np.random.SeedSequence([seed, uid]))
        length = int(rng.integers(min_len, max_len + 1))
        if bucket is not None:
            length = min(bucket_cap(length, bucket), max_len)
        budget = int(rng.integers(min_new, max_new + 1))
        if stagger:
            budget = min_new + (budget - min_new + uid) % \
                max(max_new - min_new + 1, 1)
        yield {
            "uid": uid,
            "prompt": rng.integers(0, vocab_size, length).astype(np.int32),
            "max_new": budget,
        }


def mask_positions(mask) -> torch.Tensor:
    """Packed position ids from a (B, S) mask: each valid token's index
    among the valid tokens of its row (an exclusive masked prefix scan on
    the triangular-MMA path).  int32, same shape, on the mask's
    device."""
    mask = dispatch.as_tensor(mask)
    pos = ci.masked_cumsum(torch.ones_like(mask), mask, axis=-1,
                           inclusive=False, method="mma")
    return pos.to(torch.int32)


class SyntheticLMData:
    """Deterministic LM batches (a stochastic bigram language, so a
    training loss falls) for ``cfg`` at ``shape_cfg``'s global batch and
    sequence length, on ``device`` (default: the card).  With a
    ``sharding``, ``batch_at`` gives this rank's block of each leaf (the
    spec's entries from the leading dimension on)."""

    def __init__(self, cfg, shape_cfg, *, seed: int = 0, sharding=None,
                 with_positions: bool = False, device=None):
        self.cfg = cfg
        self.shape = shape_cfg
        self.seed = seed
        self.sharding = sharding
        self.with_positions = with_positions
        self.device = dispatch.default_device(device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int) -> dict:
        """Regenerate the global batch for ``step`` (deterministic)."""
        cfg, sh = self.cfg, self.shape
        rng = self._rng(step)
        b, s = sh.global_batch, sh.seq_len
        order = rng.permutation(cfg.vocab_size)
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
        noise = rng.random((b, s)) < 0.15
        rand = rng.integers(0, cfg.vocab_size, (b, s))
        for t in range(s):
            nxt = order[toks[:, t] % cfg.vocab_size]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((b, s), np.float32),
        }
        if cfg.vision_tokens:
            batch["vision_embeds"] = rng.standard_normal(
                (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.is_encdec:
            batch["src_embeds"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
        out = self._put(batch)
        if self.with_positions:
            out["positions"] = mask_positions(out["mask"])
        return out

    def _put(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.sharding is not None:
                t = shd.local_shard(t, self.sharding.spec,
                                    self.sharding.mesh)
            out[k] = t.to(self.device, copy=True)
        return out

    def iter(self, start_step: int = 0, prefetch: int = 2
             ) -> Iterator[dict]:
        """Prefetching iterator from ``start_step`` (for resume).

        Shutdown is cooperative: the worker only blocks in a timed put,
        so it re-checks the stop event even when the consumer abandons
        the iterator with a full queue; the ``finally`` sets the event,
        drains the queue to unblock a put in flight, and joins the
        worker.
        """
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                item = self.batch_at(step)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            while True:           # unblock a put racing the flag
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
