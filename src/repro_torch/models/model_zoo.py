"""Public model API: build(cfg) -> Model with init / loss / logits /
prefill / decode_step / input_specs for every architecture family — the
counterpart of ``repro.models.model_zoo``.

Batch layouts (tensors; ``input_specs`` gives their shapes and dtypes):
  train:   {tokens (B,S) i32, labels (B,S) i32, mask (B,S) f32}
           [+ vision_embeds (B,V,D) | src_embeds (B,S,D) for vlm/audio]
  prefill: {tokens (B,S)} [+ modality inputs]      -> (last logits, caches)
  decode:  {token (B,1), pos () or (B,), caches}   -> (logits, caches)

Every entry point runs where the parameters lie: ``init`` puts them on
the card unless it is asked for the CPU.  ``loss`` is the forward value;
its gradients come with training (ROADMAP item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.dispatch import default_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.param import (ShapeDtype, _map, axes_tree,
                                      count_params, init_tree, shapes_tree)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    specs: Any
    init: Callable          # (generator, device=None) -> params
    loss: Callable          # (params, batch) -> (loss, metrics)
    logits: Callable        # (params, batch) -> (B, S, V) full-seq logits
    prefill: Callable       # (params, batch) -> (logits, caches)
    decode_step: Callable   # (params, batch) -> (logits, caches)
    input_specs: Callable   # (shape_cfg) -> batch tree of ShapeDtype
    cache_specs: Callable   # (shape_cfg) -> caches tree of ShapeDtype

    def param_axes(self):
        return axes_tree(self.specs)

    def param_shapes(self):
        return shapes_tree(self.specs)

    def num_params(self) -> int:
        return count_params(self.param_shapes())


def _encoder_cfg(cfg):
    return dataclasses.replace(
        cfg, num_layers=cfg.encoder_layers, pattern=("global",),
        moe=None, mla=None, mtp=False, attn_softcap=None)


def _full_specs(cfg):
    specs = T.decoder_specs(cfg)
    if cfg.is_encdec:
        specs["encoder"] = T.backbone_specs(_encoder_cfg(cfg))
    return specs


def _beside(params, value, dtype=None):
    """``value`` (a tensor, array or number) as a tensor on the
    parameters' device."""
    return torch.as_tensor(value, device=params["embed"]["table"].device,
                           dtype=dtype)


def _memory(params, cfg, batch):
    """Cross-attention memory: encoder output (audio) or vision embeds."""
    if cfg.is_encdec:
        enc_cfg = _encoder_cfg(cfg)
        x, _, _ = T.decoder_forward(
            params["encoder"], enc_cfg, None, causal=False,
            inputs_embeds=_beside(params, batch["src_embeds"]))
        return x
    if cfg.vision_tokens:
        return _beside(params, batch["vision_embeds"]).to(cfg.compute_dtype)
    return None


def _mtp_loss(params, cfg, hidden, tokens, labels, mask):
    """DeepSeek MTP: one extra block predicts token t+2 from
    (h_t, embed(token_{t+1}))."""
    mp = params["mtp"]
    emb_next = L.embed_lookup(params["embed"], tokens, scale=False,
                              d=cfg.d_model,
                              compute_dtype=cfg.compute_dtype)
    # shift: h_t pairs with embedding of t+1 (== tokens shifted left)
    h = hidden[:, :-1]
    e = emb_next[:, 1:]
    z = torch.cat([h, e], dim=-1) @ mp["proj"].to(h.dtype)
    s = z.shape[1]
    z, _, _ = T.block_apply(mp["block"], cfg, T.LayerDesc("global", "dense"),
                            z, None,
                            positions=torch.arange(s, dtype=torch.int32,
                                                   device=z.device))
    z = L.apply_norm(mp["norm"], z, kind=cfg.norm_type,
                     method=cfg.reduce_method)
    logits = T.logits_from_hidden(params, cfg, z)
    # labels for t+2 = labels shifted left by one
    return T.cross_entropy(logits, labels[:, 1:], mask[:, 1:],
                           reduce_method=cfg.reduce_method)


def build(cfg) -> Model:
    specs = _full_specs(cfg)

    def init(gen: torch.Generator, device=None):
        """Parameters drawn from ``gen`` on ``device`` (default: the
        card, raising without one)."""
        return init_tree(gen, specs, device=default_device(device))

    def loss(params, batch):
        memory = _memory(params, cfg, batch)
        tokens = _beside(params, batch["tokens"])
        labels = _beside(params, batch["labels"])
        mask = _beside(params, batch["mask"], torch.float32)
        hidden, _, aux = T.decoder_forward(params, cfg, tokens,
                                           memory=memory)
        chunk = getattr(cfg, "ce_vocab_chunk", 0)
        if chunk:
            ce = T.chunked_cross_entropy(params, cfg, hidden, labels, mask,
                                         chunk=chunk)
        else:
            logits = T.logits_from_hidden(params, cfg, hidden)
            ce = T.cross_entropy(logits, labels, mask,
                                 reduce_method=cfg.reduce_method)
        total = ce
        metrics = {"ce": ce}
        if cfg.moe is not None:
            total = total + cfg.moe.aux_loss_weight * aux
            metrics["aux"] = aux
        if cfg.mtp:
            mtp = _mtp_loss(params, cfg, hidden, tokens, labels, mask)
            total = total + cfg.mtp_loss_weight * mtp
            metrics["mtp"] = mtp
        metrics["loss"] = total
        return total, metrics

    def logits_fn(params, batch):
        """Full-sequence teacher-forcing logits (B, S, V) — the scoring
        path.  Unlike ``prefill`` (which keeps only the last position for
        the decode loop), every position's logits survive; no caches are
        allocated."""
        memory = _memory(params, cfg, batch)
        hidden, _, _ = T.decoder_forward(
            params, cfg, _beside(params, batch["tokens"]), memory=memory)
        return T.logits_from_hidden(params, cfg, hidden)

    def prefill(params, batch, *, extra_capacity: int = 64):
        """Run the prompt; allocate caches with decode headroom."""
        memory = _memory(params, cfg, batch)
        tokens = _beside(params, batch["tokens"])
        b, s = tokens.shape
        mem_len = 0 if memory is None else memory.shape[1]
        caches = T.init_decoder_cache(cfg, b, s + extra_capacity, mem_len,
                                      device=tokens.device)
        hidden, caches, _ = T.decoder_forward(
            params, cfg, tokens, caches=caches, memory=memory)
        return T.logits_from_hidden(params, cfg, hidden[:, -1:]), caches

    def decode_step(params, batch):
        """One token for the whole batch against existing caches, which
        are written in place.

        ``pos`` is a scalar () when every row sits at the same position
        (the fixed-batch generate loop), or (B,) per-slot absolute
        positions (continuous batching: each slot serves its own request
        at its own depth).
        """
        pos = _beside(params, batch["pos"], torch.int32)
        positions = pos[:, None] if pos.ndim == 1 else pos[None]
        hidden, caches, _ = T.decoder_forward(
            params, cfg, _beside(params, batch["token"]), positions=positions,
            caches=batch["caches"], decode=True)
        return T.logits_from_hidden(params, cfg, hidden), caches

    def input_specs(shape_cfg):
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        extra = {}
        if cfg.vision_tokens:
            extra["vision_embeds"] = ShapeDtype(
                (b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        if cfg.is_encdec:
            extra["src_embeds"] = ShapeDtype((b, s, cfg.d_model),
                                             torch.bfloat16)
        if shape_cfg.kind == "train":
            return {"tokens": ShapeDtype((b, s), torch.int32),
                    "labels": ShapeDtype((b, s), torch.int32),
                    "mask": ShapeDtype((b, s), torch.float32), **extra}
        if shape_cfg.kind == "prefill":
            return {"tokens": ShapeDtype((b, s), torch.int32), **extra}
        # decode: token + pos + caches
        return {"token": ShapeDtype((b, 1), torch.int32),
                "pos": ShapeDtype((), torch.int32),
                "caches": cache_specs(shape_cfg)}

    def cache_specs(shape_cfg):
        """The caches' shapes and dtypes, made on the meta device (no
        memory is allocated)."""
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        mem_len = cfg.vision_tokens or (s if cfg.is_encdec else 0)
        caches = T.init_decoder_cache(cfg, b, s, mem_len, device="meta")
        return _map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), caches)

    return Model(cfg=cfg, specs=specs, init=init, loss=loss,
                 logits=logits_fn, prefill=prefill,
                 decode_step=decode_step, input_specs=input_specs,
                 cache_specs=cache_specs)
