"""Batched serving example: prefill and KV-cache decode for a batch of
heterogeneous requests (greedy) across three architecture families,
dense (gemma2), MoE + MLA (deepseek smoke) and recurrent (rwkv6), then
one continuous-batching pass over the paged int8 store (gemma2) — the
port of ``examples/serve_lm.py``.

    python -m repro_torch.examples.serve_lm                # on the card
    python -m repro_torch.examples.serve_lm --device cpu   # plain versions
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.precision import MmaPolicy
from repro_torch.data.pipeline import synthetic_requests
from repro_torch.launch.serve import ContinuousServer, Server, _extras
from repro_torch.models import model_zoo

ARCHS = ("gemma2-2b", "deepseek-v3-671b", "rwkv6-7b")


def _model(arch: str, device):
    cfg = registry.get_config(arch, smoke=True)
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    return cfg, model, params


def demo(arch: str, device, batch=4, prompt_len=12, max_new=12):
    cfg, model, params = _model(arch, device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    extras = _extras(cfg, rng, batch, prompt_len, device)
    srv = Server(model, temperature=0.0)
    t0 = time.time()
    out = srv.generate(params, prompts, max_new=max_new, extras=extras,
                       eos_id=0)
    dt = time.time() - t0
    print(f"{arch:18s} generated {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:5.2f}s; first row: {out[0][:8]}")


def continuous_demo(device, n=6, capacity=40):
    cfg, model, params = _model("gemma2-2b", device)
    reqs = list(synthetic_requests(cfg.vocab_size, n=n, seed=0, min_len=3,
                                   max_len=12, min_new=2, max_new=10,
                                   stagger=1))
    eng = ContinuousServer(model, num_slots=2, capacity=capacity,
                           page_size=8, quant="int8",
                           precision=MmaPolicy(split_words=2),
                           device=device)
    t0 = time.time()
    out = eng.generate(params, reqs)
    dt = time.time() - t0
    tokens = sum(len(t) for t in out.values())
    print(f"{'continuous int8':18s} {tokens} tokens from {len(reqs)} "
          f"requests over 2 slots in {dt:5.2f}s; uid 0: {out[0][:8]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the models run (cuda | cpu)")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        demo(arch, args.device)
    continuous_demo(args.device)


if __name__ == "__main__":
    main()
