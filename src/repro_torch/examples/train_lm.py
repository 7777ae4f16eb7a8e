"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
on the synthetic bigram pipeline, with checkpointing and restart — the
port of ``examples/train_lm.py``.

    python -m repro_torch.examples.train_lm [--steps 300]     # on the card
    python -m repro_torch.examples.train_lm --device cpu --steps 4 \
        --batch 2 --seq 16

The model is a scaled Gemma-2-family config (~100M params), registered
in the port's config registry as ``gemma2-100m``; every arithmetic
reduction in the loop (the loss mean, the gradient global norm, the
RMSNorm statistics) goes through the paper's MMA engine.  Without
``--ckpt-dir`` the checkpoints go to a temporary directory, deleted at
the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
import tempfile
import types

from repro_torch.configs import registry

NAME = "gemma2-100m"


def build_100m():
    base = registry.get_config("gemma2-2b")
    return dataclasses.replace(
        base, name=NAME, num_layers=14, d_model=640,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2560,
        vocab_size=32_768, window=256)


def register(cfg) -> None:
    """Make ``cfg`` resolvable as ``NAME`` by the port's registry (its
    FULL and SMOKE alike)."""
    mod = types.ModuleType("repro_torch.configs._train_lm_example")
    mod.FULL = mod.SMOKE = cfg
    sys.modules[mod.__name__] = mod
    registry._MODULES[NAME] = mod.__name__


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.launch import train as trainlib
    from repro_torch.models import model_zoo

    cfg = build_100m()
    register(cfg)
    n = model_zoo.build(cfg).num_params()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_lm_")
    try:
        _, history = trainlib.run(
            NAME, steps=args.steps, smoke=True,
            batch_override=args.batch, seq_override=args.seq,
            ckpt_dir=ckpt_dir, log_every=max(1, min(20, args.steps // 4)),
            save_every=100, device=args.device)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    first, last = history[0][1], history[-1][1]
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return history


if __name__ == "__main__":
    main()
