"""Quickstart: the paper's chained-MMA reduction as a drop-in service —
the port of ``examples/quickstart.py``.

  1. reduce a million numbers three ways (the paper's three variants)
     and through kernel B1,
  2. check precision against the FP64 oracle (paper §5.4),
  3. let the autotuner pick the configuration (``method='auto'``),
  4. use the engine inside a tiny LM training step (loss + grad norm).

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu   # plain versions
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import registry
from repro_torch.core import autotune, global_norm, reduce_sum, tc_reduce
from repro_torch.core import theory
from repro_torch.core.dispatch import default_device
from repro_torch.core.integration import _leaves
from repro_torch.core.precision import (fp64_oracle, normal_input,
                                        percent_error)
from repro_torch.kernels import mma_reduce
from repro_torch.models import model_zoo


def train_step_numbers(device) -> tuple[float, float]:
    """A Gemma-2 2B SMOKE model's loss on a (2, 16) batch and the global
    norm of its gradients (both through the MMA engine)."""
    cfg = registry.get_config("gemma2-2b", smoke=True)
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen),
             "mask": torch.ones((2, 16))}
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return float(loss.detach()), float(global_norm(grads))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = default_device(ap.parse_args(argv).device)

    # --- 1. the three variants (paper §5) ---------------------------
    x = normal_input(1_000_000, seed=0)
    xt = torch.from_numpy(x).to(device)
    print("chained-MMA reduction of 1e6 numbers")
    print(f"  fp64 oracle         : {fp64_oracle(x):+.6f}")
    for variant in ("single_pass", "recurrence", "split"):
        got = float(tc_reduce(xt, variant=variant))
        print(f"  {variant:12s} (torch): {got:+.6f}  "
              f"err={percent_error(got, x):.2e}%")
    got = float(mma_reduce(xt))   # kernel B1 (its plain version on the CPU)
    print(f"  single_pass (B1)    : {got:+.6f}  "
          f"err={percent_error(got, x):.2e}%")

    # --- 2. theory (paper §4.2) -------------------------------------
    print(f"\nPRAM speedup S=(4/5)log2(m^2): m=4 -> {theory.speedup(4)}"
          f" (paper: 3.2x measured), m=16 (Hopper mma tile) -> "
          f"{theory.speedup(16)}")

    # --- 3. autotuned dispatch (the R-vs-B search made automatic) ----
    got = float(reduce_sum(xt, method="auto"))
    plan = autotune.get_plan(xt.numel(), xt.dtype, op="reduce_sum",
                             backend=xt.device.type)
    print(f"\nmethod='auto'       : {got:+.6f}  via plan "
          f"[{plan.method} variant={plan.variant} R={plan.chain} "
          f"B={plan.block_rows} source={plan.source}]")

    # --- 4. inside a training step ----------------------------------
    loss, gnorm = train_step_numbers(device)
    print(f"\ntiny-LM loss (MMA-reduced mean) : {loss:.4f}")
    print(f"grad global-norm (MMA-reduced)  : {gnorm:.4f}")


if __name__ == "__main__":
    main()
