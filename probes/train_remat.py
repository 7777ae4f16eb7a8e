"""Where a training step's time and memory go, by remat policy: Gemma-2
2B at full width (all 26 layers unless ``--layers`` cuts depth), f32
params and moments, a fixed batch of 2 x 1024 from
``SyntheticLMData(seed=0)``, on the card.

For each of ``none`` / ``full`` / ``dots`` / ``dots_tagged``: the median
ms (CUDA events, ``--reps`` after two warm calls) of the forward loss
alone (no grad), of ``launch.train.loss_and_grads`` and of the whole
train step (clip, AdamW, the parameter norm); one step's device time
under ``torch.profiler`` (every CUDA event of the trace) and its share
of the median step; the ops a step dispatches (a ``TorchDispatchMode``
count over one step); the peak memory of a whole step, and where it
lies: the memory held after the forward pass (its saved activations
alive), the peak while the loss and gradients are taken, the memory
held with the gradients, and the peak of the AdamW update beside them.
Prints one line a policy beside the card's name and power limit, and
writes ``chiprun_out/train_remat.json``.

    python3 probes/train_remat.py [--layers 26] [--reps 5] \
        [--policies none,full,dots,dots_tagged]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3


def dispatched_ops(fn) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def measure(policy: str, args, row: dict) -> None:
    """Fills ``row`` stage by stage (an out-of-memory error leaves the
    stages reached)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.integration import _leaves
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import train as trainlib
    from repro_torch.models import model_zoo
    from repro_torch.optim import adamw
    gib = 2**30
    cfg = dataclasses.replace(registry.get_config("gemma2-2b"),
                              num_layers=args.layers, remat=policy)
    model = model_zoo.build(cfg)
    batch = SyntheticLMData(cfg, ShapeConfig("t", 1024, 2, "train"),
                            seed=0, device="cuda").batch_at(0)
    step, make_init = trainlib.make_train_step(
        model, TrainConfig(total_steps=1000, warmup_steps=1),
        device="cuda")
    state = make_init(0)

    def forward():
        with torch.no_grad():
            model.loss(state.params, batch)

    def grads():
        trainlib.loss_and_grads(model, state.params, batch)

    def whole():
        nonlocal state
        state, _ = step(state, batch)

    row["state_gib"] = torch.cuda.memory_allocated() / gib
    # where the peak lies: after the forward pass, while the loss and
    # gradients are taken, and in the update beside them
    for p in _leaves(state.params):
        p.requires_grad_(True)
    row["stage"] = "forward"
    loss, metrics = model.loss(state.params, batch)
    torch.cuda.synchronize()
    row["after_forward_gib"] = torch.cuda.memory_allocated() / gib
    del loss, metrics           # both hold the graph
    row["stage"] = "loss and grads"
    torch.cuda.reset_peak_memory_stats()
    _, _, g = trainlib.loss_and_grads(model, state.params, batch)
    torch.cuda.synchronize()
    row["grads_peak_gib"] = torch.cuda.max_memory_allocated() / gib
    row["with_grads_gib"] = torch.cuda.memory_allocated() / gib
    row["stage"] = "update"
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        adamw.update(g, state.opt, state.params, lr=1e-4)
    torch.cuda.synchronize()
    row["update_peak_gib"] = torch.cuda.max_memory_allocated() / gib
    del g
    row["stage"] = "timing"
    torch.cuda.reset_peak_memory_stats()
    row["forward_ms"] = median_ms(forward, args.reps)
    row["grads_ms"] = median_ms(grads, args.reps)
    row["step_ms"] = median_ms(whole, args.reps)
    row["step_device_ms"] = device_ms(whole)
    row["busy_share"] = row["step_device_ms"] / row["step_ms"]
    row["ops_a_step"] = dispatched_ops(whole)
    row["peak_gib"] = torch.cuda.max_memory_allocated() / gib
    row["stage"] = "done"


def main() -> int:
    from repro_torch.models.remat import POLICIES
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=26)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--policies", default=",".join(POLICIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_remat: needs a CUDA card", file=sys.stderr)
        return 2
    card = smi()
    rows = []
    for policy in args.policies.split(","):
        gc.collect()            # the last policy's graph, if a cycle held it
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = {"policy": policy, "layers": args.layers, "card": card}
        rows.append(row)
        try:
            measure(policy, args, row)
        except torch.OutOfMemoryError:
            # the stage it reached, and the most it held on the way
            row["out_of_memory_in"] = row.pop("stage")
            row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            print(f"train_remat: {policy:11s} {args.layers} layers: out "
                  f"of memory in the {row['out_of_memory_in']} stage "
                  f"(held {row['peak_gib']:.2f} GiB at most; state "
                  f"{row['state_gib']:.2f}, after the forward "
                  f"{row.get('after_forward_gib', 0):.2f}); on {card}",
                  flush=True)
            continue
        print(f"train_remat: {policy:11s} {args.layers} layers: forward "
              f"{row['forward_ms']:.4f} ms, loss and grads "
              f"{row['grads_ms']:.4f}, step {row['step_ms']:.4f} (device "
              f"{row['step_device_ms']:.4f}, busy {row['busy_share']:.3f}),"
              f" {row['ops_a_step']} ops dispatched a step, peak "
              f"{row['peak_gib']:.2f} GiB (state {row['state_gib']:.2f}, "
              f"after the forward {row['after_forward_gib']:.2f}, loss and "
              f"grads peak {row['grads_peak_gib']:.2f}, with the grads "
              f"{row['with_grads_gib']:.2f}, update peak "
              f"{row['update_peak_gib']:.2f}); on {card}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_remat.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
