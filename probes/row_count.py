"""Does a row's sum depend on how many rows came with it?  The row-count
probe behind ``core.reduction._ROW_TILE``, on the device it runs on
(the CPU by default; ``--device cuda`` on the card).

  * ``tc_reduce_lastdim`` (the ``mma`` engine's row sums, which the
    default norms take) of f32 squares of bf16 values: for each of 200
    random rows, the sum at 1 row against the same row's sum among 2,
    with the rows padded to a multiple of ``_ROW_TILE`` (as committed)
    and without padding (``_ROW_TILE = 1``, as before the repair);
  * the ``vpu`` attention's per-head ``bmm`` at a decode step's shape
    over 1024 keys (a (2, 1024) by (1024, 256) product a batch item), in
    f32 and bf16: of 30 draws of 4 items, and of 2 draws of 64, the
    items whose product at batch 1 differs from the same item's in the
    batch (torch's batched product; ``core.reduction.bmm_items`` runs
    one item a call for this reason), and on the card the ms of one
    ``bmm_items`` against one batched product at 4, 16 and 64 items
    (CUDA events, median of 20 after 3 warm calls);
  * the continuous engine over the paged int8 store against each
    request alone (Gemma-2 2B at SMOKE size, ``attn_method=
    'fused_pallas'``, two slots, the request stream of seed 7: of seeds
    0-7 with these parameters, the one whose unpadded stream meets the
    fault on the CPU): the logits rows whose bits differ, padded and
    unpadded.

    PYTHONPATH=src python3 probes/row_count.py [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import reduction
from repro_torch.data.pipeline import synthetic_requests
from repro_torch.launch import serve
from repro_torch.models import model_zoo

ROWS = 200
CAP = 40


def rows_apart(d: int, device) -> int:
    """Of ROWS random rows, those whose sum at 1 row differs from its
    sum beside a second row."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(ROWS, 2, d)).astype(np.float32))
    x = (x.to(torch.bfloat16).to(torch.float32) ** 2).to(device)
    return sum(not torch.equal(reduction.tc_reduce_lastdim(x[r])[0],
                               reduction.tc_reduce_lastdim(x[r, :1])[0])
               for r in range(ROWS))


def bmm_items_apart(device, dtype, n: int, draws: int) -> int:
    gen = torch.Generator(device=device).manual_seed(1)
    apart = 0
    for _ in range(draws):
        a = torch.randn(n, 2, 1024, generator=gen, device=device).to(dtype)
        b = torch.randn(n, 1024, 256, generator=gen,
                        device=device).to(dtype)
        full = reduction._bmm(a, b)
        apart += sum(not torch.equal(full[i], reduction._bmm(
            a[i:i + 1], b[i:i + 1])[0]) for i in range(n))
    return apart


def bmm_items_ms(n: int) -> tuple:
    """(bmm_items ms, one batched product's ms) at n items, bf16."""
    import statistics
    gen = torch.Generator(device="cuda").manual_seed(2)
    a = torch.randn(n, 2, 1024, generator=gen, device="cuda").bfloat16()
    b = torch.randn(n, 1024, 256, generator=gen, device="cuda").bfloat16()
    out = []
    for fn in (reduction.bmm_items, reduction._bmm):
        for _ in range(3):
            fn(a, b)
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(a, b)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out.append(statistics.median(times))
    return tuple(out)


def served_rows_apart(device) -> tuple:
    """(rows, rows with other bits, max |diff|) of the continuous engine
    against each request alone."""
    cfg = dataclasses.replace(registry.get_config("gemma2-2b", smoke=True),
                              attn_method="fused_pallas")
    model = model_zoo.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    reqs = [serve.Request(**d) for d in synthetic_requests(
        cfg.vocab_size, n=6, seed=7, min_len=3, max_len=12, min_new=2,
        max_new=8, stagger=1)]
    eng = serve.ContinuousServer(model, num_slots=2, capacity=CAP,
                                 page_size=8, quant="int8", device=device)
    rows, pick, picks = {}, eng._pick, eng._picks

    def one(row, uid, index):
        rows[(uid, index)] = row.clone()
        return pick(row, uid, index)

    def many(last, slots):
        for s, st in slots.items():
            rows[(st.uid, st.n_out)] = last[s].clone()
        return picks(last, slots)
    eng._pick, eng._picks = one, many
    eng.generate(params, reqs)
    apart, worst = 0, 0.0
    for r in reqs:
        srv = serve.Server(eng.model, extra_capacity=CAP - len(r.prompt))
        seen, sample = [], srv._sample

        def spy(logits, seed, step, sample=sample, seen=seen):
            seen.append(logits[0, -1].clone())
            return sample(logits, seed, step)
        srv._sample = spy
        got = srv.generate(params, r.prompt[None], max_new=r.max_new)[0]
        for i in range(len(got)):
            if not torch.equal(rows[(r.uid, i)], seen[i]):
                apart += 1
                worst = max(worst, float(torch.max(torch.abs(
                    rows[(r.uid, i)] - seen[i]))))
    return len(rows), apart, worst


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    committed = reduction._ROW_TILE
    for tile, what in ((committed, f"padded to {committed} rows"),
                       (1, "unpadded")):
        reduction._ROW_TILE = tile
        sums = {d: rows_apart(d, args.device) for d in (64, 256, 2304)}
        n, apart, worst = served_rows_apart(args.device)
        print(f"{what}: rows of tc_reduce_lastdim with other bits at 1 row "
              f"than beside a second, of {ROWS}: {sums}; the continuous "
              f"engine's logits rows with other bits than the request "
              f"alone: {apart} of {n}, max |diff| {worst}")
    reduction._ROW_TILE = committed
    for dtype in (torch.float32, torch.bfloat16):
        print(f"vpu attention's bmm over 1024 keys, {dtype}: "
              f"{bmm_items_apart(args.device, dtype, 4, 30)} of 120 items "
              f"with other bits at batch 1 than at 4, "
              f"{bmm_items_apart(args.device, dtype, 64, 2)} of 128 than "
              f"at 64")
    if args.device == "cuda":
        for n in (4, 16, 64):
            one, batched = bmm_items_ms(n)
            print(f"bmm_items at {n} items, bf16: {one:.4f} ms against "
                  f"{batched:.4f} ms for one batched product")


if __name__ == "__main__":
    main()
