"""Does a row's sum depend on how many rows came with it?  The row-count
probe behind ``core.reduction._ROW_TILE``, on the device it runs on
(the CPU by default; ``--device cuda`` on the card).

  * ``tc_reduce_lastdim`` (the ``mma`` engine's row sums, which the
    default norms take) of f32 squares of bf16 values: for each of 200
    random rows, the sum at 1 row against the same row's sum among 2,
    with the rows padded to a multiple of ``_ROW_TILE`` (as committed)
    and without padding (``_ROW_TILE = 1``, as before the repair);
  * the ``vpu`` attention's per-head ``bmm`` at a decode step's shape
    over 1024 keys (a (2, 1024) by (1024, 256) product a batch item):
    of 30 draws of 4 items, the items whose product at batch 1 differs
    from the same item's at batch 4 (not padded; reported only);
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


def bmm_items_apart(device) -> int:
    gen = torch.Generator(device=device).manual_seed(1)
    apart = 0
    for _ in range(30):
        a = torch.randn(4, 2, 1024, generator=gen, device=device)
        b = torch.randn(4, 1024, 256, generator=gen, device=device)
        full = torch.bmm(a, b)
        apart += sum(not torch.equal(full[i], torch.bmm(a[i:i + 1],
                                                        b[i:i + 1])[0])
                     for i in range(4))
    return apart


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
        print(torch.cuda.get_device_name(0))
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
    print(f"vpu attention's bmm over 1024 keys: {bmm_items_apart(args.device)}"
          f" of 120 batch items with other bits at batch 1 than at 4")


if __name__ == "__main__":
    main()
