"""Host time a call of the kernel entries that ``kernels.ops`` also
registers as ``torch.library`` ops (B1's single pass, B8, B9, B10), on
the card: the wall time of one call, timed call by call with no
synchronize between calls (the launches queue on the stream), after
warm-up; the lowest of five medians of 1000 calls.

With ``--ops`` it also times, in one process and round by round in
turn, three routes to the same kernel wrapper on the same prepared
arguments: the wrapper called directly, the tree's ``custom_op``
(``torch.ops.repro_torch.*``, where the tree has it), and the same
schema defined with ``torch.library.Library`` and bound with ``impl``
to the CUDA key alone (namespace ``repro_probe``).

    python probes/wrapper_host_us.py [--root TREE] [--ops] [--out FILE]
        [--build-only]

``--root`` runs the entries of another checkout (its ``src``), so two
trees can be compared in one call on one card.  Prints one JSON line:
``{"root": ..., "us": {entry: us}, "routes_us": {route: {entry: us}}}``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import sys
import time

import torch

CALLS = 1000
ROUNDS = 5
WARMUP = 200


def median_us(call, rounds: int = ROUNDS) -> float:
    """The lowest of ``rounds`` medians of CALLS calls each (the
    collector off), in us."""
    for _ in range(WARMUP):
        call()
    torch.cuda.synchronize()
    medians = []
    gc.disable()
    try:
        for _ in range(rounds):
            times = []
            for i in range(CALLS):
                t0 = time.perf_counter()
                call()
                times.append(time.perf_counter() - t0)
                if i % 256 == 255:          # keep the queue short
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            medians.append(statistics.median(times) * 1e6)
    finally:
        gc.enable()
    return min(medians)


SCHEMAS = {
    "b1_single_pass": "(Tensor x, int chain, int block_rows, bool square)"
                      " -> Tensor",
    "b8_rmsnorm": "(Tensor x2d, Tensor weight, float eps, "
                  "float weight_offset) -> Tensor",
    "b10_norm_matmul": "(Tensor x2d, Tensor scale, Tensor w, Tensor? "
                       "w_gate, Tensor? bias, str? act, float eps) -> Tensor",
    "b9_attention": "(Tensor qg, Tensor k, Tensor v, Tensor qpos, "
                    "bool causal, int? window, Tensor? kv_len, float scale, "
                    "float? cap) -> Tensor",
}


def time_routes(x1, x8, w8, x10, s10, w10, qg, kv, qpos) -> dict:
    """Each entry's wrapper by the three routes (see the module
    docstring), ROUNDS rounds of CALLS calls a route in turn; the median
    of each route's round medians, in us."""
    # the package exports the entries under the modules' names
    ma, mnm, mr, mrn = (importlib.import_module(f"repro_torch.kernels.{m}")
                        for m in ("mma_attention", "mma_norm_matmul",
                                  "mma_reduce", "mma_rmsnorm"))
    wrappers = {
        "b1_single_pass": lambda x, chain, block_rows, square:
            mr.single_pass_cuda(x, chain=chain, block_rows=block_rows,
                                square=square),
        "b8_rmsnorm": lambda x2d, weight, eps, weight_offset:
            mrn.rmsnorm_cuda(x2d, weight, eps=eps,
                             weight_offset=weight_offset),
        "b10_norm_matmul": lambda x2d, scale, w, w_gate, bias, act, eps:
            mnm.norm_matmul_cuda(x2d, scale, w, w_gate=w_gate, bias=bias,
                                 act=act, eps=eps),
        "b9_attention": lambda qg, k, v, qpos, causal, window, kv_len,
        scale, cap: ma.attention_cuda(qg, k, v, qpos=qpos, causal=causal,
                                      window=window, kv_len=kv_len,
                                      scale=scale, cap=cap),
    }
    lib = torch.library.Library("repro_probe", "DEF")
    for name, schema in SCHEMAS.items():
        lib.define(name + schema)
        lib.impl(name, wrappers[name], "CUDA")
    q9 = qpos.expand(qg.shape[0], qg.shape[1]).contiguous()
    argv = {
        "b1_single_pass": (x1.reshape(-1), 4, 128, True),
        "b8_rmsnorm": (x8, w8, 1e-6, 0.0),
        "b10_norm_matmul": (x10, s10, w10, w10, None, "gelu", 1e-6),
        "b9_attention": (qg, kv, kv, q9, False, None, None, 256 ** -0.5,
                         None),
    }
    routes = {"direct": wrappers,
              "library_impl": {n: getattr(torch.ops.repro_probe, n)
                               for n in SCHEMAS}}
    if hasattr(torch.ops.repro_torch, "b8_rmsnorm"):
        routes["custom_op"] = {n: getattr(torch.ops.repro_torch, n)
                               for n in SCHEMAS}
    medians: dict = {r: {n: [] for n in SCHEMAS} for r in routes}
    for _ in range(ROUNDS):
        for name, a in argv.items():
            for route, fns in routes.items():
                medians[route][name].append(
                    median_us(lambda f=fns[name], a=a: f(*a), rounds=1))
    return {r: {n: statistics.median(v) for n, v in by.items()}
            for r, by in medians.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--build-only", action="store_true",
                    help="build the four libraries and exit")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import _build, ops
    _build.build_all(["mma_reduce", "mma_rmsnorm", "mma_norm_matmul",
                      "mma_attention"])
    if args.build_only:
        return

    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    # B8 at a decode step of 64 slots at Gemma-2 2B's width, B10 at
    # 128 rows (decode_32k's batch) of its MLP, B9 at a decode step of
    # 128 rows over 4096 keys, B1 over 2^20 values (a clip's leaf)
    x8, w8 = t(64, 2304), t(2304, dtype=torch.float32)
    x10, s10, w10 = t(128, 2304), t(2304, dtype=torch.float32), \
        t(2304, 9216)
    qg, kv = t(128, 1, 4, 2, 256), t(128, 4096, 4, 256)
    qpos = torch.full((128, 1), 4095, dtype=torch.int32, device="cuda")
    x1 = t(1 << 20, dtype=torch.float32)
    entries = {
        "b1_squared_sum": lambda: ops.mma_squared_sum(x1, chain=4,
                                                      block_rows=128),
        "b8_rmsnorm": lambda: ops.mma_rmsnorm(x8, w8),
        "b10_norm_matmul": lambda: ops.mma_norm_matmul(
            x10, s10, w10, w_gate=w10, act="gelu"),
        "b9_attention": lambda: ops.mma_attention(qg, kv, kv, qpos=qpos),
    }
    out = {"root": os.path.abspath(args.root),
           "card": torch.cuda.get_device_name(0),
           "us": {name: median_us(call) for name, call in entries.items()}}
    if args.ops:
        out["routes_us"] = time_routes(x1, x8, w8, x10, s10, w10, qg, kv,
                                       qpos)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
