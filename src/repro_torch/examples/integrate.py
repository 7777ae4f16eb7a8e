"""Numerical integration on the dd engine family: the f64-equivalent
budget tier in action — the port of ``examples/integrate.py``.

Two estimators whose accuracy is limited only by the accumulation:

  * composite Simpson quadrature of f(x) = cos(2.5 x) on [0, pi]
    (closed form sin(2.5 pi) / 2.5), 2^20 + 1 points;
  * a Monte-Carlo estimate of pi via 4 / (1 + x^2) on [0, 1], 2^20
    samples (seed 7), gated against the f64 sum of the same samples.

The f64 terms go through ``reduce_sum(..., method='auto')`` under
``precision.F64_EQUIVALENT``, which only the double-double engines meet
(``--method pallas_dd`` forces kernel B5);
the (hi, lo) pair collapses through ``dd_value``.  The same terms in f32
through ``mma`` and the compensated ``mma_ec`` must fail the 1e-12
relative gate that the dd engines pass.  torch has f64 without a
process-wide switch, so nothing global is flipped.

    python -m repro_torch.examples.integrate                # on the card
    python -m repro_torch.examples.integrate --device cpu   # plain versions

Exits 0 when the gate separates the families, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.integration import reduce_sum
from repro_torch.core.precision import F64_EQUIVALENT, dd_value

N_QUAD = (1 << 20) + 1          # Simpson needs an odd point count
N_MC = 1 << 20
SEED = 7
GATE_REL = 1e-12                # only the dd family passes this
DD_METHODS = ("auto", "pallas_dd")


def simpson_weights(n: int, h: float) -> np.ndarray:
    """Composite Simpson weights for n (odd) points at spacing h."""
    w = np.full(n, 2.0)
    w[1::2] = 4.0
    w[0] = w[-1] = 1.0
    return w * (h / 3.0)


def quadrature_terms() -> tuple:
    """(terms, exact): weighted f64 samples of cos(2.5 x) on [0, pi]
    and the closed-form integral sin(2.5 pi) / 2.5."""
    xs = np.linspace(0.0, np.pi, N_QUAD)
    h = xs[1] - xs[0]
    terms = np.cos(2.5 * xs) * simpson_weights(N_QUAD, h)
    return terms, float(np.sin(2.5 * np.pi) / 2.5)


def monte_carlo_terms(seed: int = SEED) -> np.ndarray:
    """f64 Monte-Carlo terms for pi = integral of 4/(1+x^2) on [0, 1]."""
    xs = np.random.default_rng(seed).random(N_MC)
    return 4.0 / (1.0 + xs * xs) / N_MC


def dd_sum(terms: np.ndarray, device: str, method: str) -> float:
    """The f64 terms through a dd engine (``auto`` must resolve one:
    nothing else meets the 1e-10 % budget); the pair collapses in f64."""
    out = reduce_sum(torch.from_numpy(terms).to(device), method=method,
                     precision=F64_EQUIVALENT)
    if out.shape != (2,):
        raise RuntimeError(f"a dd engine returns a (2,) pair, got "
                           f"{tuple(out.shape)}")
    return dd_value(out)


def f32_sum(terms: np.ndarray, device: str, method: str) -> float:
    """The same sum in f32 through an f32-scalar engine — the baseline
    whose error fails the gate."""
    x = torch.from_numpy(terms.astype(np.float32)).to(device)
    return float(reduce_sum(x, method=method))


def resolved_plans() -> list:
    """(key, plan) rows the auto path cached for the reduce_sum op."""
    return [(k, p) for k, p in autotune.default_registry().items()
            if k.startswith("reduce_sum")]


def run(device: str = "cuda", method: str = "auto") -> dict:
    """Both estimators through the dd ``method`` and through ``mma`` and
    ``mma_ec``; returns {estimator: {engine: relative error}}, the
    plans ``auto`` resolved, and whether the gate separated them."""
    if method not in DD_METHODS:
        raise ValueError(f"method must be one of {DD_METHODS}")
    terms, exact = quadrature_terms()
    mc = monte_carlo_terms()
    rows = {}
    for name, t, truth in (("simpson", terms, exact),
                           ("monte_carlo", mc, float(np.sum(mc)))):
        ests = {f"dd:{method}": dd_sum(t, device, method),
                "mma": f32_sum(t, device, "mma"),
                "mma_ec": f32_sum(t, device, "mma_ec")}
        rows[name] = {k: abs(v - truth) / abs(truth)
                      for k, v in ests.items()}
        rows[name]["truth"] = truth
    plans = resolved_plans()
    dd_key = f"dd:{method}"
    passed = all(r[dd_key] <= GATE_REL and r["mma"] > GATE_REL
                 and r["mma_ec"] > GATE_REL for r in rows.values())
    if method == "auto":
        passed = passed and any(p.method in ("mma_dd", "pallas_dd")
                                for k, p in plans if "|prec:" in k)
    return {"errors": rows, "plans": plans, "passed": passed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sums run (default: the card)")
    ap.add_argument("--method", default="auto", choices=DD_METHODS,
                    help="the dd-tier engine (default: auto)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return 2
    got = run(args.device, args.method)
    for name, errs in got["errors"].items():
        print(f"{name} (truth {errs['truth']:+.15f}):")
        for engine, rel in errs.items():
            if engine == "truth":
                continue
            verdict = "PASS" if rel <= GATE_REL else "FAIL"
            print(f"  {engine:>14s}  rel={rel:9.3e}  "
                  f"[{verdict} @ {GATE_REL:g}]")
    print("plans resolved by auto:")
    for key, plan in got["plans"]:
        print(f"  {plan.method} chain={plan.chain} "
              f"block_rows={plan.block_rows}  <-  {key}")
    print("ACCURACY GATE:", "PASS" if got["passed"] else "FAIL")
    return 0 if got["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
