"""PRAM-style cost model from the paper (§4.2, §4.3).

All formulas are the paper's, parameterised by the MMA tile ``m``:
GPU tensor cores give m=4 (hardware) / m=16 (wmma fragments).  The
port of ``repro.core.theory``, line for line, with the paper's m = 16
(the Hopper kernels' chain link) as the default in place of the
reference's TPU tile of 128.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def t_classic(n: float) -> float:
    """Classic parallel reduction: T(n) = 4 log2 n (paper Eq. before (17))."""
    return 4.0 * math.log2(max(n, 2.0))


def t_tc(n: float, m: int = 16) -> float:
    """Two-MMA tensor-core reduction: T_tc(n) = 5 log_{m^2} n (Eq. 16)."""
    return 5.0 * math.log(max(n, 2.0), m * m)


def t_tc_chained(n: float, m: int = 16, chain: int = 1) -> float:
    """Chained variant: T^R_tc(n) = (2R+3) log_{R m^2} n (Eq. 24)."""
    base = chain * m * m
    return (2.0 * chain + 3.0) * math.log(max(n, 2.0), base)


def speedup(m: int = 16) -> float:
    """S = (4/5) log2 m^2 (Eq. 17) — n-independent."""
    return 0.8 * math.log2(m * m)


def speedup_chained(n: float, m: int = 16, chain: int = 1) -> float:
    """Finite-n speedup of the chained variant: T(n) / T^R_tc(n).

    The paper's abstract states the asymptotic bound for the two-MMA
    encoding (chain R = 1): the tensor-core reduction is

        S = (4/5) * log2(m^2)

    times faster than the classic 4 log2 n parallel reduction — an
    n-independent constant (Eq. 17, ``speedup``), e.g. 3.2x at the GPU
    hardware tile m = 4 and 11.2x at the TPU MXU tile m = 128.  This
    function evaluates the same ratio at finite n and general R, where
    T^R_tc(n) = (2R+3) log_{Rm^2} n (Eq. 24): as n grows it converges
    to (4 log2(R m^2)) / (2R+3), which at R = 1 is exactly the
    abstract's (4/5) log2 m^2 bound.
    """
    return t_classic(n) / t_tc_chained(n, m=m, chain=chain)


def t_tc_scan(n: float, m: int = 16, chain: int = 1) -> float:
    """Chained triangular-MMA prefix-scan depth (model extension).

    Not a paper equation — the scan analogue of Eq. 24, after Dakkak et
    al.'s TCU scan: each level folds R m-element rows per group with R
    triangular MMAs (the per-row prefixes), one strict-triangular MMA
    for the intra-group carries, and 2 steps of f32 carry combine, and
    a level maps n -> n / (R m) values, so

        T^R_scan(n) = (2R + 4) log_{R m} n.

    Note the level fan-in is R*m (one prefix row per MMA), not the
    reduction's R*m^2: a scan must *keep* every prefix, so each MMA
    folds one row, not a full m x m tile.
    """
    base = max(chain * m, 2)
    return (2.0 * chain + 4.0) * math.log(max(n, 2.0), base)


def optimal_chain(n: float, m: int = 16, max_chain: int = 64) -> int:
    """argmin_R T^R_tc(n) under the infinite-processor PRAM model.

    The model says R=1 (Eq. 24 grows with R); finite hardware says
    otherwise (paper found R=4..5 best experimentally) — the benchmark
    sweep reproduces that tension.
    """
    best, best_t = 1, float("inf")
    for r in range(1, max_chain + 1):
        t = t_tc_chained(n, m=m, chain=r)
        if t < best_t:
            best, best_t = r, t
    return best


@dataclass(frozen=True)
class OpCount:
    """Exact operation accounting for one tc_reduce call — used by the
    benchmarks to report 'work on the matrix unit vs vector unit'."""
    mma_ops: int          # number of m x m ones-MMAs issued
    mxu_flops: int        # 2*m^3 per MMA (what the matrix unit executes)
    useful_flops: int     # n-1 adds actually required by the reduction
    vpu_flops: int        # scalar/vector adds outside the MMAs


def op_count(n: int, m: int = 16, chain: int = 4,
             variant: str = "single_pass") -> OpCount:
    """Count MMAs like the paper counts them: R+1 MMAs per R m^2 numbers,
    then the variant-specific combine."""
    per_group = chain * m * m
    groups = max(1, math.ceil(n / per_group))
    mma = groups * (chain + 1)
    vpu = 0
    if variant == "single_pass":
        vpu = groups  # f32 adds of per-group scalars (atomics analogue)
    elif variant == "recurrence":
        g = groups
        while g > 1:
            g = max(1, math.ceil(g / per_group))
            mma += g * (chain + 1)
    return OpCount(
        mma_ops=mma,
        mxu_flops=mma * 2 * m * m * m,
        useful_flops=max(n - 1, 0),
        vpu_flops=vpu,
    )


def op_count_scan(n: int, m: int = 16, chain: int = 4,
                  variant: str = "single_pass") -> OpCount:
    """Operation accounting for one tc_scan call (triangular MMAs).

    Per group of R m-element rows: R row-prefix MMAs (X x U_m) plus one
    intra-group carry MMA (t x U'_R); the cross-group carries cost
    either G f32 vector adds (single_pass) or recursive MMA levels over
    G totals (recurrence).  A prefix sum needs n - 1 useful adds to
    produce all n outputs from its inclusive recurrence.
    """
    per_group = chain * m
    groups = max(1, math.ceil(n / per_group))
    mma = groups * (chain + 1)
    vpu = 0
    if variant == "single_pass":
        vpu = groups
    elif variant == "recurrence":
        g = groups
        while g > 1:
            g = max(1, math.ceil(g / per_group))
            mma += g * (chain + 1)
    return OpCount(
        mma_ops=mma,
        mxu_flops=mma * 2 * m * m * m,
        useful_flops=max(n - 1, 0),
        vpu_flops=vpu,
    )
