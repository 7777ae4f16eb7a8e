"""The precision-policy subsystem of the PyTorch port: one carrier for
every dtype / accuracy decision the MMA engines make (paper §5.4, §6).

The counterpart of ``repro.core.precision``.  Every numeric pin of the
port lives here:

  * ``ACCUM_DTYPE`` — THE f32-accumulator contract.  Every contraction
    of the port accumulates in this dtype; on CUDA the 16-bit matmuls
    use the ``out_dtype=ACCUM_DTYPE`` overloads (``aten::mm.dtype``),
    because plain ``torch.matmul`` on bf16 returns bf16.
  * **TF32.**  Hopper has no f32 tensor-core MMA.  The port's plain
    matmuls run in full f32: ``torch.backends.cuda.matmul.allow_tf32``
    (and cuDNN's flag) are set to False here, when the package is
    imported.  The hand-written kernels split every f32 multiplicand
    into ``TF32_WORDS`` = 2 TF32 words, ``hi = rna_tf32(x)`` and
    ``lo = rna_tf32(x - hi)``, which keeps 22 significand bits; one
    word would bias a sum of positive values by 2^-12..2^-11 relative,
    several times the ``pallas`` error ceiling.  So every
    ``MmaPolicy.mma_precision`` spelling maps onto the same choice —
    full f32 in the matmuls, two TF32 words in the kernels — and the
    field only keys plans (``signature``), as it does for the reduce
    family in the reference.
  * the split-bf16 decomposition, the error-free transforms and the
    double-double helpers, bit for bit the reference's arithmetic;
  * the paper's fp64-oracle harness (numpy, identical bits for a seed).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "ACCUM_DTYPE",
    "EXACT_OFFSETS",
    "F64_EQUIVALENT",
    "MmaPolicy",
    "TF32_WORDS",
    "as_dtype",
    "as_policy",
    "compensated_sum",
    "dd_add",
    "dd_from_any",
    "dd_value",
    "dtype_name",
    "error_sweep",
    "fast_two_sum",
    "fp64_oracle",
    "normal_input",
    "percent_error",
    "split_f32_words",
    "two_prod",
    "two_sum",
    "uniform_input",
]

# The paper's FP32 C/D accumulators: the one accumulator-dtype pin.
ACCUM_DTYPE = torch.float32

# Full-f32 matmuls: a TF32 matmul keeps ~3 decimal digits, which would
# break the f32-accumulator contract of every plain engine.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# TF32 words per f32 multiplicand in the hand-written Hopper kernels
# (hi + lo: 11 + 11 significand bits).
TF32_WORDS = 2


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    got = getattr(torch, name, None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return got


def dtype_name(dtype) -> str:
    """The reference's dtype spelling (``'float32'``, ``'bfloat16'``):
    the plan-key and context component, so keys match across packages."""
    return str(as_dtype(dtype)).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class MmaPolicy:
    """Dtype/accuracy policy for MMA-encoded reductions.

    The fields mean what they mean in ``repro.core.precision.MmaPolicy``
    with torch dtypes: ``input_dtype`` (the plain engines' multiplicand
    cast, None = keep the caller's dtype), ``accum_dtype``,
    ``split_words`` (bf16 words of the compensated family),
    ``error_budget_pct`` (the ceiling a ``method='auto'`` plan must
    meet) and ``mma_precision`` (a plan-key component only: see the
    module docstring for its TF32 meaning on Hopper).

    >>> MmaPolicy().signature()
    'any.float32'
    >>> MmaPolicy(split_words=2, error_budget_pct=1e-4).signature()
    'any.float32.w2.b0.0001'
    """

    input_dtype: Optional[torch.dtype] = None
    accum_dtype: torch.dtype = ACCUM_DTYPE
    split_words: int = 1
    error_budget_pct: Optional[float] = None
    mma_precision: Optional[str] = None

    def cast_in(self, x):
        """Cast to the policy's multiplicand dtype (no-op when None)."""
        if self.input_dtype is None:
            return x
        return x.to(as_dtype(self.input_dtype))

    def signature(self) -> str:
        """Plan-key component ``<in>.<acc>[.w<N>][.b<budget>][.p<P>]``,
        the reference's grammar and spelling."""
        in_name = "any" if self.input_dtype is None \
            else dtype_name(self.input_dtype)
        parts = [in_name, dtype_name(self.accum_dtype)]
        if self.split_words != 1:
            parts.append(f"w{int(self.split_words)}")
        if self.error_budget_pct is not None:
            parts.append(f"b{self.error_budget_pct:g}")
        if self.mma_precision is not None:
            parts.append(f"p{self.mma_precision}")
        return ".".join(parts)


# Integer-exact prefix offsets (the MoE dispatch path).
EXACT_OFFSETS = MmaPolicy(input_dtype=torch.float32,
                          mma_precision="highest")

# The f64-equivalent budget tier: only the double-double family meets it.
F64_EQUIVALENT = MmaPolicy(accum_dtype=torch.float64,
                           error_budget_pct=1e-10)


def as_policy(precision) -> Optional[MmaPolicy]:
    """Normalise a hook's ``precision=`` argument to an ``MmaPolicy``:
    None, an ``MmaPolicy``, or a precision spelling (``'highest'``,
    ``'high'``, ``'default'`` — the string form of the reference's
    ``jax.lax.Precision``), which pins only ``mma_precision``."""
    if precision is None or isinstance(precision, MmaPolicy):
        return precision
    if isinstance(precision, str):
        return MmaPolicy(mma_precision=precision.lower())
    raise TypeError(
        f"precision must be an MmaPolicy, a precision name or None — "
        f"got {type(precision).__name__}")


# ------------------------------------------------ split-bf16 words


def split_f32_words(x, words: int):
    """Split f32 values into ``words`` round-to-nearest bf16 words that
    sum back to x (Markidis et al.); most significant first."""
    if words < 1:
        raise ValueError(f"split_f32_words needs words >= 1, got {words}")
    r = x.to(torch.float32)
    parts = []
    for _ in range(words - 1):
        hi = r.to(torch.bfloat16)
        parts.append(hi)
        r = r - hi.to(torch.float32)
    parts.append(r.to(torch.bfloat16))
    return parts


# ------------------------------------------- compensated accumulation


def two_sum(a, b):
    """Error-free transform: ``s, e`` with ``s = fl(a + b)`` and
    ``s + e == a + b`` exactly (Knuth TwoSum, branch-free)."""
    s = a + b
    bv = s - a
    av = s - bv
    return s, (a - av) + (b - bv)


def compensated_sum(v) -> torch.Tensor:
    """Sum a vector of f32 partials with a pairwise TwoSum tree; the
    per-pair errors are summed plainly (second order, ~eps^2)."""
    v = torch.as_tensor(v).reshape(-1).to(ACCUM_DTYPE)
    if v.shape[0] == 0:
        return torch.zeros((), dtype=ACCUM_DTYPE, device=v.device)
    err = torch.zeros((), dtype=ACCUM_DTYPE, device=v.device)
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.nn.functional.pad(v, (0, 1))
        s, e = two_sum(v[0::2], v[1::2])
        err = err + torch.sum(e)
        v = s
    return v[0] + err


# ------------------------------------- double-double (dd) arithmetic


def fast_two_sum(a, b):
    """Dekker FastTwoSum (requires ``|a| >= |b|`` or a == 0)."""
    s = a + b
    return s, b - (s - a)


# Dekker's splitter for f32 (24-bit significand): 2^12 + 1.
_SPLIT_F32 = 4097.0


def two_prod(a, b):
    """Error-free transform ``p, e`` with ``p + e == a * b`` exactly
    (Dekker TwoProd via the 2^12+1 split; eager torch ops on the CPU
    never contract into an FMA).  Inputs are cast to f32."""
    a = torch.as_tensor(a).to(ACCUM_DTYPE)
    b = torch.as_tensor(b).to(ACCUM_DTYPE)
    p = a * b
    ta = _SPLIT_F32 * a
    ahi = ta - (ta - a)
    alo = a - ahi
    tb = _SPLIT_F32 * b
    bhi = tb - (tb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def dd_add(hi_a, lo_a, hi_b, lo_b):
    """Add two dd numbers: TwoSum on the high words, fold both low
    words into the residual, renormalise with FastTwoSum."""
    s, e = two_sum(hi_a, hi_b)
    return fast_two_sum(s, e + (lo_a + lo_b))


def dd_from_any(x):
    """Promote a tensor to elementwise dd pairs ``(hi, lo)``: f64
    splits into f32(x) and the exact f32 residual; narrower floats
    convert exactly with lo = 0."""
    if x.dtype == torch.float64:
        hi = x.to(ACCUM_DTYPE)
        lo = (x - hi.to(torch.float64)).to(ACCUM_DTYPE)
        return hi, lo
    hi = x.to(ACCUM_DTYPE)
    return hi, torch.zeros_like(hi)


def dd_value(out) -> float:
    """Collapse an engine result (a scalar, or a dd ``[hi, lo]`` pair)
    to a Python float in f64."""
    if isinstance(out, torch.Tensor):
        out = out.detach().to("cpu", torch.float64).numpy()
    return float(np.asarray(out, dtype=np.float64).ravel().sum())


# ---------------------------------------------- fp64-oracle harness


# The paper's two input classes (§5.4): very different error behaviour.
def normal_input(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1.0, size=n)


def uniform_input(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=n)


def fp64_oracle(x: np.ndarray) -> float:
    """The paper's reference: CPU reduction in double precision."""
    return float(np.sum(np.asarray(x).astype(np.float64)))


def percent_error(measured: float, x: np.ndarray) -> float:
    """% error vs the FP64 oracle (paper Figs. 7/8 bottom rows)."""
    ref = fp64_oracle(x)
    denom = abs(ref) if ref != 0.0 else 1.0
    return 100.0 * abs(float(measured) - ref) / denom


def error_sweep(reduce_fn: Callable[[np.ndarray], float],
                sizes, dist: str = "normal", seed: int = 0):
    """Run a reduction over growing n and report (n, %error) pairs."""
    gen = normal_input if dist == "normal" else uniform_input
    rows = []
    for n in sizes:
        x = gen(int(n), seed=seed)
        rows.append((int(n), percent_error(reduce_fn(x), x)))
    return rows
