"""PyTorch / CUDA port of the chained-MMA arithmetic reductions for one
NVIDIA H100, beside the JAX reference package ``repro``.

Entry points (``repro_torch.core.integration``) run on the card unless
the caller passes CPU tensors; the kernels (``repro_torch.kernels``)
are hand-written CUDA C++ for ``sm_90a``.  This package imports neither
JAX nor anything of ``repro``.
"""
