"""Hand-written Hopper kernels of the PyTorch port.

``csrc/`` holds the CUDA sources, ``_build`` compiles and loads them,
each kernel module pairs a kernel's wrapper with its plain PyTorch
version and a launch counter (B1-B3 in ``mma_reduce``, B4-B5 in
``mma_compensated``, B6 in ``mma_scan``, B7 in ``mma_segment``, B8 in
``mma_rmsnorm``, B10 in ``mma_norm_matmul``),
``ops`` exposes the public API and ``ref`` the plain oracles.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    M,
    mma_dd_reduce,
    mma_dd_squared_sum,
    mma_ec_reduce,
    mma_ec_squared_sum,
    mma_norm_matmul,
    mma_reduce,
    mma_reduce_partials,
    mma_rmsnorm,
    mma_scan,
    mma_segment_sum,
    mma_squared_sum,
)
