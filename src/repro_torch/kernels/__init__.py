"""Hand-written Hopper kernels of the PyTorch port.

``csrc/`` holds the CUDA sources, ``_build`` compiles and loads them,
each kernel module pairs a kernel's wrapper with its plain PyTorch
version and a launch counter, ``ops`` exposes the public API and
``ref`` the plain oracles.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    M,
    mma_reduce,
    mma_reduce_partials,
    mma_squared_sum,
)
