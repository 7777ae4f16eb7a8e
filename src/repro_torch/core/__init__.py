"""Core of the PyTorch port: the paper's chained-MMA arithmetic
reduction, its PRAM cost model, precision policy, and the hooks that
make it a service of the framework.
"""

from repro_torch.core.reduction import (  # noqa: F401
    tc_contract,
    tc_reduce,
    tc_reduce_axes,
    tc_reduce_lastdim,
    tc_reduce_rows,
)
from repro_torch.core.precision import (  # noqa: F401
    ACCUM_DTYPE,
    MmaPolicy,
)
from repro_torch.core.integration import (  # noqa: F401
    expert_counts,
    global_norm,
    masked_mean,
    reduce_mean,
    reduce_sum,
    squared_sum,
)
from repro_torch.core import dispatch, theory, precision  # noqa: F401
