"""Core of the PyTorch port: the paper's chained-MMA arithmetic
reduction, the triangular-MMA prefix scan, the one-hot segmented sum,
the chunked linear recurrence, their PRAM cost model,
precision policy, and the hooks that make them a service of the
framework.
"""

from repro_torch.core.reduction import (  # noqa: F401
    tc_contract,
    tc_reduce,
    tc_reduce_axes,
    tc_reduce_dd,
    tc_reduce_ec,
    tc_reduce_lastdim,
    tc_reduce_rows,
)
from repro_torch.core.scan import (  # noqa: F401
    tc_cumprod,
    tc_linear_recurrence,
    tc_scan,
    tc_scan_ec,
    tc_segment_reduce,
)
from repro_torch.core.precision import (  # noqa: F401
    ACCUM_DTYPE,
    MmaPolicy,
)
from repro_torch.core.integration import (  # noqa: F401
    cumsum,
    expert_counts,
    global_norm,
    masked_cumsum,
    masked_mean,
    reduce_mean,
    reduce_sum,
    segment_sum,
    squared_sum,
)
from repro_torch.core import dispatch, theory, precision  # noqa: F401
