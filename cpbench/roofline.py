"""The least time an exact CP-ALS sweep can take on the card, from shapes.

An exact ALS sweep needs every mode's MTTKRP of the same factors.  The
fewest passes over the tensor that give all of them are two: a dimension
tree's two partial contractions, each of which reads the tensor once and
does ``2 * C`` operations an entry.  So the work of a sweep is counted as
two reads of the tensor and ``2 * 2 * C * numel`` operations, whatever
implements it (a fused or matrix-free kernel, cuBLAS GEMMs, a dimension
tree), and the least time is the larger of bytes over the card's memory
bandwidth and operations over its peak rate in the tensor's dtype.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full power limit of 700 W.  float32 is the rate outside the tensor cores
(TF32 is off for a float32 configuration); float64 the FP64 tensor-core
rate; 16-bit types the dense tensor-core rate.
"""

from __future__ import annotations

import math
from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "float32": 67e12,
    "float64": 67e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}
BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}
READS_PER_SWEEP = 2


def sweep_bytes(shape: Sequence[int], dtype: str, batch: int = 1) -> float:
    """HBM bytes of one exact sweep: the tensor (a batch of them) read twice."""
    return float(READS_PER_SWEEP * batch * math.prod(shape) * BYTES[dtype])


def sweep_flops(shape: Sequence[int], rank: int, batch: int = 1) -> float:
    """Operations of one exact sweep: ``2 * C`` an entry on each read."""
    return float(READS_PER_SWEEP * 2 * rank * batch * math.prod(shape))


def least_sweep_s(shape: Sequence[int], rank: int, dtype: str, batch: int = 1) -> float:
    """The least seconds of one exact sweep of ``batch`` tensors of ``shape``:
    ``max(bytes / bandwidth, operations / peak)``."""
    return max(
        sweep_bytes(shape, dtype, batch) / HBM_BYTES_PER_S,
        sweep_flops(shape, rank, batch) / PEAK_FLOPS[dtype],
    )

