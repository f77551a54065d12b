"""Analytic single-device roofline terms for the port.

Port of ``dtype_itemsize``, ``mttkrp_roofline`` and the hardware constants
of ``repro.analysis.roofline``, with the constants of an NVIDIA H100 SXM in
place of the TPU's.  Both are NVIDIA's nominal datasheet values for the SXM
part at its full 700 W power limit, not measurements; a card set to a lower
power limit runs slower:

* ``PEAK_FLOPS`` -- 67 TFLOP/s fp32 outside the tensor cores.  The reference
  contracts at ``Precision.HIGHEST`` and the port keeps TF32 off
  (``torch.backends.cuda.matmul.allow_tf32 = False``), so fp32 CUDA-core
  throughput is the ceiling its contractions can reach.
* ``HBM_BW`` -- 3.35 TB/s HBM3.
* ``NVLINK_BW`` -- 900 GB/s of NVLink 4 a GPU, the link the flat
  collective between the cards of one node rides (nominal: the datasheet's
  total bandwidth a GPU, not a measured all-gather rate).
* ``INFINIBAND_BW`` -- 50 GB/s a GPU across nodes: one 400 Gb/s NDR
  InfiniBand ConnectX-7 port a GPU, as NVIDIA's DGX H100 datasheet lists
  (eight single-port adapters for eight GPUs).  The slow level of a
  two-level mesh, the counterpart of the reference's ``DCN_BW``; nominal
  until measured, like the others.  Its ratio to ``NVLINK_BW`` is 18x,
  where the reference's ``ICI_BW / DCN_BW`` is 4x, so the planner's
  flat-or-hierarchical and mesh-mapping choices may differ from the
  reference's; the byte counts they compare do not.

The collective parser comes with the LM's analysis (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_FLOPS = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 900e9
INFINIBAND_BW = 50e9

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# numpy-spelled dtypes that np.dtype() cannot resolve on its own
_DTYPE_NAME_BYTES = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def dtype_itemsize(dtype) -> int:
    """Bytes per element from a ``torch.dtype``, an HLO dtype name ('bf16'),
    a numpy-style name ('bfloat16'), or anything ``np.dtype`` accepts."""
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    if isinstance(dtype, str):
        if dtype in _DTYPE_BYTES:
            return _DTYPE_BYTES[dtype]
        if dtype in _DTYPE_NAME_BYTES:
            return _DTYPE_NAME_BYTES[dtype]
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError as e:
        raise ValueError(f"cannot resolve itemsize for dtype {dtype!r}") from e


def mttkrp_roofline(
    shape,
    rank: int,
    n: int,
    *,
    dtype="f32",
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
) -> dict:
    """Analytic single-device roofline *bound* for one mode-``n`` MTTKRP.

    The flop/byte terms of :func:`repro_torch.core.mttkrp.mttkrp_flops`
    (external modes charged the full KRP, internal modes the 2-step
    intermediate) in seconds against the constants above, assuming perfect
    compute/memory overlap (``max`` of the two terms).
    """
    from repro_torch.core.mttkrp import mttkrp_flops

    itemsize = dtype_itemsize(dtype)
    f = mttkrp_flops(shape, rank, n, itemsize=itemsize)
    internal = f["second_step_flops"] > 0
    flops = f["gemm_flops"] + (f["second_step_flops"] if internal else f["krp_flops"])
    intermediate = f["second_step_flops"] / 2.0 * itemsize  # In*min(L,R)*C elems
    bytes_ = f["tensor_bytes"] + (intermediate if internal else f["krp_bytes"])
    compute_s, memory_s = flops / peak_flops, bytes_ / hbm_bw
    return {
        "flops": flops,
        "bytes": bytes_,
        "itemsize": f["itemsize"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "intensity_flops_per_byte": flops / bytes_ if bytes_ else 0.0,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "bound_s": max(compute_s, memory_s),
    }
