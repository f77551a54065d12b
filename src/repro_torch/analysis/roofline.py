"""Roofline terms for the port: the analytic MTTKRP bound and the LM's
whole-step terms from a dry-run record.

Port of ``repro.analysis.roofline``, with the constants of an NVIDIA H100
SXM in place of the TPU's.  They are NVIDIA's nominal datasheet values for
the SXM part at its full 700 W power limit, not measurements; a card set to
a lower power limit runs slower:

* ``PEAK_FLOPS`` -- 67 TFLOP/s fp32 outside the tensor cores.  The reference
  contracts at ``Precision.HIGHEST`` and the port keeps TF32 off
  (``torch.backends.cuda.matmul.allow_tf32 = False``), so fp32 CUDA-core
  throughput is the ceiling its contractions can reach.
* ``BF16_PEAK_FLOPS`` -- 989 TFLOP/s dense BF16 on the tensor cores (the
  datasheet's 1979 is with 2:4 sparsity).  The LM's steps contract in
  bf16, so this is the ceiling of :class:`RooflineTerms` and its
  ``mfu_bound``, where the reference uses its chip's bf16 peak.
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

The LM half reads the records of :mod:`repro_torch.launch.dryrun`: three
terms a step, in seconds, per rank (the dry-run traces rank 0's part of
the SPMD program):

    compute    = flops / BF16_PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective operand bytes / NVLINK_BW

:func:`parse_collectives` is the reference's parser of XLA HLO text, kept
as it is (the port's dry-run records its collectives where they are
issued, under the same kind names, and parses no text).
:func:`extrapolate` is the reference's linear depth correction from L=1/L=2
probes; the port's dry-run records no probes, because its trace runs
every layer (``launch/dryrun.py``), so :func:`terms_from_record` takes the
record's ``full`` numbers.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
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


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


_COLL_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# "%name = type[...]... kind(" or "kind-start(" -- scheduled HLO form
_COLL_RE = re.compile(
    r"(%\S+)\s+=\s+(\S+)\s+(" + "|".join(_COLL_KINDS) + r")(?:-start)?\("
)
_DEF_RE = re.compile(r"^\s+(%[\w.\-]+)\s+=\s+([a-z0-9]+)\[([0-9,]*)\]")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_OPERAND_RE = re.compile(r"%[\w.\-]+")


def parse_collectives(hlo_text: str) -> dict:
    """Per-kind operand-byte totals from a partitioned XLA HLO module's text.

    Scheduled HLO prints operands by name only, so a symbol table of
    instruction result shapes resolves each collective's operand bytes
    (falling back to the collective's own result shape, which equals the
    operand for all-reduce).  Kept for records written from HLO text; the
    port's own dry-run records the same dict where its collectives run.
    """
    sizes: dict[str, int] = {}
    for line in hlo_text.splitlines():
        d = _DEF_RE.match(line)
        if d:
            sizes[d.group(1)] = _shape_bytes(d.group(2), d.group(3))

    totals = {k: 0 for k in _COLL_KINDS}
    counts = {k: 0 for k in _COLL_KINDS}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        kind = m.group(3)
        args_part = line[m.end():].split(")", 1)[0]
        inline = _SHAPE_RE.findall(args_part)
        if inline:  # unscheduled form: shapes inline
            op_bytes = sum(_shape_bytes(dt, dims) for dt, dims in inline)
        else:
            names = _OPERAND_RE.findall(args_part)
            op_bytes = sum(sizes.get(n, 0) for n in names)
            if op_bytes == 0:  # fallback: result shape (== operand for AR)
                res = _SHAPE_RE.findall(m.group(2))
                op_bytes = sum(_shape_bytes(dt, dims) for dt, dims in res)
        totals[kind] += op_bytes
        counts[kind] += 1
    return {
        "bytes_by_kind": totals,
        "count_by_kind": counts,
        "total_bytes": sum(totals.values()),
        "total_count": sum(counts.values()),
    }


def extrapolate(v1: float, v2: float, layers: int) -> float:
    """Linear-in-depth correction from L=1 / L=2 probes."""
    return v1 + (layers - 1) * (v2 - v1)


@dataclass
class RooflineTerms:
    flops: float  # per rank
    hbm_bytes: float  # per rank
    coll_bytes: float  # per rank, collective operand bytes
    model_flops_total: float  # analytic 6ND (whole step, all ranks)
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / BF16_PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_bound_s(self) -> float:
        """Roofline-optimal step time assuming perfect overlap."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops -- how much of the traced compute is useful."""
        total = self.flops * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flops utilization at the roofline bound."""
        t = self.step_bound_s
        if not t:
            return 0.0
        return self.model_flops_total / (self.chips * BF16_PEAK_FLOPS * t)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_bound_s": self.step_bound_s,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def terms_from_record(record: dict) -> RooflineTerms | None:
    """Roofline terms from a dry-run JSON record (``launch/dryrun.py``).

    Uses probe extrapolation when probes are present (records written from
    a compiled loop body), else the ``full`` numbers times ``accum_steps``.
    The port's records carry no probes and a ``full`` that is the whole
    step divided by ``accum_steps``, so this is the whole step's count.
    """
    chips = record["chips"]
    layers = record["n_layers"]
    accum = record.get("accum_steps", 1)
    if record.get("probe1") and record.get("probe2"):
        p1, p2 = record["probe1"], record["probe2"]
        flops = extrapolate(p1["flops"], p2["flops"], layers) * accum
        hbm = extrapolate(p1["bytes"], p2["bytes"], layers) * accum
        coll = extrapolate(p1["coll_bytes"], p2["coll_bytes"], layers) * accum
    else:
        full = record["full"]
        flops = full["flops"] * accum
        hbm = full["bytes"] * accum
        coll = full["coll_bytes"] * accum
    return RooflineTerms(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=coll,
        model_flops_total=record["model_flops"],
        chips=chips,
    )
