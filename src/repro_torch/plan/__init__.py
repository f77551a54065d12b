"""``repro_torch.plan`` -- one front door: Problem -> SweepPlan -> Executor.

Port of ``repro.plan`` for single-device CP-ALS, one tensor or a batch of
same-shaped tensors (``Problem(batch=B)``):

* :class:`Problem` -- immutable descriptor (shape, rank, dtype); its
  :meth:`~Problem.signature` string equals the reference's.
* :class:`Schedule` -- the contraction-schedule IR (flat, binary, chain
  and custom trees of :class:`ContractionNode` GEMMs).
* :func:`plan_sweep` -- the cost-model planner (H100 roofline constants);
  :meth:`SweepPlan.describe` exposes the predictions.
* :class:`LocalExecutor` -- where contractions run; ``"fused"`` and
  ``"matrix_free"`` leaves launch the port's CUDA kernels on the card.
* :func:`cp_als` / :func:`als_sweep` -- the one sweep engine and driver.
* :func:`tune` -- hardware autotuning: times kernel tiles and every
  candidate plan's contractions on the tensor's device into a
  :class:`TuningCache`, which ``plan_sweep(strategy="autotune")`` reads
  through :func:`lookup_measurements`.

Sharded problems (mapped modes or a sharded batch axis) and
pairwise-perturbation problems raise ``NotImplementedError``: they come
with the distribution and PP slices.
"""

from .autotune import (
    Measurements,
    TuningCache,
    default_tuning_cache,
    lookup_measurements,
    tune,
)
from .cost import (
    ALGORITHMS,
    EXECUTORS,
    ModeCost,
    dimtree_mode_cost,
    executor_mode_cost,
    mode_cost,
    node_cost,
    validate_executor,
)
from .executor import Executor, LocalExecutor, make_executor
from .planner import SCHEDULE_NAMES, STRATEGIES, ModePlan, NodePlan, SweepPlan, plan_sweep
from .problem import Problem
from .schedule import (
    ContractionNode,
    Schedule,
    binary_schedule,
    build_schedule,
    chain_schedule,
    enumerate_schedules,
    flat_schedule,
    ring_allreduce_bytes,
)
from .sweep import SweepState, als_sweep, cp_als

__all__ = [
    "ALGORITHMS",
    "EXECUTORS",
    "SCHEDULE_NAMES",
    "STRATEGIES",
    "ContractionNode",
    "Executor",
    "LocalExecutor",
    "Measurements",
    "ModeCost",
    "ModePlan",
    "NodePlan",
    "Problem",
    "Schedule",
    "SweepPlan",
    "SweepState",
    "TuningCache",
    "als_sweep",
    "binary_schedule",
    "build_schedule",
    "chain_schedule",
    "cp_als",
    "default_tuning_cache",
    "dimtree_mode_cost",
    "enumerate_schedules",
    "executor_mode_cost",
    "flat_schedule",
    "lookup_measurements",
    "make_executor",
    "mode_cost",
    "node_cost",
    "plan_sweep",
    "ring_allreduce_bytes",
    "tune",
    "validate_executor",
]
