"""``repro_torch.plan`` -- one front door: Problem -> SweepPlan -> Executor.

Port of ``repro.plan`` for CP-ALS on one device or sharded over a
``torch.distributed`` DeviceMesh, one tensor or a batch of same-shaped
tensors (``Problem(batch=B)``):

* :class:`Problem` -- immutable descriptor (shape, rank, dtype); its
  :meth:`~Problem.signature` string equals the reference's.
* :class:`Schedule` -- the contraction-schedule IR (flat, binary, chain
  and custom trees of :class:`ContractionNode` GEMMs).
* :func:`plan_sweep` -- the cost-model planner (H100 roofline constants);
  :meth:`SweepPlan.describe` exposes the predictions.
* :class:`LocalExecutor` -- where contractions run; ``"fused"`` and
  ``"matrix_free"`` leaves launch the port's CUDA kernels on the card.
  :class:`ShardedExecutor` runs the same local contractions on this
  rank's block of a mesh-sharded problem and completes each with a
  deterministic reduction (:mod:`repro_torch.dist`);
  :class:`OverlappingExecutor` issues each node's reduction slab by slab
  behind the contraction (exact), :class:`CompressedShardedExecutor` makes
  it the int8 error-feedback gather, its residuals carried through the
  sweep (``SweepState.carry``).  :func:`select_executor` is the cost
  argmin among them and :func:`make_executor` builds one from
  ``SweepPlan.executor``.
* :func:`cp_als` / :func:`als_sweep` -- the one sweep engine and driver;
  :func:`legacy_sweep` is the bridge behind the legacy wrappers
  (``core.cpals.als_sweep``, ``core.dimtree.dimtree_sweep``).
* Pairwise perturbation (Ma & Solomonik, arXiv 2010.12056):
  ``Problem(pp_tol > 0)`` opts a problem into approximate sweeps that
  reuse cached pairwise intermediates (:func:`pp_pairs` describes them,
  :class:`PPState` carries them) plus first-order corrections while every
  factor's drift stays under tolerance, rebuilding after an exact sweep
  once one crosses it.  :func:`pp_amortized_cost` prices the amortized
  sweep so ``plan_sweep`` can argmin PP against the exact strategies
  (``strategy="pp"`` forces it); ``pp_tol=0`` problems never build the
  cache and stay bitwise identical to classic exact ALS.
* :func:`tune` -- hardware autotuning: times kernel tiles and every
  candidate plan's contractions on the tensor's device into a
  :class:`TuningCache`, which ``plan_sweep(strategy="autotune")`` reads
  through :func:`lookup_measurements`.
* Two-level collectives (Ballard/Knight/Rouse, arXiv 1708.07401): problems
  built with ``intra_axes`` declare a fast intra-node level of the mesh;
  the cost model prices each node reduction's intra- and inter-node bytes
  apart (:func:`collective_level_bytes`), the planner picks flat or
  hierarchical per node (:func:`hierarchical_applicable` gates it),
  enumerates alternative mode-to-axis mappings and certifies the winner
  against the communication lower bound a node
  (:func:`mttkrp_comm_lower_bound`), stamped as
  ``SweepPlan.certified_bandwidth_optimal``.

Sharded problems plan with ``plan_sweep`` as unsharded ones do:
``executor="auto"`` argmins the sharded kinds; ``tune(mesh=, mode_axes=)``
measures them (``intra_axes=`` on a two-level mesh), and ``pp_tol > 0``
runs pairwise perturbation on this rank's blocks.
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
    DEFAULT_OVERLAP_CHUNKS,
    EXECUTORS,
    PP_EXACT_FRACTION,
    ModeCost,
    collective_level_bytes,
    compressed_allgather_bytes,
    dimtree_mode_cost,
    executor_mode_cost,
    hierarchical_applicable,
    mode_cost,
    mttkrp_comm_lower_bound,
    node_cost,
    pp_amortized_cost,
    pp_build_cost,
    pp_correction_cost,
    validate_executor,
)
from .executor import (
    CompressedShardedExecutor,
    Executor,
    LocalExecutor,
    OverlappingExecutor,
    ShardedExecutor,
    make_executor,
)
from .planner import (
    SCHEDULE_NAMES,
    STRATEGIES,
    ModePlan,
    NodePlan,
    SweepPlan,
    plan_sweep,
    select_executor,
)
from .problem import Problem
from .schedule import (
    ContractionNode,
    PPPair,
    Schedule,
    binary_schedule,
    build_schedule,
    chain_schedule,
    enumerate_schedules,
    flat_schedule,
    pp_pairs,
    ring_allreduce_bytes,
)
from .sweep import PPState, SweepState, als_sweep, cp_als, legacy_sweep

__all__ = [
    "ALGORITHMS",
    "DEFAULT_OVERLAP_CHUNKS",
    "EXECUTORS",
    "SCHEDULE_NAMES",
    "STRATEGIES",
    "CompressedShardedExecutor",
    "ContractionNode",
    "Executor",
    "LocalExecutor",
    "Measurements",
    "ModeCost",
    "ModePlan",
    "NodePlan",
    "OverlappingExecutor",
    "PPPair",
    "PPState",
    "PP_EXACT_FRACTION",
    "Problem",
    "Schedule",
    "ShardedExecutor",
    "SweepPlan",
    "SweepState",
    "TuningCache",
    "als_sweep",
    "binary_schedule",
    "build_schedule",
    "chain_schedule",
    "collective_level_bytes",
    "compressed_allgather_bytes",
    "cp_als",
    "default_tuning_cache",
    "dimtree_mode_cost",
    "enumerate_schedules",
    "executor_mode_cost",
    "flat_schedule",
    "hierarchical_applicable",
    "legacy_sweep",
    "lookup_measurements",
    "make_executor",
    "mode_cost",
    "mttkrp_comm_lower_bound",
    "node_cost",
    "plan_sweep",
    "pp_amortized_cost",
    "pp_build_cost",
    "pp_correction_cost",
    "pp_pairs",
    "ring_allreduce_bytes",
    "select_executor",
    "tune",
    "validate_executor",
]
