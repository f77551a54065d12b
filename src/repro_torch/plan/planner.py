"""``plan_sweep``: the single front door for ALS algorithm choice.

Port of ``repro.plan.planner`` for unsharded problems on the ``"local"``
executor, batched (``Problem(batch=B)``, every cost term scaled by the
batch) or not.  ``auto`` cost-argmins jointly over the contraction-tree
shapes of :func:`repro_torch.plan.schedule.enumerate_schedules` and each
root leaf's MTTKRP algorithm (1-step / 2-step-left / 2-step-right),
breaking near-ties (within 10%) toward the paper's Sec. 5.3.3
recommendation and the flat per-mode sweep; ``autotune`` argmins on
hardware measurements read from the tuning cache wherever a comparison set
is fully measured; any other strategy forces that algorithm on every mode
of the flat schedule.

Problems with ``pp_tol > 0`` also price the pairwise-perturbation sweep
(``SweepPlan.pp_info``): ``strategy="pp"`` forces it, ``"auto"`` and
``"autotune"`` enable it when its amortized per-sweep seconds beat the
exact sweep's, and every other strategy prices it without enabling it.

Sharded problems (mapped modes or a sharded batch axis) plan jointly over
the schedule and the executor: with ``executor="auto"`` (the default) a
mode-parallel problem argmins ``"sharded"``, ``"overlapping"`` (slab
reductions hidden behind the slab contractions) and ``"compressed"`` (the
int8 error-feedback gather, which changes the numerics and so must win by
more than 10%, ``_COMPRESS_MARGIN``) on predicted sweep seconds, as the
reference's :func:`select_executor` does; a batch-parallel placement has
no reduction and runs ``"sharded"``.  Every node is priced on the
per-device block, and a batched mode-parallel problem is argmin'd against
its all-batch-parallel remap (``SweepPlan.placements``).

Two-level meshes (``Problem.intra_axes``) plan against the
Ballard-Knight-Rouse communication lower bound, as the reference does:
every node whose reduction spans both levels is argmin'd flat against
hierarchical (``NodePlan.collective``), alternative mode-to-axis mappings
of the same mesh are enumerated until one's modeled node-crossing volume
is within ``certify_eps`` of the bound (``SweepPlan.mappings``,
``lower_bound_bytes``, ``certified_bandwidth_optimal``).  The winning
mapping is ``SweepPlan.problem``: build the executor and the blocks from
its ``mode_axes`` and ``node_axis``.  With the H100's links (NVLink 18x
the node-crossing rate, against the reference's 4x) the per-node choice
and the mapping may differ from the reference's.  ``describe()`` keeps the
reference's JSON layout.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, replace
from typing import Mapping

from .cost import (
    DEFAULT_OVERLAP_CHUNKS,
    EXECUTORS,
    ModeCost,
    executor_mode_cost,
    hierarchical_applicable,
    mttkrp_comm_lower_bound,
    node_cost,
    pp_amortized_cost,
    validate_executor,
)
from .problem import Problem
from .schedule import (
    ContractionNode,
    Schedule,
    binary_schedule,
    chain_schedule,
    enumerate_schedules,
    flat_schedule,
)

STRATEGIES = (
    "auto",
    "autotune",
    "pp",
    "1step",
    "2step",
    "2step-left",
    "2step-right",
    "dimtree",
    "fused",
    "matrix_free",
    "einsum",
    "baseline",
)

# Named schedule shapes accepted by ``plan_sweep(schedule=...)``.
SCHEDULE_NAMES = ("flat", "binary", "chain")

# auto prefers 2-step on internal modes unless 1-step is predicted >10%
# cheaper, and a tree must beat the flat sweep by >10% to win: the model
# alone decides only clear wins.
_NEAR_TIE = 0.9

# the compressed executor changes the numerics (int8 and error feedback), so
# it must beat the best exact executor by >10% predicted time to be chosen
_COMPRESS_MARGIN = 0.9


@dataclass(frozen=True)
class ModePlan:
    """Algorithm choice + predicted cost for one mode's MTTKRP (leaf view)."""

    mode: int
    algorithm: str
    cost: ModeCost

    def as_dict(self) -> dict:
        """JSON-ready row: mode, algorithm, and every cost term."""
        return {"mode": self.mode, "algorithm": self.algorithm, **self.cost.as_dict()}


@dataclass(frozen=True)
class NodePlan:
    """One schedule node's planned contraction: algorithm + predicted cost.

    ``algorithm`` is a per-mode MTTKRP method for leaves off the root,
    ``"partial-krp"`` for root-level partial GEMMs, and ``"partial-ttv"``
    for contractions of an already-computed partial.  ``tiles`` carries a
    tuned tile config read from the tuning cache for kernel-backed leaves.
    ``collective`` is the completing reduction the executor runs
    (``"flat"`` or ``"hierarchical"``, argmin'd per node on two-level
    meshes).  ``lower_bound_bytes`` is a leaf's share of the
    Ballard-Knight-Rouse lower bound (bytes a node a sweep), stamped when
    the plan was certified against it; ``None`` elsewhere.
    """

    node: ContractionNode
    algorithm: str
    cost: ModeCost
    tiles: Mapping[str, int] | None = None
    collective: str = "flat"
    lower_bound_bytes: float | None = None

    def as_dict(self) -> dict:
        """JSON-ready row: node topology metadata + every cost term."""
        return {
            **self.node.as_dict(),
            "algorithm": self.algorithm,
            "tiles": dict(self.tiles) if self.tiles else None,
            "collective": self.collective,
            "lower_bound_bytes": self.lower_bound_bytes,
            **self.cost.as_dict(),
        }


@dataclass(frozen=True)
class SweepPlan:
    """Planned contraction schedule for one full ALS sweep.

    ``schedule`` is the contraction tree the engine walks and ``nodes`` its
    per-node plans in evaluation order; ``modes`` is the per-mode leaf view.
    ``split`` is the binary half boundary when the tree is the classic
    two-partial split; ``normalize`` is part of the sweep recipe.
    ``describe()`` is the JSON-ready prediction surface.

    For batched sharded problems the planner also argmins over placements
    (mode-parallel as given against all-batch-parallel); ``placements``
    records each candidate's predicted cost and ``problem`` is the winning
    placement -- build the executor from ``plan.problem``'s
    ``mode_axes``/``batch_axes``, not from the problem that was planned.

    On two-level meshes (``Problem.intra_axes``) the planner also argmins
    over mesh mappings (mode-to-axis assignments), the flat-or-hierarchical
    choice folded in per node: ``mappings`` records each evaluated
    candidate with its modeled node-crossing volume a node and the
    Ballard-Knight-Rouse lower bound, ``lower_bound_bytes`` is the winning
    problem's bound (bytes a node a sweep) and
    ``certified_bandwidth_optimal`` flags a winner within the planner's
    ``certify_eps`` of it.  ``serial_fractions`` records the overlap
    constants the plan was priced with when it was given (or read from a
    tuning entry) any; ``None`` when the analytic defaults priced it.

    ``pp`` flags the pairwise-perturbation sweep mode: the engine still
    carries this plan's exact schedule (exact sweeps run it verbatim), but
    while factor drift stays under ``problem.pp_tol`` each sweep
    approximates every MTTKRP from the cached pairwise intermediates plus
    first-order corrections.  ``pp_info`` is the pricing row behind the
    decision (:func:`repro_torch.plan.cost.pp_amortized_cost`), ``None``
    when the problem never opted in (``pp_tol == 0``).
    """

    problem: Problem
    strategy: str
    modes: tuple[ModePlan, ...]
    split: int | None = None
    normalize: bool = True
    executor: str = "local"
    schedule: Schedule | None = None
    nodes: tuple[NodePlan, ...] = ()
    placements: tuple[Mapping, ...] = ()
    pp: bool = False
    pp_info: Mapping | None = None
    mappings: tuple[Mapping, ...] = ()
    serial_fractions: Mapping[str, float] | None = None
    lower_bound_bytes: float | None = None
    certified_bandwidth_optimal: bool = False

    @property
    def kind(self) -> str:
        """``"dimtree"`` for tree schedules, ``"permode"`` for the flat one."""
        if self.schedule is not None:
            return "permode" if self.schedule.is_flat else "dimtree"
        return "dimtree" if self.split is not None else "permode"

    @property
    def resolved_schedule(self) -> Schedule:
        """The plan's schedule, deriving the degenerate tree for plans built
        without one (flat, or the binary split when ``split`` is set)."""
        if self.schedule is not None:
            return self.schedule
        if self.split is not None:
            return binary_schedule(self.problem, self.split)
        return flat_schedule(self.problem)

    def node_plan(self, node_id: int) -> NodePlan:
        """The :class:`NodePlan` of one schedule node."""
        for np_ in self.nodes:
            if np_.node.id == node_id:
                return np_
        raise ValueError(f"no plan for node {node_id}")

    def total_cost(self) -> dict:
        """Sweep-level sums of the per-contraction cost terms."""
        rows = self.nodes if self.nodes else self.modes
        return {
            "flops": sum(r.cost.flops for r in rows),
            "bytes": sum(r.cost.bytes for r in rows),
            "collective_bytes": sum(r.cost.collective_bytes for r in rows),
            "intra_bytes": sum(r.cost.intra_bytes for r in rows),
            "inter_bytes": sum(r.cost.inter_bytes for r in rows),
            "predicted_s": sum(r.cost.predicted_s for r in rows),
        }

    def describe(self) -> dict:
        """Predicted flops / HBM bytes / collective bytes per mode and per
        schedule node, plus totals, in the reference's layout -- and, for
        batched sharded problems, the placement candidates compared (each
        with its predicted seconds and wire bytes, the selected one
        flagged).  The ``pp`` row prices the
        pairwise-perturbation strategy against the exact sweep (amortized
        per-sweep seconds; ``{"enabled": False}`` when the problem never
        opted in via ``pp_tol``)."""
        return {
            "shape": list(self.problem.shape),
            "rank": self.problem.rank,
            "dtype": self.problem.dtype_str,
            "strategy": self.strategy,
            "kind": self.kind,
            "executor": self.executor,
            "split": self.split,
            "sharded": self.problem.sharded,
            "mode_axes": {str(k): v for k, v in self.problem.mode_axes.items()},
            "batch": self.problem.batch,
            "batch_axes": list(self.problem.batch_axes),
            "local_batch": self.problem.local_batch,
            "placement": _placement_label(self.problem),
            "placements": [dict(p) for p in self.placements],
            "local_shape": list(self.problem.local_shape),
            "schedule": self.resolved_schedule.name,
            "modes": [m.as_dict() for m in self.modes],
            "nodes": [n.as_dict() for n in self.nodes],
            "serial_fractions": dict(self.serial_fractions or {}),
            "pp": {"enabled": self.pp, **dict(self.pp_info or {})},
            "mappings": [dict(m) for m in self.mappings],
            "lower_bound_bytes": self.lower_bound_bytes,
            "certified": self.certified_bandwidth_optimal,
            "totals": self.total_cost(),
        }


def _placement_label(problem: Problem) -> str:
    """Human name of a problem's mesh placement (for describe()/planning)."""
    if problem.mode_axes:
        return "mode-parallel"
    if problem.batch_axes:
        return "batch-parallel"
    return "unsharded"


def _placement_candidates(problem: Problem) -> list[Problem]:
    """Placement candidates the planner argmins over, as-given first: a
    batched mode-parallel problem also gets the all-batch-parallel remap
    (no mapped modes, the batch sharded over every mesh axis) whenever the
    batch divides the device count -- the placement with zero reduce
    traffic.  Any other problem has one candidate."""
    cands = [problem]
    if problem.batched and problem.mode_axes and problem.axis_sizes:
        devices = math.prod(problem.axis_sizes.values())
        if devices > 1 and problem.batch % devices == 0:
            cands.append(
                replace(problem, mode_axes={}, batch_axes=tuple(sorted(problem.axis_sizes)))
            )
    return cands


def _mapping_candidates(problem: Problem) -> list[Problem]:
    """Alternative mode-to-axis assignments of a two-level problem's mesh:
    every way to hand the axes the given mapping uses to distinct tensor
    modes (divisibility-checked), the given one excluded -- the search
    space of certified mesh planning.  Empty for a single-level problem,
    whose planning never changes."""
    if not (problem.intra_axes and problem.mode_axes):
        return []
    axes = sorted(set(problem.mode_axes.values()))
    given = dict(problem.mode_axes)
    out = []
    for modes in itertools.permutations(range(problem.ndim), len(axes)):
        mapping = dict(zip(modes, axes))
        if mapping == given:
            continue
        if any(problem.shape[m] % problem.axis_sizes[a] for m, a in mapping.items()):
            continue
        out.append(replace(problem, mode_axes=mapping))
    return out


def _node_bound_bytes(problem: Problem) -> tuple[float, tuple[float, ...]] | None:
    """(BKR bound, per-mode terms) in bytes a node a sweep for a two-level
    mode-parallel problem; ``None`` where certification does not apply (a
    flat mesh, a single node, or no mapped mode)."""
    if not (problem.mode_axes and problem.intra_axes and problem.n_nodes > 1):
        return None
    bound, terms, _ = mttkrp_comm_lower_bound(
        problem.shape, problem.rank, problem.n_nodes, itemsize=problem.itemsize, per_mode=True
    )
    lb = problem.local_batch
    return bound * lb, tuple(t * lb for t in terms)


def _pick_collective(
    problem: Problem,
    node: ContractionNode,
    alg: str,
    cost: ModeCost,
    executor: str,
    n_chunks: int,
    serial_fractions: Mapping[str, float] | None,
    measured=None,
) -> tuple[str, ModeCost]:
    """Flat-or-hierarchical argmin for one node's completing reduction.
    ``cost`` is the node's flat cost (its measurement stamped when there is
    one).  Where the reduction spans both levels the hierarchical variant
    is priced head to head: measured seconds decide when both are
    measured, the analytic prediction otherwise."""
    if not hierarchical_applicable(problem, node.reduce_axes):
        return "flat", cost
    if node.from_root and node.is_leaf:
        hier = executor_mode_cost(
            problem, node.mode, alg, executor, n_chunks=n_chunks,
            serial_fractions=serial_fractions, collective="hierarchical",
        )
    else:
        hier = node_cost(
            problem, node, executor, n_chunks=n_chunks,
            serial_fractions=serial_fractions, collective="hierarchical",
        )
    if measured is not None:
        m = measured.node_time(node, alg, executor, collective="hierarchical")
        if m is not None:
            hier = replace(hier, measured_s=m)
    if cost.measured_s is not None and hier.measured_s is not None:
        pick_hier = hier.measured_s < cost.measured_s
    else:
        pick_hier = hier.predicted_s < cost.predicted_s
    return ("hierarchical", hier) if pick_hier else ("flat", cost)


def _auto_mode(
    problem: Problem,
    n: int,
    node: ContractionNode,
    executor: str = "local",
    measured=None,
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    serial_fractions: Mapping[str, float] | None = None,
) -> ModePlan:
    """Cost-model dispatch for one mode (reproduces paper Sec. 5.3.3).

    With ``measured`` (``strategy='autotune'``) every candidate's hardware
    time is stamped on its cost; when the whole candidate set is measured
    the choice is a strict argmin over measured seconds and the kernels
    (``fused``, ``matrix_free``) join the candidates.  A partially measured
    set falls back to the analytic near-tie rule.
    """

    def cost(alg: str) -> ModeCost:
        c = executor_mode_cost(
            problem, n, alg, executor, n_chunks=n_chunks, serial_fractions=serial_fractions
        )
        if measured is not None:
            m = measured.node_time(node, alg, executor)
            if m is not None:
                c = replace(c, measured_s=m)
        return c

    cands: dict[str, ModeCost] = {"1step": cost("1step")}
    if not problem.external_mode(n):
        cands["2step-left"] = cost("2step-left")
        cands["2step-right"] = cost("2step-right")
    for kernel_alg in ("fused", "matrix_free"):
        if measured is not None and measured.node_time(node, kernel_alg, executor) is not None:
            cands[kernel_alg] = cost(kernel_alg)
    if len(cands) > 1 and all(c.measured_s is not None for c in cands.values()):
        alg = min(cands, key=lambda a: cands[a].measured_s)
        return ModePlan(n, alg, cands[alg])

    if problem.external_mode(n):
        return ModePlan(n, "1step", cands["1step"])
    left, right = cands["2step-left"], cands["2step-right"]
    # strict < keeps the Alg. 4 tie convention (L == R resolves right-first)
    two_alg, two = (
        ("2step-left", left) if left.predicted_s < right.predicted_s else ("2step-right", right)
    )
    one = cands["1step"]
    if one.predicted_s < _NEAR_TIE * two.predicted_s:
        return ModePlan(n, "1step", one)
    return ModePlan(n, two_alg, two)


def _plan_nodes(
    problem: Problem,
    sched: Schedule,
    strategy: str,
    executor: str = "local",
    measured=None,
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    serial_fractions: Mapping[str, float] | None = None,
) -> tuple[NodePlan, ...]:
    """NodePlans in evaluation order for one (schedule, executor) pair; on
    a two-level mesh each node's reduction is also argmin'd flat against
    hierarchical (:func:`_pick_collective`)."""
    plans = []
    for node in sched.walk():
        if node.from_root and node.is_leaf:
            if strategy in ("auto", "autotune"):
                mp = _auto_mode(
                    problem, node.mode, node, executor, measured, n_chunks, serial_fractions
                )
                alg, cost = mp.algorithm, mp.cost
            else:
                # forced strategies pin the leaf algorithm; tree strategies
                # route root leaves through the 1-step GEMM
                alg = "1step" if strategy == "dimtree" else strategy
                cost = executor_mode_cost(
                    problem, node.mode, alg, executor, n_chunks=n_chunks,
                    serial_fractions=serial_fractions,
                )
            tiles = None
            if measured is not None and alg in ("fused", "matrix_free"):
                tiles = measured.kernel_tiles("fused_mttkrp" if alg == "fused" else alg)
            coll, cost = _pick_collective(
                problem, node, alg, cost, executor, n_chunks, serial_fractions, measured
            )
            plans.append(NodePlan(node, alg, cost, tiles=tiles, collective=coll))
        else:
            alg = "partial-krp" if node.from_root else "partial-ttv"
            cost = node_cost(
                problem, node, executor, n_chunks=n_chunks, serial_fractions=serial_fractions
            )
            if measured is not None:
                m = measured.node_time(node, alg, executor)
                if m is not None:
                    cost = replace(cost, measured_s=m)
            coll, cost = _pick_collective(
                problem, node, alg, cost, executor, n_chunks, serial_fractions, measured
            )
            plans.append(NodePlan(node, alg, cost, collective=coll))
    return tuple(plans)


def _best_executor(
    problem: Problem,
    sched: Schedule,
    strategy: str,
    candidates: tuple[str, ...],
    n_chunks: int,
    serial_fractions: Mapping[str, float] | None,
    measured=None,
) -> tuple[str, tuple[NodePlan, ...], float, float | None]:
    """Cost-argmin executor for one schedule among ``candidates``:
    ``(kind, node plans, analytic total, measured total or None)``.

    Exact kinds compete head to head (a tie keeps the earlier, plainer
    kind); ``compressed`` changes the numerics, so it must beat the best
    exact kind by >10% (``_COMPRESS_MARGIN``).  When every candidate's node
    plans are measured (autotune) the comparison runs on measured sweep
    seconds, otherwise on the analytic predictions: measured and analytic
    seconds never meet in one comparison."""
    plans = {
        ex: _plan_nodes(problem, sched, strategy, ex, measured, n_chunks, serial_fractions)
        for ex in candidates
    }
    pred = {ex: sum(np_.cost.predicted_s for np_ in plans[ex]) for ex in candidates}
    fully_measured = measured is not None and all(
        np_.cost.measured_s is not None for ex in candidates for np_ in plans[ex]
    )
    totals = (
        {ex: sum(np_.cost.measured_s for np_ in plans[ex]) for ex in candidates}
        if fully_measured
        else pred
    )

    def result(ex: str):
        return ex, plans[ex], pred[ex], (totals[ex] if fully_measured else None)

    exacts = [ex for ex in candidates if ex != "compressed"]
    if not exacts:  # compressed was forced
        return result(candidates[0])
    best = exacts[0]
    for ex in exacts[1:]:
        if totals[ex] < totals[best]:
            best = ex
    if "compressed" in candidates and totals["compressed"] < _COMPRESS_MARGIN * totals[best]:
        best = "compressed"
    return result(best)


def _resolve_schedules(
    problem: Problem, strategy: str, split: int | None, schedule
) -> list[Schedule]:
    """Candidate schedules for one plan_sweep call."""
    if isinstance(schedule, Schedule):
        if schedule.problem != problem:
            raise ValueError("schedule was built for a different Problem")
        return [schedule]
    if isinstance(schedule, str):
        if schedule not in SCHEDULE_NAMES:
            raise ValueError(f"unknown schedule {schedule!r} (choose from {SCHEDULE_NAMES})")
        if schedule == "flat":
            return [flat_schedule(problem)]
        if schedule == "binary":
            return [binary_schedule(problem, split)]
        return [chain_schedule(problem)]
    if schedule is not None:
        raise TypeError(f"schedule must be a Schedule, a name or None, got {schedule!r}")
    if strategy == "dimtree":
        return [binary_schedule(problem, split)]
    if strategy in ("auto", "autotune"):
        return enumerate_schedules(problem)
    return [flat_schedule(problem)]


def select_executor(
    problem: Problem,
    strategy: str = "auto",
    *,
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    schedule=None,
    serial_fractions: Mapping[str, float] | None = None,
    tuning_cache=None,
) -> str:
    """Cost-argmin executor kind for ``problem`` under ``strategy``, as
    :func:`plan_sweep` picks it with ``executor="auto"``.

    Unsharded problems run locally and batch-parallel placements on the
    plain ``"sharded"`` executor (no reduction to hide).  Mode-parallel
    problems compare ``"sharded"`` with ``"overlapping"`` (slab reductions
    hidden behind the slab contractions) and ``"compressed"`` (the int8
    error-feedback gather) on predicted sweep seconds, jointly with the
    schedule shapes the strategy admits; ``"compressed"`` must win by more
    than 10% (``_COMPRESS_MARGIN``), ties go to the exact kinds.  With the
    H100 constants the choice may differ from the reference's."""
    return plan_sweep(
        problem, strategy, executor="auto", n_chunks=n_chunks, schedule=schedule,
        serial_fractions=serial_fractions, tuning_cache=tuning_cache,
    ).executor


def plan_sweep(
    problem: Problem,
    strategy: str = "auto",
    *,
    split: int | None = None,
    normalize: bool = True,
    executor: str = "auto",
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    schedule: Schedule | str | None = None,
    serial_fractions: Mapping[str, float] | None = None,
    tuning_cache=None,
    certify_eps: float = 0.25,
) -> SweepPlan:
    """Plan one full ALS sweep for ``problem`` (batched or not, sharded or
    not).

    ``strategy='auto'`` cost-argmins jointly over contraction-tree shapes
    (flat, the binary split at every boundary, the chain for order >= 4)
    and each root leaf's algorithm; near-ties (within 10%) break toward the
    flat per-mode sweep.  ``'autotune'`` does the same on hardware seconds
    read from ``tuning_cache`` (the process default when ``None``) wherever
    a comparison set is fully measured; an empty cache gives exactly
    ``'auto'``.  ``'dimtree'`` forces the binary tree (``split`` defaults to
    the balanced half); any other strategy forces that algorithm on every
    mode of the flat schedule.  ``schedule`` pins the tree shape.

    ``executor='auto'`` also picks the executor kind by the same argmin
    (see :func:`select_executor`); an explicit kind of
    :data:`repro_torch.plan.cost.EXECUTORS` forces it, checked by
    :func:`repro_torch.plan.cost.validate_executor`.  ``n_chunks`` sizes
    the overlapping executor's slab pipeline; ``serial_fractions``
    (executor kind -> unhidable fraction in [0, 1]) replaces the analytic
    overlap constants in every cost and is recorded on
    ``SweepPlan.serial_fractions`` (``'autotune'``, ``'fused'`` and
    ``'matrix_free'`` read a tuned entry's fractions when none are given).
    A batched mode-parallel problem is argmin'd against its
    all-batch-parallel remap: the winner becomes ``SweepPlan.problem`` and
    both candidates are recorded on ``SweepPlan.placements``.

    Two-level problems (``Problem.intra_axes``) plan against the
    Ballard-Knight-Rouse communication lower bound: every node's reduction
    is argmin'd flat against hierarchical, the alternative mode-to-axis
    mappings of the same mesh are enumerated (divisibility-checked
    permutations), each stamped with its modeled node-crossing volume a
    node and the bound, and the enumeration stops once a candidate is
    within ``certify_eps`` (relative) of the bound; the winner carries
    ``certified_bandwidth_optimal`` and per-leaf ``lower_bound_bytes``.

    Problems with ``pp_tol > 0`` additionally price the pairwise-
    perturbation sweep mode (Ma & Solomonik): ``'auto'``/``'autotune'``
    enable it (``SweepPlan.pp``) when the amortized per-sweep seconds --
    assumed exact-sweep fraction x (exact sweep + cache build) plus the
    correction-only sweeps -- beat the exact sweep, and ``strategy='pp'``
    forces it (its exact plan follows the ``'auto'`` argmin).  The
    comparison runs on measured seconds only when both sides are measured
    (the winning schedule's nodes and the tuned PP rows).  ``'fused'``,
    ``'matrix_free'`` and the other forced strategies price PP but never
    enable it.  A sharded PP problem prices its pair reductions and the
    corrections' sums over the mapped modes.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (choose from {STRATEGIES})")
    if strategy == "pp" and problem.pp_tol <= 0.0:
        raise ValueError(
            "strategy='pp' needs Problem(pp_tol > 0): the drift threshold is "
            "part of the problem (and its signature), not a planner flag"
        )
    if executor != "auto":
        validate_executor(problem, executor)
    # "pp" forces the approximate sweep mode but still needs a full exact
    # plan (exact sweeps run it verbatim): its schedule and leaf choices
    # follow the "auto" cost argmin
    node_strategy = "auto" if strategy == "pp" else strategy
    if split is not None:
        if strategy != "dimtree" and schedule != "binary":
            raise ValueError(
                "split is only meaningful for strategy='dimtree' (or schedule='binary')"
            )
        if not 0 < split < problem.ndim:
            raise ValueError(f"split {split} out of range for order-{problem.ndim} tensor")
    if serial_fractions is not None:
        for kind, f in dict(serial_fractions).items():
            if kind not in EXECUTORS:
                raise ValueError(
                    f"unknown executor {kind!r} in serial_fractions (choose from {EXECUTORS})"
                )
            if not 0.0 <= float(f) <= 1.0:
                raise ValueError(f"serial_fractions[{kind!r}] must be in [0, 1], got {f}")
    measured = None
    if strategy in ("autotune", "fused", "matrix_free"):
        # forced kernel strategies reuse tuned tile stamps; only autotune
        # argmins on the measurements
        from .autotune import lookup_measurements

        measured = lookup_measurements(problem, cache=tuning_cache)
        if measured is not None and serial_fractions is None and measured.serial_fractions:
            serial_fractions = dict(measured.serial_fractions)

    def candidates(prob: Problem) -> tuple[str, ...]:
        if executor != "auto":
            return (executor,)
        if prob.mode_axes:
            return ("sharded", "overlapping", "compressed")
        # a batch-parallel placement has no reduction: the plain kind
        return ("sharded",) if prob.batch_axes else ("local",)

    # a pinned Schedule instance is bound to one Problem, so placement and
    # mapping exploration (which rebuild schedules per candidate) are off
    pinned = isinstance(schedule, Schedule)

    def evaluate(prob: Problem):
        """One candidate problem's best (schedule, executor) row, or
        ``None`` when a forced executor kind cannot run an alternate one."""
        if prob is not problem and executor != "auto":
            try:
                validate_executor(prob, executor)
            except ValueError:
                return None
        rows = [
            (sched,) + _best_executor(
                prob, sched, node_strategy, candidates(prob), n_chunks, serial_fractions,
                measured,
            )
            for sched in _resolve_schedules(prob, node_strategy, split, schedule)
        ]
        if measured is not None and all(r[4] is not None for r in rows):
            best = min(rows, key=lambda r: r[4])
        else:
            best = rows[0]
            for r in rows[1:]:
                if r[3] < best[3]:
                    best = r
            # near-tie preference: a tree must beat the flat sweep by >10% to win
            flat_row = next((r for r in rows if r[0].is_flat), None)
            if flat_row is not None and best[0] is not flat_row[0]:
                if best[3] >= _NEAR_TIE * flat_row[3]:
                    best = flat_row
        return (prob,) + best

    def certify(row):
        """(bound, node-crossing volume a node, certified) of one row;
        ``(None, None, False)`` where the bound does not apply."""
        bt = _node_bound_bytes(row[0])
        if bt is None:
            return None, None, False
        bound, _ = bt
        # per-device inter volume x devices a node = bytes crossing the node
        # boundary a node a sweep, the quantity the bound limits
        inter = sum(np_.cost.inter_bytes for np_ in row[3]) * row[0].intra_shards
        return bound, inter, inter <= (1.0 + certify_eps) * bound

    picked = []  # rows: (problem, schedule, executor, node plans, analytic, measured)
    cert_rows = []  # (row, bound, inter, certified) of the rows the bound applies to
    certified_found = False
    for prob in [problem] if pinned else _placement_candidates(problem):
        row = evaluate(prob)
        if row is None:
            continue
        picked.append(row)
        bound, inter, ok = certify(row)
        if bound is not None:
            cert_rows.append((row, bound, inter, ok))
            certified_found = certified_found or ok
    n_placements = len(picked)  # mapping rows appended below are not placements
    # the mesh-mapping enumeration of a two-level problem, until a candidate
    # certifies against the lower bound (skipped when the given one does)
    if not pinned and not certified_found:
        for prob in _mapping_candidates(problem):
            row = evaluate(prob)
            if row is None:
                continue
            picked.append(row)
            bound, inter, ok = certify(row)
            cert_rows.append((row, bound, inter, ok))
            if ok:
                break
    # placement and mapping argmin on the analytic totals: strict < keeps
    # the as-given problem on a tie
    winner = picked[0]
    for row in picked[1:]:
        if row[4] < winner[4]:
            winner = row
    prob, sched, chosen, node_plans = winner[0], winner[1], winner[2], winner[3]
    lower_bound, certified = None, False
    for row, bound, _, ok in cert_rows:
        if row is winner:
            lower_bound, certified = bound, ok
            break
    if lower_bound is not None:
        _, terms = _node_bound_bytes(prob)
        node_plans = tuple(
            replace(np_, lower_bound_bytes=terms[np_.node.mode]) if np_.node.is_leaf else np_
            for np_ in node_plans
        )
    mapping_rows = tuple(
        {
            "mode_axes": {str(k): v for k, v in row[0].mode_axes.items()},
            "executor": row[2],
            "schedule": row[1].name,
            "predicted_s": row[4],
            "inter_bytes_per_node": inter,
            "lower_bound_bytes": bound,
            "certified": ok,
            "collectives": [np_.collective for np_ in row[3]],
            "selected": row is winner,
        }
        for row, bound, inter, ok in cert_rows
    )
    placement_rows = tuple(
        {
            "placement": _placement_label(r[0]),
            "mode_axes": {str(k): v for k, v in r[0].mode_axes.items()},
            "batch_axes": list(r[0].batch_axes),
            "executor": r[2],
            "schedule": r[1].name,
            "predicted_s": r[4],
            "collective_bytes": sum(np_.cost.collective_bytes for np_ in r[3]),
            "selected": r is winner,
        }
        for r in picked[:n_placements]
    ) if n_placements > 1 else ()

    # pairwise perturbation, priced against the chosen exact plan whenever
    # the problem opted in; measured and analytic seconds never meet in one
    # comparison
    pp_enabled = False
    pp_info = None
    if prob.pp_tol > 0.0:
        m_build = measured.pp_second("build_s") if measured is not None else None
        m_corr = measured.pp_second("correct_sweep_s") if measured is not None else None
        if winner[5] is not None and m_build is not None and m_corr is not None:
            pp_info = pp_amortized_cost(prob, winner[5], build_s=m_build, correction_s=m_corr)
            pp_info["basis"] = "measured"
        else:
            pp_info = pp_amortized_cost(prob, winner[4])
            pp_info["basis"] = "analytic"
        if strategy == "pp":
            pp_enabled = True
        elif strategy in ("auto", "autotune"):
            pp_enabled = pp_info["amortized_sweep_s"] < pp_info["exact_sweep_s"]
    modes = tuple(
        sorted(
            (
                ModePlan(np_.node.mode, np_.algorithm, np_.cost)
                for np_ in node_plans
                if np_.node.is_leaf
            ),
            key=lambda mp: mp.mode,
        )
    )
    return SweepPlan(
        prob,
        strategy,
        modes,
        split=sched.split,
        normalize=normalize,
        executor=chosen,
        schedule=sched,
        nodes=node_plans,
        placements=placement_rows,
        pp=pp_enabled,
        pp_info=pp_info,
        mappings=mapping_rows,
        serial_fractions=dict(serial_fractions) if serial_fractions else None,
        lower_bound_bytes=lower_bound,
        certified_bandwidth_optimal=certified,
    )
