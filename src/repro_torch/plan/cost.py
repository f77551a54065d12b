"""Analytic per-mode / per-node cost model behind ``plan_sweep``.

Port of ``repro.plan.cost`` for the ``"local"``, ``"sharded"``,
``"overlapping"`` and ``"compressed"`` executors: :class:`ModeCost`,
:func:`mode_cost`, :func:`node_cost`, :func:`executor_mode_cost` and
:func:`dimtree_mode_cost` (each with the reference's ``collective``
keyword), :func:`validate_executor`, :func:`compressed_allgather_bytes`,
the two-level prices (:func:`collective_level_bytes`,
:func:`hierarchical_applicable`) and the Ballard-Knight-Rouse
communication lower bound (:func:`mttkrp_comm_lower_bound`), and the
pairwise-perturbation prices (:func:`pp_build_cost`,
:func:`pp_correction_cost`, :func:`pp_amortized_cost`,
:data:`PP_EXACT_FRACTION`).  The flop/byte terms are the reference's,
term for term, on the per-device block dims of a sharded problem; a
batched problem scales every term by its ``local_batch`` (nothing is
shared across the batch).  A sharded node's completing reduction is
priced as the reference prices its psum: the ring all-reduce volume of
the local output block over the axes mapped to the contracted modes
(``collective_bytes``), split on a two-level mesh (``Problem.intra_axes``)
into the bytes that stay in a node and those that cross nodes
(``inter_bytes``), equal to the reference's byte for byte.  Seconds come
from the H100 constants of :mod:`repro_torch.analysis.roofline` under the
reference's bounded-overlap model::

    predicted_s = max(compute_s, collective_s)
                + serial_fraction * min(compute_s, collective_s)

with ``compute_s = flops / PEAK_FLOPS + bytes / HBM_BW`` and
``collective_s = intra_bytes / NVLINK_BW + inter_bytes / INFINIBAND_BW``.
``serial_fraction`` is 1 on the plain executors (the reduction waits for
the whole contraction) and ``1 / n_chunks`` on the overlapping one; the
compressed executor replaces the ring by the int8 gather's bytes and adds
its quantize and dequantize passes.  Measured fractions enter through
``serial_fractions``.  With H100 constants a plan may legitimately choose
other algorithms, executors, collectives and mappings than the JAX
package chooses (the links' ratio is 18x here, 4x there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Mapping

from repro_torch.analysis.roofline import HBM_BW, INFINIBAND_BW, NVLINK_BW, PEAK_FLOPS
from repro_torch.core.mttkrp import mttkrp_flops
from repro_torch.core.tensor_ops import dims_split

from .problem import Problem
from .schedule import ContractionNode, binary_schedule, pp_pairs, ring_allreduce_bytes

ALGORITHMS = (
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

# Executor kinds the planner dispatches over (repro_torch.plan.executor).
EXECUTORS = ("local", "sharded", "overlapping", "compressed")

# Default slab count of the overlapping executor's reduction pipeline: the
# serial fraction is about 1 / n_chunks, so 4 hides 75% of the hidable term
# while each slab's contraction stays large.
DEFAULT_OVERLAP_CHUNKS = 4

# compressed_psum's payload: one int8 byte an element plus one fp32 scale
# a sender (a quarter of an fp32 element's bytes).
_INT8_ITEMSIZE = 1.0
_SCALE_BYTES = 4.0

# Assumed long-run fraction of pairwise-perturbation sweeps that
# re-materialize the cache (factor drift crossing ``pp_tol``): the
# reference's planning assumption, 1 in 8.  A run's measured fraction is
# ``CPState.pp_exact_sweeps / CPState.it``.
PP_EXACT_FRACTION = 0.125


def validate_executor(problem: Problem, executor: str) -> None:
    """THE validity predicate for (problem, executor) pairings, as the
    reference's: ``local`` cannot run sharded problems, and the
    communication-hiding kinds need mapped modes to have anything to hide
    (a batch-parallel placement has no reduction).  Schedules never
    restrict the executor: any node's reduction can be overlapped or
    compressed.  Raises ``ValueError`` on rejection."""
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r} (choose from {EXECUTORS})")
    reason = None
    if executor == "local" and problem.sharded:
        reason = "it runs on one device but the problem maps modes/batch to mesh axes"
    elif executor in ("overlapping", "compressed") and not problem.mode_axes:
        reason = "it reschedules/compresses psums but the problem has none"
    if reason is not None:
        raise ValueError(f"executor {executor!r} cannot run this problem: {reason}")


def _level_shards(problem: Problem, reduce_axes) -> tuple[int, int]:
    """Split one reduction's participants into (intra ``k``, inter ``m``)
    shards: ``k`` over the axes of ``Problem.intra_axes``, ``m`` over the
    node-crossing rest."""
    k = m = 1
    for axis in reduce_axes:
        if axis in problem.intra_axes:
            k *= problem.axis_sizes[axis]
        else:
            m *= problem.axis_sizes[axis]
    return k, m


def collective_level_bytes(
    problem: Problem, block_bytes: float, reduce_axes, collective: str = "flat"
) -> tuple[float, float]:
    """Per-device ``(collective_bytes, inter_bytes)`` of one node's
    reduction of a ``block_bytes`` output block over ``reduce_axes``, as
    the reference splits it:

    * a single-level problem (no ``intra_axes``): the ring volume, all on
      the fast links (``inter_bytes = 0``);
    * a reduction within one node (``m <= 1``): the ring over the intra
      shards, nothing crosses nodes;
    * a reduction only across nodes (``k <= 1``): the whole ring on the
      slow level;
    * ``"flat"`` spanning both: one ring over all ``k * m`` devices, its
      slowest hops across nodes, so all of it is charged there;
    * ``"hierarchical"``: reduce-scatter and all-gather within the node
      (``2 B (k - 1) / k``) and a ring over the ``1/k`` shard across nodes
      (``2 (B / k) (m - 1) / m`` inter), the factor-``k`` cut of the slow
      level's volume.
    """
    k, m = _level_shards(problem, reduce_axes)
    if k * m <= 1:
        return 0.0, 0.0
    if not problem.intra_axes:
        return ring_allreduce_bytes(block_bytes, k * m), 0.0
    if m <= 1:
        return ring_allreduce_bytes(block_bytes, k), 0.0
    if k <= 1:
        t = ring_allreduce_bytes(block_bytes, m)
        return t, t
    if collective != "hierarchical":
        t = ring_allreduce_bytes(block_bytes, k * m)
        return t, t
    intra = ring_allreduce_bytes(block_bytes, k)
    inter = ring_allreduce_bytes(block_bytes / k, m)
    return intra + inter, inter


def hierarchical_applicable(problem: Problem, reduce_axes) -> bool:
    """True when a node's reduction spans both levels of a two-level mesh
    (``k > 1`` intra shards and ``m > 1`` nodes): only then does the
    hierarchical sum decompose instead of falling back to the flat one, so
    only then has the planner a flat-or-hierarchical choice."""
    k, m = _level_shards(problem, reduce_axes)
    return k > 1 and m > 1


def _node_grids(n_modes: int, nodes: int):
    """All integer grids ``(m_1 .. m_N)`` with ``prod m_i == nodes``."""
    if n_modes == 1:
        yield (nodes,)
        return
    d = 1
    while d * d <= nodes:
        if nodes % d == 0:
            for q in (d, nodes // d):
                for rest in _node_grids(n_modes - 1, nodes // q):
                    yield (q,) + rest
                if d * d == nodes:
                    break
        d += 1


def mttkrp_comm_lower_bound(
    shape, rank: int, mesh_shape, *, itemsize: float = 4.0, per_mode: bool = False
):
    """Communication lower bound of one full MTTKRP sweep over ``P`` nodes,
    the reference's Ballard/Knight/Rouse-style accounting (arXiv
    1708.07401): a block placement of the dense tensor on ``P`` nodes is an
    integer grid ``(m_1 .. m_N)`` with ``prod m_n = P``, and mode ``n``'s
    MTTKRP then reduces partial factor blocks across the ``P / m_n`` nodes
    sharing a mode-``n`` slab -- at best a ring all-reduce of the ``(I_n /
    m_n, R)`` block, ``2 (I_n / m_n) R s (1 - m_n / P)`` bytes a node.  The
    bound is the least per-sweep sum over all grids (fractional blocks
    allowed, so it bounds every realizable mapping).

    ``mesh_shape`` is the node count, or a tuple whose product is taken.
    Returns bytes a node a sweep; with ``per_mode=True`` ``(bound, terms,
    grid)``, ``terms[n]`` mode ``n``'s share at the minimizing grid.
    """
    dims = tuple(int(d) for d in shape)
    if not dims:
        raise ValueError("shape must have at least one mode")
    nodes = mesh_shape
    if not isinstance(nodes, int):
        nodes = math.prod(int(x) for x in mesh_shape)
    nodes = int(nodes)
    if nodes < 1:
        raise ValueError(f"node count must be >= 1, got {nodes}")
    s = float(itemsize)
    best = None
    best_grid = None
    for grid in _node_grids(len(dims), nodes):
        total = 0.0
        for d, m in zip(dims, grid):
            total += 2.0 * (d / m) * rank * s * (1.0 - m / nodes)
        if best is None or total < best:
            best, best_grid = total, grid
    if not per_mode:
        return best
    terms = tuple(
        2.0 * (d / m) * rank * s * (1.0 - m / nodes) for d, m in zip(dims, best_grid)
    )
    return best, terms, best_grid


@dataclass(frozen=True)
class ModeCost:
    """Cost terms for one contraction (a mode's MTTKRP or a schedule node).

    ``gemm_flops`` / ``krp_flops`` / ``second_step_flops`` are the terms of
    ``mttkrp_flops`` (local block dims for sharded problems); ``bytes`` is
    total HBM traffic including intermediates; ``collective_bytes`` is the
    per-device wire volume of the completing reduction (0 on unsharded
    problems) and ``inter_bytes`` its share that crosses the node boundary
    of a two-level mesh, priced at ``INFINIBAND_BW`` (0 on one level, where
    all of it rides NVLink).  ``serial_fraction`` is the
    executor's unhidable share of the smaller of the compute and collective
    times (1: no overlap, the additive model).  ``measured_s`` is a
    hardware-measured time from the tuning cache (``None`` when never
    measured); ``predicted_s`` stays model-only and ``expected_s`` prefers
    the measurement.
    """

    gemm_flops: float
    krp_flops: float
    second_step_flops: float
    bytes: float
    measured_s: float | None = None
    collective_bytes: float = 0.0
    inter_bytes: float = 0.0
    serial_fraction: float = 1.0

    @property
    def flops(self) -> float:
        """Total floating-point operations across all three terms."""
        return self.gemm_flops + self.krp_flops + self.second_step_flops

    @property
    def compute_s(self) -> float:
        """Roofline time: flops at peak plus HBM traffic at full rate."""
        return self.flops / PEAK_FLOPS + self.bytes / HBM_BW

    @property
    def intra_bytes(self) -> float:
        """Wire bytes on the fast level: the collective volume not
        crossing nodes."""
        return self.collective_bytes - self.inter_bytes

    @property
    def collective_s(self) -> float:
        """Wire time of the completing collective: the intra-node bytes at
        the nominal ``NVLINK_BW``, the node-crossing ones at
        ``INFINIBAND_BW``."""
        return self.intra_bytes / NVLINK_BW + self.inter_bytes / INFINIBAND_BW

    @property
    def predicted_s(self) -> float:
        """Bounded-overlap roofline: ``max + serial_fraction * min`` of the
        compute and collective times (``serial_fraction`` 1 is their sum:
        the reduction waits for the whole local contraction)."""
        c, q = self.compute_s, self.collective_s
        return max(c, q) + self.serial_fraction * min(c, q)

    @property
    def predicted_overlap_efficiency(self) -> float:
        """The share of the hidable (smaller) term that is hidden:
        ``1 - serial_fraction`` when there is a collective, else 0."""
        if self.collective_bytes <= 0.0:
            return 0.0
        return 1.0 - self.serial_fraction

    @property
    def expected_s(self) -> float:
        """The measurement when one exists, the prediction otherwise."""
        return self.predicted_s if self.measured_s is None else self.measured_s

    def as_dict(self) -> dict:
        """JSON-ready projection of all terms plus the derived predictions,
        under the reference's keys."""
        return {
            "gemm_flops": self.gemm_flops,
            "krp_flops": self.krp_flops,
            "second_step_flops": self.second_step_flops,
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "intra_bytes": self.intra_bytes,
            "inter_bytes": self.inter_bytes,
            "serial_fraction": self.serial_fraction,
            "compute_s": self.compute_s,
            "collective_s": self.collective_s,
            "predicted_overlap_efficiency": self.predicted_overlap_efficiency,
            "predicted_s": self.predicted_s,
            "measured_s": self.measured_s,
            "expected_s": self.expected_s,
        }


def compressed_allgather_bytes(
    block_bytes: float, participants: int, itemsize: float = 4.0
) -> float:
    """Per-device wire bytes of :func:`repro_torch.dist.collectives.compressed_psum`:
    each device receives the ``participants - 1`` other int8 payloads
    (``block_bytes / itemsize`` bytes each) plus one fp32 scale each.
    Against the fp32 ring all-reduce (``2 B (p - 1) / p``) the ratio is
    ``p / 8``: a gain for few participants (4x at 2) that vanishes at 8 and
    inverts beyond, which is why the executor is chosen by cost."""
    if participants <= 1:
        return 0.0
    payload = block_bytes * _INT8_ITEMSIZE / itemsize
    return (participants - 1) * (payload + _SCALE_BYTES)


def _fused_krp_dims(local_shape, n: int) -> tuple[int, int]:
    """Row counts of the two partial KRPs the fused kernel streams
    (internal modes: the L/R sides; external modes: the log-balanced split
    of :func:`repro_torch.kernels.ops.fused_mttkrp`)."""
    L, _, R = dims_split(local_shape, n)
    if 0 < n < len(local_shape) - 1:
        return L, R
    from repro_torch.kernels.ops import balanced_split

    dims = [d for k, d in enumerate(local_shape) if k != n]
    if len(dims) < 2:
        return dims[0] if dims else 1, 1
    s = balanced_split(dims)
    return math.prod(dims[:s]), math.prod(dims[s:])


def mode_cost(
    problem: Problem, n: int, algorithm: str, *, collective: str = "flat"
) -> ModeCost:
    """Cost of one mode-``n`` MTTKRP under ``algorithm``, on the per-device
    block dims, with the ring all-reduce of the local output block over the
    axes mapped to the contracted modes for a sharded problem (none when
    mode ``n`` is the only mapped mode: its axis carries the output rows).
    On a two-level problem ``collective`` picks how that volume splits over
    the levels (:func:`collective_level_bytes`); on one level both values
    price the flat ring, as in the reference.

    ``"dimtree"`` prices the mode's share of the balanced binary schedule
    via :func:`dimtree_mode_cost`.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r} (choose from {ALGORITHMS})")
    if algorithm == "dimtree":
        return dimtree_mode_cost(problem, n, (problem.ndim + 1) // 2, collective=collective)
    shape = problem.local_shape
    c = problem.rank
    s = problem.itemsize
    lb = problem.local_batch
    base = mttkrp_flops(shape, c, n, itemsize=s, batch=lb)
    L, In, R = dims_split(shape, n)
    out_bytes = In * c * s * lb
    coll, inter = collective_level_bytes(problem, out_bytes, problem.reduce_axes_for(n),
                                         collective)
    wire = dict(collective_bytes=coll, inter_bytes=inter)

    if algorithm == "2step" and not problem.external_mode(n):
        # forced 2-step resolves its order by cost, like the Alg. 4 line-4 rule
        left = mode_cost(problem, n, "2step-left", collective=collective)
        right = mode_cost(problem, n, "2step-right", collective=collective)
        return left if left.predicted_s < right.predicted_s else right

    if algorithm == "1step" or (
        problem.external_mode(n) and algorithm in ("2step", "2step-left", "2step-right")
    ):
        # explicit KRP: L*R*C materialized (written once, read once by the GEMM)
        return ModeCost(
            gemm_flops=base["gemm_flops"],
            krp_flops=base["krp_flops"],
            second_step_flops=0.0,
            bytes=base["tensor_bytes"] + 2.0 * base["krp_bytes"] + out_bytes,
            **wire,
        )
    if algorithm in ("2step-left", "2step-right"):
        second_side = R if algorithm == "2step-left" else L
        intermediate = In * second_side * c * s * lb
        return ModeCost(
            gemm_flops=base["gemm_flops"],
            krp_flops=float((L + R) * c * lb),
            second_step_flops=2.0 * In * second_side * c * lb,
            bytes=base["tensor_bytes"] + 2.0 * intermediate + (L + R) * c * s * lb + out_bytes,
            **wire,
        )
    if algorithm == "fused":
        da, db = _fused_krp_dims(shape, n)
        return ModeCost(
            gemm_flops=base["gemm_flops"],
            krp_flops=float((da + db) * c * lb),
            second_step_flops=0.0,
            # the full KRP never hits HBM -- only the two partials stream in
            bytes=base["tensor_bytes"] + (da + db) * c * s * lb + out_bytes,
            **wire,
        )
    if algorithm == "matrix_free":
        # bytes-read-once: the tensor streams through exactly once, the raw
        # non-target factors ride along, nothing of KRP shape is written
        others = [k for k in range(len(shape)) if k != n]
        spatial = float(math.prod(shape)) / shape[others[-1]]
        fold = 0.0
        for k in reversed(others[:-1]):
            fold += 2.0 * spatial * c * lb
            spatial /= shape[k]
        factor_bytes = float(sum(shape[k] for k in others)) * c * s * lb
        return ModeCost(
            gemm_flops=base["gemm_flops"],
            krp_flops=0.0,
            second_step_flops=fold,
            bytes=base["tensor_bytes"] + factor_bytes + out_bytes,
            **wire,
        )
    if algorithm == "einsum":
        return ModeCost(
            gemm_flops=base["gemm_flops"],
            krp_flops=0.0,
            second_step_flops=0.0,
            bytes=base["tensor_bytes"] + (L + In + R) * c * s * lb + out_bytes,
            **wire,
        )
    # baseline: reorder (transpose copy: read + write) then one GEMM over the copy
    return ModeCost(
        gemm_flops=base["gemm_flops"],
        krp_flops=base["krp_flops"],
        second_step_flops=0.0,
        bytes=3.0 * base["tensor_bytes"] + 2.0 * base["krp_bytes"] + out_bytes,
        **wire,
    )


def _compress_terms(
    problem: Problem,
    base: ModeCost,
    block_bytes: float,
    participants: int,
    *,
    reduce_axes=(),
    collective: str = "flat",
) -> ModeCost:
    """Replace a node's ring all-reduce by the int8 error-feedback gather:
    the wire bytes become :func:`compressed_allgather_bytes` of the local
    output block, and HBM traffic grows by the quantize pass (write and
    read the int8 block) and the dequantize pass (read the ``p - 1``
    gathered payloads).  On a two-level problem ``"hierarchical"`` prices
    the split the executors run: an exact ring within the node and the
    int8 gather across the ``m`` nodes only."""
    s = problem.itemsize
    int8_block = block_bytes * _INT8_ITEMSIZE / s
    k, m = _level_shards(problem, reduce_axes)
    if collective == "hierarchical" and k > 1 and m > 1:
        intra = ring_allreduce_bytes(block_bytes, k)
        inter = compressed_allgather_bytes(block_bytes, m, s)
        return replace(
            base,
            collective_bytes=intra + inter,
            inter_bytes=inter,
            bytes=base.bytes + (m + 1) * int8_block,
        )
    coll = compressed_allgather_bytes(block_bytes, participants, s)
    return replace(
        base,
        collective_bytes=coll,
        inter_bytes=coll if (problem.intra_axes and m > 1) else 0.0,
        bytes=base.bytes + (participants + 1) * int8_block,
    )


def _adjust(
    problem: Problem,
    base: ModeCost,
    executor: str,
    *,
    chunk_extent: int,
    n_chunks: int,
    block_bytes: float,
    participants: int,
    serial_fractions: Mapping[str, float] | None,
    reduce_axes=(),
    collective: str = "flat",
) -> ModeCost:
    """The executor's adjustment of a node's terms: the compression terms,
    then the schedule's serial fraction (``1 / chunks`` on the overlapping
    executor, chunks capped by the slab axis' local extent, unless a
    fitted fraction is given)."""
    if executor == "compressed" and base.collective_bytes > 0.0:
        base = _compress_terms(problem, base, block_bytes, participants,
                               reduce_axes=reduce_axes, collective=collective)
    fitted = (serial_fractions or {}).get(executor)
    if base.collective_bytes <= 0.0:
        return base
    if executor == "overlapping":
        chunks = max(1, min(int(n_chunks), int(chunk_extent)))
        f = float(fitted) if fitted is not None else 1.0 / chunks
        return replace(base, serial_fraction=f)
    if fitted is not None:
        return replace(base, serial_fraction=float(fitted))
    return base


def executor_mode_cost(
    problem: Problem,
    n: int,
    algorithm: str,
    executor: str = "sharded",
    *,
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    serial_fractions: Mapping[str, float] | None = None,
    collective: str = "flat",
) -> ModeCost:
    """Cost of one mode-``n`` MTTKRP under ``algorithm`` on ``executor``,
    the executor's adjustments on top of :func:`mode_cost`:

    * ``"local"`` / ``"sharded"`` -- the per-algorithm terms unchanged
      (serial fraction 1: the reduction waits for the whole contraction);
    * ``"overlapping"`` -- the same terms, but the slab pipeline hides all
      but ``1 / n_chunks`` of the smaller of compute and collective time
      (chunks capped by mode ``n``'s local extent);
    * ``"compressed"`` -- the ring all-reduce becomes the int8 gather
      (:func:`compressed_allgather_bytes`) and HBM traffic grows by the
      quantize and dequantize passes.

    ``serial_fractions`` (executor kind -> measured unhidable fraction,
    e.g. from :func:`repro_torch.plan.autotune.tune`) overrides the analytic
    defaults.  ``collective`` as in :func:`mode_cost`."""
    validate_executor(problem, executor)
    base = mode_cost(problem, n, algorithm, collective=collective)
    _, in_local, _ = dims_split(problem.local_shape, n)
    block = in_local * problem.rank * problem.itemsize * problem.local_batch
    axes = problem.reduce_axes_for(n)
    p = math.prod(problem.axis_sizes[a] for a in axes)
    return _adjust(
        problem, base, executor, chunk_extent=problem.local_shape[n], n_chunks=n_chunks,
        block_bytes=block, participants=p, serial_fractions=serial_fractions,
        reduce_axes=axes, collective=collective,
    )


def node_cost(
    problem: Problem,
    node: ContractionNode,
    executor: str | None = None,
    *,
    algorithm: str = "1step",
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    serial_fractions: Mapping[str, float] | None = None,
    collective: str = "flat",
) -> ModeCost:
    """Cost of one schedule node's contraction on ``executor``
    (``None``: ``"sharded"`` for a sharded problem, ``"local"`` otherwise),
    on the per-device block dims:

    * leaf off the root -- a full mode MTTKRP under ``algorithm``;
    * internal node off the root -- one X-sized GEMM against the KRP of the
      contracted modes, writing the partial tensor;
    * any node off a partial -- a multi-TTV: one pass over the parent's
      partial per contracted mode, shrinking as it goes;

    each plus the ring all-reduce of its output block over the axes of the
    mapped modes contracted at that node (split over the levels of a
    two-level mesh per ``collective``), adjusted for the executor as in
    :func:`executor_mode_cost` (the overlapping executor's slabs run along
    the node's first kept mode).
    """
    if executor is None:
        executor = "sharded" if problem.sharded else "local"
    validate_executor(problem, executor)
    if node.is_root:
        raise ValueError("the schedule root is the raw tensor, not a contraction")
    if node.from_root and node.is_leaf:
        return executor_mode_cost(
            problem, node.lo, algorithm, executor, n_chunks=n_chunks,
            serial_fractions=serial_fractions, collective=collective,
        )
    c = problem.rank
    s = problem.itemsize
    lb = problem.local_batch
    local = problem.local_shape
    t_bytes = math.prod(node.local_shape) * lb * s  # kept local dims * rank (x batch)
    coll, inter = collective_level_bytes(problem, t_bytes, node.reduce_axes, collective)
    wire = dict(collective_bytes=coll, inter_bytes=inter)
    if node.from_root:
        total = math.prod(local) * lb
        krp_elems = (
            math.prod(local[m] for m in node.contracted) * c * lb if node.contracted else 0
        )
        base = ModeCost(
            gemm_flops=2.0 * total * c,
            krp_flops=float(krp_elems),
            second_step_flops=0.0,
            bytes=total * s + 2.0 * krp_elems * s + t_bytes,
            **wire,
        )
    else:
        parent_elems = math.prod(local[node.parent_lo : node.parent_hi]) * c * lb
        ttv = 0.0
        elems = float(parent_elems)
        for m in node.contracted:
            ttv += 2.0 * elems
            elems /= local[m]
        base = ModeCost(
            gemm_flops=0.0,
            krp_flops=0.0,
            second_step_flops=ttv,
            bytes=parent_elems * s + t_bytes,
            **wire,
        )
    return _adjust(
        problem, base, executor, chunk_extent=local[node.lo], n_chunks=n_chunks,
        block_bytes=t_bytes, participants=node.psum_participants,
        serial_fractions=serial_fractions, reduce_axes=node.reduce_axes, collective=collective,
    )


def dimtree_mode_cost(
    problem: Problem, n: int, split: int, *, collective: str = "flat"
) -> ModeCost:
    """Dimension-tree cost of mode ``n`` given the half split at ``split``:
    the mode's leaf, plus its half's partial contraction (GEMM and
    reduction) for the first mode of each multi-mode half (summing over
    modes equals summing :func:`node_cost` over the binary schedule's
    nodes)."""
    sched = binary_schedule(problem, split)
    leaf = sched.leaf_for_mode(n)
    total = node_cost(problem, leaf, algorithm="1step", collective=collective)
    if not leaf.from_root and n == leaf.parent_lo:
        head = node_cost(problem, sched.nodes[leaf.parent], collective=collective)
        total = ModeCost(
            gemm_flops=total.gemm_flops + head.gemm_flops,
            krp_flops=total.krp_flops + head.krp_flops,
            second_step_flops=total.second_step_flops + head.second_step_flops,
            bytes=total.bytes + head.bytes,
            collective_bytes=total.collective_bytes + head.collective_bytes,
            inter_bytes=total.inter_bytes + head.inter_bytes,
        )
    return total


def pp_build_cost(problem: Problem) -> ModeCost:
    """Cost of materializing the pairwise-perturbation cache once: one pass
    over the (local) tensor per pair intermediate ``M_{n,m}`` (the per-pair
    einsum the executor runs, not an amortizing tree), each completed by
    its ring all-reduce over the axes mapped to the contracted modes
    (:func:`repro_torch.plan.schedule.pp_pairs` stamps the volume), plus
    the N small base contractions ``M_{n,m} x V_m``.  Paid on every exact
    sweep that rebuilds, so the planner adds it to the exact-sweep term."""
    c = problem.rank
    s = problem.itemsize
    lb = problem.local_batch
    total = math.prod(problem.local_shape) * lb
    gemm = byts = coll = 0.0
    for pair in pp_pairs(problem):
        gemm += 2.0 * total * c
        byts += total * s + math.prod(pair.local_shape) * lb * s
        coll += pair.psum_bytes
    # base terms: one correction-shaped GEMM per mode off its first pair
    for n in range(problem.ndim):
        m = 1 if n == 0 else 0
        ln, lm = problem.local_shape[n], problem.local_shape[m]
        gemm += 2.0 * ln * lm * c * lb
        byts += (ln * lm * c + lm * c + ln * c) * s * lb
    return ModeCost(gemm_flops=gemm, krp_flops=0.0, second_step_flops=0.0, bytes=byts,
                    collective_bytes=coll)


def pp_correction_cost(problem: Problem) -> ModeCost:
    """Cost of ONE approximate (correction-only) PP sweep, all modes: each
    mode's MTTKRP is its cached base plus ``N - 1`` small GEMMs
    ``(C, I_n, I_m) x (I_m, C) -> (I_n, C)``, so the sweep never touches
    the tensor: ``O(sum I_n I_m C)`` flops instead of ``O(N |X| C)``.  On
    a sharded problem the contraction over a mapped mode ``m`` ends in a
    ring all-reduce of the ``(I_n, C)`` block over that mode's axis."""
    c = problem.rank
    s = problem.itemsize
    lb = problem.local_batch
    gemm = byts = coll = 0.0
    for n in range(problem.ndim):
        ln = problem.local_shape[n]
        out_bytes = ln * c * s * lb
        for m in range(problem.ndim):
            if m == n:
                continue
            lm = problem.local_shape[m]
            gemm += 2.0 * ln * lm * c * lb
            byts += (ln * lm * c + lm * c) * s * lb + out_bytes
            coll += ring_allreduce_bytes(out_bytes, problem.mode_shards(m))
    return ModeCost(gemm_flops=gemm, krp_flops=0.0, second_step_flops=0.0, bytes=byts,
                    collective_bytes=coll)


def pp_amortized_cost(
    problem: Problem,
    exact_sweep_s: float,
    *,
    exact_fraction: float = PP_EXACT_FRACTION,
    build_s: float | None = None,
    correction_s: float | None = None,
) -> dict:
    """Amortized per-sweep price of the PP strategy, as a ``describe()`` row:
    ``f * (exact_sweep_s + build_s) + (1 - f) * correction_s`` with ``f``
    the assumed exact-sweep fraction.  ``build_s`` / ``correction_s``
    default to the analytic predictions; pass hardware measurements (from
    :func:`repro_torch.plan.autotune.tune`) to price on the measured
    basis.  Slightly over-prices PP (the engine builds only after exact
    sweeps whose own step settled under the tolerance), so the argmin errs
    toward the exact strategy."""
    if build_s is None:
        build_s = pp_build_cost(problem).predicted_s
    if correction_s is None:
        correction_s = pp_correction_cost(problem).predicted_s
    f = float(exact_fraction)
    amortized = f * (exact_sweep_s + build_s) + (1.0 - f) * correction_s
    return {
        "tol": problem.pp_tol,
        "exact_fraction": f,
        "exact_sweep_s": exact_sweep_s,
        "build_s": build_s,
        "correction_sweep_s": correction_s,
        "amortized_sweep_s": amortized,
    }
