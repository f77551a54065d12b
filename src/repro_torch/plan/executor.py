"""Executors: where a planned contraction actually runs.

Port of ``repro.plan.executor``: the :class:`Executor` protocol,
:class:`LocalExecutor` (schedule nodes and the pairwise-perturbation
intermediates on one device), :class:`ShardedExecutor` (the same local
contractions and pairwise intermediates on this rank's block of a
DeviceMesh-sharded problem, each completed by the ordered reduction of
:mod:`repro_torch.dist`, flat or two-level as the plan's node says),
:class:`OverlappingExecutor` (the same results, each node's reduction
issued slab by slab behind the contraction: communication hiding, exact),
:class:`CompressedShardedExecutor` (each node's reduction the int8
error-feedback gather, the per-node residuals threaded through the sweep
as carry state: communication compression, approximate but convergent)
and :func:`make_executor`.

Besides ``contract``, an executor gives the sweep engine two hooks for the
small algebra of a sweep (:mod:`repro_torch.plan.sweep`):

* ``allsum(t, modes)`` sums a partial result over the ranks that hold
  different index blocks of ``modes`` -- the row sums of the Grams, the
  column norms and the fit's inner product, and the tensor norm.  The
  identity on one device, so a world of one runs the local engine's
  operations bitwise.
* ``gather_fits(fits)`` turns this rank's per-sweep fits into the whole
  batch's, so every rank takes the same stopping decision.
"""

from __future__ import annotations

from typing import Mapping, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core.dimtree import contract_from_partial, partial_mttkrp_range
from repro_torch.core.mttkrp import mttkrp, mttkrp_batched

from repro_torch.dist.collectives import gather_cat, ordered_psum
from repro_torch.dist.dist_mttkrp import (
    _validate_collective,
    contract_block,
    contract_block_compressed,
    mttkrp_block,
    mttkrp_compressed_block,
    mttkrp_overlapped_block,
    pp_pairs_block,
    shard_problem,
)

from .cost import DEFAULT_OVERLAP_CHUNKS, EXECUTORS
from .schedule import ContractionNode

Tensor = torch.Tensor


def _node_is_batched(node: ContractionNode, src: Tensor) -> bool:
    """True when ``src`` carries a leading batch axis over the node's shape.

    The unbatched source of a node has a known rank from the topology alone:
    the raw tensor's order for root contractions, the parent's kept modes
    plus the rank axis for partial-to-partial ones.  One extra axis = batch.
    """
    expected = (node.parent_hi - node.parent_lo) + (0 if node.from_root else 1)
    return src.ndim == expected + 1


@runtime_checkable
class Executor(Protocol):
    """The contractions an ALS sweep needs, placement included.

    The schedule walker drives everything through :meth:`contract` -- one
    entry point per :class:`repro_torch.plan.schedule.ContractionNode`,
    whether the node is a full mode MTTKRP, a root-level partial GEMM, or a
    partial-to-partial multi-TTV.
    """

    def prepare(self, problem, x: Tensor, factors: Sequence[Tensor]):
        """Place tensor + factors for this executor (identity when local)."""
        ...

    def contract(
        self, node: ContractionNode, src: Tensor, factors: Sequence[Tensor],
        algorithm: str = "auto", tiles: Mapping[str, int] | None = None,
        collective: str = "flat",
    ) -> Tensor:
        """Run one schedule node's contraction of ``src`` (the parent's
        output; the raw tensor for children of the root).  ``collective``
        is the plan's completing reduction for the node
        (``NodePlan.collective``; ignored by executors without one)."""
        ...

    def allsum(self, t: Tensor, modes: Sequence[int]) -> Tensor:
        """``t`` summed over the ranks holding other index blocks of
        ``modes`` (the identity on one device)."""
        ...

    def gather_fits(self, fits: list[Tensor]) -> list[Tensor]:
        """The whole batch's per-sweep fits from this rank's."""
        ...


class LocalExecutor:
    """Single-device execution of the paper's shared-memory algorithms on
    whatever device the tensor lies on."""

    def prepare(self, problem, x: Tensor, factors: Sequence[Tensor]):
        """No placement needed on one device: returns inputs unchanged."""
        return x, list(factors)

    def contract(
        self, node: ContractionNode, src: Tensor, factors: Sequence[Tensor],
        algorithm: str = "auto", tiles: Mapping[str, int] | None = None,
        collective: str = "flat",
    ) -> Tensor:
        """One schedule node: the planned MTTKRP for leaves off the root,
        the range GEMM for internal nodes off the root, a multi-TTV einsum
        for anything contracted from a partial.  A leading batch axis on
        ``src`` (and every factor) runs the batched MTTKRP for leaves (the
        batched kernels under ``fused``/``matrix_free``) and a
        ``torch.func.vmap`` of the same contraction otherwise.
        ``collective`` is accepted for the protocol and ignored: one device
        has nothing to reduce."""
        batched = _node_is_batched(node, src)
        if node.from_root:
            if node.is_leaf:
                run = mttkrp_batched if batched else mttkrp
                return run(src, list(factors), node.mode, method=algorithm, tiles=tiles)
            if batched:
                return torch.func.vmap(
                    lambda t, *fs: partial_mttkrp_range(t, list(fs), node.lo, node.hi)
                )(src, *factors)
            return partial_mttkrp_range(src, list(factors), node.lo, node.hi)
        if batched:
            return torch.func.vmap(
                lambda t, *fs: contract_from_partial(
                    t, dict(zip(node.contracted, fs)), node.lo, node.hi, node.parent_lo
                )
            )(src, *[factors[m] for m in node.contracted])
        sibs = {m: factors[m] for m in node.contracted}
        return contract_from_partial(src, sibs, node.lo, node.hi, node.parent_lo)

    def pp_pairs(
        self, problem, x: Tensor, factors: Sequence[Tensor]
    ) -> dict[tuple[int, int], Tensor]:
        """All pairwise-perturbation intermediates at the current factors:
        ``{(n, m): M_nm}`` for every ``n < m`` with
        ``M_nm[c, i_n, i_m] = sum X * prod_{k not in {n,m}} U_k[i_k, c]``
        in the rank-major layout of :class:`repro_torch.plan.schedule.PPPair`.
        One einsum a pair, contracted rank-last (the GEMM orientation), then
        rank moved to the front and made contiguous, so every correction is
        a stride-1 batched GEMM; a leading batch axis on ``x`` and the
        factors broadcasts through the ``...`` prefix.  The sharded
        executors' block build with no mapped mode, so nothing to reduce
        (:func:`repro_torch.dist.dist_mttkrp.pp_pairs_block`)."""
        return pp_pairs_block(x, list(factors), {}, None)

    def allsum(self, t: Tensor, modes: Sequence[int]) -> Tensor:
        """One device holds every row: the identity."""
        return t

    def gather_fits(self, fits: list[Tensor]) -> list[Tensor]:
        """One device holds the whole batch: the identity."""
        return fits


class ShardedExecutor:
    """Block-distributed execution over a ``torch.distributed`` DeviceMesh,
    one process a rank.

    Holds the concrete mesh and ``mode_axes`` mapping (the Problem carries
    only their sizes).  :meth:`prepare` keeps this rank's blocks of the
    global tensor and factors; every node contraction is the local
    shared-memory contraction on the blocks -- the LocalExecutor's own calls,
    so ``fused``/``matrix_free`` leaves launch the CUDA kernels -- plus the
    ordered reduction over the axes mapped to the modes contracted at that
    node (:func:`repro_torch.dist.dist_mttkrp.contract_block`).  The small
    Gram/pinv algebra runs in the engine on every rank, its row sums
    completed through :meth:`allsum`.

    ``batch_axes`` names the mesh axes the leading batch dimension of a
    batched problem is cut over (empty: batch whole on every rank, or no
    batch).  Batch-parallel placements (``mode_axes`` empty, ``batch_axes``
    set) run every contraction without a collective: each rank owns whole
    problems.  ``node_axis`` names the intra-node axis of a two-level mesh
    (``Problem.node_axis`` of a problem built with ``intra_axes``): a node
    planned with ``collective="hierarchical"`` reduce-scatters over it,
    sums the shard across nodes and gathers it back.
    """

    # slab count of a tree node's reduction: 1 = one reduction
    _n_chunks = 1

    def __init__(self, mesh, mode_axes, batch_axes=(), node_axis=None):
        self.mesh = mesh
        self.mode_axes = dict(mode_axes)
        self.batch_axes = tuple(batch_axes)
        self.node_axis = node_axis

    def prepare(self, problem, x: Tensor, factors: Sequence[Tensor]):
        """This rank's blocks of the global tensor and factors per
        ``mode_axes`` (no reordering); a leading batch axis is cut over
        ``batch_axes``."""
        return shard_problem(x, factors, self.mode_axes, self.mesh, batch_axes=self.batch_axes)

    def contract(
        self, node: ContractionNode, src: Tensor, factors: Sequence[Tensor],
        algorithm: str = "auto", tiles: Mapping[str, int] | None = None,
        collective: str = "flat",
    ) -> Tensor:
        """One schedule node on this rank's blocks: the local contraction
        plus the node's ordered reduction over the axes mapped to its
        contracted modes, flat or hierarchical (over ``node_axis``) per
        ``collective``."""
        _validate_collective(collective)
        if node.from_root and node.is_leaf:
            return mttkrp_block(
                src, list(factors), node.mode, self.mode_axes, self.mesh,
                method=algorithm, tiles=tiles, collective=collective, node_axis=self.node_axis,
            )
        return contract_block(
            src, list(factors), node.lo, node.hi, node.parent_lo, node.parent_hi,
            self.mode_axes, self.mesh, from_root=node.from_root, n_chunks=self._n_chunks,
            collective=collective, node_axis=self.node_axis,
        )

    def pp_pairs(
        self, problem, x: Tensor, factors: Sequence[Tensor]
    ) -> dict[tuple[int, int], Tensor]:
        """All pairwise-perturbation intermediates of this rank's blocks
        (``x`` and ``factors`` as :meth:`prepare` cut them):
        :func:`repro_torch.dist.dist_mttkrp.pp_pairs_block`, the local
        einsum of :meth:`LocalExecutor.pp_pairs` on the blocks, each pair
        reduced in order over the axes of its contracted modes only, so
        pair ``(n, m)`` is cut over the axes of modes ``n`` and ``m`` as
        the factors its corrections perturb.  The overlapping and
        compressed executors inherit it: the build stays exact."""
        return pp_pairs_block(x, list(factors), self.mode_axes, self.mesh)

    def allsum(self, t: Tensor, modes: Sequence[int]) -> Tensor:
        """``t`` summed over the ranks that hold different index blocks of
        ``modes``: the ordered reduction over the axes mapped to them, in
        mode order (the identity when none is mapped)."""
        axes = tuple(self.mode_axes[m] for m in sorted(set(modes)) if m in self.mode_axes)
        return ordered_psum(t, axes, self.mesh) if axes else t

    def gather_fits(self, fits: list[Tensor]) -> list[Tensor]:
        """The whole batch's per-sweep fits from this rank's: one gather a
        batch axis over the chunk's fits stacked (the identity when the
        batch is not cut: then every rank holds the same fits)."""
        if not self.batch_axes or fits[0].ndim == 0:
            return fits
        return list(gather_cat(torch.stack(fits), self.batch_axes, self.mesh, dim=-1).unbind(0))


class OverlappingExecutor(ShardedExecutor):
    """Communication-hiding sharded executor (exact).

    The placement and results of :class:`ShardedExecutor`, but every
    node's reduction is pipelined in ``n_chunks`` slabs along its first
    kept mode, each issued asynchronously (``async_op=True``) before the
    next slab's work is queued: a full MTTKRP leaf runs one local MTTKRP a
    slab (its own GEMM or kernel launch, so the leaf agrees with the plain
    executor at fp32 tolerance:
    :func:`repro_torch.dist.dist_mttkrp.mttkrp_overlapped_block`), and a
    tree node runs one local contraction and reduces its slabs' disjoint
    rows (bitwise the plain executor's).  Only the schedule changes.
    """

    def __init__(
        self, mesh, mode_axes, n_chunks: int = DEFAULT_OVERLAP_CHUNKS, batch_axes=(),
        node_axis=None,
    ):
        super().__init__(mesh, mode_axes, batch_axes, node_axis)
        self.n_chunks = int(n_chunks)

    @property
    def _n_chunks(self) -> int:
        """Slab count of the inherited tree-node ``contract``."""
        return self.n_chunks

    def contract(
        self, node: ContractionNode, src: Tensor, factors: Sequence[Tensor],
        algorithm: str = "auto", tiles: Mapping[str, int] | None = None,
        collective: str = "flat",
    ) -> Tensor:
        """One schedule node with its reduction issued behind the slab
        contractions (flat or hierarchical per ``collective``)."""
        _validate_collective(collective)
        if node.from_root and node.is_leaf:
            return mttkrp_overlapped_block(
                src, list(factors), node.mode, self.mode_axes, self.mesh,
                method=algorithm, tiles=tiles, n_chunks=self.n_chunks,
                collective=collective, node_axis=self.node_axis,
            )
        return super().contract(node, src, factors, algorithm, tiles=tiles, collective=collective)


class CompressedShardedExecutor(ShardedExecutor):
    """Communication-compressing sharded executor (approximate, convergent).

    Every node's reduction -- the per-mode MTTKRP reductions and the
    partial contractions of tree schedules -- runs through the int8
    error-feedback gather (:func:`repro_torch.dist.collectives.compressed_psum`):
    each rank quantizes its partial plus its carried residual, the int8
    payloads are gathered and every rank adds them dequantized in rank
    order.  The per-node residuals are sweep state: :meth:`init_carry`
    makes them, the engine threads them through :meth:`contract_carry`, so
    the accumulated quantization error of every node stays within one int8
    step and compressed CP-ALS converges to the exact fit.  The engine's
    ``allsum`` and ``gather_fits`` hooks stay exact: only node
    contractions are compressed.  Nodes whose mapping needs no reduction
    run the exact path.
    """

    def init_carry(self, plan, x: Tensor, factors: Sequence[Tensor]) -> dict[int, Tensor]:
        """Zero residuals, one for every schedule node that reduces: this
        rank's output block of the node (after a leading axis of the local
        batch for a batched problem), fp32, on ``x``'s device.  The
        reference's residuals are global arrays with one leading axis a
        reduced mesh axis; SPMD, each rank holds its own."""
        prob = plan.problem
        lead = (prob.local_batch,) if prob.batched else ()
        return {
            node.id: torch.zeros(lead + tuple(node.local_shape), dtype=torch.float32,
                                 device=x.device)
            for node in plan.resolved_schedule.walk()
            if node.reduce_axes
        }

    def contract_carry(
        self,
        node: ContractionNode,
        src: Tensor,
        factors: Sequence[Tensor],
        algorithm: str,
        carry,
        tiles: Mapping[str, int] | None = None,
        collective: str = "flat",
    ) -> tuple[Tensor, dict]:
        """Compressed node contraction; returns ``(result, new_carry)``.  A
        node without a residual runs the exact path and leaves the carry as
        it is; ``tiles`` threads the plan's kernel knob into the local
        MTTKRP.  With ``collective="hierarchical"`` the intra-node stage is
        an exact sum over ``node_axis`` and only the cross-node one is
        compressed."""
        _validate_collective(collective)
        if carry is None or node.id not in carry:
            out = self.contract(node, src, factors, algorithm, tiles=tiles, collective=collective)
            return out, carry
        err = carry[node.id]
        if node.from_root and node.is_leaf:
            out, new_err = mttkrp_compressed_block(
                src, list(factors), node.mode, self.mode_axes, self.mesh, err,
                method=algorithm, tiles=tiles, collective=collective, node_axis=self.node_axis,
            )
        else:
            out, new_err = contract_block_compressed(
                src, list(factors), node.lo, node.hi, node.parent_lo, node.parent_hi,
                self.mode_axes, self.mesh, err, from_root=node.from_root,
                collective=collective, node_axis=self.node_axis,
            )
        return out, {**carry, node.id: new_err}


def make_executor(
    kind: str,
    mesh=None,
    mode_axes=None,
    *,
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    batch_axes=(),
    node_axis=None,
) -> Executor:
    """Instantiate the executor for a planner-chosen kind.

    ``kind`` is a ``SweepPlan.executor`` value (one of
    :data:`repro_torch.plan.cost.EXECUTORS`); the sharded kinds need the
    concrete ``mesh`` + ``mode_axes``, which the Problem does not carry.
    ``n_chunks`` sizes the overlapping executor's slab pipeline;
    ``batch_axes`` names the mesh axes a batched problem's leading batch
    dimension is cut over (batch-parallel placements pass ``mode_axes={}``
    plus the batch axes); ``node_axis`` names the intra-node mesh axis the
    hierarchical collective decomposes over (``Problem.node_axis`` for
    problems built with ``intra_axes``).
    """
    if kind not in EXECUTORS:
        raise ValueError(f"unknown executor kind {kind!r} (choose from {EXECUTORS})")
    if kind == "local":
        return LocalExecutor()
    if mesh is None or mode_axes is None:
        raise ValueError(f"executor {kind!r} needs mesh and mode_axes")
    if kind == "overlapping":
        return OverlappingExecutor(mesh, mode_axes, n_chunks, batch_axes, node_axis)
    if kind == "compressed":
        return CompressedShardedExecutor(mesh, mode_axes, batch_axes, node_axis)
    return ShardedExecutor(mesh, mode_axes, batch_axes, node_axis)
