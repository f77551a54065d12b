"""Block-distributed MTTKRP and CP-ALS over a ``torch.distributed`` DeviceMesh.

Port of ``repro.dist.dist_mttkrp``.  The paper's
shared-memory parallelization assigns contiguous row blocks of the
(never-materialized) matricization to threads; the distributed port
assigns contiguous *index blocks of the tensor modes* to devices.  A
``mode_axes`` mapping ``{mode: mesh axis}`` places the dense tensor on an
N-D grid without reordering a single entry: every rank holds a natural
row-major subtensor (a block of each mapped mode, all of each unmapped
mode), and each factor ``U_k`` is row-distributed over the axis of its mode
(or whole on every rank when mode ``k`` is unmapped).

Per-mode-n MTTKRP then factors exactly as in Ballard/Knight/Rouse's
communication lower-bound analysis:

  * each rank runs the *local* shared-memory MTTKRP
    (:func:`repro_torch.core.mttkrp.mttkrp`; under ``method="fused"`` or
    ``"matrix_free"`` the CUDA kernels) on its block with its factor rows
    -- a partial sum over the mapped modes != n;
  * one reduction over the mesh axes mapped to modes != n completes it;
  * nothing reduces over the axis mapped to mode ``n`` itself: the output
    rows stay distributed over it, like the factor they update.

The reference runs one process over global arrays and lets ``psum`` pick
the summation order.  The port is SPMD, one process a rank: every entry
point here takes the *global* tensor and factors (the same on every rank)
and returns *this rank's block* of the result; each reduction is the
ordered gather-sum of :mod:`repro_torch.dist.collectives`, so every rank of
a reduce group holds the same bits and runs repeat bitwise.  All sweeps
route through the one engine of :mod:`repro_torch.plan.sweep`
(``ShardedExecutor`` holds the mesh); this module keeps the placement
primitives and the entry points of the reference's names.

Besides the plain entries: the overlapped ones (``dist_mttkrp_overlapped``
cuts the local MTTKRP into slabs along mode ``n`` and issues each slab's
reduction asynchronously before the next slab's contraction; a tree
node's reduction is issued slab by slab the same way), and the compressed
ones (``dist_mttkrp_compressed`` and ``dist_contract_*_compressed``
complete with the int8 error-feedback gather of
:func:`repro_torch.dist.collectives.compressed_psum`, this rank's residual
threaded through).  Every entry takes the reference's
``collective="hierarchical"`` with a ``node_axis``: each reduction is then
:func:`repro_torch.dist.collectives.hierarchical_psum`, the reduce-scatter
within the node axis along the block's leading row axis, the ordered psum
across nodes and the gather back; under compression the intra-node stage
stays exact and only the cross-node one is int8.  :func:`dist_pp_pairs`
builds the pairwise-perturbation intermediates of a sharded problem, each
reduced over the axes of its contracted modes only.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.core.dimtree import contract_from_partial, partial_mttkrp_range
from repro_torch.core.mttkrp import Method, mttkrp, mttkrp_batched
from repro_torch.core.tensor_ops import mode_letters

from .collectives import (
    _Count,
    compressed_psum,
    hierarchical_psum,
    hierarchical_psum_async,
    ordered_psum,
    ordered_psum_async,
)

Tensor = torch.Tensor
ModeAxes = Mapping[int, str]

# default slab count of the overlapped reduction pipeline; the planner's
# knob is repro_torch.plan.cost.DEFAULT_OVERLAP_CHUNKS (the same value,
# kept as a literal here so repro_torch.dist never imports repro_torch.plan
# at module level)
DEFAULT_OVERLAP_CHUNKS = 4

# copies the overlapped MTTKRP makes of a slab that is not contiguous in
# the block (every mode but the first): ``calls`` and ``bytes`` copied
SLAB_COPIES = _Count()

# Collective strategies a node reduction can complete with: "flat" is the
# ordered psum over every reduced axis; "hierarchical" the two-level one of
# repro_torch.dist.collectives.hierarchical_psum (reduce-scatter within the
# node axis, ordered psum of the shard across nodes, all-gather back).
COLLECTIVES = ("flat", "hierarchical")


def _validate_collective(collective: str) -> None:
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r} (choose from {COLLECTIVES})")


def _node_psum(m: Tensor, reduce_axes, mesh, collective: str, node_axis: str | None,
               *, scatter_axis: int = 0) -> Tensor:
    """Complete one node contraction's reduction over ``reduce_axes``:
    :func:`~repro_torch.dist.collectives.hierarchical_psum` with
    ``node_axis`` as the intra-node level under ``"hierarchical"`` (the
    flat sum wherever the decomposition cannot apply), the ordered psum
    under ``"flat"``."""
    _validate_collective(collective)
    if collective == "hierarchical":
        return hierarchical_psum(m, reduce_axes, mesh, node_axis, scatter_axis=scatter_axis)
    return ordered_psum(m, reduce_axes, mesh)


def _node_psum_async(m: Tensor, reduce_axes, mesh, collective: str, node_axis: str | None,
                     *, scatter_axis: int = 0):
    """:func:`_node_psum` issued asynchronously: ``.wait()`` gives the sum."""
    if collective == "hierarchical":
        return hierarchical_psum_async(m, reduce_axes, mesh, node_axis,
                                       scatter_axis=scatter_axis)
    return ordered_psum_async(m, reduce_axes, mesh)


def _compressed_reduce(out: Tensor, reduce_axes, mesh, err: Tensor, collective: str,
                       node_axis: str | None) -> tuple[Tensor, Tensor]:
    """The int8 error-feedback reduction of ``out`` over ``reduce_axes``.
    Under ``"hierarchical"`` a reduction over ``node_axis`` and another
    axis sums within the node exactly first and compresses only across
    nodes; ``err`` keeps its shape (every rank of a node compresses the
    same node sum)."""
    _validate_collective(collective)
    gather_axes = tuple(reduce_axes)
    if collective == "hierarchical" and node_axis in reduce_axes and len(reduce_axes) > 1:
        out = ordered_psum(out, (node_axis,), mesh)
        gather_axes = tuple(a for a in reduce_axes if a != node_axis)
    return compressed_psum(out, gather_axes, err.reshape(out.shape), mesh)


def _axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _validate(shape: Sequence[int], mode_axes: ModeAxes, mesh) -> None:
    sizes = _axis_sizes(mesh)
    seen: dict[str, int] = {}
    for mode, axis in mode_axes.items():
        if not 0 <= mode < len(shape):
            raise ValueError(f"mode {mode} out of range for order-{len(shape)} tensor")
        if axis not in sizes:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {mesh.mesh_dim_names})")
        if axis in seen:
            raise ValueError(f"mesh axis {axis!r} mapped to modes {seen[axis]} and {mode}")
        seen[axis] = mode
        if shape[mode] % sizes[axis]:
            raise ValueError(
                f"mode {mode} dim {shape[mode]} not divisible by "
                f"axis {axis!r} size {sizes[axis]}"
            )


def _validate_batch(batch: int, batch_axes: Sequence[str], mode_axes: ModeAxes, mesh) -> None:
    sizes = _axis_sizes(mesh)
    used = set(mode_axes.values())
    seen: set[str] = set()
    shards = 1
    for axis in batch_axes:
        if axis not in sizes:
            raise ValueError(f"mesh has no axis {axis!r} (axes: {mesh.mesh_dim_names})")
        if axis in used:
            raise ValueError(f"mesh axis {axis!r} cannot shard both a mode and the batch")
        if axis in seen:
            raise ValueError(f"duplicate batch axis {axis!r}")
        seen.add(axis)
        shards *= sizes[axis]
    if batch % shards:
        raise ValueError(f"batch {batch} not divisible by batch-axis product {shards}")


def _reduce_axes(mode_axes: ModeAxes, keep_modes: Sequence[int]) -> tuple[str, ...]:
    """Mesh axes whose modes are contracted away (i.e. not in ``keep_modes``)."""
    keep = set(keep_modes)
    return tuple(mode_axes[m] for m in sorted(mode_axes) if m not in keep)


def _node_reduce_axes(mode_axes: ModeAxes, contracted: Sequence[int]) -> tuple[str, ...]:
    """Mesh axes of the mapped modes contracted at one node, in mode order."""
    want = set(contracted)
    return tuple(mode_axes[m] for m in sorted(mode_axes) if m in want)


def _chunk_bounds(extent: int, n_chunks: int) -> list[int]:
    """Split ``[0, extent)`` into ``<= n_chunks`` near-equal static slices."""
    k = max(1, min(int(n_chunks), int(extent)))
    sizes = [extent // k + (1 if i < extent % k else 0) for i in range(k)]
    bounds = [0]
    for s in sizes:
        bounds.append(bounds[-1] + s)
    return bounds


def _rows(t: Tensor, dim: int, axis: str | None, mesh) -> Tensor:
    """This rank's contiguous index block of ``t`` along ``dim``, cut
    equally over mesh ``axis`` (all of it when ``axis`` is ``None``)."""
    if axis is None:
        return t
    size = _axis_sizes(mesh)[axis]
    step = t.shape[dim] // size
    return t.narrow(dim, mesh.get_local_rank(axis) * step, step)


def _batch_rows(t: Tensor, batch_axes: Sequence[str], mesh) -> Tensor:
    """This rank's block of a leading batch axis cut over ``batch_axes``
    (row-major over the axes: the first the most significant)."""
    if not batch_axes:
        return t
    sizes = _axis_sizes(mesh)
    index, shards = 0, 1
    for axis in batch_axes:
        index = index * sizes[axis] + mesh.get_local_rank(axis)
        shards *= sizes[axis]
    step = t.shape[0] // shards
    return t.narrow(0, index * step, step)


def _block(t: Tensor, axes: Sequence[str | None], mesh, batch_axes=None) -> Tensor:
    """This rank's block of ``t``: a batch block first when ``batch_axes``
    is given, then each of the following dims cut over its axis in
    ``axes``.  Made contiguous: its own row-major tensor, as the
    reference's ``device_put`` hands each device its block, no entry
    reordered within it."""
    lead = 0
    if batch_axes is not None:
        t, lead = _batch_rows(t, batch_axes, mesh), 1
    for d, axis in enumerate(axes):
        t = _rows(t, lead + d, axis, mesh)
    return t.contiguous()


def shard_problem(
    x: Tensor,
    factors: Sequence[Tensor],
    mode_axes: ModeAxes,
    mesh,
    *,
    batch_axes: Sequence[str] = (),
) -> tuple[Tensor, list[Tensor]]:
    """This rank's blocks of the global tensor and factors; no reordering.

    The tensor is block-distributed: the rank at mesh coordinate
    ``(i, j, ...)`` gets the row-major subtensor of its index block along
    each mapped mode, and all of each unmapped mode.  Factor ``U_k`` keeps
    the row block of ``mode_axes[k]`` when mapped, and is whole otherwise.

    A *batched* problem (``x.ndim == len(factors) + 1``: one leading batch
    axis on the tensor and on every factor) is also cut along the batch
    over ``batch_axes``: each rank holds whole problems, so no contraction
    needs a collective across the batch.
    """
    batched = x.ndim == len(factors) + 1
    shape = x.shape[1:] if batched else x.shape
    _validate(shape, mode_axes, mesh)
    if batched:
        _validate_batch(x.shape[0], batch_axes, mode_axes, mesh)
    order = len(shape)
    lead = tuple(batch_axes) if batched else None
    xs = _block(x, [mode_axes.get(k) for k in range(order)], mesh, lead)
    fs = [_block(u, [mode_axes.get(k)], mesh, lead) for k, u in enumerate(factors)]
    return xs, fs


# --------------------------------------------------------------------------
# Block-level contractions: this rank's local contraction, completed by the
# ordered reduction over the axes of the mapped modes contracted there.
# The local calls are the LocalExecutor's own, argument for argument, so a
# world of one runs the single-device engine's operations bitwise.
# ShardedExecutor calls these on the blocks it holds.
# --------------------------------------------------------------------------
def _local_mttkrp(x, factors, n, method, tiles) -> Tensor:
    """The local mode-``n`` MTTKRP of a block (batched on a leading batch
    axis), the LocalExecutor's own call."""
    run = mttkrp_batched if x.ndim == len(factors) + 1 else mttkrp
    return run(x, list(factors), n, method=method, tiles=tiles)


def mttkrp_block(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    mode_axes: ModeAxes,
    mesh,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
    *,
    collective: str = "flat",
    node_axis: str | None = None,
) -> Tensor:
    """Mode-``n`` MTTKRP of this rank's blocks (a leading batch axis runs
    the batched MTTKRP), reduced over the axes mapped to modes != n
    (``collective`` and ``node_axis`` as in :func:`dist_mttkrp`; the
    scatter axis is the output's row axis)."""
    m = _local_mttkrp(x, factors, n, method, tiles)
    axes = _reduce_axes(mode_axes, (n,))
    if not axes:
        return m
    lead = 1 if x.ndim == len(factors) + 1 else 0
    return _node_psum(m, axes, mesh, collective, node_axis, scatter_axis=lead)


def _slab(x: Tensor, dim: int, i0: int, i1: int) -> Tensor:
    """Rows ``[i0, i1)`` of ``x`` along ``dim``, copied when the view is not
    contiguous (the CUDA kernels take contiguous operands); each copy is
    counted in :data:`SLAB_COPIES`."""
    s = x.narrow(dim, i0, i1 - i0)
    if s.is_contiguous():
        return s
    SLAB_COPIES.calls += 1
    SLAB_COPIES.bytes += s.numel() * s.element_size()
    return s.contiguous()


def mttkrp_overlapped_block(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    mode_axes: ModeAxes,
    mesh,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    *,
    collective: str = "flat",
    node_axis: str | None = None,
) -> Tensor:
    """:func:`mttkrp_block` with the reduction pipelined behind the
    contraction: the block is cut into ``n_chunks`` slabs along mode ``n``,
    each slab's local MTTKRP (its own GEMM or kernel launch) is followed at
    once by its asynchronous reduction, and the reductions are waited for
    in order and laid side by side.  Slabs own disjoint output rows, so
    this is one reduction's result up to the slab contractions' own
    rounding (a slab's kernel may split its sum otherwise).  Under
    ``collective="hierarchical"`` each slab's reduce-scatter is the
    asynchronous step; a slab whose rows the node axis does not divide
    reduces flat.  No collective to hide, ``n_chunks <= 1`` or one local
    row: :func:`mttkrp_block`."""
    _validate_collective(collective)
    axes = _reduce_axes(mode_axes, (n,))
    lead = 1 if x.ndim == len(factors) + 1 else 0
    local_in = x.shape[lead + n]
    if not axes or n_chunks <= 1 or local_in <= 1:
        return mttkrp_block(x, factors, n, mode_axes, mesh, method=method, tiles=tiles,
                            collective=collective, node_axis=node_axis)
    bounds = _chunk_bounds(local_in, n_chunks)
    pending = [
        _node_psum_async(
            _local_mttkrp(_slab(x, lead + n, i0, i1), factors, n, method, tiles),
            axes, mesh, collective, node_axis, scatter_axis=lead,
        )
        for i0, i1 in zip(bounds[:-1], bounds[1:])
    ]
    return torch.cat([p.wait() for p in pending], dim=lead)


def mttkrp_compressed_block(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    mode_axes: ModeAxes,
    mesh,
    err: Tensor,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
    *,
    collective: str = "flat",
    node_axis: str | None = None,
) -> tuple[Tensor, Tensor]:
    """Mode-``n`` MTTKRP of this rank's blocks completed by the int8
    error-feedback gather over the axes mapped to modes != n; ``err`` is
    this rank's residual (the local output block's shape).  Under
    ``collective="hierarchical"`` the ``node_axis`` stage is an exact sum
    first and only the cross-node one is compressed.  Returns ``(result,
    new_err)``; with nothing to reduce, the exact result and ``err``
    unchanged."""
    axes = _reduce_axes(mode_axes, (n,))
    m = _local_mttkrp(x, factors, n, method, tiles)
    if not axes:
        return m, err
    return _compressed_reduce(m, axes, mesh, err, collective, node_axis)


def _contract_local(
    src: Tensor,
    factors: Sequence[Tensor],
    lo: int,
    hi: int,
    parent_lo: int,
    parent_hi: int,
    *,
    from_root: bool,
) -> tuple[Tensor, list[int], int]:
    """One schedule node's local contraction of this rank's block:
    ``(output, contracted modes, 1 if batched else 0)``.  A leading batch
    axis on ``src`` (one more than the node's topology gives) runs the same
    contraction under ``torch.func.vmap``."""
    order = parent_hi - parent_lo
    batched = src.ndim == (order if from_root else order + 1) + 1
    contracted = [m for m in range(parent_lo, parent_hi) if not lo <= m < hi]
    if from_root:
        if batched:
            out = torch.func.vmap(
                lambda t, *fs: partial_mttkrp_range(t, list(fs), lo, hi)
            )(src, *factors)
        else:
            out = partial_mttkrp_range(src, list(factors), lo, hi)
    elif batched:
        out = torch.func.vmap(
            lambda t, *fs: contract_from_partial(t, dict(zip(contracted, fs)), lo, hi, parent_lo)
        )(src, *[factors[m] for m in contracted])
    else:
        out = contract_from_partial(
            src, {m: factors[m] for m in contracted}, lo, hi, parent_lo
        )
    return out, contracted, 1 if batched else 0


def contract_block(
    src: Tensor,
    factors: Sequence[Tensor],
    lo: int,
    hi: int,
    parent_lo: int,
    parent_hi: int,
    mode_axes: ModeAxes,
    mesh,
    *,
    from_root: bool,
    n_chunks: int = 1,
    collective: str = "flat",
    node_axis: str | None = None,
) -> Tensor:
    """One schedule node on this rank's blocks: the range contraction of
    the raw tensor block (``from_root``) or the contraction of a partial
    block, then the ordered reduction over the axes of the mapped modes
    contracted at this node.  ``factors`` is the full list of factor
    blocks.  ``n_chunks > 1`` reduces slab by slab along mode ``lo`` (the
    output's first kept mode), the overlapping executor's tree-node path:
    every slab's reduction is issued asynchronously, then each is waited
    for in order and written into its rows.  Elementwise sums of disjoint
    rows of one local result: bitwise the values of one reduction (under
    ``collective="hierarchical"`` the slab's rows are what the node axis
    scatters, so a slab may group its sum otherwise than the whole)."""
    _validate_collective(collective)
    out, contracted, lead = _contract_local(
        src, factors, lo, hi, parent_lo, parent_hi, from_root=from_root
    )
    reduce_axes = _node_reduce_axes(mode_axes, contracted)
    if not reduce_axes:
        return out
    bounds = _chunk_bounds(out.shape[lead], n_chunks)
    if len(bounds) == 2:
        return _node_psum(out, reduce_axes, mesh, collective, node_axis, scatter_axis=lead)
    pending = [
        (i0, i1, _node_psum_async(out.narrow(lead, i0, i1 - i0), reduce_axes, mesh,
                                  collective, node_axis, scatter_axis=lead))
        for i0, i1 in zip(bounds[:-1], bounds[1:])
    ]
    total = torch.empty_like(out)  # the local result's layout, as one reduction keeps it
    for i0, i1, p in pending:
        total.narrow(lead, i0, i1 - i0).copy_(p.wait())
    return total


def contract_block_compressed(
    src: Tensor,
    factors: Sequence[Tensor],
    lo: int,
    hi: int,
    parent_lo: int,
    parent_hi: int,
    mode_axes: ModeAxes,
    mesh,
    err: Tensor,
    *,
    from_root: bool,
    collective: str = "flat",
    node_axis: str | None = None,
) -> tuple[Tensor, Tensor]:
    """:func:`contract_block` completed by the int8 error-feedback gather
    over the node's reduce axes, ``err`` this rank's residual of the node
    (the local output block's shape; the hierarchical split as in
    :func:`mttkrp_compressed_block`).  Returns ``(result, new_err)``; with
    nothing to reduce, the exact result and ``err`` unchanged."""
    out, contracted, _ = _contract_local(
        src, factors, lo, hi, parent_lo, parent_hi, from_root=from_root
    )
    reduce_axes = _node_reduce_axes(mode_axes, contracted)
    if not reduce_axes:
        return out, err
    return _compressed_reduce(out, reduce_axes, mesh, err, collective, node_axis)


def pp_pairs_block(
    x: Tensor, factors: Sequence[Tensor], mode_axes: ModeAxes, mesh
) -> dict[tuple[int, int], Tensor]:
    """Every pairwise-perturbation intermediate of this rank's blocks:
    ``{(n, m): this rank's block of M_nm}`` for every ``n < m``, in the
    rank-major layout of :class:`repro_torch.plan.schedule.PPPair`
    (``(C, I_n / p_n, I_m / p_m)``, after a leading axis of the local batch
    when batched).  Per pair the LocalExecutor's own einsum on the blocks
    (rank-last, then rank moved to the front and made contiguous), then the
    ordered reduction over the axes mapped to the contracted modes only:
    the kept modes' axes carry the pair's rows and columns, as the factors
    the corrections perturb are cut.  A batch-parallel placement, or no
    mapped mode at all (``mode_axes`` empty; ``mesh`` is then not read:
    the local executor's pairs), reduces nothing."""
    order = len(factors)
    letters = mode_letters(order)
    out: dict[tuple[int, int], Tensor] = {}
    for n in range(order):
        for m in range(n + 1, order):
            others = [k for k in range(order) if k not in (n, m)]
            spec = (
                ",".join(["..." + letters] + ["..." + letters[k] + "c" for k in others])
                + "->..." + letters[n] + letters[m] + "c"
            )
            p = torch.einsum(spec, x, *[factors[k] for k in others])
            p = torch.movedim(p, -1, -3).contiguous()
            out[(n, m)] = ordered_psum(p, _reduce_axes(mode_axes, (n, m)), mesh)
    return out


# --------------------------------------------------------------------------
# The reference's entry points: global inputs in, this rank's block out.
# --------------------------------------------------------------------------
def dist_mttkrp(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    mode_axes: ModeAxes,
    mesh,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
    *,
    batch_axes: Sequence[str] = (),
    collective: str = "flat",
    node_axis: str | None = None,
) -> Tensor:
    """Mode-``n`` MTTKRP of the block-distributed global tensor ``x``.

    Each rank runs the local MTTKRP on its block (``method`` and ``tiles``
    as for :func:`repro_torch.core.mttkrp.mttkrp`: ``"fused"`` and
    ``"matrix_free"`` launch the CUDA kernels on the card), then the
    ordered reduction over the axes mapped to the contracted modes only.
    Returns this rank's block of the result: the rows of ``mode_axes[n]``'s
    block (all rows when mode ``n`` is unmapped) -- the distribution of the
    factor it updates in ALS.

    A leading batch axis on ``x`` (``x.ndim == len(factors) + 1``) is cut
    over ``batch_axes`` and each rank runs the batched MTTKRP on its whole
    problems; batch axes are never reduced, which is why a batch-parallel
    placement moves no reduce traffic.

    ``collective="hierarchical"`` completes the reduction with
    :func:`repro_torch.dist.collectives.hierarchical_psum` instead of the
    flat ordered psum: reduce-scatter of the output rows within
    ``node_axis`` (the intra-node mesh axis), ordered psum of the ``1/k``
    shard across nodes, all-gather back -- the same value up to the
    grouping of the sum, ``k`` times less volume on the slow level.
    """
    _validate_collective(collective)
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return mttkrp_block(xs, fs, n, mode_axes, mesh, method=method, tiles=tiles,
                        collective=collective, node_axis=node_axis)


def dist_pp_pairs(
    x: Tensor,
    factors: Sequence[Tensor],
    mode_axes: ModeAxes,
    mesh,
    *,
    batch_axes: Sequence[str] = (),
) -> dict[tuple[int, int], Tensor]:
    """All pairwise-perturbation intermediates of the block-distributed
    global tensor ``x``: for every mode pair ``n < m``,
    ``M_nm[c, i_n, i_m] = sum X * prod_{k not in {n, m}} U_k[i_k, c]`` with
    the full MTTKRP's treatment and two kept modes instead of one (see
    :func:`pp_pairs_block`).  A leading batch axis (``x.ndim ==
    len(factors) + 1``) is cut over ``batch_axes`` and never reduced.
    Returns ``{(n, m): this rank's block}``, the global pair ``(C, I_n,
    I_m)`` (batch-led when batched) cut over the axes of modes ``n`` and
    ``m``."""
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return pp_pairs_block(xs, fs, mode_axes, mesh)


def dist_contract_range(
    x: Tensor,
    factors: Sequence[Tensor],
    lo: int,
    hi: int,
    mode_axes: ModeAxes,
    mesh,
    *,
    n_chunks: int = 1,
    batch_axes: Sequence[str] = (),
    collective: str = "flat",
    node_axis: str | None = None,
) -> Tensor:
    """Distributed range contraction: every mode outside ``[lo, hi)`` of the
    block-distributed global tensor is contracted with its row-distributed
    factor.

    Local :func:`repro_torch.core.dimtree.partial_mttkrp_range` on this
    rank's block, then one ordered reduction over the axes mapped to the
    contracted modes.  Returns this rank's block of the partial tensor
    (``x.shape[lo:hi] + (C,)`` globally), distributed over the axes of its
    surviving modes.  ``n_chunks > 1`` reduces slab by slab along mode
    ``lo``, with the same values as one reduction.  ``collective`` and
    ``node_axis`` as in :func:`dist_mttkrp` (the scatter axis is mode
    ``lo``).
    """
    _validate_collective(collective)
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return contract_block(
        xs, fs, lo, hi, 0, len(factors), mode_axes, mesh, from_root=True, n_chunks=n_chunks,
        collective=collective, node_axis=node_axis,
    )


def _partial_blocks(t, factors, parent_lo, parent_hi, mode_axes, mesh, batch_axes):
    """This rank's blocks of a global partial tensor (modes ``[parent_lo,
    parent_hi)`` plus the rank axis, after a leading batch axis when
    batched) and of the global factors."""
    batched = t.ndim == parent_hi - parent_lo + 2
    lead = tuple(batch_axes) if batched else None
    if batched:
        _validate_batch(t.shape[0], batch_axes, mode_axes, mesh)
    kept = [mode_axes.get(k) for k in range(parent_lo, parent_hi)]
    ts = _block(t, kept + [None], mesh, lead)
    fs = [_block(u, [mode_axes.get(k)], mesh, lead) for k, u in enumerate(factors)]
    return ts, fs


def dist_contract_partial(
    t: Tensor,
    factors: Sequence[Tensor],
    lo: int,
    hi: int,
    parent_lo: int,
    parent_hi: int,
    mode_axes: ModeAxes,
    mesh,
    *,
    n_chunks: int = 1,
    batch_axes: Sequence[str] = (),
    collective: str = "flat",
    node_axis: str | None = None,
) -> Tensor:
    """Distributed partial-to-partial contraction of one schedule node.

    ``t`` is a global partial tensor carrying modes ``[parent_lo,
    parent_hi)`` plus the rank axis (after a leading batch axis when
    batched); each rank takes its block of the mapped kept modes, contracts
    the modes outside ``[lo, hi)`` with their row-distributed factors (a
    multi-TTV, the rank axis shared), and one ordered reduction over those
    modes' axes completes it.  Returns this rank's block.  With a single
    kept mode this is the leaf update off a partial.  ``n_chunks``,
    ``collective`` and ``node_axis`` as in :func:`dist_contract_range`.
    """
    _validate_collective(collective)
    ts, fs = _partial_blocks(t, factors, parent_lo, parent_hi, mode_axes, mesh, batch_axes)
    return contract_block(
        ts, fs, lo, hi, parent_lo, parent_hi, mode_axes, mesh, from_root=False,
        n_chunks=n_chunks, collective=collective, node_axis=node_axis,
    )


def dist_mttkrp_overlapped(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    mode_axes: ModeAxes,
    mesh,
    method: Method = "auto",
    n_chunks: int = DEFAULT_OVERLAP_CHUNKS,
    tiles: Mapping[str, int] | None = None,
    *,
    batch_axes: Sequence[str] = (),
    collective: str = "flat",
    node_axis: str | None = None,
) -> Tensor:
    """Mode-``n`` MTTKRP with the completing reduction hidden behind the
    contraction.

    The placement of :func:`dist_mttkrp`, but this rank's block is cut into
    ``n_chunks`` slabs along mode ``n`` (along mode ``n`` of every problem
    of a batched block): slab ``k``'s local MTTKRP runs, its reduction is
    issued asynchronously (``async_op=True``), and slab ``k + 1``'s
    contraction is queued while it is in flight; the reductions are waited
    for in order and laid side by side.  A slab that is not contiguous in
    the block is copied first (:data:`SLAB_COPIES`): the CUDA kernels take
    contiguous operands.  Slabs own disjoint output rows, so the result is
    :func:`dist_mttkrp`'s up to each slab contraction's own rounding.
    Falls back to :func:`dist_mttkrp` when the mapping needs no reduction,
    ``n_chunks <= 1`` or the local extent of mode ``n`` is 1.  Returns this
    rank's block.  ``collective="hierarchical"`` completes each slab's
    reduction with the two-level sum (a slab whose row count the
    ``node_axis`` size does not divide reduces flat, still exact).
    """
    _validate_collective(collective)
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return mttkrp_overlapped_block(
        xs, fs, n, mode_axes, mesh, method=method, tiles=tiles, n_chunks=n_chunks,
        collective=collective, node_axis=node_axis,
    )


def init_mttkrp_error_state(
    shape: Sequence[int], rank: int, mode_axes: ModeAxes, mesh, *, device=None
) -> dict[int, Tensor]:
    """Zero error-feedback residuals for the compressed factor reduction:
    one fp32 tensor for each mode whose MTTKRP needs a reduction (a mapped
    mode other than itself exists).  SPMD, so each is *this rank's*
    residual, the shape of its output block ``(I_n / size of mode n's axis,
    C)`` -- not the reference's global array with one leading axis a
    reduced mesh axis.  Thread the dict through :func:`dist_mttkrp_compressed`
    calls.  ``device`` defaults to the mesh's device type."""
    _validate(shape, mode_axes, mesh)
    sizes = _axis_sizes(mesh)
    device = mesh.device_type if device is None else device
    errs: dict[int, Tensor] = {}
    for n in range(len(shape)):
        if not _reduce_axes(mode_axes, (n,)):
            continue
        rows = shape[n] // (sizes[mode_axes[n]] if n in mode_axes else 1)
        errs[n] = torch.zeros((rows, rank), dtype=torch.float32, device=device)
    return errs


def dist_mttkrp_compressed(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    mode_axes: ModeAxes,
    mesh,
    err: Tensor,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
    *,
    batch_axes: Sequence[str] = (),
    collective: str = "flat",
    node_axis: str | None = None,
) -> tuple[Tensor, Tensor]:
    """Mode-``n`` MTTKRP completed by the int8 error-feedback collective.

    The local MTTKRP and placement of :func:`dist_mttkrp`, but the
    completing reduction is :func:`repro_torch.dist.collectives.compressed_psum`
    over the same axes: each rank quantizes ``partial + err`` to int8 with
    a private scale, the payloads are gathered and every rank adds them
    dequantized in rank order.  ``err`` is this rank's residual for mode
    ``n`` (:func:`init_mttkrp_error_state`; a batched block takes one of its
    output block's shape).  Returns ``(this rank's block, new_err)``.  The
    carried residual keeps the accumulated quantization error within one
    int8 step, which lets compressed CP-ALS track the exact fit.

    ``collective="hierarchical"`` splits the levels around the compressor:
    the ``node_axis`` (intra-node) reduction is an exact ordered sum
    first, then only the cross-node exchange is quantized -- every rank of
    a node compresses the same node sum, so the residual's shape and carry
    are unchanged while the int8 gather spans the nodes only.
    """
    _validate_collective(collective)
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return mttkrp_compressed_block(xs, fs, n, mode_axes, mesh, err, method=method, tiles=tiles,
                                   collective=collective, node_axis=node_axis)


def dist_contract_range_compressed(
    x: Tensor,
    factors: Sequence[Tensor],
    lo: int,
    hi: int,
    mode_axes: ModeAxes,
    mesh,
    err: Tensor,
    *,
    batch_axes: Sequence[str] = (),
    collective: str = "flat",
    node_axis: str | None = None,
) -> tuple[Tensor, Tensor]:
    """:func:`dist_contract_range` with the node's reduction compressed:
    the int8 error-feedback gather over the same axes, ``err`` this rank's
    residual of the node (its output block's shape).  Returns ``(this
    rank's block, new_err)``; the exact path when the node reduces
    nothing.  ``collective`` and ``node_axis`` as in
    :func:`dist_mttkrp_compressed`."""
    _validate_collective(collective)
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return contract_block_compressed(
        xs, fs, lo, hi, 0, len(factors), mode_axes, mesh, err, from_root=True,
        collective=collective, node_axis=node_axis,
    )


def dist_contract_partial_compressed(
    t: Tensor,
    factors: Sequence[Tensor],
    lo: int,
    hi: int,
    parent_lo: int,
    parent_hi: int,
    mode_axes: ModeAxes,
    mesh,
    err: Tensor,
    *,
    batch_axes: Sequence[str] = (),
    collective: str = "flat",
    node_axis: str | None = None,
) -> tuple[Tensor, Tensor]:
    """:func:`dist_contract_partial` with the node's reduction compressed
    (``err``, ``collective`` and ``node_axis`` as in
    :func:`dist_contract_range_compressed`); returns ``(this rank's block,
    new_err)``."""
    _validate_collective(collective)
    ts, fs = _partial_blocks(t, factors, parent_lo, parent_hi, mode_axes, mesh, batch_axes)
    return contract_block_compressed(
        ts, fs, lo, hi, parent_lo, parent_hi, mode_axes, mesh, err, from_root=False,
        collective=collective, node_axis=node_axis,
    )


# --------------------------------------------------------------------------
# Sharded ALS sweeps: thin wrappers over the one engine of
# repro_torch.plan.sweep, which keeps the update algebra once and finishes
# its row sums (Grams, column norms, the fit's inner product, the tensor
# norm) with the executor's ordered reduction.
# --------------------------------------------------------------------------
def dist_als_sweep(
    x: Tensor,
    factors: list[Tensor],
    weights: Tensor,
    norm_x: Tensor,
    it,
    mode_axes: ModeAxes,
    mesh,
    method: Method = "auto",
    normalize: bool = True,
) -> tuple[list[Tensor], Tensor, Tensor]:
    """One distributed ALS sweep; mirrors
    :func:`repro_torch.core.cpals.als_sweep`.  ``x`` and ``factors`` are
    global; returns this rank's factor blocks, the weights and the fit
    (the same on every rank)."""
    from repro_torch import plan as planlib

    return planlib.legacy_sweep(
        x, factors, weights, norm_x, it,
        strategy=method, normalize=normalize, mode_axes=mode_axes, mesh=mesh,
    )


def dist_dimtree_sweep(
    x: Tensor,
    factors: list[Tensor],
    weights: Tensor,
    norm_x: Tensor,
    it,
    mode_axes: ModeAxes,
    mesh,
    *,
    normalize: bool = True,
    split: int | None = None,
) -> tuple[list[Tensor], Tensor, Tensor]:
    """Distributed dimension-tree sweep; the same iterates as the standard
    sweep.  Two distributed X-sized partial contractions a sweep (instead
    of N full MTTKRPs): ``T_L`` from the old right factors, the left half's
    updates from ``T_L``, then ``T_R`` from the fresh left factors and the
    right half's updates.  ``x`` and ``factors`` are global; returns this
    rank's factor blocks, the weights and the fit."""
    from repro_torch import plan as planlib

    return planlib.legacy_sweep(
        x, factors, weights, norm_x, it,
        strategy="dimtree", normalize=normalize, split=split,
        mode_axes=mode_axes, mesh=mesh,
    )


def dist_cp_als(
    x: Tensor,
    rank: int,
    mode_axes: ModeAxes,
    mesh,
    n_iters: int = 50,
    tol: float = 1.0e-5,
    *,
    seed: int = 0,
    method: Method = "auto",
    normalize: bool = True,
    dimtree: bool = False,
    init_factors: list[Tensor] | None = None,
    executor: str = "sharded",
) -> tuple[list[Tensor], Tensor, Tensor]:
    """Sharded CP-ALS: the init and stop logic of core ``cp_als``.

    ``x`` (and ``init_factors``, when given) are global, the same on every
    rank; without ``init_factors`` every rank draws the global factors from
    one generator seeded with ``seed`` and keeps its block, so any mesh
    starts where one device does.  Returns ``(factors, weights, fit)``:
    this rank's factor blocks (row-distributed per ``mode_axes``), and the
    weights and fit, the same on every rank.  ``dimtree=True`` runs the
    distributed dimension-tree sweep (the same iterates, 2 tensor reads a
    sweep).  ``executor`` picks the communication of the node reductions:
    ``"sharded"`` (the default, one ordered reduction a node),
    ``"overlapping"`` (slab reductions issued behind the slab
    contractions; exact), ``"compressed"`` (the int8 error-feedback gather,
    its residuals threaded through the sweeps; approximate) or ``"auto"``
    (the cost argmin of :func:`repro_torch.plan.select_executor`).

    A wrapper over the one :func:`repro_torch.plan.cp_als` loop.
    """
    from repro_torch import plan as planlib

    problem = planlib.Problem.from_tensor(x, rank, mode_axes=mode_axes, mesh=mesh)
    # the tree shape stays pinned to the wrapper's historical behavior:
    # flat per-mode, or the binary split for dimtree
    sweep_plan = planlib.plan_sweep(
        problem,
        strategy="dimtree" if dimtree else method,
        normalize=normalize,
        executor=executor,
        schedule=None if dimtree else "flat",
    )
    st = planlib.cp_als(
        x,
        sweep_plan,
        executor=planlib.make_executor(sweep_plan.executor, mesh, mode_axes),
        n_iters=n_iters,
        tol=tol,
        seed=seed,
        init_factors=init_factors,
    )
    return st.factors, st.weights, st.fit
