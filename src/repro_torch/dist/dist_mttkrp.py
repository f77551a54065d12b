"""Block-distributed MTTKRP and CP-ALS over a ``torch.distributed`` DeviceMesh.

Port of the flat entries of ``repro.dist.dist_mttkrp``.  The paper's
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

Only the flat collective is here: ``collective="hierarchical"`` comes with
distribution slice 4, the overlapped and compressed variants with slices 2
and 3.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.core.dimtree import contract_from_partial, partial_mttkrp_range
from repro_torch.core.mttkrp import Method, mttkrp, mttkrp_batched

from .collectives import ordered_psum

Tensor = torch.Tensor
ModeAxes = Mapping[int, str]

# Collective strategies of the reference's node reductions; "hierarchical"
# (reduce-scatter within the node axis, cross-node psum, all-gather back)
# comes with distribution slice 4 of the port.
COLLECTIVES = ("flat", "hierarchical")


def _validate_collective(collective: str) -> None:
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r} (choose from {COLLECTIVES})")
    if collective == "hierarchical":
        raise NotImplementedError(
            "the hierarchical collective comes with distribution slice 4 of the port"
        )


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
def mttkrp_block(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    mode_axes: ModeAxes,
    mesh,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
) -> Tensor:
    """Mode-``n`` MTTKRP of this rank's blocks (a leading batch axis runs
    the batched MTTKRP), reduced over the axes mapped to modes != n."""
    run = mttkrp_batched if x.ndim == len(factors) + 1 else mttkrp
    m = run(x, list(factors), n, method=method, tiles=tiles)
    return ordered_psum(m, _reduce_axes(mode_axes, (n,)), mesh)


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
) -> Tensor:
    """One schedule node on this rank's blocks: the range contraction of
    the raw tensor block (``from_root``) or the contraction of a partial
    block, then the ordered reduction over the axes of the mapped modes
    contracted at this node.  ``factors`` is the full list of factor
    blocks.  A leading batch axis on ``src`` (one more than the node's
    topology gives) runs the same contraction under ``torch.func.vmap``.
    ``n_chunks > 1`` reduces slab by slab along mode ``lo`` (the output's
    first kept mode): elementwise sums of disjoint rows, so the values are
    those of one reduction."""
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
    reduce_axes = _node_reduce_axes(mode_axes, contracted)
    if not reduce_axes:
        return out
    lead = 1 if batched else 0
    bounds = _chunk_bounds(out.shape[lead], n_chunks)
    if len(bounds) == 2:
        return ordered_psum(out, reduce_axes, mesh)
    total = torch.empty_like(out)  # the local result's layout, as one reduction keeps it
    for i0, i1 in zip(bounds[:-1], bounds[1:]):
        total.narrow(lead, i0, i1 - i0).copy_(
            ordered_psum(out.narrow(lead, i0, i1 - i0), reduce_axes, mesh)
        )
    return total


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
    placement moves no reduce traffic.  ``collective`` is ``"flat"``
    (``"hierarchical"`` and ``node_axis`` come with distribution slice 4).
    """
    _validate_collective(collective)
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return mttkrp_block(xs, fs, n, mode_axes, mesh, method=method, tiles=tiles)


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
    ``lo``, with the same values as one reduction.
    """
    _validate_collective(collective)
    xs, fs = shard_problem(x, factors, mode_axes, mesh, batch_axes=batch_axes)
    return contract_block(
        xs, fs, lo, hi, 0, len(factors), mode_axes, mesh, from_root=True, n_chunks=n_chunks
    )


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
    kept mode this is the leaf update off a partial.  ``n_chunks`` as in
    :func:`dist_contract_range`.
    """
    _validate_collective(collective)
    order = parent_hi - parent_lo
    batched = t.ndim == order + 2
    lead = tuple(batch_axes) if batched else None
    if batched:
        _validate_batch(t.shape[0], batch_axes, mode_axes, mesh)
    kept = [mode_axes.get(k) for k in range(parent_lo, parent_hi)]
    ts = _block(t, kept + [None], mesh, lead)
    fs = [_block(u, [mode_axes.get(k)], mesh, lead) for k, u in enumerate(factors)]
    return contract_block(
        ts, fs, lo, hi, parent_lo, parent_hi, mode_axes, mesh, from_root=False,
        n_chunks=n_chunks,
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
    sweep).  ``executor`` is ``"sharded"``; the overlapping and compressed
    executors and ``"auto"`` come with distribution slices 2 and 3.

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
