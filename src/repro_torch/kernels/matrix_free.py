"""Matrix-free MTTKRP: stream the tensor once, no KRP anywhere.

Port of ``repro.kernels.matrix_free`` (``matrix_free_kernel``,
``matrix_free_batched_kernel``, ``_fold_tile``, ``_reduction_blocks``,
``matrix_free_mttkrp``, ``matrix_free_mttkrp_batched``).  The tensor
stays in its natural N-D layout -- no matricization, no view, no KRP of any
size -- and is folded against the raw non-target factors: one contraction
over the highest non-target mode, then one broadcast-multiply-reduce per
remaining non-target mode.  On the card :func:`matrix_free_kernel` launches
the CUDA kernel of ``csrc/matrix_free.cu`` (design notes there); on the CPU
it takes :func:`matrix_free_kernel_plain`, the same fold in torch ops.
The batched forms fold each slab of a stack ``(S, *shape)`` against that
slab's own factors ``(S, I_k, C)``.  Both forms launch one kernel body
(``csrc/mttkrp_cluster.cuh``, which the fused bilinear kernels launch
too), whose steps -- one (chunk of the contracted mode, outer index) pair
each -- are split over thread-block clusters and summed on chip, with the
geometry from the shape alone: :func:`launch_shape` for a stack (one
launch), :func:`unbatched_launch_shape` for one tensor (one launch, plus a
pass that adds the clusters' partials in a fixed order where a row block
has more than one cluster).  A rank above 64 is cut into column blocks of
the same launch (:func:`column_blocks`).

Supported: every mode of order-3..6 tensors, plus a leading batch axis, at
any rank, in float32, bfloat16, float16 and float64.  As the reference's
kernels (which cast each tile and factor tile to float32 and declare a
float32 output), the kernel-level entries and their plain versions sum in
fp32 and return float32 whatever the operands' dtype; the
``matrix_free_mttkrp*`` wrappers return ``x.dtype``.  The CUDA kernel reads
each operand at its own width (``csrc/mttkrp_cluster.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Sequence

import torch

from ._build import CudaKernel
from ._tiling import (
    BLOCK_RANK,
    KERNEL_DTYPES,
    BLOCK_ROWS,
    BLOCKS_PER_SM,
    PADDED_RANKS,
    block,
    check_rank,
    check_slabs,
    kernel_suffix,
    reference_tiles,
    use_kernel,
)

Tensor = torch.Tensor

# Indices of the contracted (highest non-target) mode a step of the first
# CUDA kernel took; :func:`_reduction_blocks` only.
BLOCK_R = 64
# Shared memory one thread block may use on Hopper (227 KB), and one SM's
# (228 KB; each resident block also holds 1 KB of it for the system).
SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
# The kernel (csrc/mttkrp_cluster.cuh, matrix_free_cluster_kernel): warps
# of a CTA (THREADS = 32 rows x 8 warps), tiles in flight, outer modes whose
# factor rows a stage carries.
WARPS = 8
STAGES = 3
MAX_OUTER = 4
# CTAs of a cluster along grid y, each a part of a row block's steps.
SPLITS = (1, 2, 4, 8)
# Grid y: groups x splits parts of a row block's steps.
MAX_GRID_Y = 65535
# SMs of an H100 SXM (a card test checks it against the device); the wave
# slots the geometry counts are CLUSTER_SLOTS, below.
SMS = 132
# Clusters of each size in SPLITS that an H100 SXM holds at once when each
# SM holds 1 or 2 of the kernel's CTAs (cudaOccupancyMaxActiveClusters; a
# card test checks it).  A cluster's CTAs share a GPC, so clusters of 4 and
# 8 leave slots empty: 62 x 4 = 248 and 30 x 8 = 240 of 264.
CLUSTER_SLOTS = {
    1: {1: 132, 2: 66, 4: 30, 8: 15},
    2: {1: 264, 2: 132, 4: 62, 8: 30},
}


def residency(padded_rank: int) -> int:
    """CTAs of the kernel resident on one SM at ``padded_rank``, a column
    block's padded width (:func:`column_blocks`): its launch bounds hold it
    to 128 registers a thread at a width <= 32 (two CTAs of 256 threads fill
    the 65,536 registers), and the geometry sizes its shared memory to let
    two in; above 32 one CTA an SM.  A card test checks this against
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    return 2 if padded_rank <= 32 else 1


def column_blocks(rank: int) -> tuple[int, int, int]:
    """The kernel's column blocks at ``rank`` (``col_blocks``,
    ``block_cols`` and ``padded_rank`` in csrc/mttkrp_common.cuh):
    ``(blocks, width, padded)``.  A CTA keeps one accumulator row of at most
    ``BLOCK_RANK`` columns in registers, so a larger rank is cut into
    ``ceil(rank / BLOCK_RANK)`` blocks of ``width = ceil(rank / blocks)``
    columns, block ``b`` holding ``[b * width, min(rank, (b + 1) * width))``
    (the last may be narrower, never empty), each padded to ``padded`` in
    ``PADDED_RANKS``.  Up to rank 64: one block of the whole rank."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    blocks = -(-rank // BLOCK_RANK)
    width = -(-rank // blocks)
    return blocks, width, next(p for p in PADDED_RANKS if width <= p)

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_FACTORS, _SHAPE = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)
# The sources of rows 1-4's entries in the element types other than float32
# (one a type, csrc/mttkrp_entries.cuh; the float32 entries are in
# matrix_free.cu and fused_mttkrp.cu).
TYPED_SOURCES = {"bf16": "mttkrp_bf16.cu", "f16": "mttkrp_f16.cu", "f64": "mttkrp_f64.cu"}
KERNEL = CudaKernel(
    "matrix_free.cu",
    "matrix_free_mttkrp_f32",
    [_ptr, _FACTORS, _SHAPE, _int, _int, _int, _int, _int, _c64, _int, _ptr, _ptr, _ptr],
    TYPED_SOURCES,
)
BATCHED_KERNEL = CudaKernel(
    "matrix_free.cu",
    "matrix_free_mttkrp_batched_f32",
    [_ptr, _FACTORS, _SHAPE, _int, _int, _int, _int, _int, _c64, _int, _ptr, _ptr],
    TYPED_SOURCES,
)
# The kernel's occupancy at one launch geometry (a query: no launch).
OCCUPANCY = CudaKernel(
    "matrix_free.cu",
    "matrix_free_occupancy_f32",
    [_int, _int, _c64, _int, ctypes.POINTER(_int), ctypes.POINTER(_int)],
    TYPED_SOURCES,
)


def _fold_tile(t: Tensor, us_by_mode: dict[int, Tensor], n: int, batched: bool = False) -> Tensor:
    """Contract every non-target mode out of ``t`` (all modes present;
    with ``batched`` a leading slab axis on ``t`` and on every factor).

    The highest non-target mode goes first as one contraction, producing a
    trailing rank axis (batched: one batched GEMM over that mode); every
    remaining non-target mode is then a broadcast-multiply-reduce, in
    descending mode order (removing an axis only shifts larger ids, which
    are already gone).  Every operand is cast to float32 first, as the
    reference's kernel and ``_fold_tile`` cast theirs, so the fold runs and
    returns float32 whatever their dtype (no copy for a float32 operand).
    """
    f32 = torch.float32
    t = t.to(f32)
    off = 1 if batched else 0
    live = list(range(t.ndim - off))
    desc = sorted((k for k in live if k != n), reverse=True)
    first = desc[0]
    u = us_by_mode[first].to(f32)
    pos = live.index(first) + off
    if batched:
        tm = t.movedim(pos, -1)
        t = torch.bmm(tm.reshape(tm.shape[0], -1, tm.shape[-1]), u)
        t = t.reshape(tuple(tm.shape[:-1]) + (u.shape[-1],))
    else:
        t = torch.tensordot(t, u, dims=([pos], [0]))
    live.remove(first)
    for a in desc[1:]:
        u = us_by_mode[a].to(f32)
        pos = live.index(a) + off
        shape = [1] * t.ndim
        if batched:
            shape[0] = u.shape[0]
        shape[pos] = u.shape[-2]
        shape[-1] = u.shape[-1]
        t = (t * u.reshape(shape)).sum(dim=pos)
        live.remove(a)
    return t


def matrix_free_kernel_plain(x: Tensor, us: Sequence[Tensor], n: int) -> Tensor:
    """The plain PyTorch version: :func:`_fold_tile` over the whole tensor."""
    others = [k for k in range(x.ndim) if k != n]
    return _fold_tile(x, dict(zip(others, us)), n)


def matrix_free_batched_kernel_plain(x: Tensor, us: Sequence[Tensor], n: int) -> Tensor:
    """The plain PyTorch version of the batched kernel: the batched
    :func:`_fold_tile` (one batched GEMM over the contracted mode, then
    broadcast reductions) over the whole stack."""
    others = [k for k in range(x.ndim - 1) if k != n]
    return _fold_tile(x, dict(zip(others, us)), n, batched=True)


def _reduction_blocks(mode_shape: Sequence[int], n: int, rank: int) -> dict[int, int]:
    """Per-non-target-mode block sizes of one step at a fixed tile of
    ``BLOCK_R`` indices of the contracted mode: the port's counterpart of
    the reference's ``_reduction_blocks``.  (The CUDA kernel stages whole q
    extents instead, sized by :func:`cluster_smem`.)

    The highest non-target mode is contracted ``BLOCK_R`` indices at a time;
    every other non-target mode advances one index per step (its factor row
    scales the contracted tile).  Raises when the step's shared memory --
    tensor tile, factor tile, outer weights and the cross-warp reduction
    buffer -- exceeds what a Hopper block may use.  Tile sizes change only
    the order of summation, never the result beyond rounding.
    """
    rb = {k: 1 for k in range(len(mode_shape)) if k != n}
    q = max(rb)
    rb[q] = block(mode_shape[q], BLOCK_R)
    cp = next((p for p in PADDED_RANKS if rank <= p), 4 * -(-rank // 4))
    smem = 4 * (BLOCK_R * (BLOCK_ROWS + 1) + BLOCK_R * cp + cp + cp * BLOCK_ROWS)
    if smem > SMEM_BYTES:
        raise ValueError(f"rank {rank} tile needs {smem} B of shared memory (> {SMEM_BYTES})")
    return rb


def _check_operands(mode_shape: Sequence[int], us: Sequence[Tensor], n: int, lead: int) -> list[int]:
    """Validate order, mode and factor shapes (``lead`` slab axes in front
    of each factor); return the non-target modes."""
    big_n = len(mode_shape)
    others = [k for k in range(big_n) if k != n]
    if not 3 <= big_n <= 6:
        raise ValueError(f"matrix-free kernel covers order-3..6, got {big_n}")
    if not 0 <= n < big_n:
        raise ValueError(f"mode {n} out of range for order-{big_n} tensor")
    if len(us) != len(others):
        raise ValueError("need one factor per non-target mode")
    c = us[0].shape[-1]
    for k, u in zip(others, us):
        if u.ndim != 2 + lead or u.shape[lead] != mode_shape[k] or u.shape[-1] != c:
            raise ValueError(f"mode {k}: factor {tuple(u.shape)} does not match the tensor")
    return others


class ClusterLaunch(NamedTuple):
    """One launch of the kernel: a grid of ``(row_blocks * col_blocks,
    groups * splits, slabs)`` CTAs of 256 threads in clusters of ``(1,
    splits, 1)``, grid x = row block * ``col_blocks`` + column block (one
    column block up to rank 64: :func:`column_blocks`).  A (slab, row
    block, column block) folds :attr:`steps` steps, one (chunk of ``q_chunk``
    indices of the contracted mode ``q``, outer index) pair each, chunk
    outer; part ``p`` of the ``P = groups * splits`` takes the flat steps
    ``[steps * p // P, steps * (p + 1) // P)`` (:func:`part_steps`).  A
    cluster sums its parts on chip; with ``groups > 1`` (one tensor) a
    second pass adds the groups' partials in group order."""

    row_blocks: int  # grid x: BLOCK_ROWS target rows a CTA
    groups: int  # clusters a row block along grid y (1 for a stack)
    splits: int  # CTAs of a cluster along grid y: parts of the steps, summed on chip
    slabs: int  # grid z
    outer: int  # outer multi-indices of a (slab, row block)
    q_chunk: int  # indices of mode q a stage holds (a multiple of 4)
    chunks: int  # passes over q: ceil(I_q / q_chunk)
    i_contig: bool  # the target mode is the last, contiguous one
    vec: bool  # 16-byte copies: the contiguous axis' extent is a multiple of 4
    smem: int  # dynamic shared memory, bytes
    residency: int  # CTAs an SM holds
    col_blocks: int  # column blocks of the rank, the inner part of grid x
    block_width: int  # columns of each block but the last, which holds the rest
    padded_rank: int  # the blocks' width padded (the kernel's register tile)

    @property
    def steps(self) -> int:
        """Steps of a (slab, row block): chunks x outer indices."""
        return self.chunks * self.outer

    @property
    def grid_x(self) -> int:
        """Grid x: the row blocks times the column blocks."""
        return self.row_blocks * self.col_blocks


def part_steps(steps: int, part: int, parts: int) -> tuple[int, int]:
    """The flat steps ``[lo, hi)`` of part ``part`` of ``parts`` (the
    kernel's balanced cut; step ``s`` is chunk ``s // outer``, outer index
    ``s % outer``)."""
    return steps * part // parts, steps * (part + 1) // parts


def contracted_mode(order: int, n: int) -> int:
    """The mode the kernel contracts first: the highest one that is not ``n``."""
    return order - 2 if n == order - 1 else order - 1


def row_stride(q_chunk: int, itemsize: int) -> int:
    """Elements between the rows of a tile whose rows run along the
    contracted mode (the target mode not last), as ``mfc_row_stride`` in
    csrc/mttkrp_cluster.cuh: at least ``q_chunk`` and 16 mod 128 bytes (4
    mod 32 floats, 8 mod 64 16-bit elements, 2 mod 16 doubles), so every
    row starts on a 16-byte line and the lanes' 16-byte reads of their own
    rows miss each other's banks."""
    line, lead = 128 // itemsize, 16 // itemsize
    return q_chunk + (line + lead - q_chunk % line) % line


def q_multiple(i_contig: bool, itemsize: int) -> int:
    """What a stage's ``q_chunk`` must be a multiple of (``mfc_q_multiple``):
    4, the fold's quads, and 8 for a 16-bit tile whose rows run along the
    contracted mode, which the kernel copies and reads 16 bytes (8
    elements) at a time."""
    return 8 if itemsize == 2 and not i_contig else 4


def cluster_smem(q_chunk: int, padded_rank: int, i_contig: bool, itemsize: int = 4) -> int:
    """Dynamic shared memory of one CTA of the kernel, in bytes (as
    ``mfc_smem_bytes`` in csrc/mttkrp_cluster.cuh): a ring of ``STAGES``
    tensor tiles of ``BLOCK_ROWS`` x ``q_chunk`` elements of ``itemsize``
    bytes (rows :func:`row_stride` apart unless ``i_contig``), each stage's
    outer factor rows and ``U_q``'s chunk in float32; the cross-warp sum
    reuses it and needs ``WARPS`` x rank x ``BLOCK_ROWS`` floats."""
    qs = q_chunk if i_contig else row_stride(q_chunk, itemsize)
    main = (STAGES * BLOCK_ROWS * qs * itemsize
            + 4 * (STAGES * MAX_OUTER * padded_rank + q_chunk * padded_rank))
    return max(main, 4 * WARPS * padded_rank * BLOCK_ROWS)


def _cluster_launch(shape: tuple[int, ...], n: int, rank: int, blocks_per_sm: int,
                    split: Callable[[int, int, int], tuple[int, int, int]],
                    itemsize: int) -> ClusterLaunch:
    """A launch at mode ``n`` and ``rank`` whose grid comes from
    ``split(grid x, steps, CTAs an SM counted) -> (groups, splits,
    slabs)``, grid x being the row blocks times the column blocks of
    ``rank`` (:func:`column_blocks`: the waves count them all), the steps a
    row block's (chunks x outer indices) and the CTAs an SM counted
    ``min(blocks_per_sm, residency)``, the residency and the stages sized by
    a column block's padded width.  A stage holds the whole extent of the
    contracted mode ``q`` where it fits in the shared memory that lets
    ``residency`` CTAs share an SM, else the largest equal chunk of it that
    fits (a multiple of :func:`q_multiple`), for elements of ``itemsize``
    bytes.  16-byte copies where the contiguous axis' bytes are a multiple
    of 16 (the wrapper also checks ``x``'s alignment)."""
    if blocks_per_sm < 1:
        raise ValueError(f"blocks_per_sm must be >= 1, got {blocks_per_sm}")
    order = len(shape)
    q = contracted_mode(order, n)
    i_contig = n == order - 1
    col_blocks, width, cp = column_blocks(rank)
    res = residency(cp)
    budget = min(SMEM_BYTES, SM_SMEM_BYTES // res - BLOCK_RESERVED_SMEM)
    eq = shape[q]
    mult = q_multiple(i_contig, itemsize)
    chunks = 1
    while True:  # the fewest equal chunks of q whose stages fit
        per_chunk = -(-eq // chunks)
        q_chunk = mult * -(-per_chunk // mult)  # up to a multiple of mult
        if cluster_smem(q_chunk, cp, i_contig, itemsize) <= budget:
            break
        chunks += 1
    chunks = -(-eq // q_chunk)
    outer = math.prod(shape[k] for k in range(order) if k not in (n, q))
    row_blocks = -(-shape[n] // BLOCK_ROWS)
    groups, splits, slabs = split(row_blocks * col_blocks, chunks * outer,
                                  min(blocks_per_sm, res))
    return ClusterLaunch(
        row_blocks, groups, splits, slabs, outer, q_chunk, chunks, i_contig,
        shape[-1] * itemsize % 16 == 0, cluster_smem(q_chunk, cp, i_contig, itemsize), res,
        col_blocks, width, cp,
    )


@functools.lru_cache(maxsize=256)
def launch_shape(
    shape: tuple[int, ...], n: int, rank: int, slabs: int, blocks_per_sm: int = BLOCKS_PER_SM,
    itemsize: int = 4,
) -> ClusterLaunch:
    """The batched kernel's launch for ``slabs`` stacked tensors of
    ``shape`` at mode ``n`` and ``rank``, from the shape alone and the
    operands' ``itemsize`` (the stage as :func:`_cluster_launch` sizes it;
    one group).

    A row block's steps are split over a cluster of ``splits`` in {1, 2, 4,
    8} CTAs (never more than there are steps).  Wave slots are counted by
    cluster, as in :func:`unbatched_launch_shape`: a wave holds
    ``CLUSTER_SLOTS[min(blocks_per_sm, residency)][splits]`` of the
    ``row_blocks * col_blocks * slabs`` clusters.  The launch takes the
    fewest waves and, within them, the most CTAs (the larger split).  So
    ``blocks_per_sm`` caps the CTAs an SM is counted to hold; at and above
    the residency it changes nothing.
    """

    def split(grid_x, steps, per_sm):
        slots = CLUSTER_SLOTS[per_sm]
        clusters = grid_x * slabs
        waves = {s: -(-clusters // slots[s]) for s in SPLITS if s <= steps}
        fewest = min(waves.values())
        return 1, max(s for s, w in waves.items() if w == fewest), slabs

    return _cluster_launch(shape, n, rank, blocks_per_sm, split, itemsize)


@functools.lru_cache(maxsize=256)
def unbatched_launch_shape(
    shape: tuple[int, ...], n: int, rank: int, blocks_per_sm: int = BLOCKS_PER_SM,
    itemsize: int = 4,
) -> ClusterLaunch:
    """The unbatched kernel's launch for one tensor of ``shape`` at mode
    ``n`` and ``rank``, from the shape alone and the operands' ``itemsize``
    (the stage as :func:`_cluster_launch` sizes it; one slab).

    One tensor's row blocks (2-8 at the fMRI modes) fill few of the card's
    CTA slots, so each row block's steps are cut into ``groups`` clusters of
    ``splits`` in {1, 2, 4, 8} CTAs.  Wave slots are counted by
    cluster, ``CLUSTER_SLOTS`` at ``min(blocks_per_sm, residency)`` CTAs an
    SM (the card holds fewer clusters of 4 and 8 than its CTA slots
    suggest).  Above rank 64 each column block of a row block is a block
    of grid x of its own, and the waves count them all.  The launch takes
    the fewest waves its grid x needs (one, unless it outnumbers the
    clusters of one a wave holds) and, within them, the most CTAs; on a
    tie the larger split (fewer groups for the second pass to add).  Every
    part holds at least one step (chunk of ``q``, outer index), and groups
    x splits stays within the grid's y limit.  So ``blocks_per_sm`` caps
    the CTAs an SM is counted to hold; at and above the residency it
    changes nothing.
    """

    def split(grid_x, steps, per_sm):
        slots = CLUSTER_SLOTS[per_sm]
        waves = -(-grid_x // slots[1])  # clusters of one: the most a wave holds
        best = (0, 0, 0)  # (CTAs, splits, groups)
        for s in SPLITS:
            groups = min(waves * slots[s] // grid_x, steps // s, MAX_GRID_Y // s)
            if groups >= 1:
                best = max(best, (grid_x * groups * s, s, groups))
        return best[2], best[1], 1

    return _cluster_launch(shape, n, rank, blocks_per_sm, split, itemsize)


def workspace_shape(g: ClusterLaunch, rows: int, rank: int) -> tuple[int, int, int] | None:
    """The unbatched launch's workspace: the groups' ``(groups, rows, rank)``
    partials (every column block writes its columns of each), or None with
    one group (its clusters write the output)."""
    return (g.groups, rows, rank) if g.groups > 1 else None


def occupancy(g: ClusterLaunch, rank: int, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """``(CTAs an SM holds, clusters the card holds)`` of the kernel at
    launch ``g`` and ``rank`` (the instance of its column blocks' padded
    width) for operands of ``dtype``, from the CUDA occupancy queries (on
    the card only)."""
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    OCCUPANCY.query(
        rank, int(g.i_contig), g.q_chunk, g.splits, ctypes.byref(per_sm), ctypes.byref(clusters),
        suffix=KERNEL_DTYPES[dtype][0],
    )
    return per_sm.value, clusters.value


def _factor_pointers(us: Sequence[Tensor], others: list[int], big_n: int):
    ptrs = [0] * big_n
    for k, u in zip(others, us):
        ptrs[k] = u.data_ptr()
    return (ctypes.c_void_p * big_n)(*ptrs)


def _check_kernel_operands(x: Tensor, us: Sequence[Tensor],
                           others: list[int]) -> tuple[int, str]:
    """Raise unless the CUDA kernels take ``x`` and ``us``; return the rank
    and the C entries' suffix of their dtype."""
    suffix = kernel_suffix(("x", x), *((f"factor {k}", u) for k, u in zip(others, us)))
    c = us[0].shape[-1]
    check_rank(c)
    return c, suffix


def _launch_unbatched(x: Tensor, us: Sequence[Tensor], n: int, others: list[int],
                      blocks_per_sm: int) -> Tensor:
    """Check the operands and launch the unbatched kernel (and, with more
    than one group, its pass over the workspace).  Returns a float32
    ``(I_n, C)``."""
    mode_shape = tuple(int(d) for d in x.shape)
    big_n = len(mode_shape)
    c, suffix = _check_kernel_operands(x, us, others)
    g = unbatched_launch_shape(mode_shape, n, c, blocks_per_sm, x.element_size())
    rows = mode_shape[n]
    out = x.new_empty((rows, c), dtype=torch.float32)
    ws_shape = workspace_shape(g, rows, c)
    ws = None if ws_shape is None else x.new_empty(ws_shape, dtype=torch.float32)
    x_ptr = x.data_ptr()
    KERNEL.launch(
        x_ptr,
        _factor_pointers(us, others, big_n),
        (ctypes.c_int64 * big_n)(*mode_shape),
        big_n, n, c, g.groups, g.splits, g.q_chunk,
        int(g.vec and x_ptr % 16 == 0),  # a contiguous view may start off a 16-byte line
        None if ws is None else ws.data_ptr(), out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(x.device.index),
        suffix=suffix,
    )
    return out


def _launch_batched(x: Tensor, us: Sequence[Tensor], n: int, others: list[int],
                    blocks_per_sm: int) -> Tensor:
    """Check the operands and make the batched kernel's one launch: one
    allocation (the output, no workspace) and one ctypes call.  Returns a
    float32 ``(S, I_n, C)``."""
    slabs = int(x.shape[0])
    mode_shape = tuple(int(d) for d in x.shape[1:])
    big_n = len(mode_shape)
    c, suffix = _check_kernel_operands(x, us, others)
    check_slabs(slabs)
    g = launch_shape(mode_shape, n, c, slabs, blocks_per_sm, x.element_size())
    out = x.new_empty((slabs, mode_shape[n], c), dtype=torch.float32)
    x_ptr = x.data_ptr()
    BATCHED_KERNEL.launch(
        x_ptr,
        _factor_pointers(us, others, big_n),
        (ctypes.c_int64 * big_n)(*mode_shape),
        big_n, n, c, slabs, g.splits, g.q_chunk,
        int(g.vec and x_ptr % 16 == 0),  # a contiguous view may start off a 16-byte line
        out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(x.device.index),
        suffix=suffix,
    )
    return out


def _reference_blocks(others: list[int], block_i, blocks, block_batch=None) -> None:
    """Check the reference's raw-grid tile keywords (one block per
    non-target mode in ``blocks``); they change nothing here."""
    if blocks is not None and len(blocks) != len(others):
        raise ValueError("need one block per non-target mode")
    reference_tiles(block_i=block_i, blocks=blocks, block_batch=block_batch)


def matrix_free_kernel(
    x: Tensor,
    us: Sequence[Tensor],
    n: int,
    *,
    block_i: int | None = None,
    blocks: Sequence[int] | None = None,
    interpret: bool = False,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """Matrix-free MTTKRP ``M = X_(n) . KRP(us)`` with no KRP.

    ``x`` is the natural N-D tensor (order 3..6) and ``us`` the non-target
    factors ``(I_k, C)`` in ascending mode order.  CUDA tensors launch the
    kernel (contiguous operands of one dtype of ``KERNEL_DTYPES`` at any
    rank >= 1, a rank above 64 in column blocks of one launch; else it
    raises); CPU tensors take the plain version.  Either sums in fp32 and
    returns float32, as the reference's kernel does.  Any extent is
    accepted: the kernel
    masks ragged tiles, so nothing is padded.  The launch comes
    from :func:`unbatched_launch_shape`, whose split of the outer reduction
    counts at most ``blocks_per_sm`` CTAs an SM (at or above the kernel's
    residency, 2 at rank <= 32, it changes nothing); the plain version
    ignores it.  ``block_i``, ``blocks`` and ``interpret`` are the
    reference's keywords, taken for its signature: the CUDA tiles are
    fixed at compile time and nothing is padded to a block, so they change
    nothing, and ``interpret`` never decides the device.
    """
    others = _check_operands(x.shape, us, n, 0)
    _reference_blocks(others, block_i, blocks)
    if not use_kernel(x, *us):
        return matrix_free_kernel_plain(x, us, n)
    return _launch_unbatched(x, us, n, others, blocks_per_sm)


def matrix_free_batched_kernel(
    x: Tensor,
    us: Sequence[Tensor],
    n: int,
    *,
    block_i: int | None = None,
    blocks: Sequence[int] | None = None,
    block_batch: int | None = None,
    interpret: bool = False,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """Batched matrix-free MTTKRP: ``x`` is ``(S, *shape)`` and ``us`` the
    per-slab non-target factors ``(S, I_k, C)``; returns ``(S, I_n, C)``.

    CUDA tensors make one launch of the batched kernel, one slab per grid
    z (contiguous operands of one dtype of ``KERNEL_DTYPES`` at any rank >=
    1, 1..65535 slabs, else it raises; float32 out): no workspace, the outer reduction split over a thread-block
    cluster and summed on chip, the geometry from :func:`launch_shape`.
    CPU tensors take the plain version.  Nothing is padded: not the slabs,
    not any extent.  ``blocks_per_sm`` caps the CTAs an SM is counted to
    hold when :func:`launch_shape` sizes the split (at or above the
    kernel's residency, 2 at rank <= 32, it changes nothing); the
    reference's keywords as in :func:`matrix_free_kernel`, ``block_batch``
    included.
    """
    if any(u.ndim != 3 or u.shape[0] != x.shape[0] for u in us):
        raise ValueError("x and every factor need the same leading slab axis")
    others = _check_operands(x.shape[1:], us, n, 1)
    _reference_blocks(others, block_i, blocks, block_batch)
    if not use_kernel(x, *us):
        return matrix_free_batched_kernel_plain(x, us, n)
    return _launch_batched(x, us, n, others, blocks_per_sm)


def matrix_free_mttkrp(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    block_i: int = 128,
    block_r: int = 8,
    interpret: bool | None = None,
    pad_rank_to: int | None = None,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """Matrix-free MTTKRP for any mode of an order-3..6 tensor: hands the
    tensor in its natural layout and the raw non-target factors to
    :func:`matrix_free_kernel` (with ``blocks_per_sm``).  ``block_i``,
    ``block_r``, ``interpret`` and ``pad_rank_to`` are the reference's
    keywords, with its defaults, taken for its signature: they change
    nothing (compile-time tiles, no padding; ``interpret`` never decides
    the device)."""
    reference_tiles(block_i=block_i, block_r=block_r)
    factors = list(factors)
    big_n = len(factors)
    if x.ndim != big_n:
        raise ValueError(
            f"x.ndim {x.ndim} != {big_n} factors -- for a leading batch axis "
            "use matrix_free_mttkrp_batched"
        )
    if not 3 <= big_n <= 6:
        raise ValueError(f"matrix-free kernel covers order-3..6, got {big_n}")
    us = [factors[k] for k in range(big_n) if k != n]
    return matrix_free_kernel(x, us, n, blocks_per_sm=blocks_per_sm).to(x.dtype)


def matrix_free_mttkrp_batched(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    block_i: int = 128,
    block_r: int = 8,
    block_batch: int = 8,
    interpret: bool | None = None,
    pad_rank_to: int | None = None,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """Batched matrix-free MTTKRP: ``x`` is ``(S, *shape)``, factors
    ``(S, I_k, C)``; hands the stack and the raw non-target factors to
    :func:`matrix_free_batched_kernel` (with ``blocks_per_sm``).  The
    reference's keywords as in :func:`matrix_free_mttkrp`, ``block_batch``
    included: they change nothing."""
    reference_tiles(block_i=block_i, block_r=block_r, block_batch=block_batch)
    factors = list(factors)
    big_n = len(factors)
    if x.ndim != big_n + 1:
        raise ValueError(
            f"x.ndim {x.ndim} != {big_n} factors + batch axis -- for an "
            "unbatched tensor use matrix_free_mttkrp"
        )
    if not 3 <= big_n <= 6:
        raise ValueError(f"matrix-free kernel covers order-3..6, got {big_n}")
    us = [factors[k] for k in range(big_n) if k != n]
    return matrix_free_batched_kernel(x, us, n, blocks_per_sm=blocks_per_sm).to(x.dtype)
