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
slab's own factors ``(S, I_k, C)``.

Supported: every mode of order-3..6 tensors, plus a leading batch axis.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ._build import CudaKernel
from ._tiling import (
    BLOCK_ROWS,
    BLOCKS_PER_SM,
    PADDED_RANKS,
    block,
    check_kernel_operand,
    check_rank,
    check_slabs,
    split_reduction,
    use_kernel,
)

Tensor = torch.Tensor

# Indices of the contracted (highest non-target) mode per step of the CUDA
# kernel (BR in mttkrp_common.cuh).
BLOCK_R = 64
# Shared memory one thread block may use on Hopper (227 KB).
SMEM_BYTES = 232448

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_FACTORS, _SHAPE = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)
KERNEL = CudaKernel(
    "matrix_free.cu",
    "matrix_free_mttkrp_f32",
    [_ptr, _FACTORS, _SHAPE, _int, _int, _int, _c64, _int, _ptr, _ptr, _ptr],
)
BATCHED_KERNEL = CudaKernel(
    "matrix_free.cu",
    "matrix_free_mttkrp_batched_f32",
    [_ptr, _FACTORS, _SHAPE, _int, _int, _int, _int, _c64, _int, _ptr, _ptr, _ptr],
)


def _fold_tile(t: Tensor, us_by_mode: dict[int, Tensor], n: int, batched: bool = False) -> Tensor:
    """Contract every non-target mode out of ``t`` (all modes present;
    with ``batched`` a leading slab axis on ``t`` and on every factor).

    The highest non-target mode goes first as one contraction, producing a
    trailing rank axis (batched: one batched GEMM over that mode); every
    remaining non-target mode is then a broadcast-multiply-reduce, in
    descending mode order (removing an axis only shifts larger ids, which
    are already gone).
    """
    off = 1 if batched else 0
    live = list(range(t.ndim - off))
    desc = sorted((k for k in live if k != n), reverse=True)
    first = desc[0]
    u = us_by_mode[first]
    pos = live.index(first) + off
    if batched:
        tm = t.movedim(pos, -1)
        t = torch.bmm(tm.reshape(tm.shape[0], -1, tm.shape[-1]), u)
        t = t.reshape(tuple(tm.shape[:-1]) + (u.shape[-1],))
    else:
        t = torch.tensordot(t, u, dims=([pos], [0]))
    live.remove(first)
    for a in desc[1:]:
        u = us_by_mode[a]
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
    """Per-non-target-mode block sizes of one step of the CUDA kernel.

    The highest non-target mode is contracted ``BLOCK_R`` indices at a time
    (the shared-memory tile); every other non-target mode advances one index
    per step (its factor row scales the contracted tile).  Raises when the
    step's shared memory -- tensor tile, factor tile, outer weights and the
    cross-warp reduction buffer -- exceeds what a Hopper block may use.
    Tile sizes change only the order of summation, never the result beyond
    rounding.
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


def launch_split(
    mode_shape: Sequence[int], n: int, device, slabs: int | None = None, *,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> tuple[int, int]:
    """``(outer steps per split, splits)`` of a launch for mode ``n``: the
    split reduction runs over every non-target mode but the contracted
    (highest) one, per slab when batched."""
    others = [k for k in range(len(mode_shape)) if k != n]
    outer = math.prod(mode_shape[k] for k in others[:-1])
    return split_reduction(
        mode_shape[n], outer, device, slabs or 1, blocks_per_sm=blocks_per_sm
    )


def _launch(kernel: CudaKernel, x: Tensor, us: Sequence[Tensor], n: int,
            others: list[int], slabs: int | None, blocks_per_sm: int) -> Tensor:
    """Check the operands and launch ``kernel``; ``slabs`` is ``None`` for
    the unbatched entry point.  Returns ``(I_n, C)`` or ``(S, I_n, C)``."""
    mode_shape = x.shape if slabs is None else x.shape[1:]
    big_n = len(mode_shape)
    c = us[0].shape[-1]
    check_kernel_operand("x", x)
    for k, u in zip(others, us):
        check_kernel_operand(f"factor {k}", u)
    check_rank(c)
    lead = () if slabs is None else (slabs,)
    if slabs is not None:
        check_slabs(slabs)
    _reduction_blocks(mode_shape, n, c)
    rows = mode_shape[n]
    o_per_split, splits = launch_split(
        mode_shape, n, x.device, slabs, blocks_per_sm=blocks_per_sm
    )
    ws = torch.empty(lead + (splits, rows, c), dtype=torch.float32, device=x.device)
    out = torch.empty(lead + (rows, c), dtype=torch.float32, device=x.device)
    ptrs = [0] * big_n
    for k, u in zip(others, us):
        ptrs[k] = u.data_ptr()
    kernel.launch(
        x.data_ptr(),
        (ctypes.c_void_p * big_n)(*ptrs),
        (ctypes.c_int64 * big_n)(*[int(d) for d in mode_shape]),
        big_n, n, c, *lead, o_per_split, splits, ws.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def matrix_free_kernel(
    x: Tensor, us: Sequence[Tensor], n: int, *, blocks_per_sm: int = BLOCKS_PER_SM
) -> Tensor:
    """Matrix-free MTTKRP ``M = X_(n) . KRP(us)`` with no KRP.

    ``x`` is the natural N-D tensor (order 3..6) and ``us`` the non-target
    factors ``(I_k, C)`` in ascending mode order.  CUDA tensors launch the
    kernel (contiguous float32 operands, rank up to 64, else it raises); CPU
    tensors take the plain version.  Any extent is accepted: the kernel
    masks ragged tiles, so nothing is padded.  ``blocks_per_sm`` sizes the
    split of the outer reduction
    (:func:`~repro_torch.kernels._tiling.split_reduction`); the plain
    version ignores it.
    """
    others = _check_operands(x.shape, us, n, 0)
    if not use_kernel(x, *us):
        return matrix_free_kernel_plain(x, us, n)
    return _launch(KERNEL, x, us, n, others, None, blocks_per_sm)


def matrix_free_batched_kernel(
    x: Tensor, us: Sequence[Tensor], n: int, *, blocks_per_sm: int = BLOCKS_PER_SM
) -> Tensor:
    """Batched matrix-free MTTKRP: ``x`` is ``(S, *shape)`` and ``us`` the
    per-slab non-target factors ``(S, I_k, C)``; returns ``(S, I_n, C)``.

    CUDA tensors launch the kernel, one slab per block along the grid's z
    axis (contiguous float32 operands, rank up to 64, 1..65535 slabs, else
    it raises); CPU tensors take the plain version.  Nothing is padded: not
    the slabs, not any extent.  ``blocks_per_sm`` as in
    :func:`matrix_free_kernel`.
    """
    if any(u.ndim != 3 or u.shape[0] != x.shape[0] for u in us):
        raise ValueError("x and every factor need the same leading slab axis")
    others = _check_operands(x.shape[1:], us, n, 1)
    if not use_kernel(x, *us):
        return matrix_free_batched_kernel_plain(x, us, n)
    return _launch(BATCHED_KERNEL, x, us, n, others, int(x.shape[0]), blocks_per_sm)


def matrix_free_mttkrp(
    x: Tensor, factors: Sequence[Tensor], n: int, *, blocks_per_sm: int = BLOCKS_PER_SM
) -> Tensor:
    """Matrix-free MTTKRP for any mode of an order-3..6 tensor: hands the
    tensor in its natural layout and the raw non-target factors to
    :func:`matrix_free_kernel` (with ``blocks_per_sm``)."""
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
    x: Tensor, factors: Sequence[Tensor], n: int, *, blocks_per_sm: int = BLOCKS_PER_SM
) -> Tensor:
    """Batched matrix-free MTTKRP: ``x`` is ``(S, *shape)``, factors
    ``(S, I_k, C)``; hands the stack and the raw non-target factors to
    :func:`matrix_free_batched_kernel` (with ``blocks_per_sm``)."""
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
