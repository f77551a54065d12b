"""Kernel wrappers: partial-KRP split, views and mode dispatch.

Port of ``repro.kernels.ops``: ``balanced_split``, ``fused_mttkrp``,
``fused_mttkrp_batched``, ``krp_materialize``, ``mttkrp_2step_kernel`` and
the aliases ``matrix_free_mttkrp``/``matrix_free_mttkrp_batched`` and
``multi_ttv``/``multi_ttv_batched``, plus the operand builders
``bilinear_operands``, ``bilinear_operands_batched`` and
``multi_ttv_operands``.  The reference pads every tiled axis to its block
multiple and the rank to the TPU's 128 lanes; the CUDA kernels mask ragged
tiles and pad the rank only in their own registers, so nothing here pads
or copies the tensor (the left-first 2-step partial is the one copy; see
:func:`multi_ttv_operands`).  As the reference's, every wrapper builds its
partial KRPs in ``x.dtype`` and returns ``x.dtype`` (float32, bfloat16,
float16 or float64); the kernels underneath sum in fp32, so a float64
MTTKRP is accurate to fp32, as the reference's kernels are under x64.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.krp import krp_or_ones, krp_or_ones_batched
from repro_torch.core.tensor_ops import dims_split

from ._tiling import BLOCKS_PER_SM, reference_tiles
from .fused_mttkrp import fused_mttkrp_bilinear, fused_mttkrp_bilinear_batched
from .krp_kernel import krp_pair
from .matrix_free import matrix_free_mttkrp, matrix_free_mttkrp_batched  # noqa: F401  (re-exported)
from .multi_ttv import multi_ttv, multi_ttv_batched  # noqa: F401  (re-exported)

Tensor = torch.Tensor


def balanced_split(dims: Sequence[int]) -> int:
    """Split index minimizing |log prod(left) - log prod(right)| (>=1 each side).

    Public because the ``plan`` cost model mirrors the fused kernel's
    partial-KRP split when predicting its HBM traffic.  ``dims`` are mode
    extents only.
    """
    best, best_val = 1, float("inf")
    total = math.prod(dims)
    acc = 1
    for i in range(1, len(dims)):
        acc *= dims[i - 1]
        val = abs(math.log(acc) - math.log(total / acc))
        if val < best_val:
            best, best_val = i, val
    return best


def _operands(x: Tensor, factors: Sequence[Tensor], n: int, lead: int):
    """``(T, A, B, pos)`` of mode ``n``'s fused MTTKRP, with ``lead``
    (0 or 1) slab axes in front of ``x`` and of every factor."""
    factors = list(factors)
    big_n = len(factors)
    if x.ndim != big_n + lead:
        raise ValueError(f"x.ndim {x.ndim} != {big_n} factors" + (" + batch axis" if lead else ""))
    mode_shape = x.shape[lead:]
    rows = [f.shape[lead] for f in factors]
    c = factors[0].shape[-1]
    left = factors[:n]
    right = factors[n + 1 :]
    in_dim = mode_shape[n]
    slab = tuple(x.shape[:lead])

    if 0 < n < big_n - 1:
        pos = 1
        a_mats, b_mats = left, right
        big_l, _, big_r = dims_split(mode_shape, n)
        t = x.view(slab + (big_l, in_dim, big_r))
    elif n == 0:
        pos = 0
        split = balanced_split(rows[1:]) if len(right) > 1 else 0
        a_mats, b_mats = right[:split], right[split:]
        da = math.prod(rows[1 : 1 + split])
        db = math.prod(rows[1 + split :])
        t = x.view(slab + (in_dim, da, db))
    else:  # n == N-1
        pos = 2
        split = balanced_split(rows[:-1]) if len(left) > 1 else 1
        a_mats, b_mats = left[:split], left[split:]
        da = math.prod(rows[:split])
        db = math.prod(rows[split:-1])
        t = x.view(slab + (da, db, in_dim))

    if lead:
        a = krp_or_ones_batched(a_mats, slab[0], c, x.dtype, x.device)
        b = krp_or_ones_batched(b_mats, slab[0], c, x.dtype, x.device)
    else:
        a = krp_or_ones(a_mats, c, x.dtype, x.device)
        b = krp_or_ones(b_mats, c, x.dtype, x.device)
    return t, a, b, pos


def bilinear_operands(
    x: Tensor, factors: Sequence[Tensor], n: int
) -> tuple[Tensor, Tensor, Tensor, int]:
    """``(T, A, B, pos)`` of mode ``n``'s fused MTTKRP.

    Internal modes take ``(K_L, K_R)`` around ``x.view(L, I_n, R)``
    (``pos=1``); external modes split their single factor list at the
    log-balanced point (``pos=0`` for mode 0, ``pos=2`` for the last mode)
    so both partial KRPs stay near the square root of the full KRP size.
    ``T`` is a free view of ``x``.
    """
    return _operands(x, factors, n, 0)


def bilinear_operands_batched(
    x: Tensor, factors: Sequence[Tensor], n: int
) -> tuple[Tensor, Tensor, Tensor, int]:
    """Batched :func:`bilinear_operands`: ``x`` is ``(S, *shape)`` and each
    factor ``(S, I_k, C)``; ``T`` is a free ``(S, 3-D view)`` of ``x`` and
    ``A``/``B`` the per-slab partial KRPs ``(S, dim, C)``.  The split keys
    on the mode dims only, never on the batch."""
    return _operands(x, factors, n, 1)


def fused_mttkrp(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    block_i: int = 128,
    block_b: int = 256,
    interpret: bool | None = None,
    pad_rank_to: int | None = None,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """MTTKRP via the fused kernel.  ``M = X_(n) . KRP(factors != n)``.

    The two partial KRPs fed to the kernel (:func:`bilinear_operands`) are
    built with the reuse fold (Alg. 1); the full ``L*R x C`` KRP never
    exists.  ``blocks_per_sm`` is the kernel's split knob (the autotuner's
    tile for this kernel).  ``block_i``, ``block_b``, ``interpret`` and
    ``pad_rank_to`` are the reference's keywords, with its defaults, taken
    for its signature: the CUDA tiles are compile-time, nothing is padded
    (the rank only in the kernel's registers), and ``interpret`` never
    decides the device.
    """
    reference_tiles(block_i=block_i, block_b=block_b)
    t, a, b, pos = bilinear_operands(x, factors, n)
    return fused_mttkrp_bilinear(t, a, b, pos=pos, blocks_per_sm=blocks_per_sm).to(x.dtype)


def fused_mttkrp_batched(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    block_i: int = 128,
    block_b: int = 256,
    block_batch: int = 8,
    interpret: bool | None = None,
    pad_rank_to: int | None = None,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """Batched fused MTTKRP: ``x`` is ``(S, *shape)``, factors ``(S, I_k, C)``.

    One launch covers all S stacked problems through the kernel's slab grid
    axis; each slab forms its own KRP tiles on chip, so no per-problem KRP
    exists in HBM.  The reference's keywords as in :func:`fused_mttkrp`;
    ``block_batch`` changes nothing either (every slab is its own z block).
    """
    reference_tiles(block_i=block_i, block_b=block_b, block_batch=block_batch)
    t, a, b, pos = bilinear_operands_batched(x, factors, n)
    return fused_mttkrp_bilinear_batched(
        t, a, b, pos=pos, blocks_per_sm=blocks_per_sm
    ).to(x.dtype)


def krp_materialize(
    mats: Sequence[Tensor], *, block_b: int = 512, interpret: bool | None = None
) -> Tensor:
    """Explicit KRP via the tiled kernel, left-folded for Z > 2 (Alg. 1
    reuse: each fold intermediate is a cached partial Hadamard product).
    The kernel masks the ragged last tile, so no fold is padded or sliced.
    ``interpret`` is the reference's keyword; it never decides the device."""
    mats = list(mats)
    out = mats[0]
    for u in mats[1:]:
        out = krp_pair(out, u, block_b=block_b)
    return out


def multi_ttv_operands(
    x: Tensor, factors: Sequence[Tensor], n: int
) -> tuple[Tensor, Tensor]:
    """``(T, W)`` of mode ``n``'s 2-step second step (Alg. 4), so that
    ``multi_ttv(T, W)`` is the MTTKRP.  Needs an internal mode (``L > 1``
    and ``R > 1``).

    ``L <= R`` is right-first: ``T = (x.view(L*I_n, R) @ K_R).view(L, I_n,
    C)`` and ``W = K_L``.  Otherwise left-first: ``K_L^T @ x.view(L,
    I_n*R)`` is ``(C, I_n, R)`` and is copied to the contiguous ``(R, I_n,
    C)`` the kernel reads (``R * I_n * C`` elements, 1.6 MB at the fMRI
    tensor's mode 2 in float32), with ``W = K_R``.  The GEMM is a plain
    ``torch.matmul`` in ``x.dtype``, as the reference's ``@``.
    """
    factors = list(factors)
    c = factors[0].shape[1]
    big_l, in_dim, big_r = dims_split(x.shape, n)
    if big_l == 1 or big_r == 1:
        raise ValueError(f"mode {n} is external: the 2-step algorithm needs L > 1 and R > 1")
    k_l = krp_or_ones(factors[:n], c, x.dtype, x.device)
    k_r = krp_or_ones(factors[n + 1 :], c, x.dtype, x.device)
    if big_l <= big_r:  # right-first: the 2nd step contracts the smaller L
        r_t = (x.reshape(big_l * in_dim, big_r) @ k_r).reshape(big_l, in_dim, c)
        return r_t, k_l
    l_t = (k_l.T @ x.reshape(big_l, in_dim * big_r)).reshape(c, in_dim, big_r)
    # (C, I, R) -> (R, I, C): the same multi-TTV form over r
    return l_t.permute(2, 1, 0).contiguous(), k_r


def mttkrp_2step_kernel(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    block_i: int = 256,
    interpret: bool | None = None,
) -> Tensor:
    """Alg. 4 with the partial MTTKRP as a plain GEMM and the 2nd-step
    multi-TTV in the kernel (:func:`multi_ttv_operands`, then
    :func:`multi_ttv` with its row tile ``block_i``).  External modes
    (``L == 1`` or ``R == 1``) take :func:`fused_mttkrp`.  ``interpret`` is
    the reference's keyword; it never decides the device."""
    big_l, _, big_r = dims_split(x.shape, n)
    if big_l == 1 or big_r == 1:
        return fused_mttkrp(x, factors, n)
    t, w = multi_ttv_operands(x, factors, n)
    return multi_ttv(t, w, block_i=block_i)
