"""Kernel wrappers: partial-KRP split, views and mode dispatch.

Port of ``balanced_split``, ``fused_mttkrp`` and the ``matrix_free_mttkrp``
alias of ``repro.kernels.ops``.  The reference pads every tiled axis to its
block multiple and the rank to the TPU's 128 lanes; the CUDA kernels mask
ragged tiles and pad the rank only in their own registers, so nothing here
pads or copies the tensor.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.core.krp import krp_or_ones
from repro_torch.core.tensor_ops import dims_split

from .fused_mttkrp import fused_mttkrp_bilinear
from .matrix_free import matrix_free_mttkrp  # noqa: F401  (re-exported alias)

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
    factors = list(factors)
    big_n = len(factors)
    if x.ndim != big_n:
        raise ValueError(f"x.ndim {x.ndim} != {big_n} factors")
    c = factors[0].shape[1]
    left = factors[:n]
    right = factors[n + 1 :]
    in_dim = x.shape[n]

    if 0 < n < big_n - 1:
        pos = 1
        a_mats, b_mats = left, right
        big_l, _, big_r = dims_split(x.shape, n)
        t = x.view(big_l, in_dim, big_r)
    elif n == 0:
        pos = 0
        split = balanced_split([f.shape[0] for f in right]) if len(right) > 1 else 0
        a_mats, b_mats = right[:split], right[split:]
        da = math.prod(f.shape[0] for f in a_mats) if a_mats else 1
        db = math.prod(f.shape[0] for f in b_mats)
        t = x.view(in_dim, da, db)
    else:  # n == N-1
        pos = 2
        split = balanced_split([f.shape[0] for f in left]) if len(left) > 1 else 1
        a_mats, b_mats = left[:split], left[split:]
        da = math.prod(f.shape[0] for f in a_mats)
        db = math.prod(f.shape[0] for f in b_mats) if b_mats else 1
        t = x.view(da, db, in_dim)

    a = krp_or_ones(a_mats, c, x.dtype, x.device)
    b = krp_or_ones(b_mats, c, x.dtype, x.device)
    return t, a, b, pos


def fused_mttkrp(x: Tensor, factors: Sequence[Tensor], n: int) -> Tensor:
    """MTTKRP via the fused kernel.  ``M = X_(n) . KRP(factors != n)``.

    The two partial KRPs fed to the kernel (:func:`bilinear_operands`) are
    built with the reuse fold (Alg. 1); the full ``L*R x C`` KRP never
    exists.
    """
    t, a, b, pos = bilinear_operands(x, factors, n)
    return fused_mttkrp_bilinear(t, a, b, pos=pos).to(x.dtype)
