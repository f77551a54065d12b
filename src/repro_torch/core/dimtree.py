"""Dimension-tree contraction primitives (the paper's Sec. 6 "next step").

Port of ``repro.core.dimtree``.  The sweep engine's
:class:`repro_torch.plan.executor.LocalExecutor` calls two primitives for
tree schedules:

* :func:`partial_mttkrp_range` -- contract every mode outside ``[lo, hi)``
  of the raw tensor away (the root-level GEMM of a tree node);
* :func:`contract_from_partial` -- contract a subset of a partial tensor's
  surviving modes with their factors (an inner edge, or a leaf's multi-TTV).

The tree shapes live in :mod:`repro_torch.plan.schedule`;
:func:`dimtree_sweep` stays as the legacy wrapper for the binary-split
sweep, and :func:`mttkrp_from_partial` is the leaf multi-TTV it was built
from.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

from .krp import krp_or_ones
from .tensor_ops import mode_letters

Tensor = torch.Tensor


def partial_mttkrp_right(x: Tensor, right_factors: Sequence[Tensor]) -> Tensor:
    """T_L = X contracted with the KRP of the trailing ``len(right)`` modes;
    shape ``x.shape[:m] + (C,)``.  One GEMM on a free view of a contiguous
    ``x`` (a strided one is copied once)."""
    n_right = len(right_factors)
    c = right_factors[0].shape[1]
    m = x.ndim - n_right
    left_size = math.prod(x.shape[:m])
    k_r = krp_or_ones(list(right_factors), c, x.dtype, x.device)
    t = x.reshape(left_size, -1) @ k_r
    return t.view(tuple(x.shape[:m]) + (c,))


def partial_mttkrp_left(x: Tensor, left_factors: Sequence[Tensor]) -> Tensor:
    """T_R = X contracted with the KRP of the leading ``len(left)`` modes;
    shape ``x.shape[m:] + (C,)``.  One GEMM on a free view of a contiguous
    ``x`` (a strided one is copied once)."""
    m = len(left_factors)
    c = left_factors[0].shape[1]
    right_size = math.prod(x.shape[m:])
    k_l = krp_or_ones(list(left_factors), c, x.dtype, x.device)
    t = k_l.T @ x.reshape(-1, right_size)  # (C, R)
    return torch.movedim(t.view((c,) + tuple(x.shape[m:])), 0, -1)


def partial_mttkrp_range(x: Tensor, factors: Sequence[Tensor], lo: int, hi: int) -> Tensor:
    """Contract every mode of ``x`` outside ``[lo, hi)`` with its factor.

    Returns the partial tensor of shape ``x.shape[lo:hi] + (C,)``.  The
    trailing modes go first through the GEMM of :func:`partial_mttkrp_right`
    (``lo == 0`` is exactly that; ``hi == N`` is
    :func:`partial_mttkrp_left`); a leading range is then contracted
    against its KRP along the shared rank axis.
    """
    n = x.ndim
    if not 0 <= lo < hi <= n:
        raise ValueError(f"range [{lo}, {hi}) invalid for order-{n} tensor")
    if lo == 0 and hi == n:
        raise ValueError("range [0, N) contracts nothing")
    if lo == 0:
        return partial_mttkrp_right(x, list(factors[hi:]))
    if hi == n:
        return partial_mttkrp_left(x, list(factors[:lo]))
    t = partial_mttkrp_right(x, list(factors[hi:]))
    c = factors[0].shape[1]
    left_size = math.prod(x.shape[:lo])
    k_l = krp_or_ones(list(factors[:lo]), c, x.dtype, x.device)
    t3 = t.reshape(left_size, -1, c)
    out = torch.einsum("lmc,lc->mc", t3, k_l)
    return out.reshape(tuple(x.shape[lo:hi]) + (c,))


def contract_from_partial(
    t: Tensor, factors: Mapping[int, Tensor], lo: int, hi: int, parent_lo: int
) -> Tensor:
    """Contract modes of a partial tensor ``t`` down to the range ``[lo, hi)``.

    ``t`` carries the parent node's surviving modes (starting at tensor mode
    ``parent_lo``) plus the trailing rank axis; ``factors`` maps each tensor
    mode contracted here to its ``(I_m, C)`` factor.
    """
    order = t.ndim - 1
    letters = mode_letters(order)
    terms = [letters + "c"]
    args: list[Tensor] = [t]
    for m in sorted(factors):
        terms.append(letters[m - parent_lo] + "c")
        args.append(factors[m])
    out = "".join(letters[k - parent_lo] for k in range(lo, hi)) + "c"
    return torch.einsum(",".join(terms) + f"->{out}", *args)


def mttkrp_from_partial(t: Tensor, siblings: Sequence[Tensor], pos: int) -> Tensor:
    """MTTKRP for one mode of a half from its partial tensor ``t``.

    ``t``: ``(I_s0, ..., I_sk, C)`` -- the half's modes plus the rank axis;
    ``siblings``: factors of the half's other modes (in order, skipping
    ``pos``).
    """
    order = t.ndim - 1
    letters = mode_letters(order)
    terms = [letters + "c"]
    args: list[Tensor] = [t]
    si = 0
    for k in range(order):
        if k == pos:
            continue
        terms.append(letters[k] + "c")
        args.append(siblings[si])
        si += 1
    return torch.einsum(",".join(terms) + f"->{letters[pos]}c", *args)


def dimtree_sweep(
    x: Tensor,
    factors: list[Tensor],
    weights: Tensor,
    norm_x: Tensor,
    it,
    *,
    normalize: bool = True,
    split: int | None = None,
):
    """One full ALS sweep via the binary dimension tree; returns
    ``(factors, weights, fit)`` like :func:`repro_torch.core.cpals.als_sweep`,
    with the same iterates.

    Legacy wrapper: builds the ``strategy='dimtree'`` plan (``split``
    defaults to the balanced half) and runs the one sweep engine on a
    ``LocalExecutor``.
    """
    from repro_torch import plan as planlib

    return planlib.legacy_sweep(
        x, factors, weights, norm_x, it,
        strategy="dimtree", normalize=normalize, split=split,
    )
