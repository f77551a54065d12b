"""Dimension-tree contraction primitives (the paper's Sec. 6 "next step").

Port of the two primitives of ``repro.core.dimtree`` that the sweep engine's
:class:`repro_torch.plan.executor.LocalExecutor` calls for tree schedules:

* :func:`partial_mttkrp_range` -- contract every mode outside ``[lo, hi)``
  of the raw tensor away (the root-level GEMM of a tree node);
* :func:`contract_from_partial` -- contract a subset of a partial tensor's
  surviving modes with their factors (an inner edge, or a leaf's multi-TTV).

The tree shapes live in :mod:`repro_torch.plan.schedule`.
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
    shape ``x.shape[:m] + (C,)``.  One GEMM on a free view."""
    n_right = len(right_factors)
    c = right_factors[0].shape[1]
    m = x.ndim - n_right
    left_size = math.prod(x.shape[:m])
    k_r = krp_or_ones(list(right_factors), c, x.dtype, x.device)
    t = x.view(left_size, -1) @ k_r
    return t.view(tuple(x.shape[:m]) + (c,))


def partial_mttkrp_left(x: Tensor, left_factors: Sequence[Tensor]) -> Tensor:
    """T_R = X contracted with the KRP of the leading ``len(left)`` modes;
    shape ``x.shape[m:] + (C,)``.  One GEMM on a free view."""
    m = len(left_factors)
    c = left_factors[0].shape[1]
    right_size = math.prod(x.shape[m:])
    k_l = krp_or_ones(list(left_factors), c, x.dtype, x.device)
    t = k_l.T @ x.view(-1, right_size)  # (C, R)
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
