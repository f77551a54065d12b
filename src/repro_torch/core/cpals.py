"""CP-ALS state and the shared per-update algebra (paper Sec. 2.2).

Port of the helpers of ``repro.core.cpals`` that the sweep engine
(:mod:`repro_torch.plan.sweep`) imports.  Per mode-n update:

    M   = MTTKRP(X, {U_k}, n)
    H   = *_{k != n} (U_k^T U_k)
    U_n = M @ pinv(H);  column-normalize -> lambda

and the fit comes from the factored identity reusing the last MTTKRP:
    ||X - Y||^2 = ||X||^2 - 2 <X, Y> + ||Y||^2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

Tensor = torch.Tensor


@dataclass
class CPState:
    factors: list[Tensor]  # (I_k, C) -- or (B, I_k, C) for batched problems
    weights: Tensor  # lambda, shape (C,) -- or (B, C)
    fit: Tensor  # 0-d tensor -- or shape (B,)
    it: int = 0


def grams(factors: Sequence[Tensor]) -> list[Tensor]:
    """``U_k^T U_k`` per factor (``(C, C)``; batched ``(B, C, C)``)."""
    return [u.transpose(-1, -2) @ u for u in factors]


def hadamard_except(gs: Sequence[Tensor], n: int) -> Tensor:
    """Elementwise product of every Gram matrix but the ``n``-th."""
    out = None
    for k, g in enumerate(gs):
        if k == n:
            continue
        out = g if out is None else out * g
    if out is None:
        raise ValueError("need at least two factors")
    return out


def fit_from_last_mttkrp(
    gs: Sequence[Tensor],
    weights: Tensor,
    m_last: Tensor,
    last_factor: Tensor,
    norm_x: Tensor,
) -> Tensor:
    """Fit via the factored identity, reusing the final mode's MTTKRP:
    ``<X, Y> = sum(M_last * (U_last * lambda))`` and
    ``||Y||^2 = lambda^T ( *_k U_k^T U_k ) lambda``."""
    n_modes = len(gs)
    full_h = gs[-1] * hadamard_except(gs, n_modes - 1)
    norm_y_sq = torch.einsum("...c,...cd,...d->...", weights, full_h, weights)
    inner = torch.sum(m_last * (last_factor * weights[..., None, :]), dim=(-2, -1))
    resid_sq = torch.clamp(norm_x**2 - 2.0 * inner + norm_y_sq, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / norm_x


def normalize_columns(u: Tensor, it: int) -> tuple[Tensor, Tensor]:
    """Column norms -> lambda.  The first sweep (``it == 0``, a Python int)
    uses the 2-norm, later sweeps ``max(1, norm)`` (the Tensor Toolbox
    convention that keeps lambdas stable).  Norms run over the row axis."""
    norms = torch.linalg.vector_norm(u, dim=-2)
    if it != 0:
        norms = torch.clamp(norms, min=1.0)
    return u / norms[..., None, :], norms
