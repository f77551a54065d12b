"""CP-ALS entry points and the shared per-update algebra (paper Sec. 2.2).

Port of ``repro.core.cpals``.  Per mode-n update:

    M   = MTTKRP(X, {U_k}, n)
    H   = *_{k != n} (U_k^T U_k)
    U_n = M @ pinv(H);  column-normalize -> lambda

and the fit comes from the factored identity reusing the last MTTKRP:
    ||X - Y||^2 = ||X||^2 - 2 <X, Y> + ||Y||^2.

The sweep itself lives in one place, :func:`repro_torch.plan.sweep.als_sweep`,
driven by a ``SweepPlan``; :func:`als_sweep` and :func:`cp_als` below are
the legacy wrappers that build the plan for the old ``method=`` argument.
This module keeps the small algebra helpers the engine imports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from .mttkrp import Method

Tensor = torch.Tensor


@dataclass
class CPState:
    factors: list[Tensor]  # (I_k, C) -- or (B, I_k, C) for batched problems
    weights: Tensor  # lambda, shape (C,) -- or (B, C)
    fit: Tensor  # 0-d tensor -- or shape (B,)
    it: int = 0
    # Exact sweeps run when the plan used pairwise perturbation
    # (Problem.pp_tol > 0); None for exact-only runs.
    pp_exact_sweeps: int | None = None


@dataclass
class CPConfig:
    rank: int
    n_iters: int = 50
    tol: float = 1.0e-5
    method: Method = "auto"
    seed: int = 0
    normalize: bool = True
    track_fit: bool = True


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
    *,
    row_sum: Callable[[Tensor], Tensor] | None = None,
) -> Tensor:
    """Fit via the factored identity, reusing the final mode's MTTKRP:
    ``<X, Y> = sum(M_last * (U_last * lambda))`` and
    ``||Y||^2 = lambda^T ( *_k U_k^T U_k ) lambda``.

    ``row_sum`` completes the inner product when ``m_last`` and
    ``last_factor`` hold only some rows of the last mode (a sharded
    problem: the sum over the ranks holding the other rows); ``None`` is
    the identity."""
    n_modes = len(gs)
    full_h = gs[-1] * hadamard_except(gs, n_modes - 1)
    norm_y_sq = torch.einsum("...c,...cd,...d->...", weights, full_h, weights)
    inner = torch.sum(m_last * (last_factor * weights[..., None, :]), dim=(-2, -1))
    if row_sum is not None:
        inner = row_sum(inner)
    resid_sq = torch.clamp(norm_x**2 - 2.0 * inner + norm_y_sq, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / norm_x


def normalize_columns(
    u: Tensor, it: int, *, row_sum: Callable[[Tensor], Tensor] | None = None
) -> tuple[Tensor, Tensor]:
    """Column norms -> lambda.  The first sweep (``it == 0``, a Python int)
    uses the 2-norm, later sweeps ``max(1, norm)`` (the Tensor Toolbox
    convention that keeps lambdas stable).  Norms run over the row axis.

    With ``row_sum`` (``u`` holds some of the rows; ``row_sum`` sums a
    per-column vector over the ranks holding the others) the norm is
    ``sqrt(row_sum(norm ** 2))`` of this block's norms."""
    norms = torch.linalg.vector_norm(u, dim=-2)
    if row_sum is not None:
        norms = torch.sqrt(row_sum(norms * norms))
    if it != 0:
        norms = torch.clamp(norms, min=1.0)
    return u / norms[..., None, :], norms


def als_sweep(
    x: Tensor,
    factors: list[Tensor],
    weights: Tensor,
    norm_x: Tensor,
    it: int,
    method: Method,
    normalize: bool,
) -> tuple[list[Tensor], Tensor, Tensor]:
    """One full ALS sweep over all modes; returns ``(factors, weights, fit)``.

    Legacy wrapper: builds the flat plan for ``method`` and runs the one
    sweep engine on a ``LocalExecutor``
    (:func:`repro_torch.plan.legacy_sweep`).
    """
    from repro_torch import plan as planlib

    return planlib.legacy_sweep(
        x, factors, weights, norm_x, it, strategy=method, normalize=normalize
    )


def cp_als(
    x: Tensor,
    config: CPConfig,
    init_factors: list[Tensor] | None = None,
    callback: Callable[[int, float, float], None] | None = None,
) -> CPState:
    """Run CP-ALS with the plan ``plan_sweep`` makes for ``config.method``;
    per-sweep times go through ``callback(it, fit, seconds)``.

    Legacy wrapper over :func:`repro_torch.plan.cp_als`, on ``x``'s device.
    """
    from repro_torch import plan as planlib

    problem = planlib.Problem.from_tensor(x, config.rank)
    sweep_plan = planlib.plan_sweep(problem, strategy=config.method, normalize=config.normalize)
    return planlib.cp_als(
        x,
        sweep_plan,
        n_iters=config.n_iters,
        tol=config.tol,
        seed=config.seed,
        track_fit=config.track_fit,
        init_factors=init_factors,
        callback=callback,
    )
