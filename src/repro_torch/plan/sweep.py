"""THE ALS sweep: the one copy of the update algebra, plan- and executor-driven.

Port of the exact path of ``repro.plan.sweep``.  Per mode-n update
(paper Sec. 2.2):

    M   = MTTKRP(X, {U_k}, n)               (executor + plan decide how)
    H   = *_{k != n} (U_k^T U_k)            (Hadamard of Gram matrices)
    U_n = M @ pinv(H);  column-normalize -> lambda

with the fit tracked through the factored identity reusing the last MTTKRP.
The engine walks the plan's contraction schedule node by node.  The
reference's ``lax.scan`` over donated buffers becomes a Python loop that
syncs with the host once per chunk of ``sweeps_per_sync`` sweeps.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, MutableMapping, Sequence

import torch

from repro_torch.core.cpals import (
    CPState,
    fit_from_last_mttkrp,
    grams,
    hadamard_except,
    normalize_columns,
)
from repro_torch.core.tensor_ops import random_factors, tensor_norm

from .executor import Executor, LocalExecutor
from .planner import SweepPlan
from .problem import Problem
from .schedule import ROOT

Tensor = torch.Tensor


def _host_fits(fits: Sequence[Tensor]) -> list:
    """THE host-synchronization point of the cp_als driver: one call per
    chunk of sweeps.  Module-level so tests can count syncs."""
    return torch.stack(list(fits)).tolist()


@dataclass
class SweepState:
    """State carried across sweeps.  ``grams`` carries the per-factor Gram
    matrices ``U_k^T U_k``: each mode's update refreshes its own, so the
    next sweep starts from exact values; ``None`` recomputes them all."""

    x: Tensor
    factors: list[Tensor]
    weights: Tensor
    norm_x: Tensor
    it: int
    fit: Tensor | float = 0.0
    grams: list[Tensor] | None = None


def _pinv(h: Tensor) -> Tensor:
    """``pinv`` with the reference's cutoff: ``jnp.linalg.pinv`` drops
    singular values below ``10 * max(m, n) * eps`` of the largest, where
    ``torch.linalg.pinv`` defaults to ``max(m, n) * eps``."""
    rtol = 10.0 * max(h.shape[-2:]) * torch.finfo(h.dtype).eps
    return torch.linalg.pinv(h, rtol=rtol)


def _update_factor(
    plan: SweepPlan, factors: list[Tensor], gs: list[Tensor], weights: Tensor,
    n: int, m_n: Tensor, it: int,
) -> Tensor:
    """THE per-mode factor update: solve ``U H = M`` via pinv on the C x C
    Gram-Hadamard, optionally column-normalize into the lambdas, and
    refresh exactly the changed factor's Gram.  Mutates ``factors``/``gs``
    in place; returns the (possibly updated) weights."""
    h = hadamard_except(gs, n)
    u = m_n @ _pinv(h)
    if plan.normalize:
        u, weights = normalize_columns(u, it)
    factors[n] = u
    gs[n] = u.transpose(-1, -2) @ u
    return weights


def als_sweep(
    problem: Problem, plan: SweepPlan, executor: Executor, state: SweepState
) -> SweepState:
    """One full ALS sweep over all modes, following ``plan`` on ``executor``.

    The engine is a schedule walker: it visits the plan's contraction tree
    in pre-order, materializing each internal node's partial tensor through
    ``executor.contract`` and caching it for its children, and updating one
    factor at each leaf.  Because children partition their parent's range
    in order and nodes materialize right before their first descendant
    leaf, any valid schedule reproduces the standard ALS iterates.
    """
    x = state.x
    factors = list(state.factors)
    weights = state.weights
    gs = list(state.grams) if state.grams is not None else grams(factors)
    m_last = None
    cache: dict[int, Tensor] = {ROOT: x}
    for node in plan.resolved_schedule.walk():
        src = cache[node.parent]
        if plan.nodes:
            np_ = plan.node_plan(node.id)
            alg, tiles = np_.algorithm, np_.tiles
        else:
            alg, tiles = "auto", None
        out = executor.contract(node, src, factors, alg, tiles=tiles)
        if node.is_leaf:
            m_last = out
            weights = _update_factor(plan, factors, gs, weights, node.mode, out, state.it)
        else:
            cache[node.id] = out
    fit = fit_from_last_mttkrp(gs, weights, m_last, factors[-1], state.norm_x)
    return SweepState(
        x=x, factors=factors, weights=weights, norm_x=state.norm_x, it=state.it,
        fit=fit, grams=gs,
    )


def cp_als(
    x: Tensor,
    plan: SweepPlan,
    *,
    executor: Executor | None = None,
    n_iters: int = 50,
    tol: float = 1.0e-5,
    seed: int = 0,
    track_fit: bool = True,
    init_factors: list[Tensor] | None = None,
    callback: Callable[[int, float, float], None] | None = None,
    sweeps_per_sync: int = 1,
    dispatch_cache: MutableMapping[Any, Callable] | None = None,
    dispatch_key: Any = None,
) -> CPState:
    """THE CP-ALS driver: init, chunked sweep loop, convergence stop.

    Runs where ``x`` lies.  Without ``init_factors`` the factors are drawn
    from a ``torch.Generator`` on ``x``'s device seeded with ``seed`` (not
    stream-identical to the JAX package's init).  Caller-provided factors
    are never modified: every update makes new tensors.

    ``sweeps_per_sync`` sweeps are queued per chunk and the host reads the
    chunk's fits once at its end (one device sync per chunk instead of per
    sweep); iterates are bitwise identical to ``sweeps_per_sync=1``.
    Convergence is checked against the chunk's per-sweep fits at each sync
    point, so a run may execute up to ``sweeps_per_sync - 1`` sweeps past
    the first converged one; ``callback(it, fit, seconds)`` fires once per
    executed sweep with the chunk's mean per-sweep seconds.

    Batched problems (``plan.problem.batched``) expect ``x`` of shape
    ``(batch, *problem.shape)`` and run all problems through the same
    launches: factors, weights and Grams gain a leading batch axis, the fit
    is per problem (``CPState.fit`` has shape ``(batch,)``), the callback
    receives the batch-mean fit, and the run stops when every problem's fit
    delta is below ``tol`` (the shared stop of one batched dispatch).

    ``dispatch_cache`` and ``dispatch_key`` are accepted for the serving
    engine's calling convention and have nothing to cache: PyTorch runs
    eagerly, so there is no compiled sweep to reuse.
    """
    problem = plan.problem
    if executor is None:
        if plan.executor != "local":
            raise ValueError(f"plan.executor={plan.executor!r} needs an executor instance")
        executor = LocalExecutor()
    k = int(sweeps_per_sync)
    if k < 1:
        raise ValueError(f"sweeps_per_sync must be >= 1, got {sweeps_per_sync}")
    lead = (problem.batch,) if problem.batched else ()
    if tuple(x.shape) != lead + problem.shape:
        raise ValueError(
            f"problem expects x.shape {lead + problem.shape}, got {tuple(x.shape)}"
        )
    if init_factors is None:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        factors = random_factors(
            gen, problem.shape, problem.rank, x.dtype, batch=problem.batch, device=x.device
        )
    else:
        factors = list(init_factors)
    x, factors = executor.prepare(problem, x, factors)
    weights = torch.ones(lead + (problem.rank,), dtype=x.dtype, device=x.device)
    norm_x = tensor_norm(x, batched=problem.batched).to(x.dtype)
    gs = grams(factors)

    fit_prev = [-math.inf] * problem.batch if problem.batched else -math.inf
    fit = torch.zeros(lead, dtype=x.dtype, device=x.device)
    it = 0
    done = False
    while it < n_iters and not done:
        length = min(k, n_iters - it)
        t0 = time.perf_counter()
        fits = []
        for j in range(length):
            state = als_sweep(
                problem, plan, executor,
                SweepState(x=x, factors=factors, weights=weights, norm_x=norm_x,
                           it=it + j, grams=gs),
            )
            factors, weights, gs = state.factors, state.weights, state.grams
            fits.append(state.fit)
        host = _host_fits(fits)  # the chunk's single host sync
        dt = time.perf_counter() - t0
        for j, f in enumerate(host):
            if problem.batched:
                # per-problem fits (B,); stop only when every problem's fit
                # delta clears tol (one batched dispatch, shared stop)
                if callback is not None:
                    callback(it + j, sum(f) / len(f), dt / length)
                if track_fit and max(abs(a - b) for a, b in zip(f, fit_prev)) < tol:
                    done = True
            else:
                if callback is not None:
                    callback(it + j, f, dt / length)
                if track_fit and abs(f - fit_prev) < tol:
                    done = True
            fit_prev = f
        it += length
        fit = fits[-1]
    return CPState(factors=factors, weights=weights, fit=fit, it=it)
