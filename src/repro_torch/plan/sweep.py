"""THE ALS sweep: the one copy of the update algebra, plan- and executor-driven.

Port of ``repro.plan.sweep``.  Per mode-n update (paper Sec. 2.2):

    M   = MTTKRP(X, {U_k}, n)               (executor + plan decide how)
    H   = *_{k != n} (U_k^T U_k)            (Hadamard of Gram matrices)
    U_n = M @ pinv(H);  column-normalize -> lambda

with the fit tracked through the factored identity reusing the last MTTKRP.
The engine walks the plan's contraction schedule node by node.  The
reference's ``lax.scan`` over donated buffers becomes a Python loop that
syncs with the host once per chunk of ``sweeps_per_sync`` sweeps.

Plans with ``plan.pp`` run pairwise-perturbation sweeps (Ma & Solomonik,
arXiv 2010.12056): while every factor's drift since the last cache build
stays under ``problem.pp_tol``, a sweep approximates each MTTKRP from
cached pairwise intermediates plus first-order corrections and never
touches the tensor.  The reference decides exact against approximate with
a traced ``lax.cond``; PyTorch runs eagerly, so the port reads one drift
maximum to the host a sweep (:func:`_host_gate`) and branches in Python.

On a sharded problem (:class:`~repro_torch.plan.executor.ShardedExecutor`,
one process a rank) the engine holds this rank's blocks: the tensor block
and, per factor, its row block (or the whole factor when its mode is
unmapped).  The reference lets JAX insert the reductions its global-array
algebra needs; here the four sums over every row or every entry -- the
Grams, the column norms, the fit's inner product over the last mode and
the tensor norm -- go through the executor's ``allsum`` hook, the identity
on one device and the ordered reduction on a mesh.  The update algebra
stays in one copy, ``pinv`` of the Hadamard of Grams runs on every rank on
the same bits, and a world of one runs the local engine's operations.
Executors with the carry extension (``contract_carry``, ``init_carry``:
the compressed executor's per-node residuals) have their state threaded
through ``SweepState.carry`` across every node contraction.

Sharded PP holds this rank's block of each pair, ``(C, I_n / p_n, I_m /
p_m)``, and completes every sum the reference's global arrays complete
silently: a correction or base term sums over the rows of its partner
mode ``m`` (``allsum`` over mode ``m``), and the drift's squared
numerators and denominators sum over mode ``n`` before the square root,
the batch's maximum taken over every rank of the batch axes
(``gather_fits``).  Every rank then reads the same gate on the host and
takes the same branch: a rank that branched otherwise would deadlock at
the next collective.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
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

from .executor import Executor, LocalExecutor, ShardedExecutor
from .planner import SweepPlan, plan_sweep
from .problem import Problem
from .schedule import ROOT, pp_pairs as pp_pair_meta

Tensor = torch.Tensor


def _host_fits(fits: Sequence[Tensor]) -> list:
    """THE host-synchronization point of the cp_als driver: one call per
    chunk of sweeps.  Module-level so tests can count syncs."""
    return torch.stack(list(fits)).tolist()


def _host_gate(drift: Tensor) -> float:
    """THE host read of the pairwise-perturbation gate: ``max(drift)`` of a
    per-factor drift vector, as a Python float.  Exactly one call a sweep
    under a PP plan (none otherwise).  Module-level so tests can count it."""
    return float(drift.max())


@dataclass
class SweepState:
    """State carried across sweeps.  ``grams`` carries the per-factor Gram
    matrices ``U_k^T U_k``: each mode's update refreshes its own, so the
    next sweep starts from exact values; ``None`` recomputes them all.

    ``carry`` is executor-private state threaded through the sweep (the
    per-node error-feedback residuals of
    :class:`~repro_torch.plan.executor.CompressedShardedExecutor`);
    ``None`` for executors without it.

    ``pp`` is the pairwise-perturbation cache (:class:`PPState`) when the
    plan enabled PP sweeps, ``None`` otherwise -- and ``None`` runs the
    classic exact sweep, so ``pp_tol=0`` plans are bitwise exact ALS.
    """

    x: Tensor
    factors: list[Tensor]
    weights: Tensor
    norm_x: Tensor
    it: int
    fit: Tensor | float = 0.0
    carry: Any = None
    grams: list[Tensor] | None = None
    pp: Any = None


@dataclass
class PPState:
    """Pairwise-perturbation cache (Ma & Solomonik, arXiv 2010.12056).

    Built after an exact sweep and carried across the approximate ones:
    ``ref`` are the factor iterates the cache was built from, ``pairs``
    maps ``(n, m)`` (``n < m``) to the rank-major pairwise intermediate
    ``M_{n,m}[c, i_n, i_m] = sum X * prod_{k not in {n,m}} V_k[i_k, c]``,
    and ``base`` is each mode's exact MTTKRP at the reference point.
    ``drift`` is the ``(ndim,)`` float32 per-factor relative drift
    ``||U_n - V_n||_F / ||V_n||_F`` since the build (max over the batch
    for batched problems; +inf while the cache is stale, so the run opens
    with an exact sweep), and ``n_exact`` counts exact sweeps.
    ``drift_max`` is the host copy of ``max(drift)`` that the gate reads
    (:func:`_host_gate`), ``None`` until read.
    """

    ref: list[Tensor]
    pairs: dict[tuple[int, int], Tensor]
    base: list[Tensor]
    drift: Tensor
    n_exact: int
    drift_max: float | None = None


def _pp_drift(factors: Sequence[Tensor], ref: Sequence[Tensor], executor=None) -> Tensor:
    """Per-factor relative drift ``||U_n - V_n||_F / ||V_n||_F`` as an
    ``(ndim,)`` float32 vector (max over the batch when batched) -- the
    quantity the PP gate compares against ``Problem.pp_tol``.  With a
    sharded ``executor`` the squared sums of factor ``n`` are summed over
    the ranks holding its other rows before the square root, and the batch
    maximum spans the whole batch, so every rank holds the same bits."""
    allsum = executor.allsum if executor is not None else _no_sum
    ds = []
    for n, (u, v) in enumerate(zip(factors, ref)):
        du = (u - v).float()
        num = torch.sqrt(allsum(torch.sum(du * du, dim=(-2, -1)), (n,)))
        den = torch.sqrt(allsum(torch.sum(v.float() ** 2, dim=(-2, -1)), (n,)))
        ratio = num / torch.clamp(den, min=1e-30)
        if executor is not None and ratio.ndim:
            ratio = executor.gather_fits([ratio])[0]
        ds.append(torch.max(ratio))
    return torch.stack(ds)


def _pp_contract_second(pair: Tensor, v: Tensor) -> Tensor:
    """``M_{n,m} . v_m -> (I_n, C)``: contract the rank-major pair
    ``(..., C, I_n, I_m)`` with a factor ``(..., I_m, C)`` over the m index,
    one stride-1 batched GEMV over the rank axis."""
    vt = v.transpose(-1, -2)  # (..., C, I_m)
    out = torch.matmul(pair, vt[..., :, :, None])[..., 0]  # (..., C, I_n)
    return out.transpose(-1, -2)


def _pp_contract_first(pair: Tensor, v: Tensor) -> Tensor:
    """``M_{m,n} . v_m -> (I_n, C)`` when the partner is the pair's first
    index (``m < n``): the same batched GEMV, contracting the
    ``(..., C, I_m, I_n)`` pair with ``(..., I_m, C)`` over ``I_m``."""
    vt = v.transpose(-1, -2)  # (..., C, I_m)
    out = torch.matmul(vt[..., :, None, :], pair)[..., 0, :]  # (..., C, I_n)
    return out.transpose(-1, -2)


def _pp_correction(pairs, v: Tensor, n: int, m: int, allsum=None) -> Tensor:
    """``M_{n,m} . v_m -> (I_n, C)`` whichever of the pair's indices the
    partner ``m`` is, summed over the ranks holding other rows of mode
    ``m`` (``allsum``; the identity on one device)."""
    if n < m:
        out = _pp_contract_second(pairs[(n, m)], v)
    else:
        out = _pp_contract_first(pairs[(m, n)], v)
    return out if allsum is None else allsum(out, (m,))


def _pp_base(pairs: dict[tuple[int, int], Tensor], ref: Sequence[Tensor], n: int,
             allsum=None) -> Tensor:
    """Mode-``n`` exact MTTKRP at the reference point, recovered from one
    pairwise intermediate: ``M_{n,m}`` contracted with the reference factor
    ``V_m`` of the smallest partner ``m`` (summed over mode ``m``'s ranks
    through ``allsum`` on a sharded problem)."""
    m = 1 if n == 0 else 0
    return _pp_correction(pairs, ref[m], n, m, allsum)


def _pp_materialize(problem: Problem, executor, x, factors, n_exact: int) -> PPState:
    """Build the PP cache at the current iterates: pairwise intermediates by
    ``executor.pp_pairs`` (this rank's blocks on a sharded problem),
    per-mode bases, zero drift."""
    pairs = executor.pp_pairs(problem, x, factors)
    base = [_pp_base(pairs, factors, n, executor.allsum) for n in range(problem.ndim)]
    return PPState(
        ref=list(factors),
        pairs=pairs,
        base=base,
        drift=torch.zeros((problem.ndim,), dtype=torch.float32, device=x.device),
        n_exact=int(n_exact),
        drift_max=0.0,
    )


def _pp_init(problem: Problem, x, factors) -> PPState:
    """Zero-filled PP cache with +inf drift, shaped like a built one (this
    rank's pair blocks on a sharded problem), so the first sweep is exact
    and ``n_exact`` counts from 0."""
    lead = (problem.local_batch,) if problem.batched else ()
    pairs = {
        (p.n, p.m): torch.zeros(lead + p.local_shape, dtype=x.dtype, device=x.device)
        for p in pp_pair_meta(problem)
    }
    return PPState(
        ref=[torch.zeros_like(u) for u in factors],
        pairs=pairs,
        base=[torch.zeros_like(u) for u in factors],
        drift=torch.full((problem.ndim,), math.inf, dtype=torch.float32, device=x.device),
        n_exact=0,
        drift_max=math.inf,
    )


def _no_sum(t: Tensor, modes: Sequence[int]) -> Tensor:
    """The ``allsum`` of one device: every row is here."""
    return t


def _grams(factors: Sequence[Tensor], allsum) -> list[Tensor]:
    """Every factor's Gram ``U_k^T U_k``, its rows summed over the ranks."""
    return [allsum(g, (k,)) for k, g in enumerate(grams(factors))]


def _fit(gs, weights, m_last, factors, norm_x, allsum) -> Tensor:
    """The fit from the last leaf's MTTKRP (mode N-1), its inner product
    summed over the ranks holding that mode's other rows."""
    last = len(factors) - 1
    return fit_from_last_mttkrp(
        gs, weights, m_last, factors[-1], norm_x, row_sum=lambda t: allsum(t, (last,))
    )


def _pinv(h: Tensor) -> Tensor:
    """``pinv`` with the reference's cutoff: ``jnp.linalg.pinv`` drops
    singular values below ``10 * max(m, n) * eps`` of the largest, where
    ``torch.linalg.pinv`` defaults to ``max(m, n) * eps``."""
    rtol = 10.0 * max(h.shape[-2:]) * torch.finfo(h.dtype).eps
    return torch.linalg.pinv(h, rtol=rtol)


def _update_factor(
    plan: SweepPlan, factors: list[Tensor], gs: list[Tensor], weights: Tensor,
    n: int, m_n: Tensor, it: int, allsum=_no_sum,
) -> Tensor:
    """THE per-mode factor update: solve ``U H = M`` via pinv on the C x C
    Gram-Hadamard, optionally column-normalize into the lambdas, and
    refresh exactly the changed factor's Gram.  The column norms and the
    Gram sum over the rows of mode ``n`` held by other ranks through
    ``allsum``.  Mutates ``factors``/``gs`` in place; returns the (possibly
    updated) weights."""
    h = hadamard_except(gs, n)
    u = m_n @ _pinv(h)
    if plan.normalize:
        u, weights = normalize_columns(u, it, row_sum=lambda t: allsum(t, (n,)))
    factors[n] = u
    gs[n] = allsum(u.transpose(-1, -2) @ u, (n,))
    return weights


def _exact_sweep(
    problem: Problem, plan: SweepPlan, executor: Executor, state: SweepState
) -> SweepState:
    """The exact schedule-walking sweep (see :func:`als_sweep`); passes
    ``state.pp`` through untouched."""
    x = state.x
    factors = list(state.factors)
    weights = state.weights
    allsum = executor.allsum
    carry = state.carry
    use_carry = hasattr(executor, "contract_carry")
    gs = list(state.grams) if state.grams is not None else _grams(factors, allsum)
    m_last = None
    cache: dict[int, Tensor] = {ROOT: x}
    for node in plan.resolved_schedule.walk():
        src = cache[node.parent]
        if plan.nodes:
            np_ = plan.node_plan(node.id)
            alg, tiles, coll = np_.algorithm, np_.tiles, np_.collective
        else:
            alg, tiles, coll = "auto", None, "flat"
        if use_carry:
            out, carry = executor.contract_carry(
                node, src, factors, alg, carry, tiles=tiles, collective=coll
            )
        else:
            out = executor.contract(node, src, factors, alg, tiles=tiles, collective=coll)
        if node.is_leaf:
            m_last = out
            weights = _update_factor(
                plan, factors, gs, weights, node.mode, out, state.it, allsum
            )
        else:
            cache[node.id] = out
    fit = _fit(gs, weights, m_last, factors, state.norm_x, allsum)
    return replace(_with_payload(state, (factors, weights, fit, gs)), carry=carry)


def _pp_sweep(problem: Problem, plan: SweepPlan, state: SweepState,
              executor: Executor | None = None) -> SweepState:
    """One approximate sweep from the PP cache: per mode ``n`` the MTTKRP is
    the cached base plus one small GEMV per perturbed factor,
    ``M_n ~= base_n + sum_{m != n} M_{n,m} . (U_m - V_m)`` (first order in
    the drifts; the neglected terms are products of two or more deltas).
    The factor update is the shared exact algebra; the tensor is never
    touched.  On a sharded problem (``executor`` a sharded one) each
    correction sums over its partner mode's ranks and the Grams, column
    norms, fit and drift over theirs, through ``executor.allsum``; with no
    executor, one device.  Returns the state with refreshed device drifts
    (not read to the host: ``drift_max`` is ``None``); the cache rides
    along."""
    allsum = executor.allsum if executor is not None else _no_sum
    pp = state.pp
    factors = list(state.factors)
    weights = state.weights
    gs = list(state.grams) if state.grams is not None else _grams(factors, allsum)
    m_last = None
    for n in range(problem.ndim):
        m_n = pp.base[n]
        for m in range(problem.ndim):
            if m != n:
                m_n = m_n + _pp_correction(pp.pairs, factors[m] - pp.ref[m], n, m, allsum)
        m_last = m_n
        weights = _update_factor(plan, factors, gs, weights, n, m_n, state.it, allsum)
    fit = _fit(gs, weights, m_last, factors, state.norm_x, allsum)
    new_pp = replace(pp, drift=_pp_drift(factors, pp.ref, executor), drift_max=None)
    return replace(_with_payload(state, (factors, weights, fit, gs)), pp=new_pp)


def _with_payload(state: SweepState, payload) -> SweepState:
    """Rebuild a :class:`SweepState` from the sweep-mutable payload
    ``(factors, weights, fit, grams)``, keeping the tensor, ``norm_x``,
    ``it``, the carry and the PP cache from ``state``."""
    factors, weights, fit, gs = payload
    return SweepState(
        x=state.x, factors=list(factors), weights=weights, norm_x=state.norm_x,
        it=state.it, fit=fit, carry=state.carry, grams=gs, pp=state.pp,
    )


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

    With a PP cache on ``state.pp`` the sweep is gated: while every
    factor's drift since the cache was built stays below
    ``problem.pp_tol`` (compared in float32, as the reference's traced
    gate does), the approximate :func:`_pp_sweep` runs; otherwise the exact
    walk runs, and the cache is rebuilt at the fresh iterates only when the
    exact sweep's own step settled under the tolerance (during the early
    large-step sweeps a build would be stale at once).  After the sweep the
    drift is the drift since the kept reference on an approximate sweep,
    zero right after a rebuild and +inf while the cache is stale;
    ``n_exact`` grows by one on every exact sweep.  Deciding on the host
    takes one read a sweep through :func:`_host_gate`: the new drift after
    an approximate sweep, the step after an exact one.  ``state.pp is
    None`` (every ``pp_tol=0`` plan) skips the gate: the classic exact
    sweep, bitwise, with no read.
    """
    if state.pp is None:
        return _exact_sweep(problem, plan, executor, state)
    pp0 = state.pp
    tol = float(torch.tensor(problem.pp_tol, dtype=torch.float32))
    gate = pp0.drift_max if pp0.drift_max is not None else _host_gate(pp0.drift)
    if gate < tol:
        out = _pp_sweep(problem, plan, state, executor)
        return replace(out, pp=replace(out.pp, drift_max=_host_gate(out.pp.drift)))
    out = _exact_sweep(problem, plan, executor, state)
    step = _host_gate(_pp_drift(out.factors, state.factors, executor))
    n_exact = pp0.n_exact + 1
    if step < tol:
        pp = _pp_materialize(problem, executor, state.x, out.factors, n_exact)
    else:
        pp = replace(
            pp0, drift=torch.full_like(pp0.drift, math.inf), n_exact=n_exact,
            drift_max=math.inf,
        )
    return replace(out, pp=pp)


def legacy_sweep(
    x: Tensor,
    factors: Sequence[Tensor],
    weights: Tensor,
    norm_x: Tensor,
    it,
    *,
    strategy: str,
    normalize: bool = True,
    split: int | None = None,
    mode_axes=None,
    mesh=None,
) -> tuple[list[Tensor], Tensor, Tensor]:
    """The one bridge behind the pre-redesign sweep signatures.

    Builds the Problem/plan/executor for an old-style ``(x, factors,
    weights, norm_x, it)`` call -- sharded when ``mesh`` is given -- runs
    the engine once, and returns the historical ``(factors, weights, fit)``
    triple.  The plan is frozen on the exact executors and the
    pre-schedule tree shapes: the flat per-mode sweep, or the binary split
    for ``strategy="dimtree"``.  Sharded, ``x`` and ``factors`` are the
    global ones and the factors returned this rank's blocks.
    """
    problem = Problem.from_tensor(x, factors[0].shape[1], mode_axes=mode_axes, mesh=mesh)
    plan = plan_sweep(
        problem, strategy=strategy, split=split, normalize=normalize,
        executor="sharded" if mesh is not None else "local",
        schedule=None if strategy == "dimtree" else "flat",
    )
    if mesh is not None:
        executor = ShardedExecutor(mesh, mode_axes)
        x, factors = executor.prepare(problem, x, factors)
    else:
        executor = LocalExecutor()
    state = SweepState(
        x=x, factors=list(factors), weights=weights, norm_x=norm_x, it=int(it)
    )
    out = als_sweep(problem, plan, executor, state)
    return out.factors, out.weights, out.fit


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

    On a sharded plan pass the matching executor (build one from
    ``plan.executor`` with :func:`repro_torch.plan.make_executor`; an
    executor with ``init_carry`` -- the compressed one -- has its carry
    made here, after ``prepare``, and threaded across the sweeps); every
    rank calls with the same global ``x`` (and ``init_factors``), draws
    the same global factors, and keeps its blocks (``executor.prepare``),
    so a run on any mesh starts where one device does.  The returned
    factors, weights and fits are this rank's blocks (the weights and an
    unbatched fit are the same on every rank); the stopping decision reads
    the whole batch's fits on every rank.

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

    Plans with ``plan.pp`` (built from a ``Problem(pp_tol > 0)``) run the
    pairwise-perturbation loop: the PP cache rides along with the factors
    (zeros and +inf drift at first, so the first sweep is exact), and
    ``CPState.pp_exact_sweeps`` reports how many sweeps were exact --
    ``pp_exact_sweeps / it`` is the measured exact-sweep fraction to hold
    against the planner's ``PP_EXACT_FRACTION``.  The gate is decided on
    the host: each sweep of a PP plan reads one drift maximum through
    :func:`_host_gate` (a device sync a sweep, on top of the chunk's), so
    the host knows before each sweep whether it streams the tensor.  A
    batched PP run takes one branch for the whole batch (the drift is the
    max over the batch).  ``pp_tol=0`` plans never build the cache, never
    read a drift, and are bitwise identical to classic exact ALS
    (``pp_exact_sweeps`` is ``None``).

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
    carry = executor.init_carry(plan, x, factors) if hasattr(executor, "init_carry") else None
    allsum = executor.allsum
    local_lead = (problem.local_batch,) if problem.batched else ()
    weights = torch.ones(local_lead + (problem.rank,), dtype=x.dtype, device=x.device)
    # the norm of this rank's block, squared and summed over every mapped axis
    block_norm = tensor_norm(x, batched=problem.batched)
    norm_x = torch.sqrt(allsum(block_norm * block_norm, range(problem.ndim))).to(x.dtype)
    gs = _grams(factors, allsum)
    pp = _pp_init(problem, x, factors) if plan.pp else None

    fit_prev = [-math.inf] * problem.batch if problem.batched else -math.inf
    fit = torch.zeros(local_lead, dtype=x.dtype, device=x.device)
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
                           it=it + j, carry=carry, grams=gs, pp=pp),
            )
            factors, weights, gs, pp = state.factors, state.weights, state.grams, state.pp
            carry = state.carry
            fits.append(state.fit)
        # the chunk's single host sync, on the whole batch's fits
        host = _host_fits(executor.gather_fits(fits))
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
    return CPState(
        factors=factors, weights=weights, fit=fit, it=it,
        pp_exact_sweeps=pp.n_exact if pp is not None else None,
    )
