"""Decomposition-as-a-service: a CP serving engine over the batched plan stack.

Port of ``repro.serve.cp_service``.  The workload the paper's Sec. 6 fMRI
scenario implies -- a fleet of same-shaped tensors (one subject = one
tensor), not one huge tensor -- is served the way an LM engine serves
prompts: clients :meth:`CPService.submit` a tensor and get a
:class:`CPFuture` back, a scheduler buckets pending requests by
*signature* (:meth:`repro_torch.plan.problem.Problem.signature` of the
batched problem plus the per-request sweep budget), packs each bucket into
fixed-size batches, and executes them through the front door::

    Problem(batch=B) -> plan_sweep -> batched cp_als   (one batched launch per mode)

Under ``strategy="fused"`` or ``"matrix_free"`` every batched dispatch runs
the batched CUDA kernel of :mod:`repro_torch.kernels` (one launch per mode
and sweep for all B problems); with ``batch_size=1`` the unbatched kernels.

Batch shapes stay fixed: a partial batch is padded by *cycling the real
requests into the dummy slots*.  Batch entries never interact inside the
sweep algebra (every contraction and solve is per slice, and the kernels
give each slab its own blocks), so a dummy cannot perturb a real problem --
and because each dummy duplicates a real problem, the shared convergence
stop (batch-max fit delta) behaves as if the padding were absent.

One dispatch state per signature: the plan is made once, on the
signature's first dispatch.  Those misses are the ``compiles`` counter, one
per signature as in the reference (PyTorch runs eagerly, so nothing is
compiled).  The persistent
:class:`repro_torch.plan.autotune.TuningCache` is the warm-plan store under
the same signature: with ``strategy="autotune"`` (the default) a signature
with measurements plans from them (``stats()["warm_plan_hits"]``); other
signatures plan from the analytic model.

A ``pp_tol > 0`` request is a batched pairwise-perturbation problem: its
signature carries ``|pp<tol>``, so it never shares a batch with the exact
request for the same tensor, and the service's ``strategy`` decides
whether its plan enables PP (``"pp"`` forces it).

The service runs on ``device`` (``"cuda"`` unless the caller asks for the
CPU): :meth:`CPService.submit` moves each tensor there.

``mesh`` (a ``torch.distributed`` DeviceMesh, one process a rank) serves
batch-parallel: every dispatch's batch is cut over all the mesh's axes
(``batch_size`` must divide by its device count), each rank runs its
slice of the batch on the sharded executor without a collective, and the
finished batch's factors, weights and fits are gathered over the batch
axes, so every rank's futures hold whole problems.  SPMD: every rank
submits the same requests in the same order, and no dispatch decision
reads a clock (``latency_s`` is reported, never used), so the ranks
dispatch alike.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Sequence

import torch

from repro_torch.core.tensor_ops import random_factors
from repro_torch.dist.collectives import gather_cat
from repro_torch.plan import Problem, cp_als, make_executor, plan_sweep
from repro_torch.plan.autotune import lookup_measurements, problem_key

from .queue import QueueFull, RequestQueue

Tensor = torch.Tensor


@dataclass(frozen=True)
class CPResult:
    """One finished decomposition, as the client reads it back.

    ``factors`` are the per-mode ``(I_k, C)`` factor matrices and
    ``weights`` the ``(C,)`` lambdas of this request's own problem (the
    batch axis is already stripped); ``fit`` is the request's final fit,
    ``sweeps`` the executed sweep count of its dispatch, ``signature`` the
    batch bucket it was served under, and ``latency_s`` the submit-to-result
    wall time (queue wait included).
    """

    rid: int
    factors: list[Tensor]
    weights: Tensor
    fit: float
    sweeps: int
    signature: str
    latency_s: float


class CPFuture:
    """Handle returned by :meth:`CPService.submit`; resolves on dispatch.

    The service is synchronous (results land during ``step``/``flush``), so
    ``done()`` flips exactly when the owning batch executed.
    """

    def __init__(self, rid: int, signature: str):
        """Internal: built by the service with the queue-assigned rid."""
        self.rid = rid
        self.signature = signature
        self._result: CPResult | None = None

    def done(self) -> bool:
        """True once the owning batch has executed."""
        return self._result is not None

    def result(self) -> CPResult:
        """The resolved :class:`CPResult`; raises if the batch has not run
        yet (call :meth:`CPService.step` or :meth:`CPService.flush`)."""
        if self._result is None:
            raise RuntimeError(
                f"request {self.rid} is still pending -- step()/flush() the service"
            )
        return self._result


@dataclass
class _CPRequest:
    """Queue payload: one tensor + its decomposition options."""

    tensor: Tensor
    rank: int
    n_iters: int
    tol: float
    pp_tol: float
    init_factors: list[Tensor] | None
    seed: int
    future: CPFuture


@dataclass
class _SignatureState:
    """Per-signature state: planned once, on the signature's first dispatch
    (``executor`` is ``None`` for ``cp_als``'s local default)."""

    problem: Problem
    plan: Any
    executor: Any = None


class CPService:
    """CP decomposition serving engine: submit tensors, stream results back.

    ``batch_size`` fixes the batch extent ``B`` of every dispatch (partial
    batches are padded).  ``n_iters`` / ``tol`` are the default per-request
    sweep budget and convergence tolerance (``tol=0.0`` runs exactly
    ``n_iters`` sweeps -- the deterministic serving default; a positive
    ``tol`` stops a batch when every problem's fit delta clears it, the
    batched driver's shared stop).  ``sweeps_per_sync`` sets the driver's
    sweeps per host sync (``None`` = the whole request budget, one sync per
    dispatch).  ``strategy`` + ``tuning_cache`` feed
    :func:`repro_torch.plan.plan_sweep` -- the default ``"autotune"`` makes
    the persistent tuning cache a warm-plan store keyed by the same
    signature as the batch buckets.  ``max_pending`` bounds the queue; a
    full queue rejects submission with
    :class:`repro_torch.serve.queue.QueueFull`.  ``device`` is where every
    request runs (default ``"cuda"``).  ``pp_tol > 0`` makes every request
    (unless it overrides it) a pairwise-perturbation problem.  ``mesh``
    shards every dispatch's batch over all its axes (batch-parallel: no
    collective inside a sweep; ``batch_size`` must divide by the mesh's
    device count), every rank serving the same requests in the same order.
    """

    def __init__(
        self,
        *,
        batch_size: int = 8,
        max_pending: int | None = None,
        n_iters: int = 20,
        tol: float = 0.0,
        sweeps_per_sync: int | None = None,
        strategy: str = "autotune",
        tuning_cache=None,
        mesh=None,
        pp_tol: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        """See the class docstring for the knobs; validation happens here."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.mesh = mesh
        if mesh is not None:
            n_dev = math.prod(int(s) for s in mesh.shape)
            if batch_size % n_dev:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the mesh's "
                    f"{n_dev} devices (batch-parallel placement shards the "
                    "batch axis evenly)"
                )
        self.batch_size = int(batch_size)
        self.n_iters = int(n_iters)
        self.tol = float(tol)
        self.sweeps_per_sync = sweeps_per_sync
        self.strategy = strategy
        self.tuning_cache = tuning_cache
        self.pp_tol = float(pp_tol)
        self.device = torch.device(device)
        self._queue = RequestQueue(max_pending)
        self._states: dict[str, _SignatureState] = {}
        self._counters = {
            "submitted": 0,
            "completed": 0,
            "rejected": 0,
            "batches": 0,
            "compiles": 0,
            "warm_plan_hits": 0,
            "padded_slots": 0,
        }
        self._execute_s = 0.0

    # ------------------------------------------------------------ submission
    def _problem_for(self, tensor: Tensor, rank: int, pp_tol: float | None = None) -> Problem:
        """The batched Problem one dispatch of this tensor's bucket solves:
        with a mesh, its batch cut over all the mesh's axes."""
        mesh = self.mesh
        axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else {}
        batch_axes = (
            tuple(mesh.mesh_dim_names) if mesh is not None and self.batch_size > 1 else ()
        )
        return Problem(
            shape=tuple(tensor.shape),
            rank=int(rank),
            dtype=tensor.dtype,
            batch=self.batch_size,
            batch_axes=batch_axes,
            axis_sizes=axis_sizes,
            pp_tol=self.pp_tol if pp_tol is None else float(pp_tol),
        )

    def signature_of(self, tensor: Tensor, rank: int, *, n_iters: int | None = None,
                     tol: float | None = None, pp_tol: float | None = None) -> str:
        """Batch-bucket signature of one request: the canonical
        :meth:`repro_torch.plan.problem.Problem.signature` of the *batched*
        problem (shape, rank, dtype, device count, batch, PP tolerance --
        via :func:`repro_torch.plan.autotune.problem_key`, so it shares the
        tuning cache's key space) extended with the update options (sweep
        budget, tolerance) of the dispatch.  A ``pp_tol > 0`` request
        buckets apart from the exact one for the same tensor."""
        n_iters = self.n_iters if n_iters is None else int(n_iters)
        tol = self.tol if tol is None else float(tol)
        base = problem_key(self._problem_for(tensor, rank, pp_tol))
        return f"{base}|i{n_iters}|t{tol:g}"

    def submit(
        self,
        tensor,
        rank: int,
        *,
        n_iters: int | None = None,
        tol: float | None = None,
        pp_tol: float | None = None,
        init_factors: Sequence | None = None,
        seed: int = 0,
        priority: int = 0,
    ) -> CPFuture:
        """Enqueue one tensor (a tensor or an array) for rank-``rank`` CP
        decomposition; it is moved to the service's device (contiguous).

        Returns a :class:`CPFuture` that resolves when the request's batch
        executes (during :meth:`step`/:meth:`flush`).  ``n_iters``/``tol``
        and ``pp_tol`` override the service defaults (they are part of the
        signature: requests only share a dispatch when their update options
        match, so a PP request never shares one with an exact request).
        ``init_factors`` pins the initial factors (per-mode ``(I_k, C)``,
        unbatched -- the service stacks them into the batch), otherwise they
        are drawn from a ``torch.Generator`` on the device seeded with
        ``seed``.  Higher
        ``priority`` serves first, FIFO within a priority.  Raises
        :class:`repro_torch.serve.queue.QueueFull` when ``max_pending``
        requests are already waiting.
        """
        tensor = torch.as_tensor(tensor).to(self.device).contiguous()  # the kernels' layout
        rank = int(rank)
        if tensor.ndim < 2:
            raise ValueError(f"expected an order >= 2 tensor, got shape {tuple(tensor.shape)}")
        if init_factors is not None:
            init_factors = [torch.as_tensor(u).to(self.device) for u in init_factors]
            want = [(d, rank) for d in tensor.shape]
            got = [tuple(u.shape) for u in init_factors]
            if got != want:
                raise ValueError(f"init_factors shapes {got} != expected {want}")
        sig = self.signature_of(tensor, rank, n_iters=n_iters, tol=tol, pp_tol=pp_tol)
        payload = _CPRequest(
            tensor=tensor,
            rank=rank,
            n_iters=self.n_iters if n_iters is None else int(n_iters),
            tol=self.tol if tol is None else float(tol),
            pp_tol=self.pp_tol if pp_tol is None else float(pp_tol),
            init_factors=init_factors,
            seed=int(seed),
            future=CPFuture(-1, sig),
        )
        try:
            req = self._queue.submit(payload, key=sig, priority=priority)
        except QueueFull:
            self._counters["rejected"] += 1
            raise
        payload.future.rid = req.rid
        self._counters["submitted"] += 1
        return payload.future

    # ------------------------------------------------------------- execution
    def _state_for(self, sig: str, payload: _CPRequest) -> _SignatureState:
        """Memoized per-signature plan and executor (the warm-plan lookup);
        a miss is a ``compiles`` count."""
        state = self._states.get(sig)
        if state is not None:
            return state
        problem = self._problem_for(payload.tensor, payload.rank, payload.pp_tol)
        warm = (
            self.strategy == "autotune"
            and lookup_measurements(problem, cache=self.tuning_cache) is not None
        )
        plan = plan_sweep(problem, strategy=self.strategy, tuning_cache=self.tuning_cache)
        executor = None
        if plan.executor != "local":
            executor = make_executor(
                plan.executor, self.mesh, plan.problem.mode_axes,
                batch_axes=plan.problem.batch_axes,
            )
        state = _SignatureState(problem=plan.problem, plan=plan, executor=executor)
        self._counters["compiles"] += 1
        if warm:
            self._counters["warm_plan_hits"] += 1
        self._states[sig] = state
        return state

    def _init_for(self, payload: _CPRequest) -> list[Tensor]:
        """One request's initial factors (pinned or drawn from its seed)."""
        if payload.init_factors is not None:
            return payload.init_factors
        gen = torch.Generator(device=self.device).manual_seed(payload.seed)
        return random_factors(
            gen, payload.tensor.shape, payload.rank, payload.tensor.dtype, device=self.device
        )

    def step(self) -> list[CPFuture]:
        """Execute ONE batched dispatch over the most urgent bucket.

        Takes up to ``batch_size`` same-signature requests (priority order,
        FIFO within), pads the batch by cycling the real requests into the
        empty slots, runs the bucket's batched ``cp_als``, and resolves
        exactly the real requests' futures -- returned in slot order.
        With a mesh each rank runs its slice of the batch and the results
        are gathered over the batch axes before they resolve.  Returns
        ``[]`` when nothing is pending.
        """
        sig = self._queue.next_key()
        if sig is None:
            return []
        chunk = self._queue.take(self.batch_size, sig)
        payloads = [r.payload for r in chunk]
        state = self._state_for(sig, payloads[0])
        B = self.batch_size
        n_iters, tol = payloads[0].n_iters, payloads[0].tol
        # pad by cycling the real requests: slot i >= len(chunk) duplicates a
        # real problem, so the shared convergence stop is unchanged and no
        # dummy can perturb anything (problems are independent per slice)
        slots = [payloads[i % len(payloads)] for i in range(B)]
        inits = [self._init_for(p) for p in slots]
        if B > 1:
            x = torch.stack([p.tensor for p in slots])
            init = [
                torch.stack([inits[b][m] for b in range(B)])
                for m in range(len(state.problem.shape))
            ]
        else:
            x = slots[0].tensor
            init = inits[0]
        t0 = time.monotonic()
        st = cp_als(
            x,
            state.plan,
            executor=state.executor,
            n_iters=n_iters,
            tol=tol,
            init_factors=init,
            sweeps_per_sync=self.sweeps_per_sync or n_iters,
        )
        factors, weights, fit = list(st.factors), st.weights, st.fit
        batch_axes = state.problem.batch_axes
        if batch_axes:  # this rank's slice of the batch -> the whole batch
            factors = [gather_cat(u, batch_axes, self.mesh) for u in factors]
            weights = gather_cat(weights, batch_axes, self.mesh)
            fit = gather_cat(fit, batch_axes, self.mesh)
        fits = fit.reshape(-1).tolist()  # the dispatch's host sync
        now = time.monotonic()
        self._execute_s += now - t0
        self._counters["batches"] += 1
        self._counters["padded_slots"] += B - len(chunk)
        self._counters["completed"] += len(chunk)
        futures = []
        for i, req in enumerate(chunk):
            if B > 1:
                req_factors = [u[i] for u in factors]
                req_weights = weights[i]
            else:
                req_factors, req_weights = factors, weights
            req.payload.future._result = CPResult(
                rid=req.rid,
                factors=req_factors,
                weights=req_weights,
                fit=fits[i],
                sweeps=int(st.it),
                signature=sig,
                latency_s=now - req.submitted_at,
            )
            futures.append(req.payload.future)
        return futures

    def flush(self) -> list[CPFuture]:
        """Drain the queue: :meth:`step` until empty; resolved futures in
        completion order (results stream back batch by batch)."""
        out: list[CPFuture] = []
        while True:
            done = self.step()
            if not done:
                return out
            out.extend(done)

    # -------------------------------------------------------------- counters
    def stats(self) -> dict:
        """Serving counters for monitoring.

        ``queue_depth`` (pending now), ``submitted`` / ``completed`` /
        ``rejected`` (QueueFull backpressure events), ``batches`` and
        ``padded_slots``, ``batch_occupancy`` (mean real-slot fraction over
        executed batches), ``signatures`` (distinct buckets seen),
        ``compiles`` (plans made -- one per signature),
        ``warm_plan_hits`` (signatures planned from tuning-cache
        measurements), ``execute_s`` and ``problems_per_s`` (completed real
        problems over in-dispatch seconds, host clock; each dispatch ends in
        a host sync).
        """
        c = dict(self._counters)
        served_slots = c["completed"] + c["padded_slots"]
        c.update(
            queue_depth=self._queue.depth,
            signatures=len(self._states),
            batch_occupancy=(c["completed"] / served_slots) if served_slots else 1.0,
            execute_s=self._execute_s,
            problems_per_s=(
                c["completed"] / self._execute_s if self._execute_s > 0 else 0.0
            ),
        )
        return c
