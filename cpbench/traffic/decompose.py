"""Traffic of one analyst: whole decompositions of one tensor, back to back.

Each unit of work is one call of the port's front door, as a user makes it:
``Problem.from_tensor`` -> ``plan_sweep(strategy=...)`` -> ``cp_als(x,
plan, n_iters=sweeps, tol=0.0, init_factors=..., callback=...)``, from
its own initial factors, keeping the fit the program reports after each
sweep, and ends when the last fit is on the host.  ``tol=0.0`` runs every
sweep, so each decomposition is the same amount of work.  The initial
factors are drawn on the device at set-up, a pool of ``init_pool`` sets
that decomposition ``k`` takes the ``k % init_pool``-th of.

Workload keys: ``strategy``, ``sweeps``, ``init_pool``.
"""

from __future__ import annotations

import math

from cpbench.check import Answer


class Driver:
    """Closed loop of one client over ``ctx.data``, one tensor."""

    batched = False

    def __init__(self, ctx):
        torch = ctx.torch
        self.ctx = ctx
        self.x = ctx.data
        self.rank = int(ctx.config["rank"])
        self.sweeps = int(ctx.cell["sweeps"])
        self.strategy = ctx.cell["strategy"]
        pool = int(ctx.cell["init_pool"])
        self.inits = [
            torch.randn((pool, d, self.rank), generator=ctx.init_gen, device=ctx.device)
            for d in self.x.shape
        ]
        self.results: list[Answer] = []
        self.units: list[tuple[float, float]] = []

    def _init(self, k: int):
        i = k % self.inits[0].shape[0]
        return [u[i] for u in self.inits]

    def _decompose(self, k: int) -> Answer:
        from torch.profiler import record_function

        from repro_torch.plan import Problem, cp_als, plan_sweep

        with record_function("cpbench.plan"):
            plan = plan_sweep(Problem.from_tensor(self.x, self.rank), strategy=self.strategy)
        fits = []
        with record_function("cpbench.cp_als"):
            st = cp_als(self.x, plan, n_iters=self.sweeps, tol=0.0,
                        init_factors=self._init(k), callback=lambda it, f, s: fits.append(f))
        return Answer(factors=list(st.factors), weights=st.weights, fit=float(st.fit), fits=fits)

    def warm(self) -> None:
        """One whole decomposition: loads the kernels and warms every shape."""
        self._decompose(0)

    def start(self) -> None:
        """Nothing is outstanding between decompositions."""

    def unit(self) -> None:
        """One decomposition, recorded with its host-clock span."""
        t0 = self.ctx.clock()
        self.results.append(self._decompose(len(self.results)))
        self.units.append((t0, self.ctx.clock()))

    def finish(self) -> None:
        """Nothing is left outstanding after the window."""

    def end_to_end(self, units: range, window_s: float) -> dict:
        """``sweep_ms``: the window over the sweeps completed in it."""
        return {"sweep_ms": window_s * 1e3 / (len(units) * self.sweeps)}

    def layer(self, units: range) -> dict:
        """Counts of a traced slice of ``units``."""
        return {"sweeps": len(units) * self.sweeps, "batch": 1}

    @property
    def attempted(self) -> int:
        return len(self.results)

    @property
    def failed(self) -> int:
        """Decompositions whose fit is not a number, or that reported a fit
        for fewer or more sweeps than they were asked to run."""
        return sum(not math.isfinite(a.fit) or len(a.fits) != self.sweeps
                   for a in self.results)

    def answered(self) -> list[int]:
        """Every decomposition has an answer."""
        return list(range(len(self.results)))

    def answer(self, k: int):
        """Answer ``k`` with the tensor and initial factors it was made from."""
        return self.results[k], self.x, self._init(k)

    def release(self) -> None:
        """Drop what the program made but the answers."""
