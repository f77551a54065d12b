"""Traffic of a study pipeline: a closed loop of clients keeping a CP service fed.

``clients`` clients each keep one request outstanding in the port's
``CPService(batch_size=batch, n_iters=sweeps, tol=0.0, strategy=...)``:
each submits one tensor of the pool ``ctx.data`` (one item a subject)
with its own initial factors and submits again as soon as its result is
back on the host.  Request ``k`` decomposes item ``k % items`` from the
``k % init_pool``-th set of initial factors, drawn on the device at
set-up.  A unit of work is one ``step()`` of the service: one batched
dispatch.  A request's latency is the host clock from its ``submit`` to
the end of the ``step`` that returned its result.

Workload keys: ``strategy``, ``sweeps``, ``batch``, ``clients``,
``init_pool``.
"""

from __future__ import annotations

import math
import statistics

from cpbench.check import Answer


class Driver:
    """Closed loop of ``clients`` clients over a pool of same-shaped tensors."""

    batched = True

    def __init__(self, ctx):
        from repro_torch.serve import CPService

        torch = ctx.torch
        self.ctx = ctx
        self.pool = ctx.data
        self.rank = int(ctx.config["rank"])
        self.sweeps = int(ctx.cell["sweeps"])
        self.batch = int(ctx.cell["batch"])
        self.clients = int(ctx.cell["clients"])
        n_init = int(ctx.cell["init_pool"])
        self.inits = [
            torch.randn((n_init, d, self.rank), generator=ctx.init_gen, device=ctx.device)
            for d in self.pool.shape[1:]
        ]
        self.service = CPService(
            batch_size=self.batch, n_iters=self.sweeps, tol=0.0,
            strategy=ctx.cell["strategy"], device=ctx.device,
        )
        self.submitted: list[float] = []  # request k's submit time
        self.done_at: dict[int, float] = {}  # request k's completion time
        self.results: dict[int, Answer] = {}
        self.rid: dict[int, int] = {}  # the service's rid -> request k
        self.units: list[tuple[float, float]] = []
        self.execute_s: list[float] = []  # the service's execute_s after each unit
        self.execute_s0 = 0.0  # ... and at the window's start

    def _inputs(self, k: int):
        i = k % self.inits[0].shape[0]
        return self.pool[k % self.pool.shape[0]], [u[i] for u in self.inits]

    def _submit(self) -> None:
        k = len(self.submitted)
        x, init = self._inputs(k)
        self.submitted.append(self.ctx.clock())
        fut = self.service.submit(x, self.rank, init_factors=init)
        self.rid[fut.rid] = k

    def _collect(self, futures, t_done: float) -> int:
        for fut in futures:
            k = self.rid.pop(fut.rid)
            res = fut.result()
            self.results[k] = Answer(factors=res.factors, weights=res.weights, fit=res.fit)
            self.done_at[k] = t_done
        return len(futures)

    def warm(self) -> None:
        """One full dispatch: plans the signature, loads the kernels and warms
        every shape of a batch (its requests are not counted)."""
        for _ in range(self.batch):
            self._submit()
        self._collect(self.service.flush(), self.ctx.clock())
        self.submitted.clear()
        self.done_at.clear()
        self.results.clear()

    def start(self) -> None:
        """Every client submits its first request."""
        self.execute_s0 = self.service.stats()["execute_s"]
        for _ in range(self.clients):
            self._submit()

    def unit(self) -> None:
        """One dispatch; each client whose result came back submits again."""
        from torch.profiler import record_function

        t0 = self.ctx.clock()
        with record_function("cpbench.step"):
            futures = self.service.step()
        t1 = self.ctx.clock()
        self.units.append((t0, t1))
        self.execute_s.append(self.service.stats()["execute_s"])
        with record_function("cpbench.submit"):
            for _ in range(self._collect(futures, t1)):
                self._submit()

    def finish(self) -> None:
        """Serve what is still outstanding (after the window, untimed)."""
        self._collect(self.service.flush(), self.ctx.clock())

    def end_to_end(self, units: range, window_s: float) -> dict:
        """``problems_per_s`` and ``request_p95_ms`` of the requests that
        completed in the window's ``units``."""
        lo, hi = self.units[units[0]][0], self.units[units[-1]][1]
        lat = [self.done_at[k] - self.submitted[k]
               for k in self.done_at if lo <= self.done_at[k] <= hi]
        return {
            "problems_per_s": len(lat) / window_s,
            "request_p95_ms": statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3,
        }

    def layer(self, units: range) -> dict:
        """Counts of a traced slice of ``units``: batch sweeps, host seconds
        in ``step()`` and the service's ``execute_s`` over them."""
        first = units[0]
        before = self.execute_s[first - 1] if first > 0 else self.execute_s0
        return {
            "sweeps": len(units) * self.sweeps,
            "batch": self.batch,
            "step_host_s": sum(self.units[u][1] - self.units[u][0] for u in units),
            "execute_s": self.execute_s[units[-1]] - before,
        }

    @property
    def attempted(self) -> int:
        return len(self.submitted)

    @property
    def failed(self) -> int:
        """Requests with no result, or a fit that is not a number."""
        bad = sum(not math.isfinite(a.fit) for a in self.results.values())
        return self.attempted - len(self.results) + bad

    def answered(self) -> list[int]:
        """The requests that have an answer, in submission order."""
        return sorted(self.results)

    def answer(self, k: int):
        """Request ``k``'s answer with the tensor and initial factors it was
        made from."""
        x, init = self._inputs(k)
        return self.results[k], x, init

    def release(self) -> None:
        """Drop the service and its per-signature state."""
        self.service = None
