"""CPU tests of a whole run at a tiny size, with the harness's look for a card
skipped: sound runs are ``correct``, runs with the timed path broken
underneath are not, the control fails the cell's limits, and the fleet's
closed loop keeps its books.  The limits are the cells' own."""

from __future__ import annotations

import math
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from cpbench import check, faults, run, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
BATCHED = [c for c in CELLS if "batch" in spec.workload(c)]
CPU = torch.device("cpu")


TINY_RANK = 3


def _tiny(name):
    """The cell and its configuration at a size the CPU runs in a second: the
    shape its synthesis gives for the CPU (the same order), the rank cut to
    ``TINY_RANK`` and a cell's own rank by the same ratio; everything else
    (strategy, sweeps, sample, limits) as committed."""
    cell = dict(spec.workload(name))
    config = dict(spec.config(cell["config"]))
    if "rank" in cell:
        cell["rank"] = max(1, round(int(cell["rank"]) * TINY_RANK / int(config["rank"])))
    config.update(shape=list(spec.synth(config).TINY_SHAPE), planted_rank=TINY_RANK,
                  rank=TINY_RANK)
    cell["init_pool"] = 16
    if "batch" in cell:
        cell.update(batch=4, clients=8)
    return cell, config


def _run(name, seed=2**31 + 11, trace=False):
    cell, config = _tiny(name)
    return run.execute(name, cell, config, seed, 0.2, trace, CPU, BENCH)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(spec.workload(name)["limits"])
    want = {m["name"] for m in spec.metrics_of(BENCH, name, "end_to_end")}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_is_correct_and_reads_no_device_metric_off_the_card(name):
    r = _run(name, trace=True)
    assert r["correct"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["busy_s"] == 0.0  # no device operation on the CPU
    layer = {m["name"] for m in spec.metrics_of(BENCH, name, "per_layer")}
    assert set(r["metrics"]) <= layer
    assert not [k for k in r["metrics"] if k.startswith(("device_", "ops_"))]


CASES = [(f, c) for f in faults.FAULTS for c in CELLS
         if f not in faults.BATCHED_ONLY or c in BATCHED]


@pytest.mark.parametrize("fault,name", CASES)
def test_broken_timed_path_is_not_correct(fault, name):
    """On every seed tried, so on whichever answers a seed samples."""
    for seed in (2**31 + 11, 5, 9_000_000_017):
        with faults.planted(fault):
            r = _run(name, seed)
        assert not r["correct"], (seed, r["checks"])
        assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", BATCHED)
def test_one_answer_in_the_wrong_slot_fails_the_cell(name):
    """Whichever sampled answer is another request's, ``correct`` is false."""
    cell = spec.workload(name)
    sound = {"factor_gap": 1e-5, "model_gap": 1e-6, "fit_gap": 1e-7}
    wrong = {"factor_gap": 1.0, "model_gap": 0.5, "fit_gap": 0.05}
    n = int(cell["check_sample"])
    assert check.verdict([sound] * n, cell["limits"])[0]
    for bad in range(n):
        readings = [wrong if i == bad else sound for i in range(n)]
        assert not check.verdict(readings, cell["limits"])[0]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell, config = _tiny(name)
    precision = check.control_precision(config)
    seeds = (1, 2, 3)
    for seed in seeds:
        r = run.execute(name, cell, config, seed, 0.2, False, CPU, BENCH, stand_ins=(precision,))
        assert r["correct"]
        limits = cell["limits"]
        assert any(r["stand_ins"][precision][n] > limits[n] for n in limits), r


def test_a_cells_rank_reaches_the_factors_the_problem_and_the_roofline(monkeypatch):
    """A workload's ``rank`` is the rank of the initial factors, of the
    port's ``Problem`` and of the least sweep time; without the key, the
    configuration's holds."""
    import repro_torch.plan

    from cpbench import roofline

    seen = {"problem": [], "roofline": [], "inits": []}
    real_plan, real_least = repro_torch.plan.plan_sweep, roofline.least_sweep_s
    real_driver = spec.driver("decompose")

    def plan_sweep(problem, **kwargs):
        seen["problem"].append(problem.rank)
        return real_plan(problem, **kwargs)

    def least_sweep_s(shape, rank, *args):
        seen["roofline"].append(rank)
        return real_least(shape, rank, *args)

    class Driver(real_driver):
        def __init__(self, ctx):
            super().__init__(ctx)
            seen["inits"] += [u.shape[-1] for u in self.inits]

    monkeypatch.setattr(repro_torch.plan, "plan_sweep", plan_sweep)
    monkeypatch.setattr(roofline, "least_sweep_s", least_sweep_s)
    monkeypatch.setattr(spec, "driver", lambda name: Driver)
    cell, config = _tiny("fmri4d.matrix_free")
    for own, want in ((None, TINY_RANK), (5, 5)):
        if own is not None:
            cell["rank"] = own
        for key in seen:
            seen[key].clear()
        r = run.execute("fmri4d.matrix_free", cell, config, 3, 0.05, True, CPU, BENCH)
        assert r["correct"], r["checks"]
        assert set(seen["problem"]) == set(seen["roofline"]) == set(seen["inits"]) == {want}


class _StubService:
    """Resolves each dispatch at once: a request's answer is its own initial
    factors, its fit the item's index, and each dispatch adds 1 s of
    ``execute_s``."""

    def __init__(self, *, batch_size, n_iters, tol, strategy, device):
        self.batch_size, self.queue, self.execute_s, self.next_rid = batch_size, [], 0.0, 0
        self.seen = []

    def submit(self, tensor, rank, *, init_factors):
        fut = SimpleNamespace(rid=self.next_rid, tensor=tensor, init=init_factors, rank=rank)
        self.next_rid += 1
        self.queue.append(fut)
        self.seen.append(fut)
        return fut

    def step(self):
        chunk, self.queue = self.queue[: self.batch_size], self.queue[self.batch_size:]
        self.execute_s += 1.0
        for f in chunk:
            f.result = lambda f=f: SimpleNamespace(factors=f.init, weights=f.init[0][0],
                                                   fit=float(f.tensor[0, 0, 0]))
        return chunk

    def flush(self):
        out = []
        while self.queue:
            out += self.step()
        return out

    def stats(self):
        return {"execute_s": self.execute_s}


def _closed_loop(monkeypatch, **cell):
    import repro_torch.serve

    monkeypatch.setattr(repro_torch.serve, "CPService", _StubService)
    ticks = iter(range(10**6))
    pool = torch.arange(5, dtype=torch.float32)[:, None, None, None].expand(5, 2, 3, 3)
    ctx = SimpleNamespace(torch=torch, device=CPU, clock=lambda: float(next(ticks)),
                          config={"rank": 2}, data=pool.contiguous(),
                          init_gen=torch.Generator().manual_seed(0),
                          cell={"sweeps": 20, "batch": 4, "clients": 8, "init_pool": 3,
                                "strategy": "matrix_free", **cell})
    return spec.driver("serve_closed")(ctx)


@pytest.mark.parametrize("own,want", [(None, 2), (5, 5)])
def test_the_services_requests_take_the_cells_rank(monkeypatch, own, want):
    drv = _closed_loop(monkeypatch, **({} if own is None else {"rank": own}))
    drv.warm()
    drv.start()
    drv.unit()
    assert {f.rank for f in drv.service.seen} == {want}
    assert all(u.shape[-1] == want for u in drv.inits)


def test_closed_loop_keeps_every_client_outstanding(monkeypatch):
    drv = _closed_loop(monkeypatch)
    drv.warm()
    assert drv.attempted == 0 and not drv.results
    drv.start()
    for _ in range(6):
        drv.unit()
        assert drv.attempted - len(drv.results) == 8  # every client has one outstanding
    svc = drv.service
    for k, fut in enumerate(svc.seen[4:]):  # after the warm dispatch's 4
        assert float(fut.tensor[0, 0, 0]) == k % 5
        assert fut.init[0].data_ptr() == drv.inits[0][k % 3].data_ptr()
    e2e = drv.end_to_end(range(6), window_s=2.0)
    assert e2e["problems_per_s"] == 24 / 2.0
    lat = [drv.done_at[k] - drv.submitted[k] for k in range(24)]
    assert min(lat) > 0 and e2e["request_p95_ms"] == pytest.approx(
        1e3 * sorted(lat)[math.ceil(0.95 * 24) - 1], rel=0.2)
    layer = drv.layer(range(2, 6))
    assert layer["sweeps"] == 80 and layer["execute_s"] == 4.0 and layer["step_host_s"] == 4.0
    drv.finish()
    assert drv.failed == 0 and drv.answered() == list(range(drv.attempted))
    got, x, init = drv.answer(13)
    assert got.fit == 13 % 5 and float(x[0, 0, 0]) == 13 % 5


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the run would not refuse")


def test_run_without_a_card_fails_and_prints_no_result(no_card):
    out = subprocess.run(
        [sys.executable, "-m", "cpbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1"], capture_output=True, text=True, cwd=spec.ROOT, timeout=300,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr
