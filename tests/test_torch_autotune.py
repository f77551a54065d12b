"""The port's measuring side of autotuning (``tune()``) against the JAX
reference, on the CPU.

Times are host-clock seconds of the plain versions here, so the tests check
what a CPU run can show: the entry's layout, the measured node keys (equal
to the reference's for the same problem), the cache round trip, the
planner's stamps, that a tuned plan computes the reference's ALS iterates,
the budget rule and the warm-plan hit of a served batch of one.  Inputs are
made with numpy from a seed; float32 tolerance ``rtol=2e-4, atol=2e-5``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jplan
import repro.plan.autotune as jautotune
import repro_torch.plan as tplan
import repro_torch.plan.autotune as tautotune
from repro.plan.schedule import enumerate_schedules as jenumerate
from repro_torch.core.mttkrp import mttkrp, mttkrp_batched
from repro_torch.kernels import fused_mttkrp as tfused
from repro_torch.kernels import matrix_free as tmf
from repro_torch.kernels import multi_ttv as tmt
from repro_torch.kernels import ops as tops
from repro_torch.serve import CPService

SHAPE, RANK = (8, 6, 4), 3
TOL = dict(rtol=2e-4, atol=2e-5)
ENTRY_KEYS = {
    "backend", "n_devices", "budget_ms", "reps", "elapsed_ms", "tiles", "nodes",
    "serial_fractions", "pp",
}
SUMMARY_KEYS = {"mode", "default_s", "tuned_s", "speedup_vs_default", "rows"}


def _data(shape=SHAPE, rank=RANK, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    fs = [rng.standard_normal((d, rank)).astype(np.float32) for d in shape]
    return x, fs


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    """One disk-backed cache tuned on the reference fixture's problem."""
    path = tmp_path_factory.mktemp("tuning") / "cache.json"
    x, fs = _data()
    cache = tplan.TuningCache(path)
    launches = [k.launches for k in (tfused.KERNEL, tmf.KERNEL, tmt.KERNEL)]
    entry = tplan.tune(
        torch.from_numpy(x), RANK, factors=[torch.from_numpy(u) for u in fs], cache=cache,
        budget_ms=None, reps=1,
    )
    assert [k.launches for k in (tfused.KERNEL, tmf.KERNEL, tmt.KERNEL)] == launches
    return path, cache, entry


def test_tune_entry_has_the_reference_layout(tuned):
    _, _, entry = tuned
    assert set(entry) == ENTRY_KEYS
    assert entry["backend"] == tautotune.backend_name() and entry["n_devices"] == 1
    assert entry["budget_ms"] is None and entry["reps"] == 1 and entry["elapsed_ms"] > 0
    assert entry["serial_fractions"] == {} and entry["pp"] == {}
    assert set(entry["tiles"]) == {"fused_mttkrp", "matrix_free", "multi_ttv"}
    knob = {"fused_mttkrp": "blocks_per_sm", "matrix_free": "blocks_per_sm", "multi_ttv": "block_i"}
    defaults = {"fused_mttkrp": 4, "matrix_free": 4, "multi_ttv": 256}
    for name, summary in entry["tiles"].items():
        assert set(summary) == SUMMARY_KEYS | {knob[name]}
        assert summary["mode"] == len(SHAPE) // 2
        # the plain versions take no knob: one launch, timed once, the default
        assert len(summary["rows"]) == 1 and summary["rows"][0]["is_default"]
        assert summary["rows"][0]["candidate"] == [defaults[name]]
        assert summary["rows"][0]["effective"] == []
        assert summary[knob[name]] == defaults[name] and summary["speedup_vs_default"] == 1.0
    for row in entry["nodes"]:
        assert set(row) == {"key", "executor", "algorithm", "collective", "schedule", "node",
                            "measured_s"}
        assert row["executor"] == "local" and row["measured_s"] > 0


def _reference_node_keys(shape, rank):
    """Every key the reference's tune() measures for this local problem,
    built from its schedules, leaf algorithms and node_key (no timing)."""
    problem = jplan.Problem(shape, rank)
    keys = set()
    for sched in jenumerate(problem):
        for node in sched.walk():
            if node.from_root and node.is_leaf:
                algs = jautotune._leaf_algorithms(problem, node, "local")
            else:
                algs = ("partial-krp" if node.from_root else "partial-ttv",)
            keys |= {jautotune.node_key(node, alg, "local") for alg in algs}
    return keys


def test_tune_measures_the_reference_node_keys(tuned):
    _, _, entry = tuned
    keys = [r["key"] for r in entry["nodes"]]
    assert len(keys) == len(set(keys))  # each contraction timed once
    assert set(keys) == _reference_node_keys(SHAPE, RANK)


def test_lookup_resolves_the_entry_after_a_fresh_disk_read(tuned):
    path, cache, entry = tuned
    problem = tplan.Problem(SHAPE, RANK)
    for c in (cache, tplan.TuningCache(path)):
        m = tplan.lookup_measurements(problem, c)
        assert m is not None
        assert m.node_s == {r["key"]: r["measured_s"] for r in entry["nodes"]}
        assert m.kernel_tiles("fused_mttkrp") == {"blocks_per_sm": 4}
        assert m.kernel_tiles("matrix_free") == {"blocks_per_sm": 4}
        assert m.kernel_tiles("multi_ttv") == {"block_i": 256}


def test_autotune_plan_stamps_measured_seconds_on_every_node(tuned):
    _, cache, entry = tuned
    plan = tplan.plan_sweep(tplan.Problem(SHAPE, RANK), "autotune", tuning_cache=cache)
    measured = {r["key"]: r["measured_s"] for r in entry["nodes"]}
    d = plan.describe()
    assert all(n["measured_s"] is not None for n in d["nodes"])
    for np_ in plan.nodes:
        assert np_.cost.measured_s == measured[
            tautotune.node_key(np_.node, np_.algorithm, "local")
        ]
        if np_.algorithm in ("fused", "matrix_free"):
            assert np_.tiles == {"blocks_per_sm": 4}
    # the chosen schedule is the measured argmin over the candidate trees
    totals = {}
    for sched in tplan.enumerate_schedules(plan.problem):
        p = tplan.plan_sweep(plan.problem, "autotune", schedule=sched, tuning_cache=cache)
        totals[sched.name] = sum(n.cost.measured_s for n in p.nodes)
    assert totals[plan.resolved_schedule.name] == min(totals.values())


def test_cp_als_under_the_tuned_plan_matches_the_reference_sweep_by_sweep(tuned):
    _, cache, _ = tuned
    x, _ = _data()
    init = _data(seed=5)[1]
    tp = tplan.plan_sweep(tplan.Problem(SHAPE, RANK), "autotune", tuning_cache=cache)
    jp = jplan.plan_sweep(jplan.Problem(SHAPE, RANK), "auto", schedule="flat",
                          tuning_cache=jplan.TuningCache())
    jfits, tfits = [], []
    jst = jplan.cp_als(jnp.asarray(x), jp, n_iters=4, tol=0.0,
                       init_factors=[jnp.asarray(u) for u in init],
                       callback=lambda i, f, s: jfits.append(f))
    tst = tplan.cp_als(torch.from_numpy(x), tp, n_iters=4, tol=0.0,
                       init_factors=[torch.from_numpy(u) for u in init],
                       callback=lambda i, f, s: tfits.append(f))
    np.testing.assert_allclose(jfits, tfits, **TOL)
    for ju, tu in zip(jst.factors, tst.factors):
        np.testing.assert_allclose(np.asarray(ju), tu.numpy(), **TOL)


def test_zero_budget_times_each_default_first_and_stops():
    x, fs = _data(seed=1)
    entry = tplan.tune(torch.from_numpy(x), RANK, factors=[torch.from_numpy(u) for u in fs],
                       cache=tplan.TuningCache(), budget_ms=0, reps=1)
    assert entry["nodes"] == []
    for summary in entry["tiles"].values():
        assert [r["is_default"] for r in summary["rows"]] == [True]
    # a plan from the empty node table is the analytic one
    cache = tplan.TuningCache()
    cache.put(tautotune.problem_key(tplan.Problem(SHAPE, RANK)), entry)
    auto = tplan.plan_sweep(tplan.Problem(SHAPE, RANK), "auto").describe()
    tuned = tplan.plan_sweep(tplan.Problem(SHAPE, RANK), "autotune", tuning_cache=cache)
    assert [n["algorithm"] for n in tuned.describe()["nodes"]] == [
        n["algorithm"] for n in auto["nodes"]
    ]


def test_tune_seeds_its_own_factors_and_candidate_tables():
    x, _ = _data(seed=2)
    a = tplan.tune(torch.from_numpy(x), RANK, cache=tplan.TuningCache(), budget_ms=None, reps=1)
    assert {r["key"] for r in a["nodes"]} == _reference_node_keys(SHAPE, RANK)
    assert tautotune.FUSED_TILE_CANDIDATES[0] == tautotune.MATRIX_FREE_TILE_CANDIDATES[0] == 4
    assert tautotune.TTV_TILE_CANDIDATES == jautotune.TTV_TILE_CANDIDATES


@pytest.mark.parametrize(
    "kwargs",
    [dict(mode_axes={0: "x"}), dict(mesh=True), dict(intra_axes=("x",)), dict(pp_tol=0.1)],
    ids=["mode_axes", "mesh", "intra_axes", "pp"],
)
def test_sharded_and_pp_tuning_raise(kwargs):
    x, _ = _data()
    if "pp_tol" in kwargs:  # PP tuning is ported: it measures the two PP rows
        cache = tplan.TuningCache()
        entry = tplan.tune(torch.from_numpy(x), RANK, cache=cache, budget_ms=None, reps=1,
                           **kwargs)
        assert set(entry["pp"]) == {"build_s", "correct_sweep_s"}
        assert all(v > 0 for v in entry["pp"].values())
        problem = tplan.Problem(SHAPE, RANK, pp_tol=kwargs["pp_tol"])
        assert tplan.lookup_measurements(problem, cache=cache).pp == entry["pp"]
        return
    if "intra_axes" in kwargs:  # two-level meshes are ported: the axis needs its mesh
        with pytest.raises(ValueError, match="no size known for intra-node mesh axis"):
            tplan.tune(torch.from_numpy(x), RANK, cache=tplan.TuningCache(), **kwargs)
        # with it, the entry keys on the node topology (8-rank two-level worlds:
        # tests/test_torch_dist_levels.py); one device has no level to split
        mesh = types.SimpleNamespace(mesh_dim_names=("x",), shape=(1,), device_type="cpu")
        cache = tplan.TuningCache()
        entry = tplan.tune(torch.from_numpy(x), RANK, mesh=mesh, cache=cache, budget_ms=None,
                           reps=1, **kwargs)
        problem = tplan.Problem(SHAPE, RANK, axis_sizes={"x": 1}, intra_axes=("x",))
        assert cache.keys() == [tplan.autotune.problem_key(problem)]
        assert cache.keys()[0].endswith("|node1")
        assert {r["collective"] for r in entry["nodes"]} == {"flat"}
        return
    if "mode_axes" in kwargs:  # a mapped mode needs the mesh it names
        with pytest.raises(ValueError, match="no size known for mesh axis"):
            tplan.tune(torch.from_numpy(x), RANK, cache=tplan.TuningCache(), **kwargs)
        return
    # sharded tuning is ported (8-rank worlds: tests/test_torch_dist_exec.py);
    # a mesh with no mapped mode tunes the local problem on its device count
    mesh = types.SimpleNamespace(mesh_dim_names=("x",), shape=(1,), device_type="cpu")
    entry = tplan.tune(torch.from_numpy(x), RANK, mesh=mesh, cache=tplan.TuningCache(),
                       budget_ms=None, reps=1)
    assert entry["n_devices"] == 1 and entry["serial_fractions"] == {}
    assert {r["executor"] for r in entry["nodes"]} == {"local"}


def test_serial_fractions_and_node_key_from_follow_the_reference():
    p = tplan.Problem(SHAPE, RANK)
    assert tautotune._recalibrate_serial_fractions(p, []) == {}
    key = "local|fused|root|keep=1:2|parent=0:3"
    assert tautotune.node_key_from(key) == jautotune.node_key_from(key) == (
        "x|x|root|keep=1:2|parent=0:3"
    )


@pytest.mark.parametrize("method", ["fused", "matrix_free"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_mttkrp_hands_the_tuned_knob_to_the_kernel_wrapper(monkeypatch, method, batched):
    """``NodePlan.tiles`` -> ``mttkrp(tiles=)`` -> the ops wrapper's
    ``blocks_per_sm`` (the default, 4, when the tiles carry none)."""
    name = {"fused": "fused_mttkrp", "matrix_free": "matrix_free_mttkrp"}[method]
    name += "_batched" if batched else ""
    seen = []
    real = getattr(tops, name)

    def spy(x, factors, n, **kw):
        seen.append(kw.get("blocks_per_sm"))
        return real(x, factors, n, **kw)

    monkeypatch.setattr(tops, name, spy)
    x, fs = _data((4, 5, 3), 2, seed=4)
    tx, tf = torch.from_numpy(x), [torch.from_numpy(u) for u in fs]
    if batched:
        tx, tf = tx[None].expand(2, *x.shape), [u[None].expand(2, *u.shape) for u in tf]
    run = mttkrp_batched if batched else mttkrp
    outs = [run(tx, tf, 1, method=method, tiles=t)
            for t in (None, {"blocks_per_sm": 8, "block_i": 7}, {"block_i": 7})]
    assert seen == [None, 8, None]
    assert all(torch.equal(o, outs[0]) for o in outs)  # the plain version ignores it


def test_served_batch_of_one_plans_from_the_entry_of_the_tensor_tuned_alone():
    x, fs = _data(seed=6)
    tx = torch.from_numpy(x)
    cache = tplan.TuningCache()
    tplan.tune(tx, RANK, cache=cache, budget_ms=None, reps=1)
    svc = CPService(batch_size=1, n_iters=3, strategy="autotune", tuning_cache=cache,
                    device="cpu")
    futs = [svc.submit(tx, RANK, init_factors=[torch.from_numpy(u) for u in fs]),
            svc.submit(tx * 2, RANK, seed=1)]
    svc.flush()
    stats = svc.stats()
    assert stats["warm_plan_hits"] == 1 and stats["compiles"] == 1
    assert all(np.isfinite(f.result().fit) for f in futs)
    cold = CPService(batch_size=2, n_iters=3, strategy="autotune", tuning_cache=cache,
                     device="cpu")
    cold.submit(tx, RANK)
    cold.flush()
    assert cold.stats()["warm_plan_hits"] == 0  # a batch of two keys as another problem
