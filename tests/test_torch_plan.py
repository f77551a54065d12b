"""Parity of the port's plan stack (Problem, schedules, cost model, planner,
executor, sweep engine, tuning-cache read side, interop) with the JAX
reference, on the CPU.

Plans are compared with the port's roofline constants pinned to the
reference's (with H100 constants a plan may legitimately differ).  CP-ALS
runs start from shared numpy factors and are compared sweep by sweep at
``rtol=2e-4, atol=2e-5``; bitwise claims hold only port against port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.roofline as jroof
import repro.plan as jplan
import repro_torch.plan as tplan
import repro_torch.plan.cost as tcost
import repro_torch.plan.sweep as tsweep
from repro_torch.interop import cpstate_from_numpy, cpstate_to_numpy
from repro_torch.kernels import fused_mttkrp as tfused
from repro_torch.kernels import matrix_free as tmf

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def reference_constants(monkeypatch):
    """Price the port's plans with the reference's roofline constants."""
    monkeypatch.setattr(tcost, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tcost, "HBM_BW", jroof.HBM_BW)


def _data(shape, rank, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    init = [rng.standard_normal((d, rank)).astype(np.float32) for d in shape]
    return x, init


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **TOL)


@pytest.mark.parametrize(
    "shape,rank,dtype",
    [((3, 4, 5), 2, np.float32), ((225, 59, 200, 200), 10, np.float32),
     ((7, 8), 3, np.float64)],
)
def test_signature_strings_match_reference(shape, rank, dtype):
    jp = jplan.Problem(shape, rank, dtype=np.dtype(dtype))
    if dtype == np.float32:
        assert jplan.Problem.from_tensor(jnp.zeros(shape[:1]), rank).dtype_str == "float32"
    tx = torch.zeros(shape, dtype=torch.from_numpy(np.zeros(1, dtype)).dtype, device="meta")
    tp = tplan.Problem.from_tensor(tx, rank)
    assert tp.signature() == jp.signature()
    assert tp.signature(backend="gpu", n_devices=4) == jp.signature(backend="gpu", n_devices=4)
    assert hash(tp) == hash(tplan.Problem(shape, rank, dtype=tp.dtype))


PLAN_SHAPES = [((5, 6, 7), 3), ((4, 5, 3, 6), 2), ((225, 59, 200, 200), 10),
               ((225, 59, 20100), 10), ((3, 4, 5, 6, 7), 4)]
PLAN_STRATEGIES = ["auto", "autotune", "fused", "matrix_free", "dimtree", "1step", "2step",
                   "2step-left", "baseline", "einsum"]


@pytest.mark.parametrize("shape,rank", PLAN_SHAPES)
def test_plans_match_reference_at_equal_constants(reference_constants, shape, rank):
    for strategy in PLAN_STRATEGIES:
        jd = jplan.plan_sweep(
            jplan.Problem(shape, rank), strategy, tuning_cache=jplan.TuningCache()
        ).describe()
        td = tplan.plan_sweep(
            tplan.Problem(shape, rank), strategy, tuning_cache=tplan.TuningCache()
        ).describe()
        assert td == jd, strategy


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 5, 3, 6), (2, 3, 2, 3, 2)])
def test_schedules_and_costs_match_reference(reference_constants, shape):
    jp, tp = jplan.Problem(shape, 3), tplan.Problem(shape, 3)
    js, ts = jplan.enumerate_schedules(jp), tplan.enumerate_schedules(tp)
    assert [s.describe() for s in ts] == [s.describe() for s in js]
    for jsched, tsched in zip(js, ts):
        for jn, tn in zip(jsched.walk(), tsched.walk()):
            if tn.from_root and tn.is_leaf:
                continue
            assert tplan.node_cost(tp, tn).as_dict() == jplan.node_cost(jp, jn).as_dict()
    for n in range(len(shape)):
        for alg in tplan.ALGORITHMS:
            assert tplan.mode_cost(tp, n, alg).as_dict() == jplan.mode_cost(jp, n, alg).as_dict()
        for split in range(1, len(shape)):
            assert (tplan.dimtree_mode_cost(tp, n, split).as_dict()
                    == jplan.dimtree_mode_cost(jp, n, split).as_dict())
    spec = [[0, 1], 2] if len(shape) == 3 else [[0, 1], list(range(2, len(shape)))]
    assert (tplan.build_schedule(tp, spec).describe()
            == jplan.build_schedule(jp, spec).describe())


def test_h100_constants_are_the_datasheet_values():
    import repro_torch.analysis.roofline as troof

    assert (troof.PEAK_FLOPS, troof.HBM_BW) == (67e12, 3.35e12)
    plan = tplan.plan_sweep(tplan.Problem((225, 59, 200, 200), 10))
    d = plan.describe()
    assert d["executor"] == "local" and d["totals"]["flops"] > 0


def test_later_slices_raise_not_implemented():
    p = tplan.Problem((4, 6), 2)
    # sharded problems plan with executor="auto" (distribution slices 2-3):
    # mode-parallel argmins the three sharded kinds, batch-parallel runs the
    # plain one, as the reference's
    mode_parallel = dict(shape=(4, 6), rank=2, mode_axes={0: "x"}, axis_sizes={"x": 2})
    assert tplan.plan_sweep(tplan.Problem(**mode_parallel)).executor in (
        "sharded", "overlapping", "compressed")
    batch_parallel = dict(shape=(4, 6), rank=2, batch=2, batch_axes=("b",), axis_sizes={"b": 2})
    assert tplan.plan_sweep(tplan.Problem(**batch_parallel)).executor == jplan.plan_sweep(
        jplan.Problem(**batch_parallel), tuning_cache=jplan.TuningCache()).executor == "sharded"
    # PP is ported: a pp_tol > 0 problem plans with its PP row, and "pp"
    # without a tolerance is the reference's ValueError
    assert tplan.plan_sweep(tplan.Problem((4, 6), 2, pp_tol=0.1)).pp_info["tol"] == 0.1
    with pytest.raises(ValueError, match="pp_tol"):
        tplan.plan_sweep(p, "pp")
    # the sharded executor takes an unsharded problem too, as the
    # reference's does; the overlapping one plans a mode-parallel problem
    assert tplan.plan_sweep(p, executor="sharded").executor == "sharded"
    assert tplan.plan_sweep(tplan.Problem(**mode_parallel),
                            executor="overlapping").executor == "overlapping"
    with pytest.raises(ValueError, match="needs mesh"):
        tplan.make_executor("overlapping")
    with pytest.raises(ValueError):
        tplan.make_executor("bogus")
    with pytest.raises(ValueError):
        tplan.plan_sweep(p, "bogus")
    with pytest.raises(ValueError):
        tplan.plan_sweep(p, split=1)
    assert isinstance(tplan.make_executor("local"), tplan.LocalExecutor)
    assert isinstance(tplan.LocalExecutor(), tplan.Executor)


def _plans(x, rank, strategy):
    jp = jplan.plan_sweep(
        jplan.Problem.from_tensor(jnp.asarray(x), rank), strategy, tuning_cache=jplan.TuningCache()
    )
    tp = tplan.plan_sweep(
        tplan.Problem.from_tensor(torch.from_numpy(x), rank), strategy,
        tuning_cache=tplan.TuningCache(),
    )
    return jp, tp


@pytest.mark.parametrize("strategy", ["auto", "fused", "matrix_free"])
@pytest.mark.parametrize("shape", [(5, 6, 4), (3, 4, 5, 3)], ids=["order3", "order4"])
def test_als_sweeps_match_reference_sweep_by_sweep(reference_constants, strategy, shape):
    rank = 3
    x, init = _data(shape, rank, seed=len(shape))
    jp, tp = _plans(x, rank, strategy)
    assert [m.algorithm for m in tp.modes] == [m.algorithm for m in jp.modes]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    js = jplan.SweepState(
        x=jx, factors=[jnp.asarray(u) for u in init], weights=jnp.ones((rank,)),
        norm_x=jnp.linalg.norm(jx), it=jnp.asarray(0),
    )
    ts = tsweep.SweepState(
        x=tx, factors=[torch.from_numpy(u) for u in init], weights=torch.ones(rank),
        norm_x=torch.linalg.vector_norm(tx), it=0,
    )
    for sweep in range(3):
        js = jplan.als_sweep(jp.problem, jp, jplan.LocalExecutor(), js)
        ts = tplan.als_sweep(tp.problem, tp, tplan.LocalExecutor(), ts)
        for ju, tu in zip(js.factors, ts.factors):
            _close(ju, tu)
        _close(js.weights, ts.weights)
        _close(js.fit, ts.fit)
        js.it, ts.it = jnp.asarray(sweep + 1), sweep + 1


@pytest.mark.parametrize("strategy", ["auto", "fused", "matrix_free"])
@pytest.mark.parametrize("shape", [(6, 5, 4), (4, 3, 5, 3)], ids=["order3", "order4"])
def test_cp_als_matches_reference(strategy, shape):
    rank = 2
    x, init = _data(shape, rank, seed=7 + len(shape))
    jp, tp = _plans(x, rank, strategy)
    jfits, tfits = [], []
    jst = jplan.cp_als(jnp.asarray(x), jp, n_iters=4, tol=0.0,
                       init_factors=[jnp.asarray(u) for u in init],
                       callback=lambda i, f, s: jfits.append(f))
    kernel = tfused.KERNEL.launches, tmf.KERNEL.launches
    tst = tplan.cp_als(torch.from_numpy(x), tp, n_iters=4, tol=0.0,
                       init_factors=[torch.from_numpy(u) for u in init],
                       callback=lambda i, f, s: tfits.append(f))
    assert (tfused.KERNEL.launches, tmf.KERNEL.launches) == kernel  # plain versions on CPU
    np.testing.assert_allclose(jfits, tfits, **TOL)
    for ju, tu in zip(jst.factors, tst.factors):
        _close(ju, tu)
    _close(jst.weights, tst.weights)
    assert tst.it == jst.it == 4


def test_sweeps_per_sync_is_bitwise_and_syncs_once_per_chunk(monkeypatch):
    x, init = _data((5, 4, 6), 3, seed=11)
    plan = tplan.plan_sweep(tplan.Problem.from_tensor(torch.from_numpy(x), 3), "matrix_free")
    syncs = []
    real = tsweep._host_fits
    monkeypatch.setattr(tsweep, "_host_fits", lambda fits: syncs.append(len(fits)) or real(fits))

    def run(k):
        fits = []
        st = tplan.cp_als(torch.from_numpy(x), plan, n_iters=6, tol=0.0, sweeps_per_sync=k,
                          init_factors=[torch.from_numpy(u) for u in init],
                          callback=lambda i, f, s: fits.append((i, f)))
        return st, fits

    base, base_fits = run(1)
    assert syncs == [1] * 6
    for k, chunks in ((4, [4, 2]), (6, [6])):
        syncs.clear()
        st, fits = run(k)
        assert syncs == chunks
        assert fits == base_fits
        assert all(torch.equal(a, b) for a, b in zip(st.factors, base.factors))
        assert torch.equal(st.weights, base.weights) and torch.equal(st.fit, base.fit)
    with pytest.raises(ValueError):
        run(0)


def test_cp_als_convergence_seed_and_dispatch_cache():
    x, _ = _data((4, 5, 6), 2, seed=12)
    plan = tplan.plan_sweep(tplan.Problem.from_tensor(torch.from_numpy(x), 2))
    a = tplan.cp_als(torch.from_numpy(x), plan, n_iters=50, tol=1e-3, seed=3)
    cache = {}
    b = tplan.cp_als(torch.from_numpy(x), plan, n_iters=50, tol=1e-3, seed=3,
                     dispatch_cache=cache, dispatch_key="k")
    assert a.it == b.it < 50  # stopped on the fit delta, same iterates with a cache
    assert all(torch.equal(u, v) for u, v in zip(a.factors, b.factors))
    assert 0.0 < float(a.fit) < 1.0
    with pytest.raises(ValueError):
        tplan.cp_als(torch.zeros(3, 3, 3), plan)


def test_state_carried_across_packages():
    """Two sweeps in JAX, the state carried into the port, two more sweeps in
    both from that state: the packages agree at tolerance."""
    shape, rank = (5, 4, 6), 3
    x, init = _data(shape, rank, seed=13)
    jp, tp = _plans(x, rank, "auto")
    jst = jplan.cp_als(jnp.asarray(x), jp, n_iters=2, tol=0.0,
                       init_factors=[jnp.asarray(u) for u in init])
    carried = cpstate_from_numpy(
        [np.asarray(u) for u in jst.factors], np.asarray(jst.weights),
        fit=np.asarray(jst.fit), it=jst.it, device="cpu",
    )
    back = cpstate_to_numpy(carried)
    assert back["it"] == 2 and float(back["fit"]) == float(jst.fit)
    for a, b in zip(back["factors"], jst.factors):
        np.testing.assert_array_equal(a, np.asarray(b))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    js = jplan.SweepState(x=jx, factors=list(jst.factors), weights=jst.weights,
                          norm_x=jnp.linalg.norm(jx), it=jnp.asarray(jst.it))
    ts = tsweep.SweepState(x=tx, factors=carried.factors, weights=carried.weights,
                           norm_x=torch.linalg.vector_norm(tx), it=carried.it)
    for _ in range(2):
        js = jplan.als_sweep(jp.problem, jp, jplan.LocalExecutor(), js)
        ts = tplan.als_sweep(tp.problem, tp, tplan.LocalExecutor(), ts)
        js.it, ts.it = js.it + 1, ts.it + 1
    for ju, tu in zip(js.factors, ts.factors):
        _close(ju, tu)
    _close(js.fit, ts.fit)


def _measured_entry(problem_cls, problem, kernel_alg):
    """A tuning entry timing every leaf of the flat schedule, the kernel
    algorithm fastest."""
    sched = jplan.flat_schedule(problem) if problem_cls is jplan.Problem else \
        tplan.flat_schedule(problem)
    rows = []
    for node in sched.walk():
        algs = ["1step", kernel_alg] + (
            [] if problem.external_mode(node.mode) else ["2step-left", "2step-right"]
        )
        for alg in algs:
            key = (jplan.autotune.node_key if problem_cls is jplan.Problem
                   else tplan.autotune.node_key)(node, alg, "local")
            rows.append({"key": key, "measured_s": 1e-4 if alg == kernel_alg else 1e-3})
    return {"nodes": rows, "tiles": {}}


@pytest.mark.parametrize("kernel_alg", ["fused", "matrix_free"])
def test_autotune_reads_measurements_like_reference(reference_constants, kernel_alg):
    shape = (4, 5, 6)
    jp, tp = jplan.Problem(shape, 2), tplan.Problem(shape, 2)
    jcache, tcache = jplan.TuningCache(), tplan.TuningCache()
    jcache.put(jplan.autotune.problem_key(jp), _measured_entry(jplan.Problem, jp, kernel_alg))
    tcache.put(tplan.autotune.problem_key(tp), _measured_entry(tplan.Problem, tp, kernel_alg))
    assert tplan.lookup_measurements(tp, tcache) is not None
    jd = jplan.plan_sweep(jp, "autotune", schedule="flat", tuning_cache=jcache).describe()
    td = tplan.plan_sweep(tp, "autotune", schedule="flat", tuning_cache=tcache).describe()
    assert [m["algorithm"] for m in td["modes"]] == [kernel_alg] * 3
    assert td == jd


def test_tuning_cache_keys_and_disk_round_trip(tmp_path):
    p = tplan.Problem((3, 4, 5), 2)
    key = tplan.autotune.problem_key(p, backend="cuda:NVIDIA H100 80GB HBM3")
    assert key == "cuda:NVIDIA H100 80GB HBM3|3x4x5|r2|float32|d1"
    assert tplan.autotune.backend_name() == (
        f"cuda:{torch.cuda.get_device_name(0)}" if torch.cuda.is_available() else "cpu"
    )
    path = tmp_path / "cache.json"
    path.write_text("")
    cache = tplan.TuningCache(path)
    assert cache.keys() == []
    cache.put(key, {"nodes": [], "tiles": {"matrix_free": {"block_i": 32, "junk": 1}}})
    again = tplan.TuningCache(path)
    assert again.get(key)["tiles"]["matrix_free"]["block_i"] == 32
    assert tplan.lookup_measurements(p, again) is None  # keyed to another backend
    assert isinstance(tplan.default_tuning_cache(), tplan.TuningCache)
