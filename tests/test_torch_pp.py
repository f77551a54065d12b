"""Parity of the port's pairwise-perturbation (PP) sweeps with the JAX
reference, on the CPU.

Inputs are made once with numpy from a seed and given to both packages;
fp32 results are compared at ``rtol=2e-4, atol=2e-5``.  Whole runs are
driven sweep by sweep in both packages: first the exact/approximate
sequence must agree (the tolerance is chosen well away from every drift
the run produces, and the test checks that it is), then the iterates.
Bitwise claims hold only port against port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.roofline as jroof
import repro.plan as jplan
import repro.plan.sweep as jsweep
import repro_torch.plan as tplan
import repro_torch.plan.cost as tcost
import repro_torch.plan.sweep as tsweep
from repro.core.tensor_ops import tensor_norm as jnorm
from repro_torch.core.tensor_ops import tensor_norm as tnorm
from repro_torch.interop import (
    cpstate_from_numpy,
    cpstate_to_numpy,
    ppstate_from_numpy,
    ppstate_to_numpy,
)
from repro_torch.serve import CPService

TOL = dict(rtol=2e-4, atol=2e-5)
# a gate value within this factor of pp_tol could flip between the packages
GATE_MARGIN = 1.05


@pytest.fixture
def reference_constants(monkeypatch):
    """Price the port's plans with the reference's roofline constants."""
    monkeypatch.setattr(tcost, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tcost, "HBM_BW", jroof.HBM_BW)


def _planted(shape, rank, seed, batch=None):
    """A planted rank-``rank`` tensor plus 10% noise (a batch of them when
    ``batch``), and random initial factors, all float32 numpy.  The noise
    keeps the fit near 0.9, where its factored identity is well conditioned
    in fp32 (near a perfect fit it cancels to ~3e-4)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    true = [rng.standard_normal(lead + (d, rank)).astype(np.float32) for d in shape]
    letters = "abdefg"[: len(shape)]
    spec = ",".join("..." + l + "c" for l in letters) + "->..." + letters
    x = np.einsum(spec, *true)
    x = x + 0.1 * np.sqrt(np.mean(x**2)) * rng.standard_normal(x.shape)
    init = [rng.standard_normal(lead + (d, rank)).astype(np.float32) for d in shape]
    return x.astype(np.float32), init


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **TOL)


# ----------------------------------------------------------------- metadata
@pytest.mark.parametrize("shape,batch", [((5, 6, 7), 1), ((4, 5, 3, 6), 1), ((4, 5, 3, 6), 3),
                                         ((3, 4, 2, 3, 2), 1)])
def test_pp_pairs_metadata_matches_reference(shape, batch):
    jp = jplan.Problem(shape, 3, batch=batch, pp_tol=0.1)
    tp = tplan.Problem(shape, 3, batch=batch, pp_tol=0.1)
    jm, tm = jplan.pp_pairs(jp), tplan.pp_pairs(tp)
    assert [p.as_dict() for p in tm] == [p.as_dict() for p in jm]
    assert [p.local_shape for p in tm] == [p.local_shape for p in jm]
    assert len(tm) == len(shape) * (len(shape) - 1) // 2


@pytest.mark.parametrize("shape,batch", [((5, 6, 7), None), ((4, 5, 3, 6), None),
                                         ((3, 4, 2, 3, 2), None), ((4, 5, 3, 6), 3)])
def test_executor_pp_pairs_match_reference(shape, batch):
    x, fs = _planted(shape, 3, seed=1, batch=batch)
    b = 1 if batch is None else batch
    jp = jplan.Problem(shape, 3, batch=b, pp_tol=0.1)
    tp = tplan.Problem(shape, 3, batch=b, pp_tol=0.1)
    jpairs = jplan.LocalExecutor().pp_pairs(jp, jnp.asarray(x), [jnp.asarray(u) for u in fs])
    tpairs = tplan.LocalExecutor().pp_pairs(tp, torch.from_numpy(x),
                                            [torch.from_numpy(u) for u in fs])
    assert list(tpairs) == list(jpairs)
    for key, t in tpairs.items():
        assert t.is_contiguous()  # rank-major, stride-1 for the corrections
        assert tuple(t.shape) == tuple(jpairs[key].shape)
        _close(jpairs[key], t)


@pytest.mark.parametrize("shape,batch", [((5, 6, 7), None), ((4, 5, 3, 6), 2)])
def test_materialized_bases_and_drift_match_reference(shape, batch):
    x, fs = _planted(shape, 3, seed=2, batch=batch)
    b = 1 if batch is None else batch
    jp = jplan.Problem(shape, 3, batch=b, pp_tol=0.1)
    tp = tplan.Problem(shape, 3, batch=b, pp_tol=0.1)
    jpp = jsweep._pp_materialize(jp, jplan.LocalExecutor(), jnp.asarray(x),
                                 [jnp.asarray(u) for u in fs], 3)
    tpp = tsweep._pp_materialize(tp, tplan.LocalExecutor(), torch.from_numpy(x),
                                 [torch.from_numpy(u) for u in fs], 3)
    for jb, tb in zip(jpp.base, tpp.base):
        _close(jb, tb)
    assert tpp.n_exact == int(jpp.n_exact) == 3 and tpp.drift_max == 0.0
    # the base is the exact MTTKRP at the reference point
    ex = tplan.LocalExecutor()
    sched = tplan.flat_schedule(tp)
    xt, ft = torch.from_numpy(x), [torch.from_numpy(u) for u in fs]
    for n, leaf in enumerate(sched.leaves()):
        np.testing.assert_allclose(tpp.base[n].numpy(),
                                   ex.contract(leaf, xt, ft, "einsum").numpy(), rtol=1e-4,
                                   atol=1e-4)
    moved = [u * (1 + 0.01 * (k + 1)) for k, u in enumerate(fs)]
    jd = jsweep._pp_drift([jnp.asarray(u) for u in moved], [jnp.asarray(u) for u in fs])
    td = tsweep._pp_drift([torch.from_numpy(u) for u in moved], ft)
    assert td.dtype == torch.float32 and tuple(td.shape) == (len(shape),)
    _close(jd, td)
    init = tsweep._pp_init(tp, xt, ft)
    assert init.n_exact == 0 and init.drift_max == math.inf
    assert bool(torch.isinf(init.drift).all())
    assert {k: tuple(v.shape) for k, v in init.pairs.items()} == {
        k: tuple(v.shape) for k, v in tpp.pairs.items()
    }


@pytest.mark.parametrize("batch", [None, 2])
def test_one_pp_sweep_from_a_shared_state_matches_reference(batch):
    shape, rank = (6, 5, 4, 3), 3
    x, ref = _planted(shape, rank, seed=3, batch=batch)
    rng = np.random.default_rng(4)
    cur = [(u + 0.02 * rng.standard_normal(u.shape)).astype(np.float32) for u in ref]
    b = 1 if batch is None else batch
    jp = jplan.Problem(shape, rank, batch=b, pp_tol=0.5)
    jex = jplan.LocalExecutor()
    jpp = jsweep._pp_materialize(jp, jex, jnp.asarray(x), [jnp.asarray(u) for u in ref], 1)
    jpp = jsweep.PPState(ref=jpp.ref, pairs=jpp.pairs, base=jpp.base,
                         drift=jsweep._pp_drift([jnp.asarray(u) for u in cur], jpp.ref),
                         n_exact=jpp.n_exact)
    fields = ppstate_to_numpy(jpp)
    tp = tplan.Problem(shape, rank, batch=b, pp_tol=0.5)
    tpp = ppstate_from_numpy(fields["ref"], fields["pairs"], fields["base"], fields["drift"],
                             fields["n_exact"], device="cpu")
    assert tpp.drift_max == float(np.max(fields["drift"])) and tpp.n_exact == 1
    lead = () if batch is None else (batch,)
    jw, tw = jnp.ones(lead + (rank,), jnp.float32), torch.ones(lead + (rank,))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jplan_, tplan_ = jplan.plan_sweep(jp, "pp"), tplan.plan_sweep(tp, "pp")
    jst = jsweep._pp_sweep(jp, jplan_, jsweep.SweepState(
        x=jx, factors=[jnp.asarray(u) for u in cur], weights=jw,
        norm_x=jnorm(jx, batched=batch is not None), it=jnp.asarray(1), pp=jpp))
    tst = tsweep._pp_sweep(tp, tplan_, tsweep.SweepState(
        x=tx, factors=[torch.from_numpy(u) for u in cur], weights=tw,
        norm_x=tnorm(tx, batched=batch is not None), it=1, pp=tpp))
    for ju, tu in zip(jst.factors, tst.factors):
        _close(ju, tu)
    _close(jst.weights, tst.weights)
    _close(jst.fit, tst.fit)
    _close(jst.pp.drift, tst.pp.drift)
    assert tst.pp.drift_max is None  # not read to the host by the sweep itself
    assert tst.pp.pairs is tpp.pairs and tst.pp.n_exact == 1


@pytest.mark.parametrize("shape,batch", [((5, 6, 7), 1), ((225, 59, 200, 200), 1),
                                         ((4, 5, 3, 6), 4)])
def test_pp_prices_match_reference(reference_constants, shape, batch):
    jp = jplan.Problem(shape, 10, batch=batch, pp_tol=0.05)
    tp = tplan.Problem(shape, 10, batch=batch, pp_tol=0.05)
    for name in ("pp_build_cost", "pp_correction_cost"):
        j, t = getattr(jplan, name)(jp), getattr(tplan, name)(tp)
        assert (t.flops, t.bytes, t.gemm_flops) == (j.flops, j.bytes, j.gemm_flops), name
        assert t.predicted_s == pytest.approx(j.predicted_s, rel=1e-12)
    assert tplan.PP_EXACT_FRACTION == jplan.PP_EXACT_FRACTION
    for kw in ({}, dict(build_s=0.5, correction_s=0.25, exact_fraction=0.3)):
        j = jplan.pp_amortized_cost(jp, 2.0, **kw)
        t = tplan.pp_amortized_cost(tp, 2.0, **kw)
        assert t.keys() == j.keys()
        for k in j:
            assert t[k] == pytest.approx(j[k], rel=1e-12), k
        f = t["exact_fraction"]
        assert t["amortized_sweep_s"] == pytest.approx(
            f * (2.0 + t["build_s"]) + (1 - f) * t["correction_sweep_s"])


# --------------------------------------------------------------- whole runs
def _drive_reference(x, init, problem, n_sweeps):
    """The reference's gated sweeps, one at a time: per sweep whether it was
    exact, and every drift value its gate compared (the gate's drift and,
    after an exact sweep, its step)."""
    plan = jplan.plan_sweep(problem, "pp")
    ex = jplan.LocalExecutor()
    sweep = jax.jit(lambda st: jsweep.als_sweep(problem, plan, ex, st))  # one compile a run
    xj = jnp.asarray(x)
    fs = [jnp.asarray(u) for u in init]
    lead = (problem.batch,) if problem.batched else ()
    st = jsweep.SweepState(
        x=xj, factors=fs, weights=jnp.ones(lead + (problem.rank,), xj.dtype),
        norm_x=jnorm(xj, batched=problem.batched).astype(xj.dtype), it=jnp.asarray(0),
        grams=jsweep.grams(fs), pp=jsweep._pp_init(problem, xj, fs),
    )
    seq, gates, states = [], [], []
    for i in range(n_sweeps):
        gate = float(jnp.max(st.pp.drift))
        out = sweep(st)
        exact = int(out.pp.n_exact) > int(st.pp.n_exact)
        seq.append(exact)
        if math.isfinite(gate):
            gates.append(gate)
        if exact:
            gates.append(float(jnp.max(jsweep._pp_drift(out.factors, st.factors))))
        states.append(out)
        st = jsweep.SweepState(x=out.x, factors=out.factors, weights=out.weights,
                               norm_x=out.norm_x, it=jnp.asarray(i + 1), fit=out.fit,
                               grams=out.grams, pp=out.pp)
    return seq, gates, states


def _drive_port(x, init, problem, n_sweeps):
    plan = tplan.plan_sweep(problem, "pp")
    ex = tplan.LocalExecutor()
    xt = torch.from_numpy(x)
    fs = [torch.from_numpy(u) for u in init]
    lead = (problem.batch,) if problem.batched else ()
    st = tsweep.SweepState(
        x=xt, factors=fs, weights=torch.ones(lead + (problem.rank,)),
        norm_x=tnorm(xt, batched=problem.batched), it=0, grams=tsweep.grams(fs),
        pp=tsweep._pp_init(problem, xt, fs),
    )
    seq, states = [], []
    for i in range(n_sweeps):
        out = tsweep.als_sweep(problem, plan, ex, st)
        seq.append(out.pp.n_exact > st.pp.n_exact)
        states.append(out)
        st = tsweep.SweepState(x=out.x, factors=out.factors, weights=out.weights,
                               norm_x=out.norm_x, it=i + 1, fit=out.fit, grams=out.grams,
                               pp=out.pp)
    return seq, states


@pytest.mark.parametrize(
    "shape,rank,batch,pp_tol",
    [((10, 8, 6), 3, None, 0.08), ((12, 10, 8, 6), 3, None, 0.05), ((10, 8, 6), 3, 3, 0.05)],
    ids=["order3", "order4", "batched"],
)
def test_pp_runs_match_reference_sweep_by_sweep(shape, rank, batch, pp_tol):
    n_sweeps = 14
    x, init = _planted(shape, rank, seed=40, batch=batch)
    b = 1 if batch is None else batch
    jseq, gates, jstates = _drive_reference(
        x, init, jplan.Problem(shape, rank, batch=b, pp_tol=pp_tol), n_sweeps)
    # the tolerance lies well away from every drift the gate compared, so a
    # 1e-7 difference cannot flip a decision between the packages
    assert all(g > pp_tol * GATE_MARGIN or g < pp_tol / GATE_MARGIN for g in gates), gates
    assert any(jseq) and not all(jseq)  # both regimes ran
    tseq, tstates = _drive_port(x, init, tplan.Problem(shape, rank, batch=b, pp_tol=pp_tol),
                                n_sweeps)
    assert tseq == jseq
    for js, ts in zip(jstates, tstates):
        assert ts.pp.n_exact == int(js.pp.n_exact)
        for ju, tu in zip(js.factors, ts.factors):
            _close(ju, tu)
        _close(js.weights, ts.weights)
        _close(js.fit, ts.fit)
        d = np.asarray(js.pp.drift)
        if np.isfinite(d).all():
            _close(d, ts.pp.drift)
        else:
            assert torch.isinf(ts.pp.drift).all()


@pytest.mark.parametrize("batch,pp_tol", [(None, 0.08), (3, 0.05)])
def test_pp_cp_als_matches_reference(batch, pp_tol):
    shape, rank, n_iters = (10, 8, 6), 3, 12
    x, init = _planted(shape, rank, seed=40, batch=batch)
    b = 1 if batch is None else batch
    jfits, tfits = [], []
    j = jplan.cp_als(jnp.asarray(x), jplan.plan_sweep(jplan.Problem(shape, rank, batch=b,
                                                                    pp_tol=pp_tol), "pp"),
                     n_iters=n_iters, tol=0.0, init_factors=[jnp.asarray(u) for u in init],
                     callback=lambda i, f, s: jfits.append(f))
    t = tplan.cp_als(torch.from_numpy(x), tplan.plan_sweep(tplan.Problem(
        shape, rank, batch=b, pp_tol=pp_tol), "pp"), n_iters=n_iters, tol=0.0,
        init_factors=[torch.from_numpy(u) for u in init],
        callback=lambda i, f, s: tfits.append(f))
    assert t.pp_exact_sweeps == j.pp_exact_sweeps and 0 < t.pp_exact_sweeps < n_iters
    np.testing.assert_allclose(jfits, tfits, **TOL)
    for ju, tu in zip(j.factors, t.factors):
        _close(ju, tu)
    got = cpstate_to_numpy(t)
    assert got["pp_exact_sweeps"] == cpstate_to_numpy(j)["pp_exact_sweeps"]
    back = cpstate_from_numpy(got["factors"], got["weights"], fit=got["fit"], it=got["it"],
                              pp_exact_sweeps=got["pp_exact_sweeps"], device="cpu")
    assert back.pp_exact_sweeps == t.pp_exact_sweeps


@pytest.mark.parametrize("batch", [None, 2])
def test_pp_tol_zero_is_bitwise_exact_als(batch):
    shape, rank = (8, 7, 6), 4
    x, init = _planted(shape, rank, seed=10, batch=batch)
    b = 1 if batch is None else batch
    xt = torch.from_numpy(x)

    def run(problem):
        return tplan.cp_als(xt, tplan.plan_sweep(problem), n_iters=8, tol=0.0,
                            init_factors=[torch.from_numpy(u) for u in init])

    exact = run(tplan.Problem(shape, rank, batch=b))
    zero = run(tplan.Problem(shape, rank, batch=b, pp_tol=0.0))
    assert tplan.plan_sweep(tplan.Problem(shape, rank, batch=b, pp_tol=0.0)).pp_info is None
    assert exact.pp_exact_sweeps is None and zero.pp_exact_sweeps is None
    assert all(torch.equal(u, v) for u, v in zip(exact.factors, zero.factors))
    assert torch.equal(exact.weights, zero.weights) and torch.equal(exact.fit, zero.fit)


@pytest.mark.parametrize("pp_tol,want", [(1e-12, 6), (1e9, 1)])
def test_pp_exact_sweep_cadence(pp_tol, want):
    """A vanishing tolerance never builds the cache (every sweep exact); a
    huge one builds after the first sweep and approximates the rest."""
    shape, rank = (8, 7, 6), 4
    x, init = _planted(shape, rank, seed=10)
    st = tplan.cp_als(torch.from_numpy(x),
                      tplan.plan_sweep(tplan.Problem(shape, rank, pp_tol=pp_tol), "pp"),
                      n_iters=6, tol=0.0, init_factors=[torch.from_numpy(u) for u in init])
    assert st.pp_exact_sweeps == want and st.it == 6


def test_the_host_gate_reads_once_a_sweep_and_only_under_pp(monkeypatch):
    shape, rank, n_iters = (10, 8, 6), 3, 9
    x, init = _planted(shape, rank, seed=40)
    reads, chunks = [], []
    real_gate, real_fits = tsweep._host_gate, tsweep._host_fits
    monkeypatch.setattr(tsweep, "_host_gate", lambda d: reads.append(1) or real_gate(d))
    monkeypatch.setattr(tsweep, "_host_fits", lambda f: chunks.append(len(f)) or real_fits(f))

    def run(pp_tol, strategy):
        reads.clear()
        chunks.clear()
        return tplan.cp_als(torch.from_numpy(x), tplan.plan_sweep(
            tplan.Problem(shape, rank, pp_tol=pp_tol), strategy), n_iters=n_iters, tol=0.0,
            sweeps_per_sync=3, init_factors=[torch.from_numpy(u) for u in init])

    st = run(0.08, "pp")
    assert 0 < st.pp_exact_sweeps < n_iters
    assert len(reads) == n_iters and chunks == [3, 3, 3]
    run(0.0, "auto")
    assert reads == [] and chunks == [3, 3, 3]


# ---------------------------------------------------- planner, tuner, service
def test_strategy_pp_needs_a_tolerance():
    with pytest.raises(ValueError, match="pp_tol"):
        tplan.plan_sweep(tplan.Problem((4, 5, 6), 2), "pp")
    with pytest.raises(ValueError, match="pp_tol"):
        jplan.plan_sweep(jplan.Problem((4, 5, 6), 2), "pp")


@pytest.mark.parametrize("strategy", ["fused", "matrix_free", "1step", "dimtree", "einsum"])
def test_forced_strategies_price_pp_but_never_enable_it(strategy):
    # a tolerance so large that the amortized price beats every exact sweep
    tp = tplan.Problem((225, 59, 200, 200), 10, pp_tol=0.5)
    plan = tplan.plan_sweep(tp, strategy, tuning_cache=tplan.TuningCache())
    d = plan.describe()["pp"]
    assert not plan.pp and d["enabled"] is False and d["basis"] == "analytic"
    assert d["amortized_sweep_s"] < d["exact_sweep_s"]
    assert tplan.plan_sweep(tp, "auto").pp  # "auto" enables it at the same price
    assert tplan.plan_sweep(tp, "pp").pp


@pytest.mark.parametrize("strategy", ["auto", "pp", "fused"])
def test_describe_pp_row_has_the_reference_keys(reference_constants, strategy):
    shape = (6, 5, 4, 3)
    jd = jplan.plan_sweep(jplan.Problem(shape, 3, pp_tol=0.2), strategy,
                          tuning_cache=jplan.TuningCache()).describe()
    td = tplan.plan_sweep(tplan.Problem(shape, 3, pp_tol=0.2), strategy,
                          tuning_cache=tplan.TuningCache()).describe()
    assert td["pp"].keys() == jd["pp"].keys()
    assert td["pp"]["tol"] == jd["pp"]["tol"] == 0.2
    assert td["pp"]["basis"] == jd["pp"]["basis"] == "analytic"
    # the same formula over each package's own exact-sweep price
    t = td["pp"]
    assert t["amortized_sweep_s"] == pytest.approx(
        t["exact_fraction"] * (t["exact_sweep_s"] + t["build_s"])
        + (1 - t["exact_fraction"]) * t["correction_sweep_s"])
    assert jplan.plan_sweep(jplan.Problem(shape, 3), strategy if strategy != "pp" else "auto"
                            ).describe()["pp"] == {"enabled": False}
    assert tplan.plan_sweep(tplan.Problem(shape, 3), strategy if strategy != "pp" else "auto"
                            ).describe()["pp"] == {"enabled": False}


def test_tuning_cache_round_trips_pp_rows(tmp_path):
    path = tmp_path / "tune.json"
    problem = tplan.Problem((5, 6, 7), 3, pp_tol=0.1)
    key = tplan.autotune.problem_key(problem)
    tplan.TuningCache(path).put(key, {"nodes": [], "tiles": {},
                                      "pp": {"build_s": 0.003, "correct_sweep_s": 0.001}})
    m = tplan.lookup_measurements(problem, cache=tplan.TuningCache(path))
    assert m.pp_second("build_s") == 0.003 and m.pp_second("correct_sweep_s") == 0.001
    assert m.pp_second("nope") is None
    # the exact problem keys apart from the PP one
    assert tplan.lookup_measurements(tplan.Problem((5, 6, 7), 3),
                                     cache=tplan.TuningCache(path)) is None


def test_tuned_pp_rows_steer_the_autotune_plan():
    x, _ = _planted((8, 6, 4), 3, seed=5)
    cache = tplan.TuningCache()
    entry = tplan.tune(torch.from_numpy(x), 3, cache=cache, budget_ms=None, reps=1, pp_tol=0.1)
    assert entry["pp"]["build_s"] > 0 and entry["pp"]["correct_sweep_s"] > 0
    plan = tplan.plan_sweep(tplan.Problem((8, 6, 4), 3, pp_tol=0.1), "autotune",
                            tuning_cache=cache)
    d = plan.describe()["pp"]
    assert d["basis"] == "measured"
    assert (d["build_s"], d["correction_sweep_s"]) == (entry["pp"]["build_s"],
                                                        entry["pp"]["correct_sweep_s"])
    assert plan.pp == (d["amortized_sweep_s"] < d["exact_sweep_s"])
    # the exact problem of the same tensor was not tuned by a PP tune()
    assert tplan.lookup_measurements(tplan.Problem((8, 6, 4), 3), cache=cache) is None


def test_service_buckets_pp_requests_apart_and_serves_them():
    shape, rank, pp_tol = (10, 8, 6), 3, 0.08
    svc = CPService(batch_size=2, n_iters=8, tol=0.0, strategy="pp", pp_tol=pp_tol,
                    device="cpu")
    exact = CPService(batch_size=2, n_iters=8, tol=0.0, strategy="auto", device="cpu")
    data = [_planted(shape, rank, seed=40 + i) for i in range(3)]
    futs = [svc.submit(x, rank, init_factors=init) for x, init in data]
    plain = exact.submit(data[0][0], rank, init_factors=data[0][1])
    assert futs[0].signature != plain.signature and f"|pp{pp_tol:g}|" in futs[0].signature
    assert "|pp" not in plain.signature
    svc.flush()
    stats = svc.stats()
    assert (stats["completed"], stats["batches"], stats["padded_slots"]) == (3, 2, 1)
    # the first batch is the port's own batched PP cp_als of the same problems
    xb = torch.stack([torch.from_numpy(data[i][0]) for i in range(2)])
    init = [torch.stack([torch.from_numpy(data[i][1][m]) for i in range(2)]) for m in range(3)]
    direct = tplan.cp_als(xb, tplan.plan_sweep(tplan.Problem(shape, rank, batch=2,
                                                             pp_tol=pp_tol), "pp"),
                          n_iters=8, tol=0.0, init_factors=init, sweeps_per_sync=8)
    assert 0 < direct.pp_exact_sweeps < 8
    for i in range(2):
        r = futs[i].result()
        assert r.fit == float(direct.fit[i]) and r.sweeps == 8
        assert all(torch.equal(u, v[i]) for u, v in zip(r.factors, direct.factors))
