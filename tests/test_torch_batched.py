"""Parity of the port's batched path (``Problem(batch=B)``) with the JAX
reference, on the CPU: batched KRPs, the batched kernels' plain versions
against the Pallas kernels in interpret mode, ``mttkrp_batched``, the
executor's batched nodes, batched plans and batched ``cp_als``.

Inputs are made once with numpy from a seed and handed to both packages;
float32 tolerance ``rtol=2e-4, atol=2e-5`` (the bound of
``tests/test_batched.py::_check_mttkrp_batched``).  Plans are compared with
the port's roofline constants pinned to the reference's.  End-to-end
convergence thresholds of the reference are not used as oracles: runs are
compared sweep by sweep from shared inputs.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.roofline as jroof
import repro.plan as jplan
import repro_torch.plan as tplan
import repro_torch.plan.cost as tcost
from repro.core.mttkrp import mttkrp_batched as j_mttkrp_batched
from repro.core.tensor_ops import tensor_norm as j_tensor_norm
from repro.kernels import fused_mttkrp as jfused
from repro.kernels import matrix_free as jmf
from repro.kernels import ops as jops
from repro_torch.core.mttkrp import mttkrp, mttkrp_batched
from repro_torch.interop import cpstate_from_numpy, cpstate_to_numpy
from repro_torch.kernels import _tiling as ttiling
from repro_torch.kernels import fused_mttkrp as tfused
from repro_torch.kernels import matrix_free as tmf
from repro_torch.kernels import ops as tops
from repro_torch.plan.schedule import ROOT

# the modules (each package's ``core`` exports a function of the same name)
jkrp = importlib.import_module("repro.core.krp")
tkrp = importlib.import_module("repro_torch.core.krp")
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def reference_constants(monkeypatch):
    """Price the port's plans with the reference's roofline constants."""
    monkeypatch.setattr(tcost, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tcost, "HBM_BW", jroof.HBM_BW)


def _batch(shape, rank, batch, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch,) + tuple(shape)).astype(np.float32)
    fs = [rng.standard_normal((batch, d, rank)).astype(np.float32) for d in shape]
    return x, fs


def _j(x, fs):
    return jnp.asarray(x), [jnp.asarray(u) for u in fs]


def _t(x, fs):
    return torch.from_numpy(x), [torch.from_numpy(u) for u in fs]


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **TOL)


def _launches():
    return (tfused.KERNEL.launches, tfused.BATCHED_KERNEL.launches,
            tmf.KERNEL.launches, tmf.BATCHED_KERNEL.launches)


# ---------------------------------------------------------------- batched KRP
@pytest.mark.parametrize("dims", [[4], [3, 5], [2, 3, 4]])
def test_krp_batched_matches_reference(dims):
    rng = np.random.default_rng(len(dims))
    mats = [rng.standard_normal((3, d, 4)).astype(np.float32) for d in dims]
    j = jkrp.krp_batched([jnp.asarray(m) for m in mats])
    t = tkrp.krp_batched([torch.from_numpy(m) for m in mats])
    assert tuple(t.shape) == (3, int(np.prod(dims)), 4)
    _close(j, t)
    for b in range(3):  # per entry, the unbatched KRP
        assert torch.equal(t[b], tkrp.krp([torch.from_numpy(m[b]) for m in mats]))
    _close(jkrp.krp_or_ones_batched([jnp.asarray(m) for m in mats], 3, 4),
           tkrp.krp_or_ones_batched([torch.from_numpy(m) for m in mats], 3, 4))
    _close(jkrp.krp_or_ones_batched([], 3, 4), tkrp.krp_or_ones_batched([], 3, 4))
    with pytest.raises(ValueError):
        tkrp.krp_batched([])


# ------------------------------------------------- batched CP-ALS helpers
def test_batched_cpals_helpers_match_reference():
    """grams, Hadamard, fit, normalisation, tensor_norm(batched=True) and
    random_factors(batch=) with a leading batch axis."""
    from repro.core import cpals as jcpals
    from repro.core import tensor_ops as jto
    from repro_torch.core import cpals as tcpals
    from repro_torch.core import tensor_ops as tto

    shape, rank, batch = (5, 4, 6), 3, 3
    x, fs = _batch(shape, rank, batch, seed=5)
    jx, jf = _j(x, fs)
    tx, tf = _t(x, fs)
    jg, tg = jcpals.grams(jf), tcpals.grams(tf)
    for a, b in zip(jg, tg):
        _close(a, b)
    for n in range(3):
        _close(jcpals.hadamard_except(jg, n), tcpals.hadamard_except(tg, n))
    w = np.random.default_rng(6).uniform(0.5, 2.0, (batch, rank)).astype(np.float32)
    m = np.random.default_rng(7).standard_normal((batch, shape[-1], rank)).astype(np.float32)
    jn, tn = jto.tensor_norm(jx, batched=True), tto.tensor_norm(tx, batched=True)
    assert tuple(tn.shape) == (batch,)
    _close(jn, tn)
    jfit = jcpals.fit_from_last_mttkrp(jg, jnp.asarray(w), jnp.asarray(m), jf[-1], jn)
    tfit = tcpals.fit_from_last_mttkrp(tg, torch.from_numpy(w), torch.from_numpy(m), tf[-1], tn)
    assert tuple(tfit.shape) == (batch,)
    _close(jfit, tfit)
    for it in (0, 1):
        ju, jl = jcpals.normalize_columns(jf[0], it)
        tu, tl = tcpals.normalize_columns(tf[0], it)
        assert tuple(tl.shape) == (batch, rank)
        _close(ju, tu)
        _close(jl, tl)
    gen = torch.Generator().manual_seed(0)
    drawn = tto.random_factors(gen, shape, rank, batch=batch, device="cpu")
    assert [tuple(u.shape) for u in drawn] == [(batch, d, rank) for d in shape]


# ------------------------------------------- plain kernel versions vs Pallas
@pytest.mark.parametrize("pos", [0, 1, 2])
@pytest.mark.parametrize("slabs", [1, 3])
def test_bilinear_batched_plain_matches_pallas_kernel(pos, slabs):
    rng = np.random.default_rng(40 + pos + slabs)
    dims = [6, 5, 7]
    t = rng.standard_normal([slabs] + dims).astype(np.float32)
    ab = [d for k, d in enumerate(dims) if k != pos]
    a = rng.standard_normal((slabs, ab[0], 3)).astype(np.float32)
    b = rng.standard_normal((slabs, ab[1], 3)).astype(np.float32)
    ref = jfused.fused_mttkrp_bilinear_batched(
        jnp.asarray(t), jnp.asarray(a), jnp.asarray(b), pos=pos,
        block_i=dims[pos], block_b=ab[1], block_batch=slabs, interpret=True,
    )
    tt, ta, tb = (torch.from_numpy(v) for v in (t, a, b))
    before = _launches()
    _close(ref, tfused.fused_mttkrp_bilinear_batched(tt, ta, tb, pos=pos))
    assert _launches() == before  # a CPU tensor never reaches a CUDA kernel


@pytest.mark.parametrize("slabs", [1, 3])
@pytest.mark.parametrize("shape", [(5, 7, 6), (3, 4, 5, 6)], ids=["order3", "order4"])
def test_fused_mttkrp_batched_matches_padded_pallas(shape, slabs):
    """Every mode (pos 0, 1 and 2) with ragged dims and a slab count that the
    reference wrapper pads to its blocks; the port pads nothing."""
    x, fs = _batch(shape, 3, slabs, seed=50 + len(shape) + slabs)
    jx, jf = _j(x, fs)
    tx, tf = _t(x, fs)
    before = _launches()
    for n in range(len(shape)):
        ref = jops.fused_mttkrp_batched(
            jx, jf, n, block_i=4, block_b=8, block_batch=2, interpret=True
        )
        out = tops.fused_mttkrp_batched(tx, tf, n)
        assert tuple(out.shape) == (slabs, shape[n], 3)
        _close(ref, out)
    assert _launches() == before


@pytest.mark.parametrize("slabs", [1, 3])
@pytest.mark.parametrize(
    "shape", [(5, 7, 6), (3, 4, 5, 6), (2, 3, 4, 3, 2), (2, 3, 2, 3, 2, 3)],
    ids=["order3", "order4", "order5", "order6"],
)
def test_matrix_free_batched_matches_padded_pallas(shape, slabs):
    x, fs = _batch(shape, 4, slabs, seed=60 + len(shape) + slabs)
    jx, jf = _j(x, fs)
    tx, tf = _t(x, fs)
    before = _launches()
    for n in range(len(shape)):
        ref = jmf.matrix_free_mttkrp_batched(
            jx, jf, n, block_i=4, block_r=4, block_batch=2, interpret=True
        )
        out = tops.matrix_free_mttkrp_batched(tx, tf, n)
        assert tuple(out.shape) == (slabs, shape[n], 4)
        _close(ref, out)
        us = [tf[k] for k in range(len(shape)) if k != n]
        for b in range(slabs):  # each slab is the unbatched fold of that slab
            _close(tmf.matrix_free_kernel_plain(tx[b], [u[b] for u in us], n), out[b])
    assert _launches() == before


def test_batched_kernel_wrappers_reject_bad_operands():
    t = torch.zeros(2, 4, 5, 6)
    with pytest.raises(ValueError):  # slab mismatch
        tfused.fused_mttkrp_bilinear_batched(t, torch.zeros(1, 4, 2), torch.zeros(2, 6, 2), pos=1)
    with pytest.raises(ValueError):  # unbatched operands
        tfused.fused_mttkrp_bilinear_batched(t[0], torch.zeros(4, 2), torch.zeros(6, 2), pos=1)
    x = torch.zeros(2, 3, 4, 5)
    with pytest.raises(ValueError):
        tmf.matrix_free_batched_kernel(x, [torch.zeros(2, 3, 2), torch.zeros(1, 4, 2)], 2)
    with pytest.raises(ValueError):
        tops.matrix_free_mttkrp_batched(x[0], [torch.zeros(3, 2)] * 3, 0)
    with pytest.raises(ValueError):
        tops.fused_mttkrp_batched(x[0], [torch.zeros(3, 2)] * 3, 0)
    with pytest.raises(ValueError):
        ttiling.check_slabs(0)


# ------------------------------------------------------------ mttkrp_batched
@pytest.mark.parametrize(
    "method", ["auto", "1step", "2step", "2step-left", "2step-right", "einsum", "baseline",
               "fused", "matrix_free"],
)
@pytest.mark.parametrize("shape", [(5, 4, 6), (3, 4, 2, 5)], ids=["order3", "order4"])
def test_mttkrp_batched_matches_reference_every_method(shape, method):
    x, fs = _batch(shape, 3, 2, seed=70 + len(shape))
    jx, jf = _j(x, fs)
    tx, tf = _t(x, fs)
    for n in range(len(shape)):
        ref = j_mttkrp_batched(jx, jf, n, method=method)
        out = mttkrp_batched(tx, tf, n, method=method, tiles={"block_batch": 2})
        _close(ref, out)
        # each slab is the unbatched MTTKRP of that slab
        _close(out[1], mttkrp(tx[1], [u[1] for u in tf], n, method="einsum"))


# -------------------------------------------------------------- the executor
@pytest.mark.parametrize("shape", [(4, 5, 3, 6), (3, 4, 5, 2, 3)], ids=["order4", "order5"])
def test_local_executor_batched_nodes_match_reference(shape):
    """Leaf, root range GEMM and partial-to-partial nodes of the chain and
    binary trees, batched, against the reference executor."""
    rank, batch = 3, 2
    x, fs = _batch(shape, rank, batch, seed=80 + len(shape))
    jx, jf = _j(x, fs)
    tx, tf = _t(x, fs)
    jp = jplan.Problem(shape, rank, batch=batch)
    tp = tplan.Problem(shape, rank, batch=batch)
    kinds = set()
    for jsched, tsched in zip(jplan.enumerate_schedules(jp), tplan.enumerate_schedules(tp)):
        jcache, tcache = {ROOT: jx}, {ROOT: tx}
        for jn, tn in zip(jsched.walk(), tsched.walk()):
            jout = jplan.LocalExecutor().contract(jn, jcache[jn.parent], jf, "auto")
            tout = tplan.LocalExecutor().contract(tn, tcache[tn.parent], tf, "auto")
            _close(jout, tout)
            kinds.add((tn.from_root, tn.is_leaf))
            if not tn.is_leaf:
                jcache[jn.id], tcache[tn.id] = jout, tout
    # leaves off the root, range GEMMs off the root, contractions of partials
    assert kinds >= {(True, True), (True, False), (False, True)}


# --------------------------------------------------------- batched planning
BATCHED_PLANS = [((5, 6, 7), 3, 4), ((4, 5, 3, 6), 2, 3), ((225, 200, 200), 10, 8),
                 ((225, 200, 200), 16, 8), ((3, 4, 5, 6, 7), 4, 2)]


@pytest.mark.parametrize("shape,rank,batch", BATCHED_PLANS)
def test_batched_plans_match_reference_at_equal_constants(reference_constants, shape, rank, batch):
    for strategy in ["auto", "autotune", "fused", "matrix_free", "dimtree", "1step",
                     "2step-right", "einsum", "baseline"]:
        jd = jplan.plan_sweep(
            jplan.Problem(shape, rank, batch=batch), strategy, tuning_cache=jplan.TuningCache()
        ).describe()
        td = tplan.plan_sweep(
            tplan.Problem(shape, rank, batch=batch), strategy, tuning_cache=tplan.TuningCache()
        ).describe()
        assert td == jd, strategy
        assert td["batch"] == td["local_batch"] == batch


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 5, 3, 6)])
def test_batched_costs_match_reference(reference_constants, shape):
    jp, tp = jplan.Problem(shape, 3, batch=4), tplan.Problem(shape, 3, batch=4)
    for n in range(len(shape)):
        for alg in tplan.ALGORITHMS:
            assert tplan.mode_cost(tp, n, alg).as_dict() == jplan.mode_cost(jp, n, alg).as_dict()
        # every term of a batch of 4 is 4 times the single tensor's
        one = tplan.mode_cost(tplan.Problem(shape, 3), n, "fused")
        assert tplan.mode_cost(tp, n, "fused").bytes == pytest.approx(4 * one.bytes)
    for jsched, tsched in zip(jplan.enumerate_schedules(jp), tplan.enumerate_schedules(tp)):
        for jn, tn in zip(jsched.walk(), tsched.walk()):
            if tn.from_root and tn.is_leaf:
                continue
            assert tplan.node_cost(tp, tn).as_dict() == jplan.node_cost(jp, jn).as_dict()


def test_sharded_batched_problems_still_raise():
    p = tplan.Problem((4, 5, 6), 2, batch=2, batch_axes=("b",), axis_sizes={"b": 2})
    # executor="auto" on a batch-parallel placement: no reduction to hide or
    # compress, so the plain sharded executor, as the reference picks
    jp0 = jplan.Problem((4, 5, 6), 2, batch=2, batch_axes=("b",), axis_sizes={"b": 2})
    assert tplan.plan_sweep(p).executor == jplan.plan_sweep(
        jp0, tuning_cache=jplan.TuningCache()).executor == "sharded"
    # sharded PP is ported: the batch-parallel placement plans PP with no
    # reduction to price, as the reference does
    tpp = tplan.plan_sweep(dataclasses.replace(p, pp_tol=0.1), "pp", executor="sharded")
    jpp = jplan.plan_sweep(dataclasses.replace(jp0, pp_tol=0.1), "pp", executor="sharded",
                           tuning_cache=jplan.TuningCache())
    assert tpp.pp and jpp.pp and tpp.executor == jpp.executor == "sharded"
    assert tplan.pp_build_cost(tpp.problem).collective_bytes == jplan.pp_build_cost(
        jpp.problem).collective_bytes == 0.0
    jp = jplan.Problem((4, 5, 6), 2, batch=2, batch_axes=("b",), axis_sizes={"b": 2})
    for key in ("flops", "bytes", "collective_bytes"):
        assert tplan.mode_cost(p, 0, "1step").as_dict()[key] == jplan.mode_cost(
            jp, 0, "1step").as_dict()[key]
    # a batched PP problem is ported: it plans and prices PP (one branch a batch)
    pp = tplan.plan_sweep(tplan.Problem((4, 5, 6), 2, batch=2, pp_tol=0.1), "pp")
    assert pp.pp and pp.describe()["pp"]["tol"] == 0.1


# ----------------------------------------------------------- batched cp_als
def _plans(shape, rank, batch, strategy):
    jp = jplan.plan_sweep(jplan.Problem(shape, rank, batch=batch), strategy,
                          tuning_cache=jplan.TuningCache())
    tp = tplan.plan_sweep(tplan.Problem(shape, rank, batch=batch), strategy,
                          tuning_cache=tplan.TuningCache())
    return jp, tp


@pytest.mark.parametrize("strategy", ["auto", "fused", "matrix_free"])
@pytest.mark.parametrize("shape", [(5, 6, 4), (3, 4, 5, 3)], ids=["order3", "order4"])
def test_batched_als_sweeps_match_reference_sweep_by_sweep(reference_constants, strategy, shape):
    rank, batch = 3, 3
    x, init = _batch(shape, rank, batch, seed=90 + len(shape))
    jp, tp = _plans(shape, rank, batch, strategy)
    assert [np_.algorithm for np_ in tp.nodes] == [np_.algorithm for np_ in jp.nodes]
    jx, jf = _j(x, init)
    tx, tf = _t(x, init)
    js = jplan.SweepState(
        x=jx, factors=jf, weights=jnp.ones((batch, rank)),
        norm_x=j_tensor_norm(jx, batched=True), it=jnp.asarray(0),
    )
    ts = tplan.SweepState(
        x=tx, factors=tf, weights=torch.ones(batch, rank),
        norm_x=torch.linalg.vector_norm(tx, dim=tuple(range(1, tx.ndim))), it=0,
    )
    for sweep in range(3):
        js = jplan.als_sweep(jp.problem, jp, jplan.LocalExecutor(), js)
        ts = tplan.als_sweep(tp.problem, tp, tplan.LocalExecutor(), ts)
        for ju, tu in zip(js.factors, ts.factors):
            _close(ju, tu)
        _close(js.weights, ts.weights)
        assert tuple(ts.fit.shape) == (batch,)
        _close(js.fit, ts.fit)
        js.it, ts.it = jnp.asarray(sweep + 1), sweep + 1


@pytest.mark.parametrize("strategy", ["auto", "fused", "matrix_free"])
@pytest.mark.parametrize("shape", [(6, 5, 4), (4, 3, 5, 3)], ids=["order3", "order4"])
def test_batched_cp_als_matches_reference(strategy, shape):
    rank, batch = 2, 3
    x, init = _batch(shape, rank, batch, seed=100 + len(shape))
    jp, tp = _plans(shape, rank, batch, strategy)
    jfits, tfits = [], []
    jst = jplan.cp_als(jnp.asarray(x), jp, n_iters=4, tol=0.0,
                       init_factors=[jnp.asarray(u) for u in init],
                       callback=lambda i, f, s: jfits.append(f))
    tst = tplan.cp_als(torch.from_numpy(x), tp, n_iters=4, tol=0.0,
                       init_factors=[torch.from_numpy(u) for u in init],
                       callback=lambda i, f, s: tfits.append(f))
    np.testing.assert_allclose(jfits, tfits, **TOL)  # batch-mean fit per sweep
    assert tst.it == jst.it == 4
    assert tuple(tst.fit.shape) == (batch,) and tuple(tst.weights.shape) == (batch, rank)
    _close(jst.fit, tst.fit)
    for ju, tu in zip(jst.factors, tst.factors):
        _close(ju, tu)


def test_batched_shared_stop_matches_reference():
    """With tol > 0 both packages stop at the same sweep: the first one at
    which every problem's fit delta is below tol."""
    shape, rank, batch = (6, 5, 4), 2, 3
    x, init = _batch(shape, rank, batch, seed=110)
    jp, tp = _plans(shape, rank, batch, "auto")
    jfits, tfits = [], []
    jst = jplan.cp_als(jnp.asarray(x), jp, n_iters=200, tol=1e-3,
                       init_factors=[jnp.asarray(u) for u in init],
                       callback=lambda i, f, s: jfits.append(f))
    tst = tplan.cp_als(torch.from_numpy(x), tp, n_iters=200, tol=1e-3,
                       init_factors=[torch.from_numpy(u) for u in init],
                       callback=lambda i, f, s: tfits.append(f))
    assert tst.it == jst.it < 200
    np.testing.assert_allclose(jfits, tfits, **TOL)
    _close(jst.fit, tst.fit)


def test_batched_shared_stop_waits_for_every_problem():
    """The port's stop rule, port against port: the batched run stops at the
    latest per-problem stop, and each problem's per-sweep fits equal the
    unbatched run's up to that sweep."""
    shape, rank, batch = (6, 5, 4), 2, 3
    x, init = _batch(shape, rank, batch, seed=111)
    tp = tplan.plan_sweep(tplan.Problem(shape, rank, batch=batch))
    st = tplan.cp_als(torch.from_numpy(x), tp, n_iters=200, tol=1e-3,
                      init_factors=[torch.from_numpy(u) for u in init])
    single = tplan.plan_sweep(tplan.Problem(shape, rank))
    its = []
    for b in range(batch):
        one = tplan.cp_als(torch.from_numpy(x[b]), single, n_iters=200, tol=1e-3,
                           init_factors=[torch.from_numpy(u[b]) for u in init])
        its.append(one.it)
    assert st.it == max(its)


@pytest.mark.parametrize("strategy", ["auto", "fused", "matrix_free", "dimtree"])
def test_each_slab_matches_the_unbatched_run(strategy):
    """Within the port: slab b of a batched run equals the unbatched run on
    tensor b from the same init (one batched launch per mode and sweep)."""
    shape, rank, batch = (5, 4, 3, 6), 3, 3
    x, init = _batch(shape, rank, batch, seed=120)
    bp = tplan.plan_sweep(tplan.Problem(shape, rank, batch=batch), strategy)
    up = tplan.plan_sweep(tplan.Problem(shape, rank), strategy)
    st = tplan.cp_als(torch.from_numpy(x), bp, n_iters=3, tol=0.0,
                      init_factors=[torch.from_numpy(u) for u in init])
    for b in range(batch):
        one = tplan.cp_als(torch.from_numpy(x[b]), up, n_iters=3, tol=0.0,
                           init_factors=[torch.from_numpy(u[b]) for u in init])
        for ub, uo in zip(st.factors, one.factors):
            np.testing.assert_allclose(ub[b].numpy(), uo.numpy(), **TOL)
        np.testing.assert_allclose(float(st.fit[b]), float(one.fit), **TOL)


def test_batched_cp_als_checks_shape_and_draws_batched_init():
    shape, rank, batch = (4, 5, 3), 2, 3
    x, _ = _batch(shape, rank, batch, seed=130)
    tp = tplan.plan_sweep(tplan.Problem(shape, rank, batch=batch))
    with pytest.raises(ValueError, match="x.shape"):
        tplan.cp_als(torch.from_numpy(x[0]), tp)
    a = tplan.cp_als(torch.from_numpy(x), tp, n_iters=2, tol=0.0, seed=5)
    b = tplan.cp_als(torch.from_numpy(x), tp, n_iters=2, tol=0.0, seed=5)
    assert [tuple(u.shape) for u in a.factors] == [(batch, d, rank) for d in shape]
    assert all(torch.equal(u, v) for u, v in zip(a.factors, b.factors))


def test_batched_state_carried_across_packages():
    """Two batched sweeps in JAX, the (B, ...) state carried into the port
    as numpy, two more sweeps in both: the packages agree at tolerance."""
    shape, rank, batch = (5, 4, 6), 3, 2
    x, init = _batch(shape, rank, batch, seed=140)
    jp, tp = _plans(shape, rank, batch, "auto")
    jst = jplan.cp_als(jnp.asarray(x), jp, n_iters=2, tol=0.0,
                       init_factors=[jnp.asarray(u) for u in init])
    carried = cpstate_to_numpy(jst)
    assert carried["fit"].shape == (batch,) and carried["weights"].shape == (batch, rank)
    tst = cpstate_from_numpy(carried["factors"], carried["weights"], fit=carried["fit"],
                             it=carried["it"], device="cpu")
    assert tuple(tst.fit.shape) == (batch,)
    assert tuple(cpstate_from_numpy(carried["factors"], carried["weights"],
                                    device="cpu").fit.shape) == (batch,)
    j2 = jplan.cp_als(jnp.asarray(x), jp, n_iters=2, tol=0.0, init_factors=jst.factors)
    t2 = tplan.cp_als(torch.from_numpy(x), tp, n_iters=2, tol=0.0, init_factors=tst.factors)
    back = cpstate_to_numpy(t2)
    for ju, tu in zip(j2.factors, back["factors"]):
        np.testing.assert_allclose(np.asarray(ju), tu, **TOL)
    np.testing.assert_allclose(np.asarray(j2.fit), back["fit"], **TOL)
