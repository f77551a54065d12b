"""Parity of the port's legacy CP-ALS wrappers (``core.cpals.CPConfig`` /
``als_sweep`` / ``cp_als``, ``core.dimtree.dimtree_sweep`` /
``mttkrp_from_partial``, ``plan.legacy_sweep``) with the JAX reference, on
the CPU.

Inputs are made once with numpy from a seed and given to both packages;
fp32 results are compared at ``rtol=2e-4, atol=2e-5``.  Bitwise claims hold
only port against port: each wrapper is the sweep engine under the plan it
builds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.cpals as jcpals
import repro.core.dimtree as jdimtree
import repro_torch.core as tcore
import repro_torch.core.cpals as tcpals
import repro_torch.core.dimtree as tdimtree
import repro_torch.plan as tplan
from repro.core.tensor_ops import tensor_norm as jnorm
from repro_torch.core.tensor_ops import tensor_norm as tnorm
from repro_torch.interop import cpstate_from_numpy, cpstate_to_numpy

TOL = dict(rtol=2e-4, atol=2e-5)
METHODS = ["auto", "1step", "2step", "fused", "matrix_free", "einsum", "dimtree"]


def _data(shape, rank, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    init = [rng.standard_normal((d, rank)).astype(np.float32) for d in shape]
    return x, init


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **TOL)


def _sweep_args(x, init, rank, pkg):
    """``(x, factors, weights, norm_x)`` of a first legacy sweep in one
    package."""
    if pkg == "jax":
        xj = jnp.asarray(x)
        return xj, [jnp.asarray(u) for u in init], jnp.ones((rank,), jnp.float32), jnorm(xj)
    xt = torch.from_numpy(x)
    return xt, [torch.from_numpy(u) for u in init], torch.ones(rank), tnorm(xt)


def test_cpconfig_and_cpstate_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcpals.CPConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcpals.CPConfig)]
    assert tf == jf
    assert tcore.CPConfig(rank=4) == tcpals.CPConfig(4, 50, 1e-5, "auto", 0, True, True)
    assert [f.name for f in dataclasses.fields(tcpals.CPState)] == [
        f.name for f in dataclasses.fields(jcpals.CPState)
    ]
    st = tcpals.CPState(factors=[], weights=torch.ones(2), fit=torch.tensor(0.5))
    assert st.pp_exact_sweeps is None
    got = cpstate_to_numpy(cpstate_from_numpy([np.ones((3, 2), np.float32)], np.ones(2),
                                              it=4, pp_exact_sweeps=2, device="cpu"))
    assert got["it"] == 4 and got["pp_exact_sweeps"] == 2
    assert {"CPConfig", "cp_als"} <= set(tcore.__all__)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", [(6, 5, 7), (5, 4, 3, 6)])
def test_legacy_cp_als_matches_reference(shape, method):
    rank = 3
    x, init = _data(shape, rank, seed=1)
    jfits, tfits = [], []
    cfg = dict(rank=rank, n_iters=5, tol=0.0, method=method)
    j = jcore.cp_als(jnp.asarray(x), jcore.CPConfig(**cfg),
                     init_factors=[jnp.asarray(u) for u in init],
                     callback=lambda i, f, s: jfits.append(f))
    t = tcore.cp_als(torch.from_numpy(x), tcore.CPConfig(**cfg),
                     init_factors=[torch.from_numpy(u) for u in init],
                     callback=lambda i, f, s: tfits.append(f))
    assert t.it == j.it == 5 and t.pp_exact_sweeps is j.pp_exact_sweeps is None
    np.testing.assert_allclose(jfits, tfits, **TOL)
    for ju, tu in zip(j.factors, t.factors):
        _close(ju, tu)
    _close(j.weights, t.weights)


def test_legacy_cp_als_converges_and_seeds_like_the_engine():
    x, _ = _data((4, 5, 6), 2, seed=2)
    xt = torch.from_numpy(x)
    a = tcore.cp_als(xt, tcore.CPConfig(rank=2, n_iters=50, tol=1e-3, seed=3))
    b = tplan.cp_als(xt, tplan.plan_sweep(tplan.Problem.from_tensor(xt, 2)), n_iters=50,
                     tol=1e-3, seed=3)
    assert a.it == b.it < 50
    assert all(torch.equal(u, v) for u, v in zip(a.factors, b.factors))


@pytest.mark.parametrize("method", METHODS)
def test_legacy_cp_als_is_the_engine_bitwise(method):
    shape, rank = (5, 4, 3, 6), 3
    x, init = _data(shape, rank, seed=3)
    xt = torch.from_numpy(x)
    fits = {"legacy": [], "engine": []}
    a = tcore.cp_als(xt, tcore.CPConfig(rank=rank, n_iters=4, tol=0.0, method=method,
                                        normalize=False),
                     init_factors=[torch.from_numpy(u) for u in init],
                     callback=lambda i, f, s: fits["legacy"].append(f))
    plan = tplan.plan_sweep(tplan.Problem.from_tensor(xt, rank), method, normalize=False)
    b = tplan.cp_als(xt, plan, n_iters=4, tol=0.0,
                     init_factors=[torch.from_numpy(u) for u in init],
                     callback=lambda i, f, s: fits["engine"].append(f))
    assert fits["legacy"] == fits["engine"]
    assert all(torch.equal(u, v) for u, v in zip(a.factors, b.factors))
    assert torch.equal(a.weights, b.weights)


@pytest.mark.parametrize("method", METHODS[:-1])
@pytest.mark.parametrize("normalize", [True, False])
def test_legacy_als_sweep_matches_reference_and_engine(method, normalize):
    shape, rank = (6, 5, 4, 3), 3
    x, init = _data(shape, rank, seed=4)
    jx, jfs, jw, jn = _sweep_args(x, init, rank, "jax")
    tx, tfs, tw, tn = _sweep_args(x, init, rank, "torch")
    for it in (0, 1):
        jout = jcpals.als_sweep(jx, jfs, jw, jn, it, method, normalize)
        tout = tcpals.als_sweep(tx, tfs, tw, tn, it, method, normalize)
        for ju, tu in zip(jout[0], tout[0]):
            _close(ju, tu)
        _close(jout[1], tout[1])
        _close(jout[2], tout[2])
        # port against port: the engine under the flat plan for this method
        plan = tplan.plan_sweep(tplan.Problem.from_tensor(tx, rank), method,
                                normalize=normalize, schedule="flat")
        st = tplan.als_sweep(plan.problem, plan, tplan.LocalExecutor(), tplan.SweepState(
            x=tx, factors=tfs, weights=tw, norm_x=tn, it=it))
        assert all(torch.equal(u, v) for u, v in zip(tout[0], st.factors))
        assert torch.equal(tout[1], st.weights) and torch.equal(tout[2], st.fit)
        assert tcpals.als_sweep(tx, tfs, tw, tn, torch.tensor(it), method, normalize)[2] == tout[2]
        jfs, jw, tfs, tw = jout[0], jout[1], tout[0], tout[1]


@pytest.mark.parametrize(
    "shape,split",
    [((6, 5, 4, 3), s) for s in (None, 1, 2, 3)] + [((5, 6, 7), s) for s in (None, 1, 2)],
)
def test_dimtree_sweep_matches_reference_and_engine(shape, split):
    rank = 3
    x, init = _data(shape, rank, seed=5)
    jx, jfs, jw, jn = _sweep_args(x, init, rank, "jax")
    tx, tfs, tw, tn = _sweep_args(x, init, rank, "torch")
    jout = jdimtree.dimtree_sweep(jx, jfs, jw, jn, jnp.asarray(0), split=split)
    tout = tdimtree.dimtree_sweep(tx, tfs, tw, tn, 0, split=split)
    for ju, tu in zip(jout[0], tout[0]):
        _close(ju, tu)
    _close(jout[1], tout[1])
    _close(jout[2], tout[2])
    # the same iterates as the flat sweep, and the engine's binary plan bitwise
    flat = tcpals.als_sweep(tx, tfs, tw, tn, 0, "einsum", True)
    for u, v in zip(flat[0], tout[0]):
        np.testing.assert_allclose(u.numpy(), v.numpy(), **TOL)
    plan = tplan.plan_sweep(tplan.Problem.from_tensor(tx, rank), "dimtree", split=split)
    st = tplan.als_sweep(plan.problem, plan, tplan.LocalExecutor(), tplan.SweepState(
        x=tx, factors=tfs, weights=tw, norm_x=tn, it=0))
    assert plan.kind == "dimtree"
    assert all(torch.equal(u, v) for u, v in zip(tout[0], st.factors))
    assert torch.equal(tout[2], st.fit)


@pytest.mark.parametrize("order,pos", [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2), (4, 2)])
def test_mttkrp_from_partial_matches_reference(order, pos):
    rng = np.random.default_rng(order * 10 + pos)
    dims = (5, 4, 3, 6)[:order]
    t = rng.standard_normal(dims + (3,)).astype(np.float32)
    sibs = [rng.standard_normal((d, 3)).astype(np.float32) for k, d in enumerate(dims)
            if k != pos]
    j = jdimtree.mttkrp_from_partial(jnp.asarray(t), [jnp.asarray(s) for s in sibs], pos)
    out = tdimtree.mttkrp_from_partial(torch.from_numpy(t), [torch.from_numpy(s) for s in sibs],
                                       pos)
    assert tuple(out.shape) == (dims[pos], 3)
    _close(j, out)
    # a leaf off a partial: the engine's contract_from_partial over the same modes
    others = {k: torch.from_numpy(s) for k, s in zip([k for k in range(order) if k != pos], sibs)}
    assert torch.allclose(out, tdimtree.contract_from_partial(torch.from_numpy(t), others, pos,
                                                              pos + 1, 0))


def test_legacy_sweep_refuses_sharded_calls_and_exports():
    x, init = _data((4, 5, 6), 2, seed=6)
    tx, tfs, tw, tn = _sweep_args(x, init, 2, "torch")
    # sharded legacy sweeps run on a DeviceMesh (tests/test_torch_dist.py); a
    # mapped mode without a mesh, or on a mesh without its axis, is refused
    # with the reference's ValueError
    import types

    import repro.plan as jplan

    jx, jfs, jw, jn = _sweep_args(x, init, 2, "jax")
    with pytest.raises(ValueError, match="no size known for mesh axis 'x'") as terr:
        tplan.legacy_sweep(tx, tfs, tw, tn, 0, strategy="auto", mode_axes={0: "x"})
    with pytest.raises(ValueError) as jerr:
        jplan.legacy_sweep(jx, jfs, jw, jn, 0, strategy="auto", mode_axes={0: "x"})
    assert str(terr.value) == str(jerr.value)
    other = types.SimpleNamespace(mesh_dim_names=("y",), shape=(2,))
    with pytest.raises(ValueError, match="no size known for mesh axis 'x'"):
        tplan.legacy_sweep(tx, tfs, tw, tn, 0, strategy="auto", mode_axes={0: "x"}, mesh=other)
    out = tplan.legacy_sweep(tx, tfs, tw, tn, 0, strategy="einsum")
    assert len(out) == 3 and tuple(out[1].shape) == (2,)
    for name in ("legacy_sweep", "pp_pairs", "PPPair", "PPState", "PP_EXACT_FRACTION",
                 "pp_build_cost", "pp_correction_cost", "pp_amortized_cost"):
        assert name in tplan.__all__ and name in jplan.__all__


def test_dimtree_sweep_takes_a_strided_tensor_as_the_reference_does():
    """The tree's root GEMMs flatten the tensor: a strided (permuted) one is
    copied, not refused, and sweeps like its contiguous copy."""
    rank = 3
    x, _ = _data((5, 6, 4, 3), rank, seed=7)
    xp = np.ascontiguousarray(x.transpose(1, 0, 2, 3))
    _, init = _data(xp.shape, rank, seed=8)
    jx, jfs, jw, jn = _sweep_args(xp, init, rank, "jax")
    strided = torch.from_numpy(x).permute(1, 0, 2, 3)
    assert not strided.is_contiguous()
    tfs, tw = [torch.from_numpy(u) for u in init], torch.ones(rank)
    tout = tdimtree.dimtree_sweep(strided, tfs, tw, tnorm(strided), 0)
    jout = jdimtree.dimtree_sweep(jnp.asarray(x).transpose(1, 0, 2, 3), jfs, jw, jn, 0)
    for ju, tu in zip(jout[0], tout[0]):
        _close(ju, tu)
    dense = tdimtree.dimtree_sweep(torch.from_numpy(xp), tfs, tw, tnorm(torch.from_numpy(xp)), 0)
    assert all(torch.equal(u, v) for u, v in zip(dense[0], tout[0]))
