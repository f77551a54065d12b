"""Parity of the port's ``core/cp_layers.py`` with the JAX reference, on the CPU.

CP factors are unique only up to the scaling and order of their columns,
and the two packages draw their seeded inits differently, so these tests
hold the *products* the factors make (``A @ B``, the reconstructed 3-way
tensor) and ``reconstruction_error``, not the factors.  Weights are built
once with numpy from a seed.  The bounds on the products are the
reference's own test bounds (``tests/test_cp_layers.py``): 1e-3 for a
planted low-rank matrix, 1e-2 for a planted expert stack and for
``compress_ffn``; ``reconstruction_error`` on equal inputs is held at the
fp32 tolerance ``rtol=2e-4, atol=2e-5``.

The 2-way ``factorize_linear`` is the first order-2 tensor the planner
meets: its plans are held against the reference's too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jplan
import repro_torch.plan as tplan
from repro.core import cp_layers as jl
from repro_torch.core import cp_layers as tl

TOL = dict(rtol=2e-4, atol=2e-5)


def _lowrank(rng, rows, cols, rank):
    return (rng.standard_normal((rows, rank)) @ rng.standard_normal((rank, cols))).astype(
        np.float32
    )


def _rel(p, q) -> float:
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    return float(np.linalg.norm(p - q) / np.linalg.norm(q))


@pytest.mark.parametrize("strategy", ["auto", "dimtree", "1step", "2step", "fused",
                                      "matrix_free", "einsum"])
def test_order_2_plans_match_the_reference(strategy):
    """An order-2 problem: the same schedule and leaf algorithms (the tree
    candidates collapse to the flat sweep; dimtree is the binary split)."""
    jp = jplan.plan_sweep(jplan.Problem((24, 16), 3), strategy)
    tp = tplan.plan_sweep(tplan.Problem((24, 16), 3), strategy)
    assert tp.resolved_schedule.name == jp.resolved_schedule.name
    assert [n.algorithm for n in tp.nodes] == [n.algorithm for n in jp.nodes]
    assert [s.name for s in tplan.enumerate_schedules(tp.problem)] == [
        s.name for s in jplan.enumerate_schedules(jp.problem)
    ]


def test_factorize_linear_matches_the_reference():
    w = _lowrank(np.random.default_rng(0), 24, 16, 3)
    ja, jb = jl.factorize_linear(jnp.asarray(w), rank=3, n_iters=120)
    ta, tb = tl.factorize_linear(torch.from_numpy(w), rank=3, n_iters=120)
    assert tuple(ta.shape) == (24, 3) and tuple(tb.shape) == (3, 16)
    assert tl.reconstruction_error(torch.from_numpy(w), ta, tb) < 1e-3
    assert _rel((ta @ tb).numpy(), np.asarray(ja @ jb)) < 1e-3


def test_factorize_expert_stack_matches_the_reference():
    rng = np.random.default_rng(2)
    planted = [rng.standard_normal((d, 2)).astype(np.float32) for d in (4, 12, 10)]
    w = np.einsum("er,ir,or->eio", *planted).astype(np.float32)
    je, ja, jb = jl.factorize_expert_stack(jnp.asarray(w), rank=2, n_iters=150)
    te, ta, tb = tl.factorize_expert_stack(torch.from_numpy(w), rank=2, n_iters=150)
    assert [tuple(u.shape) for u in (te, ta, tb)] == [(4, 2), (12, 2), (10, 2)]
    tw = torch.einsum("er,ir,or->eio", te, ta, tb).numpy()
    jw = np.asarray(jnp.einsum("er,ir,or->eio", je, ja, jb))
    assert _rel(tw, w) < 1e-2
    assert _rel(tw, jw) < 1e-2


@pytest.mark.parametrize("shape,rank", [((24, 16), 3), ((9, 30), 5)])
def test_reconstruction_error_matches_the_reference(shape, rank):
    rng = np.random.default_rng(rank)
    w = rng.standard_normal(shape).astype(np.float32)
    a = rng.standard_normal((shape[0], rank)).astype(np.float32)
    b = rng.standard_normal((rank, shape[1])).astype(np.float32)
    got = tl.reconstruction_error(torch.from_numpy(w), torch.from_numpy(a), torch.from_numpy(b))
    assert isinstance(got, float)
    np.testing.assert_allclose(
        got, jl.reconstruction_error(jnp.asarray(w), jnp.asarray(a), jnp.asarray(b)), **TOL
    )


def test_compress_ffn_matches_the_reference():
    rng = np.random.default_rng(5)
    d, f, r = 16, 32, 4
    dense = {"gate": _lowrank(rng, d, f, r), "up": _lowrank(rng, d, f, r),
             "down": _lowrank(rng, f, d, r)}
    jc = jl.compress_ffn({k: jnp.asarray(v) for k, v in dense.items()}, rank=r)
    tc = tl.compress_ffn({k: torch.from_numpy(v) for k, v in dense.items()}, rank=r)
    assert set(tc) == set(jc) == {"gate_a", "gate_b", "up_a", "up_b", "down_a", "down_b"}
    for name, w in dense.items():
        ta, tb = tc[f"{name}_a"], tc[f"{name}_b"]
        assert tuple(ta.shape) == tuple(jc[f"{name}_a"].shape)
        assert tuple(tb.shape) == tuple(jc[f"{name}_b"].shape)
        assert tl.reconstruction_error(torch.from_numpy(w), ta, tb) < 1e-2
        assert _rel((ta @ tb).numpy(), np.asarray(jc[f"{name}_a"] @ jc[f"{name}_b"])) < 1e-2
    assert tl.compress_ffn({"up": torch.from_numpy(dense["up"])}, rank=r).keys() == {"up_a", "up_b"}
