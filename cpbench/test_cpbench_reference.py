"""CPU tests of the yardstick's plain side: the float64 ALS, TF32 rounding
and the seeded data synthesis."""

from __future__ import annotations

import math

import pytest
import torch

from cpbench.reference import als, synth


def _planted(shape, rank, gen):
    factors = [torch.randn((d, rank), generator=gen, dtype=torch.float64) for d in shape]
    letters = "abde"[: len(shape)]
    spec = ",".join(f"{x}c" for x in letters) + "->" + letters
    return torch.einsum(spec, *factors), factors


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 3, 5, 6)])
def test_mttkrp_is_the_tensor_contracted_with_every_other_factor(shape):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    fs = [torch.randn((d, 3), generator=gen, dtype=torch.float64) for d in shape]
    letters = "abde"[: len(shape)]
    con = als._Contract("float64")
    for n in range(len(shape)):
        others = [k for k in range(len(shape)) if k != n]
        spec = letters + "," + ",".join(f"{letters[k]}c" for k in others) + f"->{letters[n]}c"
        want = torch.einsum(spec, x, *(fs[k] for k in others))
        torch.testing.assert_close(als.mttkrp(x, fs, n, con), want, rtol=1e-12, atol=1e-12)


def test_als_recovers_a_planted_tensor():
    gen = torch.Generator().manual_seed(2)
    x, factors = _planted((9, 8, 7, 6), 3, gen)
    init = [u + 0.1 * torch.randn(u.shape, generator=gen, dtype=torch.float64) for u in factors]
    us, weights, fits = als.cp_als(x, init, 30)
    assert len(fits) == 30 and fits[-1] > 1 - 1e-8
    letters = "abde"
    model = torch.einsum("c," + ",".join(f"{x}c" for x in letters) + "->" + letters,
                         weights, *us)
    torch.testing.assert_close(model, x, rtol=1e-6, atol=1e-6)


def test_als_is_the_ports_algorithm():
    """The port run in float64 on the CPU follows the reference sweep for sweep:
    the same update, normalisation, weights and fit."""
    from repro_torch.plan import Problem, cp_als, plan_sweep

    gen = torch.Generator().manual_seed(3)
    x = synth.fmri_tensor(gen, (12, 5, 6, 6), 3, 0.05, "cpu").double()
    init = [torch.randn((d, 3), generator=gen, dtype=torch.float64) for d in x.shape]
    st = cp_als(x, plan_sweep(Problem.from_tensor(x, 3), strategy="auto"), n_iters=6,
                tol=0.0, init_factors=init)
    us, weights, fits = als.cp_als(x, init, 6, stated=torch.float64)
    for p, r in zip(list(st.factors) + [st.weights], us + [weights]):
        torch.testing.assert_close(p, r, rtol=1e-9, atol=1e-9)
    # the port takes the tensor's norm in float32 whatever its dtype
    assert float(st.fit) == pytest.approx(fits[-1], abs=1e-6)


def test_precisions_differ_as_their_rounding():
    gen = torch.Generator().manual_seed(4)
    x = synth.fmri_tensor(gen, (12, 5, 6, 6), 3, 0.05, "cpu")
    init = [torch.randn((d, 3), generator=gen) for d in x.shape]
    ref = als.cp_als(x, init, 5)
    gap = {p: max(float((a.double() - b).norm() / b.norm()) for a, b in
                  zip(als.cp_als(x, init, 5, p)[0], ref[0])) for p in ("float32", "tf32")}
    assert gap["tf32"] > 30 * gap["float32"]
    with pytest.raises(ValueError):
        als.cp_als(x, init, 5, "bfloat16")


def test_update_is_the_pseudo_inverse_with_the_stated_cutoff():
    """Two equal initial columns make ``H`` singular: the update keeps them
    equal and finite, as the port's does, where a solve would not."""
    from repro_torch.plan import Problem, cp_als, plan_sweep

    assert als.pinv_rtol(10, torch.float32) == pytest.approx(100 * 2.0**-23)
    gen = torch.Generator().manual_seed(6)
    x = synth.fmri_tensor(gen, (12, 5, 6, 6), 3, 0.05, "cpu")
    init = [torch.randn((d, 3), generator=gen) for d in x.shape]
    for u in init:
        u[:, 2] = u[:, 1]
    us, weights, fits = als.cp_als(x, init, 4)
    assert all(torch.isfinite(u).all() for u in us) and math.isfinite(fits[-1])
    assert all(torch.allclose(u[:, 1], u[:, 2], rtol=1e-9, atol=1e-12) for u in us)
    st = cp_als(x, plan_sweep(Problem.from_tensor(x, 3), strategy="auto"), n_iters=4,
                tol=0.0, init_factors=init)
    assert float(st.fit) == pytest.approx(fits[-1], abs=1e-4)


def test_tf32_keeps_ten_mantissa_bits_ties_to_even():
    u = 2.0 ** -10
    t = torch.tensor([1.0, 1 + u / 2, 1 + 3 * u / 2, 1 + u / 2 + 2**-20, -(1 + 3 * u / 2), 3.0])
    got = als.to_tf32(t).tolist()
    assert got == [1.0, 1.0, 1 + 2 * u, 1 + u, -(1 + 2 * u), 3.0]
    r = torch.randn(10000, generator=torch.Generator().manual_seed(5))
    assert float(((als.to_tf32(r) - r) / r).abs().max()) <= 2.0 ** -11


def test_synthesis_is_made_from_the_seed():
    def make(seed):
        gen = torch.Generator().manual_seed(synth.derived_seed(seed, 0))
        return synth.fmri_tensor(gen, (10, 4, 6, 6), 3, 0.05, "cpu")

    big = 2**31 + 7
    a, b, c = make(big), make(big), make(big + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (10, 4, 6, 6) and math.isclose(float(a.abs().max()), 1.0, abs_tol=0.3)
    s = synth.subjects(a, 1)
    assert s.is_contiguous() and s.shape == (4, 10, 6, 6)
    assert all(torch.equal(s[i], a[:, i]) for i in range(4))
    assert 0 <= synth.derived_seed(-5, 3) < 2**63
