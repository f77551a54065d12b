"""Quickstart: CP decomposition of a dense tensor with the paper's MTTKRP.

Port of ``examples/quickstart.py``.  Builds a rank-4 planted tensor + 5%
noise, plans the sweep through the ``Problem -> SweepPlan -> Executor``
front door (the planner argmins over contraction schedules and, inside
each, over the paper's Sec. 5.3.3 method mix, against the port's nominal
H100 roofline constants), runs CP-ALS, prints the fit trajectory and
per-iteration timing, and cross-checks the fused MTTKRP against the einsum
oracle on one mode.  On the card the fused MTTKRP launches the port's CUDA
kernel (``fused_mttkrp_bilinear_f32``); on the CPU it takes the kernel's
plain PyTorch version.

    PYTHONPATH=src python examples/repro_torch/quickstart.py [--device cpu] [--seed 0]
"""

import argparse

import torch

from repro_torch.core import CPConfig, cp_als, cp_full, mttkrp_einsum, random_factors
from repro_torch.kernels import fused_mttkrp, ops
from repro_torch.plan import Problem, plan_sweep

SHAPE, RANK = (60, 48, 36, 24), 4
FIT_BOUND = 0.95  # the reference example's own
ERR_BOUND = 1e-2  # the reference example's own, on max |kernel - oracle|


def planted_tensor(shape=SHAPE, rank=RANK, *, seed=0, device="cuda"):
    """A rank-``rank`` CP tensor from a generator seeded ``seed`` on
    ``device``, plus Gaussian noise of 5% of its standard deviation."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = cp_full(None, random_factors(gen, shape, rank, device=device))
    return x + 0.05 * x.std() * torch.randn(x.shape, generator=gen, device=device)


def fused_check(x, factors, n=1):
    """Mode-``n`` MTTKRP through ``ops.fused_mttkrp`` and its max abs error
    against ``mttkrp_einsum``: ``(m_kernel, err)``."""
    m_kernel = ops.fused_mttkrp(x, factors, n)
    err = float((m_kernel - mttkrp_einsum(x, factors, n)).abs().max())
    return m_kernel, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where to run (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    x = planted_tensor(seed=args.seed, device=args.device)
    print(f"tensor {SHAPE}, planted rank {RANK}, noise 5% of signal std, on {x.device}")

    # the front door: plan the sweep, see what the cost model picked per mode
    plan = plan_sweep(Problem.from_tensor(x, RANK))
    print(f"  schedule {plan.resolved_schedule.name}, executor {plan.executor}")
    for mp in plan.modes:
        print(f"  mode {mp.mode}: {mp.algorithm:12s} "
              f"predicted {mp.cost.predicted_s*1e6:8.3f} us "
              f"({mp.cost.flops:.2e} flops, {mp.cost.bytes:.2e} B)")

    history = []
    state = cp_als(
        x,
        CPConfig(rank=RANK, n_iters=40, tol=1e-7, method="auto"),
        callback=lambda it, fit, dt: history.append((it, fit, dt)),
    )
    for it, fit, dt in history[:3] + history[-2:]:
        print(f"  iter {it:2d}  fit={fit:.6f}  {dt*1e3:7.1f} ms")
    print(f"final fit {float(state.fit):.6f} after {state.it} sweeps")
    assert float(state.fit) > FIT_BOUND

    # the fused MTTKRP (the CUDA kernel on the card) against the oracle
    before = fused_mttkrp.KERNEL.launches
    _, err = fused_check(x, state.factors, 1)
    launches = fused_mttkrp.KERNEL.launches - before
    print(f"fused MTTKRP max|err| vs einsum oracle: {err:.2e} "
          f"(bound {ERR_BOUND:g}); {fused_mttkrp.KERNEL.symbol} launches {launches}")
    assert err < ERR_BOUND
    print("OK")
    return state, err, launches


if __name__ == "__main__":
    main()
