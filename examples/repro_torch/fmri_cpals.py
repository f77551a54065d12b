"""The paper's neuroimaging application (Sec. 3 / Sec. 5.3.3), synthetic data.

Port of ``examples/fmri_cpals.py``.  Builds a time x subject x region x
region functional-connectivity tensor with planted network components
(rank-1 outer products of temporal envelopes, subject loadings, and
symmetric network maps), then:
  1. runs CP-ALS on the 4-way tensor,
  2. linearizes the symmetric region-region modes (upper triangle, as the
     paper does -- halves the entries) and runs CP-ALS on the 3-way tensor,
  3. reports per-iteration times for the paper's method mix vs the
     reorder-baseline, and the recovered component weights.

The data come from a ``torch.Generator`` seeded ``--seed`` on ``--device``
(not stream-identical to the reference's ``jax.random``); both runs of a
tensor start from the same seeded init.  At the paper's size (``--time 225
--subjects 59 --regions 200 --rank 10``) the 4-way tensor is 2.12 GB and
the 3-way one 1.07 GB in float32.

    PYTHONPATH=src python examples/repro_torch/fmri_cpals.py [--regions 60] [--rank 5] [--device cpu]
"""

import argparse
import math

import torch

from repro_torch.core import CPConfig, cp_als


def synth_fmri(t=120, subjects=30, regions=60, rank=5, seed=0, *, device="cuda", noise=0.05):
    """The planted tensor ``(t, subjects, regions, regions)``, scaled to
    max |x| = 1, plus Gaussian noise of ``noise`` (0.05 in the reference);
    every draw from one generator seeded ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    # temporal envelopes: smooth positive signals
    tt = torch.linspace(0, 8 * math.pi, t, device=device)[:, None]
    phases = torch.rand((1, rank), generator=gen, device=device) * 2 * math.pi
    temporal = 1.0 + torch.sin(tt / (1 + torch.arange(rank, device=device)) + phases)
    subj = torch.nn.functional.softplus(torch.randn((subjects, rank), generator=gen, device=device))
    seeds = torch.randn((regions, rank), generator=gen, device=device)
    networks = torch.einsum("ir,jr->rij", seeds, seeds)  # symmetric maps
    x = torch.einsum("tr,sr,rij->tsij", temporal, subj, networks).contiguous()
    x /= x.abs().max()
    if noise:
        x.add_(torch.randn(x.shape, generator=gen, device=device), alpha=noise)
    return x


def run(x, rank, label, method="auto", iters=15, *, init_factors=None):
    """CP-ALS of ``x`` through ``core.cp_als``; prints the fit and the best
    per-iteration seconds after the first; returns ``(state, per_iter)``."""
    times = []
    st = cp_als(
        x,
        CPConfig(rank=rank, n_iters=iters, tol=1e-6, method=method),
        init_factors=init_factors,
        callback=lambda it, fit, dt: times.append(dt),
    )
    per_iter = min(times[1:]) if len(times) > 1 else times[0]
    print(
        f"  {label:28s} fit={float(st.fit):.4f}  per-iter={per_iter*1e3:8.3f} ms"
        f"  ({st.it} sweeps)"
    )
    return st, per_iter


def linearize(x4):
    """The upper triangle of the two symmetric region modes as one mode:
    ``(t, s, r, r) -> (t, s, r (r + 1) / 2)``."""
    r = x4.shape[-1]
    iu = torch.triu_indices(r, r, device=x4.device)
    return x4[:, :, iu[0], iu[1]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--regions", type=int, default=60)
    ap.add_argument("--subjects", type=int, default=30)
    ap.add_argument("--time", type=int, default=120)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="where to run (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    x4 = synth_fmri(args.time, args.subjects, args.regions, args.rank, args.seed,
                    device=args.device)
    print(f"4-way tensor {tuple(x4.shape)} ({x4.numel():,} entries) on {x4.device}")
    st4, t_auto = run(x4, args.rank, "4D paper methods (auto)")
    st4b, t_base = run(x4, args.rank, "4D reorder-baseline", method="baseline")
    print(f"  4D speedup over baseline: {t_base / t_auto:.2f}x")

    # linearize symmetric region modes (paper: halves entries, 3-way tensor)
    x3 = linearize(x4)
    del x4
    print(f"3-way linearized tensor {tuple(x3.shape)}")
    st3, t3_auto = run(x3, args.rank, "3D paper methods (auto)")
    st3b, t3_base = run(x3, args.rank, "3D reorder-baseline", method="baseline")
    print(f"  3D speedup over baseline: {t3_base / t3_auto:.2f}x")

    # component summary: the weights are the components' energies
    w = torch.sort(st3.weights.cpu(), descending=True).values[: args.rank]
    print(f"recovered component weights: {[round(float(v), 3) for v in w]}")
    return {"4D": (st4, t_auto, st4b, t_base), "3D": (st3, t3_auto, st3b, t3_base)}


if __name__ == "__main__":
    main()
