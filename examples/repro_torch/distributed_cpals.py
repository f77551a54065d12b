"""Distributed CP-ALS demo: paper Alg. 3 across a device mesh.

Port of ``examples/distributed_cpals.py``.  One process a rank, SPMD: the
tensor is block-distributed over two modes of a ``(--data, --model)``
mesh, each rank runs the local shared-memory MTTKRP on its block and one
deterministic reduction over the contracted modes' axes completes it (an
all-gather summed in rank order, the same bits on every rank).  Rank 0
prints.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
        examples/repro_torch/distributed_cpals.py --device cpu          # 8 gloo ranks
    PYTHONPATH=src torchrun --standalone --nproc-per-node 1 \\
        examples/repro_torch/distributed_cpals.py --data 1 --model 1    # NCCL, one card

``--data * --model`` must equal the world size.  Without a launcher (no
process group and no ``RANK`` in the environment) it starts a world of one
(``launch.mesh.host_world``).
"""

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import CPConfig, cp_als, cp_full, random_factors
from repro_torch.dist.dist_mttkrp import dist_cp_als
from repro_torch.launch.mesh import host_world, make_host_mesh
from repro_torch.plan import Problem, plan_sweep

SHAPE, RANK = (64, 48, 40), 6
MODE_AXES = {0: "data", 1: "model"}
FIT_AGREE = 1e-2  # the reference example's own


def run(mesh, x, *, init_factors=None, iters=60):
    """Plan the sharded sweep, run ``dist_cp_als`` and the single-device
    ``cp_als`` from the same init; returns ``(dist fit, local fit)``."""
    rank0 = dist.get_rank() == 0
    # plan the sharded sweep: per-mode algorithm + predicted collective bytes,
    # plus the cost-argmin executor pick (see docs/repro_torch/distributed.md)
    plan = plan_sweep(Problem.from_tensor(x, RANK, mode_axes=MODE_AXES, mesh=mesh))
    if rank0:
        print(f"  planner picked executor: {plan.executor}")
        for mp in plan.modes:
            print(f"  mode {mp.mode}: {mp.algorithm:12s} "
                  f"collective {mp.cost.collective_bytes/1e3:8.1f} kB/device "
                  f"overlap_eff {mp.cost.predicted_overlap_efficiency:.2f}")

    t0 = time.perf_counter()
    _, _, fit = dist_cp_als(x, rank=RANK, mode_axes=MODE_AXES, mesh=mesh, n_iters=iters,
                            init_factors=init_factors)
    t_dist = time.perf_counter() - t0
    if rank0:
        print(f"distributed CP-ALS: fit={float(fit):.5f} in {t_dist:.2f}s "
              f"(tensor sharded {tuple(mesh.shape)} over modes 0,1)")

    t0 = time.perf_counter()
    st = cp_als(x, CPConfig(rank=RANK, n_iters=iters), init_factors=init_factors)
    t_local = time.perf_counter() - t0
    if rank0:
        print(f"single-device reference: fit={float(st.fit):.5f} in {t_local:.2f}s")
    assert abs(float(fit) - float(st.fit)) < FIT_AGREE
    if rank0:
        print("OK: distributed result matches")
    return float(fit), float(st.fit)


def main(argv=None, *, x=None, init_factors=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=2, help="ranks on the mesh's data axis")
    ap.add_argument("--model", type=int, default=4, help="ranks on the mesh's model axis")
    ap.add_argument("--device", default="cuda", help="where to run (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    with host_world(args.device):
        size = dist.get_world_size()
        if args.data * args.model != size:
            raise SystemExit(f"--data {args.data} x --model {args.model} must equal the "
                             f"world size {size}")
        device = torch.device(args.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        mesh = make_host_mesh(args.data, args.model, device=device.type)
        if dist.get_rank() == 0:
            print(f"ranks: {size} ({device.type})")
        if x is None:  # every rank draws the same tensor from the same seed
            gen = torch.Generator(device=device).manual_seed(args.seed)
            x = cp_full(None, random_factors(gen, SHAPE, RANK, device=device))
        return run(mesh, x.to(device), init_factors=init_factors)


if __name__ == "__main__":
    main()
