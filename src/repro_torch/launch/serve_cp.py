"""CP serving driver: submit a mixed-signature tensor fleet, stream results.

Port of ``repro.launch.serve_cp``::

    PYTHONPATH=src python -m repro_torch.launch.serve_cp --requests 16 \\
        --batch-size 8 --rank 4 [--device cpu] [--tuning-cache /path/cache.json]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve_cp --mesh [--device cpu]

Generates a fleet of small random tensors over two shapes (two signatures:
the scheduler must bucket them into separate dispatches), submits them
all, drains the service, and logs problems/sec plus the serving counters.
``--device`` is where the service runs (default ``cuda``; ``cpu`` runs the
kernels' plain versions); ``--tuning-cache`` names a persistent
:class:`repro_torch.plan.autotune.TuningCache` file to use as the warm-plan
store.  ``--mesh`` serves batch-parallel, one process a rank (a card a
rank on ``cuda``, NCCL; ``gloo`` with ``--device cpu``): the process group
comes from the environment ``torchrun`` sets, the mesh is one axis ``"b"``
over the whole world, every rank submits the same fleet, and the world
size must divide ``--batch-size``.
"""

from __future__ import annotations

import argparse
import logging
import time

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
log = logging.getLogger("repro_torch.launch.serve_cp")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--n-iters", type=int, default=5)
    ap.add_argument("--dim", type=int, default=12, help="edge of the cubic shape")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the batch axis over the ranks of a torchrun world")
    ap.add_argument("--tuning-cache", default=None,
                    help="persistent TuningCache file (the warm-plan store)")
    ap.add_argument("--device", default="cuda", help="where the service runs")
    args = ap.parse_args(argv)

    import torch

    device, mesh = args.device, None
    if args.mesh:
        import os

        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        on_cpu = torch.device(args.device).type == "cpu"
        if not on_cpu:  # one card a rank
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        dist.init_process_group("gloo" if on_cpu else "nccl")
        world = dist.get_world_size()
        mesh = init_device_mesh("cpu" if on_cpu else "cuda", (world,), mesh_dim_names=("b",))
        log.info("rank %d: batch-parallel over %d ranks (%s)", dist.get_rank(), world,
                 dist.get_backend())
    try:
        return _serve(args, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, device, mesh):
    import torch

    from repro_torch.core.tensor_ops import random_tensor
    from repro_torch.plan.autotune import TuningCache
    from repro_torch.serve import CPService

    cache = TuningCache(args.tuning_cache) if args.tuning_cache else None
    svc = CPService(
        batch_size=args.batch_size, n_iters=args.n_iters, tuning_cache=cache, mesh=mesh,
        device=device,
    )
    # two shapes -> two signatures: the scheduler buckets them separately
    shapes = [(args.dim,) * 3, (args.dim, args.dim // 2, args.dim)]
    futures = [
        svc.submit(
            random_tensor(torch.Generator(device=device).manual_seed(i), shapes[i % 2],
                          device=device),
            args.rank,
        )
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    done = svc.flush()
    dt = time.perf_counter() - t0
    assert all(f.done() for f in futures)
    stats = svc.stats()
    fits = [f.result().fit for f in done]
    log.info(
        "served %d problems in %.2fs (%.1f problems/s end-to-end, "
        "%.1f in-dispatch) mean fit %.4f on %s",
        len(done), dt, len(done) / dt, stats["problems_per_s"],
        sum(fits) / len(fits), svc.device,
    )
    log.info(
        "signatures=%d compiles=%d warm_plan_hits=%d batches=%d "
        "occupancy=%.2f padded=%d",
        stats["signatures"], stats["compiles"], stats["warm_plan_hits"],
        stats["batches"], stats["batch_occupancy"], stats["padded_slots"],
    )
    return stats


if __name__ == "__main__":
    main()
