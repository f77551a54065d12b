"""CP serving driver: submit a mixed-signature tensor fleet, stream results.

Port of ``repro.launch.serve_cp``::

    PYTHONPATH=src python -m repro_torch.launch.serve_cp --requests 16 \\
        --batch-size 8 --rank 4 [--device cpu] [--tuning-cache /path/cache.json]

Generates a fleet of small random tensors over two shapes (two signatures:
the scheduler must bucket them into separate dispatches), submits them
all, drains the service, and logs problems/sec plus the serving counters.
``--device`` is where the service runs (default ``cuda``; ``cpu`` runs the
kernels' plain versions); ``--tuning-cache`` names a persistent
:class:`repro_torch.plan.autotune.TuningCache` file to use as the warm-plan
store.  ``--mesh`` (batch-parallel sharding) comes with the distribution
slice of the port and raises ``NotImplementedError``.
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
                    help="shard the batch axis over all attached devices")
    ap.add_argument("--tuning-cache", default=None,
                    help="persistent TuningCache file (the warm-plan store)")
    ap.add_argument("--device", default="cuda", help="where the service runs")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.tensor_ops import random_tensor
    from repro_torch.plan.autotune import TuningCache
    from repro_torch.serve import CPService

    if args.mesh:
        raise NotImplementedError(
            "--mesh (batch-parallel serving) comes with the distribution slice of the port"
        )
    cache = TuningCache(args.tuning_cache) if args.tuning_cache else None
    svc = CPService(
        batch_size=args.batch_size, n_iters=args.n_iters, tuning_cache=cache,
        device=args.device,
    )
    # two shapes -> two signatures: the scheduler buckets them separately
    shapes = [(args.dim,) * 3, (args.dim, args.dim // 2, args.dim)]
    futures = [
        svc.submit(
            random_tensor(torch.Generator(device=args.device).manual_seed(i), shapes[i % 2],
                          device=args.device),
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
