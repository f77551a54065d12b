"""Training driver: model + data pipeline + fault-tolerant loop.

Port of ``repro.launch.train``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 50 --batch 8 --seq 128 --reduced [--device cpu]

The same flags as the reference's, plus ``--device`` (default ``cuda``;
``cpu`` trains on the host).  The data pipeline shards by host:
``host_id``/``host_count`` are the rank and world size of
``torch.distributed`` when it is initialized (``--distributed`` calls
``init_process_group`` from the launcher's environment, as ``torchrun``
sets it), else 0 and 1.  ``--dp``/``--tp`` above 1, or a world of more than
one rank, raise: the sharded LM is not ported yet.  The checkpoints
(``--ckpt-dir``) restore in either package's ``launch.serve --ckpt-dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
log = logging.getLogger("repro_torch.launch.train")


def main(argv=None):
    """Run the driver; returns the loop's ``LoopResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--corpus", default=None, help="memmap token .bin (else synthetic)")
    ap.add_argument("--distributed", action="store_true",
                    help="call torch.distributed.init_process_group() (multi-host fleet)")
    ap.add_argument("--device", default="cuda", help="where to train (default cuda)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, MemmapCorpus, SyntheticLM
    from repro_torch.launch.mesh import SHARDED_LM
    from repro_torch.models import build_model
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import OptConfig

    if args.distributed:  # pragma: no cover -- real fleet only
        dist.init_process_group()
    host_id, host_count = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() \
        else (0, 1)
    if args.dp * args.tp > 1 or host_count > 1:
        raise NotImplementedError(f"--dp {args.dp} --tp {args.tp} on {host_count} ranks: "
                                  f"{SHARDED_LM}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab=min(cfg.vocab, 2048))
    device = torch.device(args.device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))

    dc = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        host_id=host_id, host_count=host_count,
    )
    data = MemmapCorpus(args.corpus, dc) if args.corpus else SyntheticLM(dc)

    log.info("mesh {'data': %d, 'model': %d}, arch %s, %d steps on %s", args.dp, args.tp,
             cfg.name, args.steps, device)
    result = train_loop(
        model,
        data,
        OptConfig(lr=args.lr, total_steps=max(args.steps, 100)),
        LoopConfig(
            total_steps=args.steps,
            ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
            accum_steps=args.accum,
        ),
    )
    log.info(
        "done: step=%d final_loss=%.4f failures=%d stragglers=%s",
        result.step,
        result.metrics_history[-1]["loss"],
        result.failures,
        result.straggler_steps,
    )
    return result


if __name__ == "__main__":
    main()
