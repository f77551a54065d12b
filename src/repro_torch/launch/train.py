"""Training driver: model + data pipeline + fault-tolerant loop.

Port of ``repro.launch.train``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 50 --batch 8 --seq 128 --reduced [--device cpu]

The same flags as the reference's, plus ``--device`` (default ``cuda``;
``cpu`` trains on the host).  With ``torch.distributed`` initialized
(``--distributed`` calls ``init_process_group`` from the launcher's
environment, as ``torchrun`` sets it, unless the caller already has), the
loop runs on ``make_host_mesh(--dp, --tp)`` over the world (``dp * tp``
must equal the world size; a CUDA rank takes the card ``LOCAL_RANK``):
data parallelism over ``"data"``, tensor and sequence parallelism over
``"model"``.  The data pipeline shards by data group: ``host_id`` is the
rank's ``"data"`` coordinate and ``host_count`` is ``dp``, so the ranks of
one data group read the same block; every family shards over ``"model"``
(the MoE's experts, the SSM's and RG-LRU's channels, the attention's heads
or query rows).  Without a process group, ``--dp`` and ``--tp`` above 1
raise.  The
checkpoints (``--ckpt-dir``, written whole by rank 0) restore in either
package's ``launch.serve --ckpt-dir``.
"""

from __future__ import annotations

import argparse
import contextlib
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

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, MemmapCorpus, SyntheticLM
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab=min(cfg.vocab, 2048))
    mesh, device = meshlib.driver_mesh(args.dp, args.tp, args.device,
                                       distributed=args.distributed)
    host_id = meshlib.dp_coord(mesh)[1] if mesh is not None else 0
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))

    dc = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        host_id=host_id, host_count=args.dp,
    )
    data = MemmapCorpus(args.corpus, dc) if args.corpus else SyntheticLM(dc)

    log.info("mesh {'data': %d, 'model': %d}, arch %s, %d steps on %s", args.dp, args.tp,
             cfg.name, args.steps, device)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(meshlib.use_mesh(mesh))
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
