"""Serving driver: load a checkpoint (or init), run the batched engine.

Port of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --reduced \\
        --requests 8 --new-tokens 16 [--ckpt-dir /tmp/ckpt] [--device cpu]

The same flags as the reference's, plus ``--device`` (default ``cuda``;
``cpu`` runs on the host).  The parameters are drawn from a generator
seeded 0 on that device, then, with ``--ckpt-dir``, restored from the
latest checkpoint there into the template ``(params, init_opt_state(params))``
(a checkpoint of either package).  The prompts are the reference's: lengths
in [4, 16) and tokens from ``np.random.default_rng(0)``.  Every
architecture is served (an enc-dec model gets the engine's zero frames);
``--dp``/``--tp`` above 1 raise: the sharded LM is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
log = logging.getLogger("repro_torch.launch.serve")


def main(argv=None) -> dict:
    """Run the driver; returns ``{rid: generated tokens}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None, help="restore params from here")
    ap.add_argument("--device", default="cuda", help="where to serve (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import SHARDED_LM
    from repro_torch.models import build_model
    from repro_torch.serve.engine import GenerationConfig, ServeEngine
    from repro_torch.train.optimizer import init_opt_state

    if args.dp * args.tp > 1:
        raise NotImplementedError(f"--dp {args.dp} --tp {args.tp}: {SHARDED_LM}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab=min(cfg.reduced().vocab, 2048))
    device = torch.device(args.device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    params = model.params
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        (params, _), manifest = mgr.restore((params, init_opt_state(params)))
        log.info("restored step %s from %s", manifest["step"], args.ckpt_dir)
    eng = ServeEngine(
        model,
        params,
        GenerationConfig(max_new_tokens=args.new_tokens, temperature=args.temperature),
        batch_size=args.batch_size,
    )
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab, size=int(rng.integers(4, 16))))
    t0 = time.perf_counter()
    results = eng.flush()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in results.values())
    log.info(
        "served %d requests / %d tokens in %.2fs (%.1f tok/s) on %s",
        len(results), total_tokens, dt, total_tokens / dt, device,
    )
    return results


if __name__ == "__main__":
    main()
