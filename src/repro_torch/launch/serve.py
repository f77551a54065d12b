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
architecture is served (an enc-dec model gets the engine's zero frames).

With ``torch.distributed`` initialized (``--distributed`` starts it from a
launcher's environment unless the caller has), the engine serves on
``make_host_mesh(--dp, --tp)`` over the world (``dp * tp`` must equal the
world size): the parameters are each rank's blocks of the serving layout
(``partition_specs(mesh, drop_fsdp=True)``; a checkpoint is restored onto
that mesh, each rank cutting its blocks), each data group serves its rows
of a batch, and every rank returns every result; every family shards over
``"model"``.  Without a process group ``--dp``/``--tp`` above 1 raise.
"""

from __future__ import annotations

import argparse
import contextlib
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
    ap.add_argument("--distributed", action="store_true",
                    help="call torch.distributed.init_process_group() (multi-host fleet)")
    ap.add_argument("--device", default="cuda", help="where to serve (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptState, init_opt_state

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab=min(cfg.reduced().vocab, 2048))
    mesh, device = meshlib.driver_mesh(args.dp, args.tp, args.device,
                                       distributed=args.distributed)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    params = model.params
    where = None
    if mesh is not None:
        specs = model.partition_specs(mesh, drop_fsdp=True)
        where = {"mesh": mesh, "specs": (specs, OptState((), specs, specs))}
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        (params, _), manifest = mgr.restore((params, init_opt_state(params)), **(where or {}))
        log.info("restored step %s from %s", manifest["step"], args.ckpt_dir)
    elif mesh is not None:
        params = meshlib.shard_tree(params, specs, mesh)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(meshlib.use_mesh(mesh))
        results, dt = _serve(model, params, cfg, args)
    total_tokens = sum(len(v) for v in results.values())
    log.info(
        "served %d requests / %d tokens in %.2fs (%.1f tok/s) on %s",
        len(results), total_tokens, dt, total_tokens / dt, device,
    )
    return results


def _serve(model, params, cfg, args) -> tuple[dict, float]:
    """The driver's requests through a :class:`ServeEngine`; returns the
    results and the seconds of ``flush``."""
    from repro_torch.serve.engine import GenerationConfig, ServeEngine

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
    return results, time.perf_counter() - t0


if __name__ == "__main__":
    main()
