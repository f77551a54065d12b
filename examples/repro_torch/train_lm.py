"""End-to-end training driver: train a small LM for a few hundred steps.

Port of ``examples/train_lm.py``.  Any of the 10 assigned architectures is
selectable with ``--arch`` (reduced to a small width by default;
``--width/--layers/--vocab`` override).  Exercises the full substrate:
data pipeline -> train loop with fault-tolerant checkpointing -> metrics,
on a ``(1, 1)`` mesh (a world of one unless a launcher started one).
The default (~40 steps, ~13M params) finishes in a few minutes on one CPU
core; ``--steps 300 --width 512`` approximates the "~100M model for a few
hundred steps" driver on a card.

    PYTHONPATH=src python examples/repro_torch/train_lm.py --arch olmo-1b --steps 40 [--device cpu]
"""

import argparse
import dataclasses
import logging
import os
import tempfile

import torch

from repro_torch.analysis.flops import param_count
from repro_torch.configs import get_config, list_archs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")


def make_config(arch, width=256, layers=4, vocab=2048):
    """The reference example's config: ``arch`` reduced, then set to
    ``width``, ``layers`` (at least the block pattern's length) and
    ``vocab``, with heads, FFN, expert, LRU and ``dt_rank`` widths derived
    from ``width``."""
    base = get_config(arch).reduced()
    return dataclasses.replace(
        base,
        d_model=width,
        n_layers=max(layers, len(base.block_pattern) or 1),
        n_heads=max(4, width // 64),
        n_kv_heads=max(2, width // 128),
        head_dim=64,
        d_ff=width * 4,
        d_ff_expert=width * 2 if base.n_experts else 0,
        d_ff_shared=width * 2 if base.d_ff_shared else 0,
        lru_width=width if base.lru_width else 0,
        dt_rank=max(8, width // 16),
        vocab=vocab,
    )


def main(argv=None):
    """Train; returns the loop's ``LoopResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="where to train (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = make_config(args.arch, args.width, args.layers, args.vocab)
    device = torch.device(args.device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))
    n_params = param_count(cfg)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} on {device}")

    data = SyntheticLM(
        DataConfig(vocab=args.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    )
    with meshlib.host_world(device), \
            meshlib.use_mesh(meshlib.make_host_mesh(1, 1, device=device.type)):
        result = train_loop(
            model,
            data,
            OptConfig(lr=args.lr, warmup_steps=20, total_steps=max(args.steps, 100)),
            LoopConfig(
                total_steps=args.steps,
                ckpt_every=max(args.steps // 4, 10),
                ckpt_dir=args.ckpt_dir,
                accum_steps=args.accum,
                log_every=10,
            ),
            params=model.params,
        )
    first = result.metrics_history[0]["loss"]
    last = result.metrics_history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {result.step} steps "
          f"({result.failures} recovered failures)")
    return result


if __name__ == "__main__":
    main()
