"""Batched serving example: prefill + decode with the request engine.

Port of ``examples/serve_lm.py``: the reduced config of ``--arch``, its
parameters drawn from a generator seeded ``--seed`` on ``--device``, a
``ServeEngine`` of batch 4 on a ``(1, 1)`` mesh (a world of one unless a
launcher started one).  Prompts come from ``np.random.default_rng(0)``,
as the reference's.  Sampling at ``--temperature`` above 0 draws from the
port's generator, which does not reproduce ``jax.random.categorical``;
``--temperature 0`` is greedy.

    PYTHONPATH=src python examples/repro_torch/serve_lm.py --arch falcon-mamba-7b [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model
from repro_torch.serve.engine import GenerationConfig, ServeEngine


def main(argv=None, *, weights=None):
    """Serve the requests; returns ``{rid: generated tokens}``.  ``weights``
    (a flat ``{path: numpy array}`` of either package's parameters, as
    ``interop.params_to_numpy`` writes them) replaces the drawn ones."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", help="where to serve (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    device = torch.device(args.device)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))
    params = model.params if weights is None else params_from_numpy(model, weights)
    with meshlib.host_world(device), \
            meshlib.use_mesh(meshlib.make_host_mesh(1, 1, device=device.type)):
        eng = ServeEngine(
            model,
            params,
            GenerationConfig(
                max_new_tokens=args.new_tokens, temperature=args.temperature, seed=args.seed
            ),
            batch_size=4,
        )
        rng = np.random.default_rng(0)
        rids = [
            eng.submit(rng.integers(0, cfg.vocab, size=rng.integers(4, 12)))
            for _ in range(args.requests)
        ]
        t0 = time.perf_counter()
        results = eng.flush()
        dt = time.perf_counter() - t0
    tokens_out = sum(len(v) for v in results.values())
    print(f"arch={cfg.name}: served {len(results)} requests, "
          f"{tokens_out} tokens in {dt:.2f}s on {device}")
    for rid in rids[:3]:
        print(f"  req {rid}: {results[rid].tolist()}")
    return results


if __name__ == "__main__":
    main()
