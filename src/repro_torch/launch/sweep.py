"""Dry-run sweep driver: one subprocess per (arch x shape x mesh) cell.

Port of ``repro.launch.sweep``.  Each cell runs
``python -m repro_torch.launch.dryrun`` in a fresh process (the dry-run
starts its own fake world of ranks, which a process holds once; isolation
also bounds the trace's memory).  Resumable: cells whose JSON already
records ok=true are skipped.  Run:

    PYTHONPATH=src python -m repro_torch.launch.sweep --out results/dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def cell_done(out_dir: str, arch: str, shape: str, mesh: str) -> bool:
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            return bool(json.load(f).get("ok"))
    except Exception:
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    # seconds a cell may take: the trace runs every op of the step, and
    # falcon-mamba-7b's train cell (64 SSM layers x 4 micro-batches of
    # chunked scans) traces for about 40 minutes on one CPU core
    ap.add_argument("--timeout", type=int, default=7200)
    ap.add_argument("--archs", nargs="*", default=None)
    args = ap.parse_args(argv)

    # ordered smallest-first so failures surface early
    archs = args.archs or [
        "olmo-1b", "whisper-base", "h2o-danube-3-4b", "qwen2-moe-a2.7b",
        "recurrentgemma-2b", "qwen3-8b", "qwen2-vl-7b", "falcon-mamba-7b",
        "deepseek-coder-33b", "dbrx-132b",
    ]
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    total = fail = skip = 0
    t0 = time.time()
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                total += 1
                if cell_done(args.out, arch, shape, mesh):
                    skip += 1
                    continue
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", mesh,
                    "--out", args.out,
                ]
                env = dict(os.environ)
                env.setdefault("PYTHONPATH", "src")
                try:
                    proc = subprocess.run(
                        cmd, env=env, timeout=args.timeout,
                        capture_output=True, text=True,
                    )
                    sys.stdout.write(proc.stdout[-400:] if proc.stdout else "")
                    if proc.returncode != 0:
                        fail += 1
                        sys.stdout.write(f"[rc={proc.returncode}] {arch} {shape} {mesh}\n")
                        sys.stdout.write((proc.stderr or "")[-600:] + "\n")
                except subprocess.TimeoutExpired:
                    fail += 1
                    sys.stdout.write(f"[TIMEOUT] {arch} {shape} {mesh}\n")
                sys.stdout.flush()
    print(f"sweep done: {total} cells, {skip} skipped, {fail} failed, "
          f"{time.time()-t0:.0f}s")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
