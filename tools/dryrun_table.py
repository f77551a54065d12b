"""Markdown table of the dry-run's records (``launch/dryrun.py`` JSON files).

One row a (arch x shape) cell, the pod and multipod records side by side
(``pod / multipod``): the whole step's flops, HBM bytes and collective
operand bytes a rank, a rank's argument and temp GB (against an H100's 80
GB), and ``RooflineTerms`` under the port's nominal H100 constants (bound
ms, bottleneck, ``mfu_bound``).  Numbers are a trace's, not the card's.

    PYTHONPATH=src python tools/dryrun_table.py results/dryrun
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ARCHS = ("olmo-1b", "whisper-base", "h2o-danube-3-4b", "qwen2-moe-a2.7b",
         "recurrentgemma-2b", "qwen3-8b", "qwen2-vl-7b", "falcon-mamba-7b",
         "deepseek-coder-33b", "dbrx-132b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
HBM_GB = 80


def _cell(out: Path, arch: str, shape: str, mesh: str):
    path = out / f"{arch}__{shape}__{mesh}.json"
    return json.loads(path.read_text()) if path.exists() else None


def _join(values) -> str:
    return " / ".join(values)


def row(out: Path, arch: str, shape: str) -> str | None:
    from repro_torch.analysis.roofline import terms_from_record

    recs = [r for r in (_cell(out, arch, shape, m) for m in ("pod", "multipod")) if r]
    if not recs:
        return None
    if any(r.get("skipped") for r in recs):
        return f"| {arch} | {shape} | skipped: {recs[0]['skipped']} |||||||"
    if not all(r.get("ok") and "step" in r for r in recs):
        return f"| {arch} | {shape} | FAILED |||||||"
    cols = {k: [] for k in ("flops", "bytes", "coll", "arg", "temp", "bound", "neck", "mfu")}
    for r in recs:
        st, t = r["step"], terms_from_record(r)
        cols["flops"].append(f"{st['flops']:.3e}")
        cols["bytes"].append(f"{st['bytes']:.3e}")
        cols["coll"].append(f"{st['coll_bytes']:.3e}")
        cols["arg"].append(f"{st['argument_size_in_bytes'] / 1e9:.2f}")
        temp = st["temp_size_in_bytes"] / 1e9
        fits = "" if st["argument_size_in_bytes"] / 1e9 + temp <= HBM_GB else " (over)"
        cols["temp"].append(f"{temp:.2f}{fits}")
        cols["bound"].append(f"{t.step_bound_s * 1e3:.2f}")
        cols["neck"].append(t.bottleneck)
        cols["mfu"].append(f"{t.mfu_bound:.4f}")
    return (f"| {arch} | {shape} | " + " | ".join(_join(v) for v in cols.values()) + " |")


def summary(out: Path) -> list[str]:
    """The ranges the table's cells span: each term against the bound, the
    largest argument + temp GB a rank."""
    from repro_torch.analysis.roofline import terms_from_record

    comp, coll, peak = [], [], []
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh in ("pod", "multipod"):
                r = _cell(out, arch, shape, mesh)
                if not r or "step" not in r:
                    continue
                t, st = terms_from_record(r), r["step"]
                tag = f"{arch} {shape} {mesh}"
                comp.append((t.compute_s / t.memory_s, tag, shape))
                coll.append((t.collective_s / t.compute_s, tag))
                peak.append(((st["argument_size_in_bytes"] + st["temp_size_in_bytes"]) / 1e9,
                             tag))
    train = [c for c in comp if c[2] == "train_4k"]
    lines = [
        f"bottleneck: memory in {sum(c[0] < 1 for c in comp)} of {len(comp)} records",
        f"train compute / memory: {min(train)[0]:.3f} ({min(train)[1]}) to "
        f"{max(train)[0]:.3f} ({max(train)[1]})",
        f"collective / compute: {min(coll)[0]:.4f} ({min(coll)[1]}) to "
        f"{max(coll)[0]:.3f} ({max(coll)[1]})",
        f"largest arguments + temp a rank: {max(peak)[0]:.2f} GB ({max(peak)[1]}) of {HBM_GB}",
    ]
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0] if argv else "results/dryrun")
    print("| arch | shape | flops | HBM bytes | coll bytes | arg GB | temp GB "
          "| bound ms | bottleneck | mfu_bound |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for arch in ARCHS:
        for shape in SHAPES:
            line = row(out, arch, shape)
            if line:
                print(line)
    for line in summary(out):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
