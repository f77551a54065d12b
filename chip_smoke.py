#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Drives the port's main path -- ``Problem.from_tensor -> plan_sweep -> cp_als``
-- on the card at the size of the paper's fMRI application (225 time points x
59 subjects x 200 x 200 regions, 2.12 GB in float32, synthetic data made from
``--seed``), and holds both CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0] [--rank 10] [--sweeps 5]

Phases (any failure ends the run with a non-zero exit and no result line):

0. device: name, count, power limit; TF32 switched off for matmuls and cuDNN.
1. build: both kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, in parallel); registers, shared memory and spills per kernel.
2. kernels vs plain versions on the card: the fused kernel on every mode of
   the 4-way tensor (pos 0, 1 and 2); the matrix-free kernel on every mode
   of the 4-way tensor, its 3-way linearization (225 x 59 x 20100) and small
   order-5 and order-6 tensors.  Norm-wise relative error ``|K-P|/|P|`` must
   stay under ``REL_ERR_BOUND``.
3. main path: ``cp_als`` for strategies auto, fused and matrix_free from one
   seeded init; kernel launch counts, per-sweep fits (finite, agreeing within
   ``FIT_AGREE``), per-sweep time and peak memory; plus a small tensor whose
   card run must agree with the port's CPU run.
4. timing of each kernel per mode at the main path's shapes with CUDA
   events, beside its plain version, one PyTorch einsum call and the bound
   ``max(bytes / 3.35e12, flops / 67e12)``.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON summary.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# fp32 kernel vs plain version: two summation orders over up to 2.36 M terms
# per output.  Blocked fp32 sums of that length agree to ~1e-6 norm-wise; an
# indexing or masking fault gives O(1).  1e-4 keeps two orders of margin.
REL_ERR_BOUND = 1e-4
# Per-sweep fits of the three strategies: the same ALS iterates computed with
# differently ordered fp32 sums; the fit's factored identity subtracts nearly
# equal terms, which amplifies their ~1e-6 relative differences to ~1e-5.
FIT_AGREE = 1e-3
# The small card-vs-CPU run: same algorithms, ~1e-6 differences per sweep.
SMALL_FIT_AGREE = 1e-4
# Nominal H100 SXM datasheet rates at 700 W (fp32 without tensor cores, HBM3).
PEAK_FLOPS = 67e12
HBM_BW = 3.35e12

FMRI = (225, 59, 200, 200)
FUSED_SOURCE = "src/repro_torch/kernels/csrc/fused_mttkrp.cu"
MF_SOURCE = "src/repro_torch/kernels/csrc/matrix_free.cu"
FUSED_REPLACES = "src/repro/kernels/fused_mttkrp.py:182"
MF_REPLACES = "src/repro/kernels/matrix_free.py:84"


def _log(msg: str) -> None:
    print(msg, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def synth_fmri(torch, gen, rank: int, device):
    """Synthetic fMRI tensor after ``examples/fmri_cpals.py``: positive
    temporal envelopes, softplus subject loadings, symmetric rank-1 network
    maps, scaled to max |x| = 1, plus 5% Gaussian noise."""
    t, s, r, _ = FMRI
    tt = torch.linspace(0, 8 * math.pi, t, device=device)[:, None]
    phases = torch.rand((1, rank), generator=gen, device=device) * 2 * math.pi
    temporal = 1.0 + torch.sin(tt / (1 + torch.arange(rank, device=device)) + phases)
    subj = torch.nn.functional.softplus(
        torch.randn((s, rank), generator=gen, device=device)
    )
    seeds = torch.randn((r, rank), generator=gen, device=device)
    ts = (temporal[:, None, :] * subj[None, :, :]).reshape(t * s, rank)
    nets = (seeds[:, None, :] * seeds[None, :, :]).reshape(r * r, rank)
    x = (ts @ nets.T).view(FMRI)
    x /= x.abs().max()
    for k in range(t):  # noise slab by slab: no second 2 GB buffer
        x[k] += 0.05 * torch.randn((s, r, r), generator=gen, device=device)
    return x


def _rel(torch, k, p) -> tuple[float, float]:
    d = (k.double() - p.double())
    return float(d.norm() / p.double().norm()), float(d.abs().max())


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _einsum_spec(order: int, n: int) -> str:
    letters = "abdefg"[:order]
    terms = [letters] + [letters[k] + "c" for k in range(order) if k != n]
    return ",".join(terms) + f"->{letters[n]}c"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--sweeps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.plan import Problem, cp_als, plan_sweep

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # ---- phase 0: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    _log(f"[0] device: {name}; count {count}; torch {torch.__version__} cuda {torch.version.cuda}")
    _log("[0] nvidia-smi name, power.limit:")
    _log(smi)
    _log(f"[0] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- phase 1: build
    t0 = time.perf_counter()
    _build.build_all([fm.KERNEL, mf.KERNEL])
    _log(f"[1] built both kernels in {time.perf_counter() - t0:.1f} s")
    for k in (fm.KERNEL, mf.KERNEL):
        for line in k.ptxas_log.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                _log(f"[1] {k.source.name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rank = args.rank
    x4 = synth_fmri(torch, gen, rank, dev)
    iu = torch.triu_indices(FMRI[2], FMRI[3], device=dev)
    x3 = x4[:, :, iu[0], iu[1]].contiguous()
    _log(f"[2] data: x4 {tuple(x4.shape)} ({x4.numel() * 4 / 1e9:.2f} GB), "
         f"x3 {tuple(x3.shape)} ({x3.numel() * 4 / 1e9:.2f} GB), seed {args.seed}")

    # ---- phase 2: kernels vs plain versions
    err = {"fused": 0.0, "mf": 0.0}

    def check(label, key, kern, plain):
        rel, mabs = _rel(torch, kern, plain)
        err[key] = max(err[key], mabs)
        ok = math.isfinite(rel) and rel <= REL_ERR_BOUND
        _log(f"[2] {label}: rel err {rel:.3e} max abs {mabs:.3e} "
             f"(bound {REL_ERR_BOUND:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: kernel disagrees with its plain version")

    f4 = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, f4, n)
        kern = fm.fused_mttkrp_bilinear(t, a, b, pos=pos)
        check(f"fused 4-way mode {n} pos {pos} T{tuple(t.shape)}", "fused", kern,
              fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos))
    small5 = torch.randn((12, 10, 8, 9, 11), generator=gen, device=dev)
    small6 = torch.randn((6, 7, 5, 8, 6, 7), generator=gen, device=dev)
    for label, x in (("4-way", x4), ("3-way", x3), ("order-5", small5), ("order-6", small6)):
        fs = [torch.randn((d, rank), generator=gen, device=dev) for d in x.shape]
        for n in range(x.ndim):
            us = [fs[k] for k in range(x.ndim) if k != n]
            check(f"matrix_free {label} mode {n}", "mf",
                  mf.matrix_free_kernel(x, us, n), mf.matrix_free_kernel_plain(x, us, n))
    del small5, small6
    torch.cuda.synchronize()

    # ---- phase 3: the main path
    init = [torch.randn((d, rank), generator=gen, device=dev) for d in FMRI]
    fits, launches = {}, {}
    for strategy in ("auto", "fused", "matrix_free"):
        problem = Problem.from_tensor(x4, rank)
        plan = plan_sweep(problem, strategy=strategy)
        algs = [np_.algorithm for np_ in plan.nodes]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.KERNEL.launches = 0
        mf.KERNEL.launches = 0
        secs = []
        st = cp_als(x4, plan, n_iters=args.sweeps, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: (fits.setdefault(strategy, []).append(f),
                                                secs.append(dt)))
        torch.cuda.synchronize()
        launches[strategy] = (fm.KERNEL.launches, mf.KERNEL.launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        _log(f"[3] {strategy}: schedule {plan.resolved_schedule.name} nodes {algs}")
        _log(f"[3] {strategy}: fits {fits[strategy]}")
        _log(f"[3] {strategy}: per-sweep s {secs} (host clock, one device sync per sweep); "
             f"peak memory {peak:.3f} GB; launches fused {launches[strategy][0]} "
             f"matrix_free {launches[strategy][1]}; card {smi}")
        if st.it != args.sweeps or any(tuple(u.shape) != (d, rank) for u, d in zip(st.factors, FMRI)):
            raise SystemExit(f"{strategy}: wrong sweep count or factor shapes")
        if not all(math.isfinite(f) for f in fits[strategy]) or not all(
            bool(torch.isfinite(u).all()) for u in st.factors
        ):
            raise SystemExit(f"{strategy}: non-finite fit or factors")
    want = 4 * args.sweeps
    if launches["auto"] != (0, 0) or launches["fused"] != (want, 0) or launches["matrix_free"] != (0, want):
        raise SystemExit(f"launch counts {launches} do not match 4 x sweeps = {want}")
    gap = max(abs(a - b) for s in ("fused", "matrix_free") for a, b in zip(fits[s], fits["auto"]))
    _log(f"[3] fit agreement across strategies: max |diff| {gap:.3e} (bound {FIT_AGREE:g})")
    if gap > FIT_AGREE:
        raise SystemExit("strategies disagree on the fits")

    # small input: the card's run against the port's CPU run (plain versions)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    xs = torch.randn((20, 15, 12, 10), generator=cpu_gen)
    inits = [torch.randn((d, 5), generator=cpu_gen) for d in xs.shape]
    for strategy in ("fused", "matrix_free"):
        out = {}
        for where in ("cpu", "cuda"):
            plan = plan_sweep(Problem.from_tensor(xs, 5), strategy=strategy)
            got = []
            cp_als(xs.to(where), plan, n_iters=5, tol=0.0, init_factors=[u.to(where) for u in inits],
                   callback=lambda it, f, dt: got.append(f))
            out[where] = got
        d = max(abs(a - b) for a, b in zip(out["cpu"], out["cuda"]))
        _log(f"[3] small {strategy} card vs CPU fits: max |diff| {d:.3e} (bound {SMALL_FIT_AGREE:g})")
        if d > SMALL_FIT_AGREE:
            raise SystemExit("card and CPU runs disagree on a small input")

    # ---- phase 4: timing at the main path's shapes
    rows = {"fused": [], "mf": []}
    for n in range(4):
        t, a, b, pos = ops.bilinear_operands(x4, init, n)
        c = a.shape[1]
        spec = {0: "iab,ac,bc->ic", 1: "aib,ac,bc->ic", 2: "abi,ac,bc->ic"}[pos]
        byts = 4 * (t.numel() + a.numel() + b.numel() + t.shape[pos] * c)
        flops = 2 * t.numel() * c
        r = {
            "ms": _time_ms(torch, lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos), 20),
            "plain_ms": _time_ms(torch, lambda: fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos), 5),
            "library_ms": _time_ms(torch, lambda: torch.einsum(spec, t, a, b), 5),
            "bytes_ms": byts / HBM_BW * 1e3, "flops_ms": flops / PEAK_FLOPS * 1e3,
        }
        rows["fused"].append(r)
        us = [init[k] for k in range(4) if k != n]
        byts = 4 * (x4.numel() + sum(u.numel() for u in us) + FMRI[n] * c)
        flops = 2 * x4.numel() * c
        r2 = {
            "ms": _time_ms(torch, lambda: mf.matrix_free_kernel(x4, us, n), 20),
            "plain_ms": _time_ms(torch, lambda: mf.matrix_free_kernel_plain(x4, us, n), 5),
            "library_ms": _time_ms(torch, lambda: torch.einsum(_einsum_spec(4, n), x4, *us), 5),
            "bytes_ms": byts / HBM_BW * 1e3, "flops_ms": flops / PEAK_FLOPS * 1e3,
        }
        rows["mf"].append(r2)
        for label, row in (("fused_mttkrp_bilinear", r), ("matrix_free_kernel", r2)):
            bound = max(row["bytes_ms"], row["flops_ms"])
            _log(f"[4] {label} mode {n}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                 f"einsum {row['library_ms']:.4f} ms, bound {bound:.4f} ms "
                 f"({'bytes' if row['bytes_ms'] >= row['flops_ms'] else 'operations'}); "
                 f"card {smi}")

    def summary(name_, source, replaces, key, launch):
        rs = rows[key]
        b_bytes = sum(r["bytes_ms"] for r in rs)
        b_ops = sum(r["flops_ms"] for r in rs)
        return {
            "name": name_, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launch, "max_abs_err": err[key],
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
        }

    _log(f"[4] times per sweep (one launch per mode, 4 modes), card {smi}; "
         f"whole smoke {time.perf_counter() - t_start:.1f} s")
    _log("kernels: fused_mttkrp_bilinear, matrix_free_kernel")
    print(json.dumps({"kernels": [
        summary("fused_mttkrp_bilinear", FUSED_SOURCE, FUSED_REPLACES, "fused",
                launches["fused"][0]),
        summary("matrix_free_kernel", MF_SOURCE, MF_REPLACES, "mf", launches["matrix_free"][1]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
