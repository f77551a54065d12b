#!/usr/bin/env python3
"""Time the KRP pair kernel against an earlier version of it, in turns, on one card.

Builds ``krp_pair.cu`` of an earlier checkout (``--parent``: the root of an
unpacked copy of the repository, whose ``krp_pair_*`` entries take
``(a, b, out, ja, jb, c, block_b, stream)``) beside this checkout's kernel,
then at the fMRI KRP's last fold ``(11800 x C) (.) (200 x C)`` (float32,
bf16, fp16 and float64 at rank 10, float32 at rank 128) checks both
bitwise against the plain version and times them by CUDA events over
``--reps`` launches, in the order earlier, this, this, earlier; then each
one's device µs a call (``torch.profiler``) and host µs a call (host
clock, no sync), and a ``fill_`` of the output's size on the card (a
write-only pass).  Printed beside them: the bound (each operand read
once, the output written once, over 3.35 TB/s), the plain version and one
``torch.einsum("ac,bc->abc")``; the last line is a JSON summary.

    python3 tools/krp_pair_turns.py --parent <dir> [--reps 50] [--seed 0]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BW = 3.35e12  # H100 SXM datasheet, 700 W
CASES = (("float32", 10), ("bfloat16", 10), ("float16", 10), ("float64", 10), ("float32", 128))
SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float16": "f16", "float64": "f64"}


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(torch, fn, reps: int) -> float:
    """Device µs a call: the mean of the CUDA kernels ``torch.profiler``
    records over ``reps`` calls (what the card spends, apart from the gaps
    a slower host leaves between calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps


def _host_us(torch, fn, reps: int) -> float:
    """Host µs a call: the host clock over ``reps`` calls, no sync inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def _build_parent(parent: Path, out_dir: Path):
    """nvcc of the earlier ``krp_pair.cu`` with this checkout's flags."""
    from repro_torch.kernels import _build

    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    lib = out_dir / "krp_pair_parent.so"
    t0 = time.perf_counter()
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                    str(csrc / "krp_pair.cu")], check=True, capture_output=True, text=True)
    print(f"built the earlier krp_pair.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    return ctypes.CDLL(str(lib))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("krp_pair_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import krp_kernel as kk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all([kk.KERNEL])
    lib = _build_parent(args.parent.resolve(), Path(tempfile.mkdtemp(prefix="krp_turns_")))

    def parent_krp(a, b):
        fn = getattr(lib, f"krp_pair_{SUFFIX[str(a.dtype).removeprefix('torch.')]}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        out = a.new_empty((a.shape[0] * b.shape[0], a.shape[1]))
        code = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0], a.shape[1],
                  512, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the earlier krp_pair failed: CUDA error {code}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = []
    for dtype_name, rank in CASES:
        dtype = getattr(torch, dtype_name)
        u1, u2, u3 = (torch.randn((d, rank), generator=gen, device="cuda").to(dtype)
                      for d in (59, 200, 200))
        k12 = kk.krp_pair(u1, u2, block_b=512)
        new = lambda: kk.krp_pair(k12, u3, block_b=512)  # noqa: E731
        old = lambda: parent_krp(k12, u3)  # noqa: E731
        plain = kk.krp_pair_plain(k12, u3)
        before = kk.KERNEL.vector_launches
        same = torch.equal(new(), plain) and torch.equal(old(), plain)
        path = "16-byte" if kk.KERNEL.vector_launches > before else "one-element"
        del plain
        torch.cuda.empty_cache()
        turns = [_time_ms(torch, fn, args.reps) for fn in (old, new, new, old)]
        n_out = k12.shape[0] * u3.shape[0] * rank
        byts = k12.element_size() * (k12.numel() + u3.numel() + n_out)
        full = torch.empty(n_out, dtype=dtype, device="cuda")
        row = {"dtype": dtype_name, "rank": rank, "bitwise": same, "path": path,
               "earlier_ms": [turns[0], turns[3]], "ms": [turns[1], turns[2]],
               "bound_ms": byts / HBM_BW * 1e3,
               "plain_ms": _time_ms(torch, lambda: kk.krp_pair_plain(k12, u3), 5),
               "library_ms": _time_ms(torch, lambda: torch.einsum("ac,bc->abc", k12, u3), 5),
               "earlier_device_us": _device_us(torch, old, args.reps),
               "device_us": _device_us(torch, new, args.reps),
               "earlier_host_us": _host_us(torch, old, args.reps),
               "host_us": _host_us(torch, new, args.reps),
               "fill_device_us": _device_us(torch, lambda: full.fill_(1), args.reps)}
        del full
        results.append(row)
        best = min(row["ms"])
        print(f"{dtype_name} rank {rank} {tuple(k12.shape)} (.) {tuple(u3.shape)}: bitwise "
              f"{same}, {path} path; earlier {turns[0]:.4f} / {turns[3]:.4f} ms, this "
              f"{turns[1]:.4f} / {turns[2]:.4f} ms ({byts / best / 1e9:.3f} TB/s, "
              f"{row['bound_ms'] / best:.2f} of the bound {row['bound_ms']:.4f} ms); device "
              f"us a call earlier {row['earlier_device_us']:.2f}, this {row['device_us']:.2f}; "
              f"host us a call earlier {row['earlier_host_us']:.2f}, this {row['host_us']:.2f}; "
              f"fill_ of the output's size {row['fill_device_us']:.2f} us; plain "
              f"{row['plain_ms']:.4f} ms, einsum {row['library_ms']:.4f} ms; card {smi}",
              flush=True)
        del k12, u1, u2, u3
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "reps": args.reps, "cases": results}))
    return 0 if all(r["bitwise"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
