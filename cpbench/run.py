"""Run one cell of the port's benchmark once and print its result line.

    python3 -m cpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's workload file names its
configuration and traffic driver; ``BENCHMARK.json`` names the metrics it
reports.  A run:

1. makes the cell's data on the card from ``--seed`` (by the synthesis the
   configuration names, ``synth/<name>.py``) and its initial factors at
   the cell's rank (:func:`cpbench.spec.rank`), and warms the program on
   one unit of the cell's own work; everything up to here is ``setup_s``;
2. drives the traffic for ``--seconds`` seconds, ending with the unit of
   work that crosses the mark, and reads the end-to-end metrics from the
   host clock over that window;
3. with ``--trace 1``, then runs ``trace_units`` more units under
   ``torch.profiler`` and reads the per-layer metrics from that slice
   instead;
4. serves what is still outstanding, reads the peak memory, frees the
   program's state, and checks a sample of the answers, drawn from the
   seed, against the float64 reference ALS (:mod:`cpbench.check`).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the last lines of standard error repeat the checks.  Without a
CUDA card, or with fewer than the cell asks for, the run fails and prints
no result; so does a run in whose process JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from cpbench import check, roofline, spec  # noqa: E402
from cpbench import trace as tracing  # noqa: E402
from cpbench.reference import als, synth  # noqa: E402


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_data(torch, config: dict, seed: int, device):
    """The configuration's data from ``seed``, made in its dtype by the
    synthesis it names (:func:`cpbench.spec.synth`)."""
    make = spec.synth(config).make
    if (config["dtype"], bool(config["tf32"])) not in check.CONTROL:
        raise ValueError(f"cpbench/configs/{config.get('name')}.json: dtype {config['dtype']!r} "
                         f"(tf32 {bool(config['tf32'])}) has no control in cpbench.check.CONTROL")
    gen = torch.Generator(device=device).manual_seed(synth.derived_seed(seed, 0))
    return make(gen, config, device)


def execute(name: str, cell: dict, config: dict, seed: int, seconds: float, trace: bool,
            device, bench: dict, t_start: float | None = None,
            stand_ins: tuple[str, ...] = ()) -> dict:
    """Steps 1-4 of a run of cell ``name`` on ``device``; returns the result
    line as a dict (``device.kind`` and ``device.count`` left to the caller),
    with each checked answer's numbers under ``readings``.

    For each precision of :mod:`cpbench.reference.als` in ``stand_ins`` the
    reference in that precision is also put in the program's place for
    each answer checked, and its numbers are returned under
    ``stand_ins[precision]`` (:mod:`cpbench.control`)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    clock = time.perf_counter
    ctx = SimpleNamespace(
        torch=torch, device=device, cell=cell, config=config, clock=clock,
        data=make_data(torch, config, seed, device),
        init_gen=torch.Generator(device=device).manual_seed(synth.derived_seed(seed, 1)),
    )
    drv = spec.driver(cell["driver"])(ctx)
    drv.warm()
    _sync(torch, device)
    setup_s = clock() - t_start

    drv.start()
    t0 = clock()
    n = 0
    while True:
        drv.unit()
        n += 1
        if clock() - t0 >= seconds:
            break
    window_s = clock() - t0
    traced = None
    if trace:
        k = int(cell["trace_units"])
        traced = tracing.record(torch, lambda: [drv.unit() for _ in range(k)])
        slice_units = range(n, n + k)
    drv.finish()
    _sync(torch, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "memory_peak_bytes": int(peak)}
    extra = {}
    if trace:
        counts = drv.layer(slice_units)
        item = tuple(ctx.data.shape[1:] if drv.batched else ctx.data.shape)
        run = SimpleNamespace(
            trace=traced, batched=drv.batched, counts=counts, sweeps=counts["sweeps"],
            least_sweep_s=roofline.least_sweep_s(item, spec.rank(cell, config), config["dtype"],
                                                 counts["batch"]),
        )
        for m in spec.metrics_of(bench, name, "per_layer"):
            value = spec.metric(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        extra["breakdown"] = traced.breakdown()
    else:
        values = drv.end_to_end(range(n), window_s)
        values["setup_s"] = setup_s
        for m in spec.metrics_of(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    answered = drv.answered()
    picks = check.sample(len(answered), int(cell["check_sample"]), synth.derived_seed(seed, 2))
    kept = [drv.answer(answered[i]) for i in picks]
    attempted, failed = drv.attempted, drv.failed
    drv.release()
    del drv, ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sweeps = int(cell["sweeps"])
    stated = getattr(torch, config["dtype"])
    readings, others = [], {p: [] for p in stand_ins}
    for got, x, init in kept:
        ref = check.reference(*als.cp_als(x, init, sweeps, "float64", stated))
        readings.append(check.gaps(got, ref))
        for p in stand_ins:
            alt = als.cp_als(x, init, sweeps, p, stated)
            others[p].append(check.gaps(check.reference(*alt), ref))
    ok, checks = check.verdict(readings, cell["limits"])
    if stand_ins:
        extra["stand_ins"] = {p: check.summarize(r) for p, r in others.items()}
    return {
        "correct": bool(ok and failed == 0 and readings),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
        **extra,
        "readings": readings,
        "checks": checks,
    }


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m cpbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    src = str(spec.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    import repro_torch  # noqa: F401  the system under test: without it there is nothing to run

    # One host thread for the CPU side of the run, which only issues work to
    # the card: with the default pool the fleet's p95 spread 36% over five
    # runs, with one thread 7% (the chip machine shares its host's cores).
    torch.set_num_threads(1)

    cell = spec.workload(args.workload)
    config = spec.config(cell["config"])
    bench = spec.benchmark()
    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"cpbench: cell {args.workload} needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(args.workload, cell, config, args.seed, args.seconds, bool(args.trace),
                     device, bench, T_START)
    bad = spec.loaded_forbidden()
    if bad:
        print(f"cpbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    del result["readings"]
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": chips, "power_limit": _power_limit(), **result["device"]}
    result["checks"] = checks
    for key, c in checks.items():
        print(f"{key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
