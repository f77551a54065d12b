"""Readings for a cell's limits: the program's numbers and the control's, over seeds.

    python3 -m cpbench.control --workload <cell> --seeds 1,2,3 --seconds 2
    python3 -m cpbench.control --workload <cell> --seeds 1,2,3 --fault frozen

For each seed, one process runs the cell as :mod:`cpbench.run` does, with
a short window, and checks the same sample of answers three times against
the float64 reference: the program's; the control's -- the reference put
in the program's place in the nearest precision below the configuration's
(:data:`cpbench.check.CONTROL`: TF32 for float32 with TF32 off); and a
witness's, the reference in the configuration's own precision, which
shows how far rounding alone carries the numbers.  One JSON line a seed,
then a summary: each number's largest program reading (the lower
reading) and smallest control reading (the upper).  A limit is set
between the two (see ``PERF.md``).  With ``--fault`` the program runs
with that fault of :mod:`cpbench.faults` planted, no stand-in is run, and
the summary gives each number's smallest reading under the fault (the
upper reading it sets).  Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from cpbench import check, faults, run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m cpbench.control", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    args = p.parse_args(argv)
    src = str(spec.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    torch.set_num_threads(1)  # as a run does
    if not torch.cuda.is_available():
        print("cpbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.workload(args.workload)
    config = spec.config(cell["config"])
    bench = spec.benchmark()
    precision = check.control_precision(config)
    stand_ins = () if args.fault else (precision, config["dtype"])
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            r = run.execute(args.workload, cell, config, seed, args.seconds, False, device,
                            bench, stand_ins=stand_ins)
        prog = check.summarize(r["readings"])
        line = {"workload": args.workload, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"], "program": prog}
        if args.fault:
            line["fault"] = args.fault
            for n in prog:
                upper[n] = min(upper.get(n, float("inf")), prog[n])
        else:
            ctrl = r["stand_ins"][precision]
            line.update(control=ctrl, control_precision=precision,
                        witness=r["stand_ins"][config["dtype"]])
            for n in prog:
                lower[n] = max(lower.get(n, 0.0), prog[n])
                upper[n] = min(upper.get(n, float("inf")), ctrl[n])
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "fault": args.fault, "lower": lower,
                      "upper": upper,
                      "upper_over_lower": {n: upper[n] / lower[n] if lower.get(n) else None
                                           for n in upper},
                      "limits": cell["limits"],
                      "kind": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
