"""Dry-run of the paper's own workload at pod scale: distributed CP-ALS.

Port of ``repro.launch.dryrun_cp``.  One distributed ALS sweep (the
engine behind ``dist.dist_mttkrp.dist_als_sweep`` and
``dist_dimtree_sweep``) runs on fake blocks of a pod-scale dense tensor
(default: a 2048 time x 1024 subject x 400 x 400 region
functional-connectivity tensor, 1.34 TB fp32 -- the paper's fMRI
application grown to the scale its Sec. 3 calls for) in a fake world of
the production mesh's size, and the record holds the same cost, memory
and collective stats as the LM dry-run (``launch/dryrun.py``: the
counters are its :func:`~repro_torch.launch.dryrun.measure`).  The blocks
are the ones ``dist.dist_mttkrp.shard_problem`` cuts, made on fake global
tensors before the sweep, so the arguments are this rank's blocks.

The MTTKRP method is selectable:
  1step : paper Alg. 3 with the explicit KRP (materializes K_L (.) K_R)
  2step : paper Alg. 4 (partial MTTKRP + multi-TTV)
  auto  : paper's recommended mix (Sec. 5.3.3)
  einsum, dimtree : one contraction a mode / the dimension tree

These run contractions, not the CUDA kernels; a kernel wrapper given a
fake tensor raises.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_cp --method auto --mesh pod
"""

from __future__ import annotations

import argparse
import json
import os


def run(shape, rank, method, mesh_kind, mode_axes, out_dir):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.dist_mttkrp import shard_problem
    from repro_torch.launch.dryrun import measure
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.plan import Problem, ShardedExecutor, SweepState, als_sweep, plan_sweep

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"), device="cpu")
    ndim = len(shape)
    with FakeTensorMode():
        x = torch.empty(tuple(shape), dtype=torch.float32)
        factors = [torch.empty((dim, rank), dtype=torch.float32) for dim in shape]
        problem = Problem.from_tensor(x, rank, mode_axes=mode_axes, mesh=mesh)
        strategy = "dimtree" if method == "dimtree" else method
        plan = plan_sweep(problem, strategy=strategy, executor="sharded",
                          schedule=None if method == "dimtree" else "flat")
        executor = ShardedExecutor(mesh, mode_axes)
        xb, fb = shard_problem(x, factors, mode_axes, mesh)
        del x, factors
        weights = torch.empty((rank,), dtype=torch.float32)
        norm_x = torch.empty((), dtype=torch.float32)

        def sweep(xb, fb, weights, norm_x):
            state = SweepState(x=xb, factors=list(fb), weights=weights, norm_x=norm_x, it=0)
            out = als_sweep(problem, plan, executor, state)
            return out.factors, out.weights, out.fit

        _, stats = measure(sweep, (xb, fb, weights, norm_x))

    entries = 1
    for d in shape:
        entries *= d
    # MODEL_FLOPS for one ALS sweep: N modes x (2|X|C MTTKRP + small solves)
    model_flops = 2.0 * entries * rank * ndim
    record = {
        "kind": "cp_als_sweep",
        "shape": list(shape),
        "rank": rank,
        "method": method,
        "mesh": mesh_kind,
        "chips": mesh.size(),
        "mode_axes": {str(k): v for k, v in mode_axes.items()},
        "model_flops": model_flops,
        "compile_s": round(stats["trace_s"], 2),
        "flops": stats["flops"],
        "bytes": stats["bytes"],
        "coll_bytes": stats["coll_bytes"],
        "coll_by_kind": stats["coll_by_kind"],
        "coll_counts": stats["coll_counts"],
        "coll_received_bytes": stats["coll_received_bytes"],
        "coll_calls": stats["coll_calls"],
        "temp_bytes": stats["temp_size_in_bytes"],
        "arg_bytes": stats["argument_size_in_bytes"],
        "plan_collective_bytes": plan.total_cost()["collective_bytes"],
        "ok": True,
    }
    os.makedirs(out_dir, exist_ok=True)
    axes_tag = "-".join(f"{k}{v[0]}" for k, v in sorted(mode_axes.items()))
    fname = os.path.join(out_dir, f"cpals__{method}__{mesh_kind}__{axes_tag}.json")
    with open(fname, "w") as f:
        json.dump(record, f, indent=1)
    print(
        f"[OK] cpals method={method} mesh={mesh_kind} axes={mode_axes}: "
        f"compile={record['compile_s']:.1f}s flops={record['flops']:.3e} "
        f"bytes={record['bytes']:.3e} coll={record['coll_bytes']:.3e} "
        f"temp={record['temp_bytes']/1e9:.2f}GB -> {fname}",
        flush=True,
    )
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs="*", default=[2048, 1024, 400, 400])
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--method", default="auto",
                    choices=["auto", "1step", "2step", "einsum", "dimtree"])
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--axes", default="0:data,1:model",
                    help="mode:axis pairs, e.g. '0:data,1:model' or '0:pod,1:data,2:model'")
    ap.add_argument("--out", default="results/dryrun_cp")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import start_fake_world

    mode_axes = {}
    for pair in args.axes.split(","):
        k, v = pair.split(":")
        mode_axes[int(k)] = v
    start_fake_world(512 if args.mesh == "multipod" else 256)
    run(tuple(args.shape), args.rank, args.method, args.mesh, mode_axes, args.out)


if __name__ == "__main__":
    main()
