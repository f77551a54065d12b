"""Dry-run of every (arch x shape x mesh) cell: rank 0's step traced on fake
tensors in a fake world of the production mesh's size.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell on 512 fake host devices; torch has no compiler that takes a 512-rank
program without ranks, so the port runs the program itself, once, where
nothing is computed:

  1. :func:`main` starts a fake process group (``init_process_group("fake",
     rank=0, world_size=N)``; its collectives return without moving data)
     of the mesh's size, 256 or 512 ranks, and refuses to run in a process
     that already has a process group -- the counterpart of the
     reference's ``XLA_FLAGS`` line, which must come first;
  2. under ``FakeTensorMode`` (tensors carry shapes and dtypes and hold no
     storage) ``launch.specs.build_cell`` gives the cell's step and rank
     0's blocks of its inputs, built without drawing a number;
  3. the step runs once under the counters of :func:`measure`.

Each XLA query has a counterpart:

  ``cost_analysis()["flops"]``  -> ``torch.utils.flop_counter.FlopCounterMode``
                                  (matmuls, convolutions, attention: the GEMM
                                  flops; elementwise work is not counted)
  ``"bytes accessed"``          -> the input and output bytes of every op that
                                  returns a tensor (views, allocations and 0-dim
                                  scalars count zero)
  ``memory_analysis()``         -> the bytes of the storages the step
                                  allocates and holds at once (``temp``: its
                                  peak, the outputs included while alive)
                                  beside its ``argument`` and ``output`` bytes;
                                  ``alias`` the outputs that are arguments
                                  written in place (a decode cell's cache; 0
                                  for a train step, which is functional)
  ``parse_collectives(...)``    -> the operand bytes and counts by kind that
                                  the port's collectives record where they run
                                  (``dist.collectives.RECORD``), over groups
                                  of more than one rank, plus the bytes this
                                  rank receives (``coll_received_bytes``: an
                                  ordered sum is an all-gather, so it receives
                                  ``n - 1`` operands where a ring all-reduce
                                  moves about two)

Counting rule.  The trace runs every op the step runs: each micro-batch
and every layer.  XLA counts a loop body once, so the reference's
``terms_from_record`` multiplies by ``accum_steps`` and extrapolates depth
from probes.  The port records no probes, and under ``full`` the whole
step's counts divided by ``accum_steps`` (the record's ``step`` holds them
undivided), so ``terms_from_record(record)`` gives the whole step exactly.
``compile_s`` is the trace's time (``lower_s`` building the cell): there is
no compile.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh pod \\
      --out results/dryrun
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _leaf_tensors(tree) -> list:
    """The tensors of a params/optimizer/batch tree (a scanned stack's
    ``Stacked`` layers included, which ``torch.utils._pytree`` takes for a
    leaf)."""
    from repro_torch._tree import leaves

    out = []
    for x in leaves(tree):
        out.extend(_tensors(x) if not isinstance(x, torch.Tensor) else [x])
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _StepCounter(TorchDispatchMode):
    """HBM bytes (inputs and outputs of every op that returns a tensor and
    is not a view or an allocation; 0-dim tensors, a host scalar's stand-in
    on one side and a tensor on the other, count zero) and the storages the
    step allocates and holds at once."""

    def __init__(self, args: Any):
        super().__init__()
        import weakref

        self._weakref = weakref
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: set[int] = set()
        self._args = {t.untyped_storage()._cdata for t in _leaf_tensors(args)}

    def _release(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("prim", "c10d", "_c10d_functional", "c10d_functional"):
            return out  # metadata queries; the port's collectives record themselves
        outs = _tensors(out)
        if outs and not func.is_view and func._opname not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) if t.dim())
            self.bytes += sum(_nbytes(t) for t in outs if t.dim())
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._args:
                continue
            n = st.nbytes()
            self._held.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            self._weakref.finalize(st, self._release, key, n)
        return out


def measure(fn: Callable, args: tuple) -> tuple[Any, dict]:
    """``(fn(*args), stats)``: the flops, bytes, memory and collectives of
    one run of ``fn`` (see the module docstring), on fake or real tensors
    alike.  ``stats`` holds the whole run's counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import collectives as coll

    rec = coll.Recorder()
    counter = _StepCounter(args)
    arg_bytes = sum(_nbytes(t) for t in _leaf_tensors(args))
    prev = coll.RECORD
    coll.RECORD = rec
    t0 = time.perf_counter()
    try:
        with FlopCounterMode(display=False) as flops, counter:
            out = fn(*args)
    finally:
        coll.RECORD = prev
    elapsed = time.perf_counter() - t0
    arg_keys = {t.untyped_storage()._cdata for t in _leaf_tensors(args)}
    seen: set[int] = set()
    out_bytes = alias_bytes = 0
    for t in _leaf_tensors(out):
        key = t.untyped_storage()._cdata
        if key in seen:
            continue
        seen.add(key)
        if key in arg_keys:
            alias_bytes += t.untyped_storage().nbytes()
        else:
            out_bytes += t.untyped_storage().nbytes()
    stats = {
        "trace_s": elapsed,
        "flops": float(flops.get_total_flops()),
        "bytes": float(counter.bytes),
        "coll_bytes": float(sum(rec.bytes.values())),
        "coll_by_kind": dict(rec.bytes),
        "coll_counts": dict(rec.counts),
        "coll_received_bytes": float(rec.received),
        "coll_issued_bytes": float(rec.issued),
        "coll_calls": list(rec.calls),
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(counter.peak),
        "alias_size_in_bytes": int(alias_bytes),
    }
    return out, stats


def start_fake_world(world_size: int) -> None:
    """Start the fake process group of ``world_size`` ranks this process
    traces rank 0 of; refuses a process that already has a process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake world: run it in a process "
                           "without a process group")
    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())


def _mesh(kind: str):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=(kind == "multipod"), device="cpu")


def _per_accum(stats: dict, accum: int) -> dict:
    """``stats`` with the step's counts divided by ``accum`` (see the module
    docstring); memory and times as they are."""
    out = dict(stats)
    for k in ("flops", "bytes", "coll_bytes", "coll_received_bytes", "coll_issued_bytes"):
        out[k] = stats[k] / accum
    for k in ("coll_by_kind", "coll_counts"):
        out[k] = {kind: v / accum for kind, v in stats[k].items()}
    return out


def _compile_once(cfg, shape, mesh) -> dict:
    """Build the cell on fake tensors and trace its step once; returns the
    whole step's stats with the build and trace times."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.specs import build_cell

    with FakeTensorMode(), meshlib.use_mesh(mesh):
        t0 = time.perf_counter()
        fn, args = build_cell(cfg, shape, mesh)
        t_lower = time.perf_counter() - t0
        _, stats = measure(fn, args)
    del stats["coll_calls"]
    stats["lower_s"] = round(t_lower, 2)
    stats["compile_s"] = round(stats.pop("trace_s"), 2)
    return stats


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, probes: bool = True):
    """Trace one cell and write ``{arch}__{shape}__{mesh}.json``.  ``probes``
    is the reference's flag; the port's trace runs every layer and records
    none (see the module docstring)."""
    from repro_torch.analysis.flops import model_flops, param_count
    from repro_torch.configs import cell_is_applicable, get_config, get_shape
    from repro_torch.launch.specs import cell_accum

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = _mesh(mesh_kind)
    chips = mesh.size()
    accum = cell_accum(cfg, shape, mesh) if shape.kind == "train" else 1

    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "chips": chips,
        "n_layers": cfg.n_layers,
        "params": param_count(cfg),
        "model_flops": model_flops(cfg, shape),
        "accum_steps": accum,
        "ok": False,
    }
    applicable, why = cell_is_applicable(cfg, shape)
    if not applicable:
        record["skipped"] = why
        record["ok"] = True
    else:
        try:
            step = _compile_once(cfg, shape, mesh)
            record["step"] = step
            record["full"] = _per_accum(step, accum)
            record["ok"] = True
        except Exception as e:  # noqa: BLE001 -- recorded, nonzero exit below
            record["error"] = f"{type(e).__name__}: {e}"
            record["traceback"] = traceback.format_exc()[-4000:]

    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    with open(fname, "w") as f:
        json.dump(record, f, indent=1)
    status = "SKIP" if record.get("skipped") else ("OK" if record["ok"] else "FAIL")
    full = record.get("full", {})
    print(
        f"[{status}] {arch} x {shape_name} x {mesh_kind}: "
        f"compile={full.get('compile_s', '-')}s flops={full.get('flops', 0):.3e} "
        f"coll={full.get('coll_bytes', 0):.3e}B -> {fname}",
        flush=True,
    )
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-probes", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import LM_SHAPES, list_archs

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    start_fake_world(512 if "multipod" in meshes else 256)
    cells = []
    if args.all:
        for arch in list_archs():
            for shape in LM_SHAPES:
                for mk in meshes:
                    cells.append((arch, shape, mk))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        for mk in meshes:
            cells.append((args.arch, args.shape, mk))

    failures = 0
    for arch, shape, mk in cells:
        rec = run_cell(arch, shape, mk, args.out, probes=not args.no_probes)
        failures += 0 if rec["ok"] else 1
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
