"""Hardware-measured autotuning: the tuning cache, its keys and ``tune()``.

Port of ``repro.plan.autotune``.  The read side
(:func:`backend_name`, :func:`problem_key`, :func:`node_key`,
:class:`Measurements`, :class:`TuningCache`, :func:`default_tuning_cache`,
:func:`lookup_measurements`) is what ``plan_sweep`` consults; the measuring
side is :func:`tune`: it times the kernels' tile candidates and every
contraction node of every candidate schedule on the device the tensor lies
on, and stores the winners.  Planning only ever reads the cache; only an
explicit :func:`tune` call runs kernels.

Keys start with :func:`backend_name`, which names the CUDA device
(``cuda:NVIDIA H100 80GB HBM3``), so entries of the port never mix with the
JAX package's (``cpu``/``gpu``/``tpu``) even in one shared cache file.

The tile tables differ from the reference's, because the CUDA kernels'
row and reduction tiles are compile-time: the fused and matrix-free
kernels take one tile knob at run time, ``blocks_per_sm`` (how finely
their outer reduction is split over the grid), and the multi-TTV kernel
takes ``block_i`` (rows per thread block).  A candidate whose launch is
the same as an earlier one's (same split, same block) is timed once; on
the CPU the plain versions take no knob, so each table times its default
alone.  A ``pp_tol > 0`` problem also gets its pairwise-perturbation rows
(the cache build and one correction-only sweep).

A sharded problem (``tune(x, rank, mesh=, mode_axes=)``, every rank with
the same global tensor) times every node under the ``"sharded"``,
``"overlapping"`` and ``"compressed"`` executors -- the kernel leaves
too, on this rank's blocks and slabs -- and fits the overlapping
executor's serial fraction from the measured sharded/overlapping pairs
(``serial_fractions``, which the planner then prices with).  The ranks
must decide alike, or they deadlock on the next collective: every
measured time is the maximum over the ranks (the slowest rank sets a
sweep's pace) and the budget is spent when any rank's is, each agreed by
one gather an axis, so every rank stores the same entry.  On a two-level
mesh (``tune(intra_axes=)``) every node whose reduction spans both levels
is timed flat and hierarchical (the ``|coll=hierarchical`` key field), so
the planner's per-node choice argmins measured times; a sharded
``pp_tol > 0`` problem times its PP rows on this rank's blocks.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core.tensor_ops import dims_split, random_factors, tensor_norm
from repro_torch.kernels._tiling import kernels_take

from .problem import Problem
from .schedule import ROOT, ContractionNode

Tensor = torch.Tensor

# Environment variable naming the on-disk cache file of the process-default
# cache (see default_tuning_cache); unset/empty means in-memory only.
CACHE_ENV = "REPRO_TUNING_CACHE"

# Candidate blocks_per_sm values of the fused and matrix-free kernels (the
# default first): how many thread blocks a fused launch aims for per SM when
# it splits its outer reduction over the grid's y axis (more splits mean
# more bytes in flight and a longer fixed-order second pass), and the most
# CTAs an SM is counted to hold when a matrix-free launch fills its waves
# (at or above the kernel's residency, 2 at rank <= 32, one launch).
FUSED_TILE_CANDIDATES = (4, 2, 8, 16)
MATRIX_FREE_TILE_CANDIDATES = (4, 2, 8, 16)

# Candidate block_i values (rows, i.e. threads, per block) of the multi-TTV
# kernel, default 256 first.
TTV_TILE_CANDIDATES = (256, 64, 128, 512)

# Leaf algorithms the tuner measures head-to-head for a full mode-n MTTKRP
# (the kernels too, under every executor: the port's kernels run on a
# rank's block as on a whole tensor).
_LEAF_ALGORITHMS = ("1step", "2step-left", "2step-right", "fused", "matrix_free")
_EXTERNAL_LEAF_ALGORITHMS = ("1step", "fused", "matrix_free")


def backend_name() -> str:
    """The device measurements are valid for: ``cuda:<card name>`` when a
    card is attached, ``cpu`` otherwise."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cpu"


def problem_key(
    problem: Problem, *, backend: str | None = None, n_devices: int | None = None
) -> str:
    """Cache key of one (hardware, problem) pair: the problem's
    :meth:`~repro_torch.plan.problem.Problem.signature` with the live
    backend filled in."""
    backend = backend_name() if backend is None else str(backend)
    return problem.signature(backend=backend, n_devices=n_devices)


def node_key(
    node: ContractionNode, algorithm: str, executor: str, collective: str = "flat"
) -> str:
    """Measurement key of one schedule node's contraction (executor kind,
    algorithm, kept range, parent range, source), shared by every candidate
    tree the node appears in."""
    src = "root" if node.from_root else "partial"
    key = (
        f"{executor}|{algorithm}|{src}|keep={node.lo}:{node.hi}"
        f"|parent={node.parent_lo}:{node.parent_hi}"
    )
    if collective != "flat":
        key += f"|coll={collective}"
    return key


@dataclass(frozen=True)
class Measurements:
    """One problem's resolved tuning entry, as the planner consumes it:
    ``node_s`` maps :func:`node_key` strings to measured median seconds,
    ``tiles`` maps kernel name to its tuned tile config,
    ``serial_fractions`` are the overlap constants fitted from measured
    sharded/overlapping node pairs (empty when nothing paired), and ``pp``
    holds the pairwise-perturbation rows (``"build_s"``,
    ``"correct_sweep_s"``) when the tuned problem opted in via
    ``pp_tol``."""

    node_s: Mapping[str, float] = field(default_factory=dict)
    tiles: Mapping[str, Mapping[str, int]] = field(default_factory=dict)
    serial_fractions: Mapping[str, float] = field(default_factory=dict)
    pp: Mapping[str, float] = field(default_factory=dict)

    def node_time(
        self, node: ContractionNode, algorithm: str, executor: str, collective: str = "flat"
    ) -> float | None:
        """Measured seconds for one node contraction, ``None`` if unmeasured."""
        return self.node_s.get(node_key(node, algorithm, executor, collective))

    def kernel_tiles(self, kernel: str) -> dict[str, int] | None:
        """Tuned tile config for one kernel name, ``None`` if untuned."""
        t = self.tiles.get(kernel)
        return {k: int(v) for k, v in t.items()} if t else None

    def pp_second(self, key: str) -> float | None:
        """Measured seconds of one PP row (``"build_s"`` /
        ``"correct_sweep_s"``), ``None`` when the entry was tuned without
        pairwise perturbation."""
        v = self.pp.get(key)
        return float(v) if v is not None else None


class TuningCache:
    """Persistent ``{problem_key: entry}`` store with in-memory memoization.

    Entries are plain JSON dicts.  ``path=None`` lives in memory only; with
    a path, construction loads whatever the file holds (an empty file is an
    empty store) and every :meth:`put` rewrites it.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path else None
        self._entries: dict[str, dict] = {}
        if self.path is not None and self.path.exists():
            text = self.path.read_text()
            self._entries = json.loads(text) if text.strip() else {}

    def get(self, key: str) -> dict | None:
        """The entry stored under ``key``, or ``None``."""
        return self._entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        """Store ``entry`` under ``key`` and persist to disk when backed."""
        self._entries[key] = entry
        self.save()

    def save(self) -> None:
        """Write the full store to ``self.path`` (no-op when memory-only)."""
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self._entries, indent=1))

    def keys(self) -> list[str]:
        """All problem keys currently held."""
        return list(self._entries)


_default_cache: TuningCache | None = None


def default_tuning_cache() -> TuningCache:
    """The process-default cache ``plan_sweep`` reads: backed by the file
    named in ``$REPRO_TUNING_CACHE`` when set, in-memory otherwise."""
    global _default_cache
    if _default_cache is None:
        _default_cache = TuningCache(os.environ.get(CACHE_ENV) or None)
    return _default_cache


def lookup_measurements(
    problem: Problem, cache: TuningCache | None = None
) -> Measurements | None:
    """Resolve ``problem``'s tuning entry into planner-ready Measurements;
    ``None`` when it was never tuned on this backend (the planner then uses
    the analytic model alone)."""
    cache = cache or default_tuning_cache()
    entry = cache.get(problem_key(problem))
    if not entry:
        return None
    node_s = {r["key"]: float(r["measured_s"]) for r in entry.get("nodes", [])}
    tiles = {
        k: {
            kk: int(vv)
            for kk, vv in v.items()
            if kk in ("block_i", "block_b", "block_r", "block_batch", "blocks_per_sm")
        }
        for k, v in entry.get("tiles", {}).items()
        if v
    }
    return Measurements(
        node_s=node_s,
        tiles=tiles,
        serial_fractions={
            str(k): float(v) for k, v in entry.get("serial_fractions", {}).items()
        },
        pp={str(k): float(v) for k, v in entry.get("pp", {}).items()},
    )


# ------------------------------------------------------------ measurement
class _Budget:
    """Wall-clock budget for one tune() call.  It starts after the kernels
    are built (see :func:`tune`), so a first ``nvcc`` build does not use it
    up; everything timed after that counts.

    With a ``mesh`` every decision is the ranks' together: ``exhausted``
    is true on every rank once it is on any, and :meth:`agree` turns a
    rank's number into the maximum over the ranks."""

    def __init__(self, budget_ms: float | None, mesh=None):
        self.budget_ms = budget_ms
        self.mesh = mesh
        self.t0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def exhausted(self) -> bool:
        if self.budget_ms is None:
            return False
        return self.agree(float(self.elapsed_ms() >= self.budget_ms)) > 0.0

    def agree(self, value: float) -> float:
        """``value``'s maximum over the mesh's ranks (one gather an axis);
        ``value`` itself without a mesh."""
        if self.mesh is None:
            return value
        from repro_torch.dist.collectives import _gather

        t = torch.tensor([float(value)], dtype=torch.float64, device=self.mesh.device_type)
        for axis in self.mesh.mesh_dim_names:
            t = torch.stack(_gather(t, self.mesh.get_group(axis))).amax(dim=0)
        return float(t)


def _time(fn: Callable[[], Any], reps: int, device: torch.device) -> float:
    """Median seconds of ``fn()`` over ``reps`` calls after one warm call:
    CUDA events around each call on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(max(1, reps)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _tile_rows(
    candidates: Sequence[tuple[int, ...]],
    effective: Callable[[tuple[int, ...]], tuple],
    run: Callable[[tuple[int, ...]], Any],
    reps: int,
    budget: _Budget,
    device: torch.device,
) -> list[dict]:
    """Time deduped tile candidates; the default candidate is always first.
    ``effective`` maps a candidate to the launch it makes (``()`` where the
    plain version runs), so two labels of one launch are timed once."""
    rows: list[dict] = []
    seen: set[tuple] = set()
    for i, cand in enumerate(candidates):
        eff = effective(cand)
        if eff in seen:
            continue
        if i > 0 and budget.exhausted():
            break
        seen.add(eff)
        rows.append(
            {
                "candidate": list(cand),
                "effective": list(eff),
                "is_default": i == 0,
                "measured_s": budget.agree(_time(lambda c=cand: run(c), reps, device)),
            }
        )
    return rows


def _summarize_tiles(rows: list[dict], names: tuple[str, ...], mode: int) -> dict:
    """Best/default summary of one kernel's measured tile rows."""
    best = min(rows, key=lambda r: r["measured_s"])
    default = rows[0]  # the default candidate is always measured first
    out = {nm: best["candidate"][k] for k, nm in enumerate(names)}
    out.update(
        {
            "mode": mode,
            "default_s": default["measured_s"],
            "tuned_s": best["measured_s"],
            "speedup_vs_default": (
                default["measured_s"] / best["measured_s"] if best["measured_s"] > 0 else 1.0
            ),
            "rows": rows,
        }
    )
    return out


def _tune_fused_tiles(x: Tensor, factors: Sequence[Tensor], *, reps: int, budget: _Budget) -> dict:
    """Measure the fused kernel's ``blocks_per_sm`` candidates on a
    representative internal mode; the winner feeds both ``NodePlan.tiles``
    and the tuner's own ``fused`` node measurements (so the argmin times
    what will execute)."""
    from repro_torch.kernels import fused_mttkrp as fm
    from repro_torch.kernels import ops as kops

    n = x.ndim // 2  # internal mode: the kernel's primary bilinear layout
    t, _, _, pos = kops.bilinear_operands(x, factors, n)
    rank = factors[0].shape[-1]

    def effective(cand):  # the launch's (groups, splits) of the view
        if not x.is_cuda:
            return ()
        g = fm.launch_geometry(tuple(t.shape), pos, rank, None, cand[0])
        return g.groups, g.splits

    rows = _tile_rows(
        tuple((b,) for b in FUSED_TILE_CANDIDATES),
        effective,
        lambda cand: kops.fused_mttkrp(x, factors, n, blocks_per_sm=cand[0]),
        reps,
        budget,
        x.device,
    )
    return _summarize_tiles(rows, ("blocks_per_sm",), n)


def _tune_matrix_free_tiles(
    x: Tensor, factors: Sequence[Tensor], *, reps: int, budget: _Budget
) -> dict:
    """Measure the matrix-free kernel's ``blocks_per_sm`` candidates on the
    same representative internal mode as the fused tuner; the winner feeds
    ``NodePlan.tiles`` and the tuner's ``matrix_free`` node measurements."""
    from repro_torch.kernels import matrix_free as mf
    from repro_torch.kernels import ops as kops

    n = x.ndim // 2
    rank = factors[0].shape[-1]

    def effective(cand):  # the kernel's (groups, splits)
        if not x.is_cuda:
            return ()
        g = mf.unbatched_launch_shape(tuple(x.shape), n, rank, cand[0])
        return g.groups, g.splits

    rows = _tile_rows(
        tuple((b,) for b in MATRIX_FREE_TILE_CANDIDATES),
        effective,
        lambda cand: kops.matrix_free_mttkrp(x, factors, n, blocks_per_sm=cand[0]),
        reps,
        budget,
        x.device,
    )
    return _summarize_tiles(rows, ("blocks_per_sm",), n)


def _tune_ttv_tiles(
    x: Tensor, factors: Sequence[Tensor], *, reps: int, budget: _Budget, seed: int
) -> dict:
    """Measure the multi-TTV kernel's ``block_i`` candidates (the 2nd step
    of Alg. 4).

    The winner parameterizes the public kernelized entry point
    ``repro_torch.kernels.ops.mttkrp_2step_kernel(block_i=...)`` -- the
    planner's ``2step-*`` algorithms use the einsum second step, so this
    runs *after* node timing in :func:`tune` and only spends leftover
    budget.  The operands have the representative mode's 2-step shapes,
    ``(min(L, R), I_n, C)`` and ``(min(L, R), C)``, with random payloads
    from a seeded generator on the tensor's device (timing depends on
    shapes, not values).
    """
    from repro_torch.kernels import multi_ttv as mt

    n = x.ndim // 2
    c = factors[0].shape[1]
    big_l, in_dim, big_r = dims_split(x.shape, n)
    small = min(big_l, big_r)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    t3 = torch.randn((small, in_dim, c), generator=gen, device=x.device)
    w2 = torch.randn((small, c), generator=gen, device=x.device)

    def effective(cand):  # the kernel's launch geometry
        return mt.launch_shape(in_dim, small, c, cand[0]) if x.is_cuda else ()

    rows = _tile_rows(
        tuple((b,) for b in TTV_TILE_CANDIDATES),
        effective,
        lambda cand: mt.multi_ttv(t3, w2, block_i=cand[0]),
        reps,
        budget,
        x.device,
    )
    return _summarize_tiles(rows, ("block_i",), n)


def _leaf_algorithms(
    problem: Problem, node: ContractionNode, *, kernels: bool = True
) -> tuple[str, ...]:
    """Algorithm candidates the tuner measures for one root-leaf MTTKRP
    under any executor (the reference's ``kind="local"`` set: the port's
    kernels run on a rank's block too, where the reference measures its
    Pallas kernels locally only), without the ``fused`` and
    ``matrix_free`` kernels when ``kernels`` is False (the tensor's device,
    dtype and rank are not theirs:
    :func:`~repro_torch.kernels._tiling.kernels_take`)."""
    algs = _EXTERNAL_LEAF_ALGORITHMS if problem.external_mode(node.mode) else _LEAF_ALGORITHMS
    return algs if kernels else tuple(a for a in algs if a not in ("fused", "matrix_free"))


def _untuned_tiles(name: str, default: int, mode: int) -> dict:
    """The summary of a kernel's tile table that was not timed (the kernel
    does not take the problem): its default knob, no rows, so the entry
    keeps the reference's layout."""
    return {
        name: default,
        "mode": mode,
        "default_s": None,
        "tuned_s": None,
        "speedup_vs_default": 1.0,
        "rows": [],
    }


def _tune_nodes(
    problem: Problem,
    x: Tensor,
    factors: Sequence[Tensor],
    *,
    reps: int,
    budget: _Budget,
    mesh=None,
    mode_axes: Mapping[int, str] | None = None,
    fused_tiles: Mapping[str, int] | None = None,
    matrix_free_tiles: Mapping[str, int] | None = None,
    kernels: bool = True,
) -> list[dict]:
    """Measure every node of every candidate (schedule x executor) plan.

    The executors are ``"local"`` for an unsharded problem and
    ``"sharded"``, ``"overlapping"`` and ``"compressed"`` for a
    mode-parallel one (on ``mesh`` with ``mode_axes``).  Walks each
    candidate schedule exactly like the sweep engine (parents' outputs
    cached for their children, the compressed executor measured through
    its carry path), timing each deduped :func:`node_key` once.  Root
    leaves are measured under every competing algorithm -- ``fused`` with
    ``fused_tiles`` and ``matrix_free`` with ``matrix_free_tiles`` (the
    already-tuned knobs), so the argmin times exactly the configuration the
    resulting plan will execute; with ``kernels`` False those two are left
    out.  Stops cleanly when ``budget`` runs out: unmeasured nodes keep
    their analytic costs at plan time.  Sharded, every time is the
    maximum over the ranks and the budget's end is agreed (see
    :class:`_Budget`), so every rank walks, times and stores alike.  On a
    two-level problem every node whose reduction spans both levels is
    timed under both collectives, the executors reducing over the
    problem's ``node_axis``.
    """
    from .cost import hierarchical_applicable
    from .executor import make_executor
    from .planner import plan_sweep
    from .schedule import enumerate_schedules

    kinds = ("sharded", "overlapping", "compressed") if problem.mode_axes else ("local",)
    executors = {kind: make_executor(kind, mesh, mode_axes, node_axis=problem.node_axis)
                 for kind in kinds}
    # every sharded kind places the problem alike: one set of blocks
    xs, fs = executors[kinds[0]].prepare(problem, x, list(factors))
    # flat first: its leaves are the full per-mode MTTKRPs every tree shares,
    # and each schedule under every executor before the next schedule, so a
    # tight budget still measures the comparisons that matter most
    schedules = sorted(enumerate_schedules(problem), key=lambda s: not s.is_flat)
    rows: list[dict] = []
    seen: set[str] = set()
    for sched in schedules:
        for kind, ex in executors.items():
            plan = plan_sweep(problem, schedule=sched, executor=kind)
            carry = ex.init_carry(plan, xs, fs) if hasattr(ex, "init_carry") else None
            cache: dict[int, Tensor] = {ROOT: xs}
            for node in sched.walk():
                src = cache[node.parent]
                planned = plan.node_plan(node.id).algorithm
                leaf = node.from_root and node.is_leaf
                algs = _leaf_algorithms(problem, node, kernels=kernels) if leaf else (planned,)
                colls = (("flat", "hierarchical")
                         if hierarchical_applicable(problem, node.reduce_axes) else ("flat",))
                for alg in algs:
                    tl = {"fused": fused_tiles, "matrix_free": matrix_free_tiles}.get(alg)
                    for coll in colls:

                        def fn(node=node, src=src, alg=alg, tl=tl, ex=ex, carry=carry,
                               coll=coll):
                            if carry is not None:
                                return ex.contract_carry(node, src, fs, alg, carry, tiles=tl,
                                                         collective=coll)
                            return ex.contract(node, src, fs, alg, tiles=tl, collective=coll)

                        key = node_key(node, alg, kind, coll)
                        if key not in seen and not budget.exhausted():
                            seen.add(key)
                            rows.append(
                                {
                                    "key": key,
                                    "executor": kind,
                                    "algorithm": alg,
                                    "collective": coll,
                                    "schedule": sched.name,
                                    "node": node.id,
                                    "measured_s": budget.agree(_time(fn, reps, x.device)),
                                }
                            )
                    # the planned contraction (flat) feeds the children, and
                    # a compressed leaf's moves the residuals on
                    if alg == planned and (not node.is_leaf or carry is not None):
                        out = fn(coll="flat")
                        if carry is not None:
                            out, carry = out
                        if not node.is_leaf:
                            cache[node.id] = out
    return rows


def _recalibrate_serial_fractions(
    problem: Problem, rows: Sequence[Mapping[str, Any]]
) -> dict[str, float]:
    """Fit the overlapping executor's unhidable fraction from measured
    pairs, as the reference does.

    For every node measured under both ``sharded`` and ``overlapping`` the
    bounded-overlap model says ``t_sh - t_ov = (1 - f) * min(compute,
    collective)``; the hidable term comes from the same node's analytic
    predictions (``(pred_sh - pred_ov) / predicted_overlap_efficiency``).
    The median over the pairs, each clamped to [0, 1]; ``{}`` when nothing
    paired (an unsharded problem)."""
    from .cost import node_cost
    from .schedule import enumerate_schedules

    if not problem.sharded:
        return {}
    by_key = {r["key"]: float(r["measured_s"]) for r in rows}
    nodes_by_sig: dict[str, ContractionNode] = {}
    for sched in enumerate_schedules(problem):
        for node in sched.walk():
            if not node.is_root:
                nodes_by_sig.setdefault(node_key(node, "x", "x"), node)
    fits: list[float] = []
    for r in rows:
        if r["executor"] != "sharded":
            continue
        t_ov = by_key.get(r["key"].replace("sharded|", "overlapping|", 1))
        node = nodes_by_sig.get(node_key_from(r["key"]))
        if t_ov is None or node is None:
            continue
        kw = dict(algorithm=r["algorithm"]) if node.from_root and node.is_leaf else {}
        pred_sh = node_cost(problem, node, "sharded", **kw)
        pred_ov = node_cost(problem, node, "overlapping", **kw)
        eff = pred_ov.predicted_overlap_efficiency
        if eff <= 0.0:
            continue
        min_term = (pred_sh.predicted_s - pred_ov.predicted_s) / eff
        if min_term <= 0.0:
            continue
        f = 1.0 - (float(r["measured_s"]) - t_ov) / min_term
        fits.append(min(1.0, max(0.0, f)))
    if not fits:
        return {}
    fits.sort()
    return {"sharded": 1.0, "overlapping": fits[len(fits) // 2]}


def node_key_from(key: str) -> str:
    """Normalize a measurement key to its executor/algorithm-free signature
    (the node topology part), for pairing measurements across executors."""
    _, _, rest = key.split("|", 2)
    return f"x|x|{rest}"


def _tune_pp(
    problem: Problem,
    x: Tensor,
    factors: Sequence[Tensor],
    *,
    reps: int,
    budget: _Budget,
    mesh=None,
    mode_axes: Mapping[int, str] | None = None,
) -> dict[str, float]:
    """Measure the two pairwise-perturbation phases of a ``pp_tol > 0``
    problem: ``build_s`` (the cache build: pairwise intermediates and bases,
    what a rebuilding exact sweep pays on top) and ``correct_sweep_s`` (one
    correction-only sweep, what replaces the exact sweep while the drifts
    stay under tolerance).  These are the measured inputs of
    :func:`repro_torch.plan.cost.pp_amortized_cost`.  A sharded problem is
    timed on this rank's blocks under the sharded executor, its sums over
    the mesh included, each time agreed over the ranks."""
    from . import sweep as sweeplib  # lazy: sweep imports planner/executor
    from .executor import make_executor
    from .planner import plan_sweep

    kind = "sharded" if problem.sharded else "local"
    ex = make_executor(kind, mesh, mode_axes, node_axis=problem.node_axis)
    xs, fs = ex.prepare(problem, x, list(factors))
    rows: dict[str, float] = {}
    if budget.exhausted():
        return rows

    def build():
        return sweeplib._pp_materialize(problem, ex, xs, fs, 0)

    rows["build_s"] = budget.agree(_time(build, reps, x.device))
    if budget.exhausted():
        return rows
    plan = plan_sweep(problem, executor=kind, schedule="flat")
    norm = tensor_norm(xs)
    state = sweeplib.SweepState(
        x=xs,
        factors=list(fs),
        weights=torch.ones((problem.rank,), dtype=xs.dtype, device=xs.device),
        norm_x=torch.sqrt(ex.allsum(norm * norm, range(problem.ndim))).to(xs.dtype),
        it=0,
        grams=sweeplib._grams(fs, ex.allsum),
        pp=build(),
    )
    rows["correct_sweep_s"] = budget.agree(
        _time(lambda: sweeplib._pp_sweep(problem, plan, state, ex), reps, x.device)
    )
    return rows


def tune(
    x: Tensor,
    rank: int,
    *,
    factors: Sequence[Tensor] | None = None,
    mesh=None,
    mode_axes: Mapping[int, str] | None = None,
    cache: TuningCache | None = None,
    budget_ms: float | None = 2000.0,
    reps: int = 3,
    seed: int = 0,
    pp_tol: float = 0.0,
    intra_axes: Sequence[str] = (),
) -> dict:
    """Measure tiles + candidate plans for ``x``'s problem; persist winners.

    The one measuring entry point (nothing else runs kernels for timing),
    on the device ``x`` lies on.  In budget priority order it times the
    fused kernel's ``blocks_per_sm`` candidates
    (:data:`FUSED_TILE_CANDIDATES`) and the matrix-free kernel's
    (:data:`MATRIX_FREE_TILE_CANDIDATES`), then every contraction node of
    every candidate schedule on the local executor -- ``fused`` /
    ``matrix_free`` leaves under the just-tuned knobs, so the argmin times
    what will execute -- then the multi-TTV kernel's ``block_i``
    candidates (:data:`TTV_TILE_CANDIDATES`; consumed by the public
    ``mttkrp_2step_kernel``, so it only spends leftover budget).  Each time
    is the median of ``reps`` calls after a warm one, by CUDA events on the
    card and the host clock on the CPU.

    On the card the kernels it may launch are built first (one ``nvcc`` per
    source, in parallel), and only then does the ``budget_ms`` clock start
    (``None`` = no cap): a first build takes tens of seconds, which would
    exhaust any budget after the default candidate, and it is paid once per
    checkout, not per tuned problem.  ``factors`` default to random ones
    from a generator seeded with ``seed`` on ``x``'s device (timing depends
    on shapes, not values).  The entry is stored in ``cache`` (the process
    default when ``None``) under :func:`problem_key` and returned; its
    layout is the reference's (``backend``, ``n_devices``, ``budget_ms``,
    ``reps``, ``elapsed_ms``, ``tiles``, ``nodes``, ``serial_fractions``,
    ``pp``).  Where the CUDA kernels do not take the problem (a CUDA tensor
    of a dtype they are not built for; they take float32, bfloat16, float16
    and float64 at any rank:
    :func:`~repro_torch.kernels._tiling.kernels_take`), no kernel is timed:
    each tile table keeps its default knob and no rows, and no ``fused`` or
    ``matrix_free`` leaf is measured, so the plan falls back to the GEMM
    algorithms (the planner takes a kernel leaf only when it was measured).
    ``pp_tol > 0`` tunes the pairwise-perturbation variant of the problem
    (its own cache key, through the signature's ``|pp`` field) and also
    measures the PP cache build and one correction-only sweep into the
    entry's ``pp`` rows, which ``plan_sweep`` then prefers over the
    analytic PP prices.

    ``mesh`` + ``mode_axes`` tune a sharded problem: call on every rank with
    the same global ``x`` (and ``factors``).  Its nodes are timed under the
    sharded, overlapping and compressed executors on this rank's blocks,
    the overlap constants are fitted from the measured pairs into the
    entry's ``serial_fractions`` (clamped to [0, 1]), and every time, the
    budget's end and ``elapsed_ms`` are agreed over the ranks (the maximum,
    one gather an axis), so every rank stores the same entry; with
    ``pp_tol > 0`` the PP rows are timed on this rank's blocks.
    ``intra_axes`` declares the fast (intra-node) mesh axes of a two-level
    mesh, as on :class:`~repro_torch.plan.problem.Problem`: every node
    whose reduction spans both levels is then timed under the flat and the
    hierarchical collective, and the entry's key carries the node
    topology, so two-level measurements never collide with single-level
    ones.
    """
    cache = cache or default_tuning_cache()
    problem = Problem.from_tensor(x, rank, mode_axes=mode_axes, mesh=mesh, pp_tol=pp_tol,
                                  intra_axes=intra_axes)
    if factors is None:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        factors = random_factors(gen, x.shape, rank, x.dtype, device=x.device)
    factors = list(factors)
    kernels = kernels_take(x.device, x.dtype, rank)
    if x.is_cuda and kernels:
        from repro_torch.kernels import _build
        from repro_torch.kernels import fused_mttkrp as fm
        from repro_torch.kernels import matrix_free as mf
        from repro_torch.kernels import multi_ttv as mt

        _build.build_all([fm.KERNEL, mf.KERNEL, mt.KERNEL])
    budget = _Budget(budget_ms, mesh if problem.sharded else None)
    mode = x.ndim // 2
    if kernels:
        fused = _tune_fused_tiles(x, factors, reps=reps, budget=budget)
        mfree = _tune_matrix_free_tiles(x, factors, reps=reps, budget=budget)
    else:
        fused = _untuned_tiles("blocks_per_sm", FUSED_TILE_CANDIDATES[0], mode)
        mfree = _untuned_tiles("blocks_per_sm", MATRIX_FREE_TILE_CANDIDATES[0], mode)
    rows = _tune_nodes(
        problem, x, factors, reps=reps, budget=budget, mesh=mesh, mode_axes=mode_axes,
        fused_tiles={"blocks_per_sm": fused["blocks_per_sm"]},
        matrix_free_tiles={"blocks_per_sm": mfree["blocks_per_sm"]},
        kernels=kernels,
    )
    tiles = {
        "fused_mttkrp": fused,
        "matrix_free": mfree,
        "multi_ttv": (
            _tune_ttv_tiles(x, factors, reps=reps, budget=budget, seed=seed) if kernels
            else _untuned_tiles("block_i", TTV_TILE_CANDIDATES[0], mode)
        ),
    }
    pp_rows = (
        _tune_pp(problem, x, factors, reps=reps, budget=budget, mesh=mesh, mode_axes=mode_axes)
        if problem.pp_tol > 0.0 else {}
    )
    entry = {
        "backend": backend_name(),
        "n_devices": math.prod(problem.axis_sizes.values()) if problem.axis_sizes else 1,
        "budget_ms": budget_ms,
        "reps": reps,
        "elapsed_ms": budget.agree(budget.elapsed_ms()),
        "tiles": tiles,
        "nodes": rows,
        "serial_fractions": _recalibrate_serial_fractions(problem, rows),
        "pp": pp_rows,
    }
    cache.put(problem_key(problem), entry)
    return entry
