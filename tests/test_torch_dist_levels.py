"""Two-level (hierarchical) reductions and sharded pairwise perturbation of
the port in 8-rank gloo worlds, on the CPU.

The harness is ``tests/test_torch_dist.py``'s: one subprocess a case,
``python tests/test_torch_dist_levels.py <case> <dir>``, spawning 8 gloo
ranks, the inputs made once with numpy from a seed in this process.

* ``hierarchical``: the 2 x 4 ``("node", "device")`` mesh of
  ``make_node_mesh(2, 4)`` with ``{0: "node", 2: "device"}``, as the
  reference's ``tests/dist_worker.py::case_hierarchical_psum``; on its
  tensor (8, 6, 4, 5) no reduction's rows divide by the 4 devices, so every
  hierarchical sum falls back to the flat one, and a second tensor (8, 8,
  4, 12) makes modes 1 and 3 decompose.
* ``pp``: the 2 x 4 ``("data", "model")`` mesh with ``{0: "data", 1:
  "model"}``, the reference's ``pp_sharded`` problem (12, 8, 8) at rank 3
  with 10% planted noise, unbatched and a batch of two, pp_tol 0.05; every
  gate value of the local runs at least 5% away from it.

The reference's functions run in one more subprocess on 8 host devices
(``python tests/test_torch_dist_levels.py reference <dir>``, ``XLA_FLAGS``
set before JAX starts), on the same inputs.  The reference's own
``pp_sharded`` case fails, so the port's sharded PP is held sweep by sweep
against the port's local PP, and only its pairs against the reference's
``dist_pp_pairs``.  Tolerances: the reference case's (hierarchical psum
against flat ``rtol=1e-6, atol=1e-6``; MTTKRPs ``rtol=1e-5, atol=1e-6``;
compressed within ``max|exact| / 127 x 8 + 1e-5``, the residual within
``2.1 max|exact| / 127``; sweeps ``rtol=1e-4, atol=1e-5``; pairs ``rtol=5e-4,
atol=5e-5``; PP factors ``rtol=5e-3, atol=5e-4``).  Bitwise claims hold port
against port: a second run is the first, and every rank holds the same bits.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dist import (  # noqa: E402  (the shared 8-rank harness)
    ROOT,
    TOL,
    WORLD,
    _all_true,
    _assemble,
    _close,
    _factors,
    _normal,
)
from test_torch_dist_exec import _gathered_json  # noqa: E402

CASE_TIMEOUT = 180  # seconds a case subprocess may take
NODE_MESH = (2, 4)  # ("node", "device")
HIER_AXES = {0: "node", 2: "device"}
SHAPES = {"a": (8, 6, 4, 5), "b": (8, 8, 4, 12)}  # the reference's, and one that decomposes
# the plans the sweeps run: the reference case's executor="auto" on its tensor;
# on the second, the flat schedule on the plain sharded executor, whose leaves
# 1 and 3 reduce their whole blocks (rows 8 and 12 over 4 devices)
PLANS = {"a": {"executor": "auto"}, "b": {"executor": "sharded", "schedule": "flat"}}
REFERENCE_KEYS = ("a",)  # the tensors the reference's process runs (each call a compile)
RAW_TOL = dict(rtol=1e-6, atol=1e-6)
MTTKRP_TOL = dict(rtol=1e-5, atol=1e-6)
SWEEP_TOL = dict(rtol=1e-4, atol=1e-5)
HIER_SWEEPS = 3
PP_AXES = {0: "data", 1: "model"}
PP_TOL = 0.05
PP_SWEEPS = 10
PAIR_TOL = dict(rtol=5e-4, atol=5e-5)
PP_FACTOR_TOL = dict(rtol=5e-3, atol=5e-4)
GATE_MARGIN = 0.05  # every gate value at least 5% away from pp_tol
FLEET, FLEET_TOL, FLEET_SWEEPS = 8, 0.25, 5


# ------------------------------------------------------------------ inputs
def _planted(rng, shape, rank, lead=()):
    """A rank-``rank`` tensor with 10% Gaussian noise (of its own std)."""
    planted = [rng.standard_normal(lead + (d, rank)).astype(np.float32) for d in shape]
    x = np.einsum("...ic,...jc,...kc->...ijk", *planted).astype(np.float32)
    return (x + 0.1 * x.std() * rng.standard_normal(x.shape)).astype(np.float32)


def _inputs(case: str) -> dict:
    out = {}
    if case == "hierarchical":
        rng = np.random.default_rng(21)
        out["v"] = np.arange(8 * 12, dtype=np.float32).reshape(8, 12) / 7.0  # the reference's
        for key, shape in SHAPES.items():
            out[f"x{key}"] = _normal(rng, shape)
            out.update({f"f{key}{k}": _normal(rng, (d, 7)) for k, d in enumerate(shape)})
    if case == "pp":
        rng = np.random.default_rng(0)
        out["x"] = _planted(rng, (12, 8, 8), 3)
        out.update({f"f{k}": _normal(rng, (d, 3)) for k, d in enumerate((12, 8, 8))})
        rng = np.random.default_rng(0)
        out["xb"] = _planted(rng, (12, 8, 8), 3, (2,))
        out.update({f"fb{k}": _normal(rng, (2, d, 3)) for k, d in enumerate((12, 8, 8))})
        rng = np.random.default_rng(31)
        out["fleet"] = np.stack([_planted(rng, (6, 5, 4), 2) for _ in range(FLEET)])
    return out


# ---------------------------------------------------------- the rank side
def _gathered(t) -> np.ndarray:
    """Every rank's ``t``, stacked in rank order."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, np.asarray(t.detach().contiguous().numpy()))
    return np.stack(parts)


def _sweeps(problem, plan, ex, x, init, n: int):
    """``n`` engine sweeps of ``plan`` on ``ex`` from ``init``: the states."""
    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.plan import SweepState, als_sweep

    xs, fs = ex.prepare(problem, x, init)
    carry = ex.init_carry(plan, xs, fs) if hasattr(ex, "init_carry") else None
    w, norm_x, states = torch.ones(problem.rank), tensor_norm(x), []
    for it in range(n):
        st = als_sweep(problem, plan, ex, SweepState(x=xs, factors=list(fs), weights=w,
                                                     norm_x=norm_x, it=it, carry=carry))
        fs, w, carry = st.factors, st.weights, st.carry
        states.append(st)
    return states


def _case_hierarchical(mesh, data, out):
    import torch.distributed as dist

    from repro_torch.dist import (
        GATHERS,
        SCATTERS,
        all_gather,
        dist_mttkrp,
        dist_mttkrp_compressed,
        dist_mttkrp_overlapped,
        hierarchical_psum,
        init_mttkrp_error_state,
        ordered_psum,
        reduce_scatter,
    )
    from repro_torch.plan import (
        Problem,
        TuningCache,
        lookup_measurements,
        make_executor,
        plan_sweep,
        tune,
    )

    axes, same = ("node", "device"), True
    # the raw collectives on one row a rank
    v = data["v"][dist.get_rank()]
    flat = ordered_psum(v, axes, mesh)
    SCATTERS.calls = SCATTERS.bytes = GATHERS.calls = 0
    h1 = hierarchical_psum(v, axes, mesh, node_axis="device")
    out["raw/counts"] = np.array([SCATTERS.calls, SCATTERS.bytes, GATHERS.calls])
    h2 = hierarchical_psum(v, axes, mesh, node_axis="device")
    out["raw/flat"], out["raw/hier"] = _gathered(flat), _gathered(h1)
    out["raw/repeat"] = np.array(_all_true(torch.equal(h1, h2)))
    rs = reduce_scatter(v, "device", mesh)
    out["raw/rs"], out["raw/ag"] = _gathered(rs), _gathered(all_gather(rs, "device", mesh))
    SCATTERS.calls = 0
    fallbacks = [
        hierarchical_psum(v, ("device",), mesh, node_axis="device"),  # the only reduced axis
        hierarchical_psum(v, axes, mesh, node_axis=None),
        hierarchical_psum(v, ("node",), mesh, node_axis="device"),  # not among the axes
        hierarchical_psum(v[:10], axes, mesh, node_axis="device"),  # 10 rows over 4 devices
    ]
    wants = [ordered_psum(v, ("device",), mesh), flat, ordered_psum(v, ("node",), mesh),
             ordered_psum(v[:10], axes, mesh)]
    out["raw/fallbacks"] = np.array(
        [SCATTERS.calls, _all_true(all(torch.equal(a, b) for a, b in zip(fallbacks, wants)))])
    # the MTTKRP entries, per tensor and mode, flat against hierarchical
    for key in SHAPES:
        x, fs = data[f"x{key}"], _factors(data, f"f{key}")
        for n in range(4):
            dims = [HIER_AXES.get(n), None]
            f_ = dist_mttkrp(x, fs, n, HIER_AXES, mesh)
            SCATTERS.calls = 0
            h = dist_mttkrp(x, fs, n, HIER_AXES, mesh, collective="hierarchical",
                            node_axis="device")
            scatters = SCATTERS.calls
            h_again = dist_mttkrp(x, fs, n, HIER_AXES, mesh, collective="hierarchical",
                                  node_axis="device")
            SCATTERS.calls = 0
            ov = dist_mttkrp_overlapped(x, fs, n, HIER_AXES, mesh, n_chunks=2,
                                        collective="hierarchical", node_axis="device")
            out[f"{key}/scatters/{n}"] = np.array([scatters, SCATTERS.calls])
            out[f"{key}/repeat/{n}"] = np.array(_all_true(torch.equal(h, h_again)))
            for label, blk in (("flat", f_), ("hier", h), ("ov", ov)):
                out[f"{key}/{label}/{n}"], ok = _assemble(blk, dims, mesh)
                same = same and ok
        # compressed: intra-node exact, cross-node int8; two rounds
        n = 1
        err = init_mttkrp_error_state(x.shape, 7, HIER_AXES, mesh)[n]
        c1, e1 = dist_mttkrp_compressed(x, fs, n, HIER_AXES, mesh, err,
                                        collective="hierarchical", node_axis="device")
        c2, e2 = dist_mttkrp_compressed(x, fs, n, HIER_AXES, mesh, e1,
                                        collective="hierarchical", node_axis="device")
        out[f"{key}/err/shapes"] = np.array([tuple(err.shape), tuple(e1.shape), tuple(e2.shape)])
        out[f"{key}/err/max"] = np.array(_gathered(e2.abs().max()).max())
        for label, blk in (("c1", c1), ("c2", c2)):
            out[f"{key}/{label}"], ok = _assemble(blk, [None, None], mesh)
            same = same and ok
        # the auto plan on the two-level problem, 3 sweeps against the flat plan
        problem = Problem.from_tensor(x, 7, mode_axes=HIER_AXES, mesh=mesh,
                                      intra_axes=("device",))
        plan = plan_sweep(problem, **PLANS[key])
        out[f"{key}/plan/agree"] = np.array(len(set(_gathered_json(plan.describe()))) == 1)
        out[f"{key}/plan"] = np.array(json.dumps({
            "executor": plan.executor, "schedule": plan.resolved_schedule.name,
            "collectives": [np_.collective for np_ in plan.nodes],
            "lower_bound_bytes": plan.lower_bound_bytes,
            "certified": plan.certified_bandwidth_optimal,
            "mode_axes": {str(k): a for k, a in plan.problem.mode_axes.items()},
        }))
        pax = plan.problem.mode_axes
        flat_prob = Problem.from_tensor(x, 7, mode_axes=pax, mesh=mesh)
        tree = ({"schedule": "binary", "split": plan.split} if plan.split is not None
                else {"schedule": plan.resolved_schedule.name})
        flat_plan = plan_sweep(flat_prob, executor=plan.executor, **tree)
        out[f"{key}/flat_plan/collectives"] = np.array(
            sorted({np_.collective for np_ in flat_plan.nodes}))
        ex_h = make_executor(plan.executor, mesh, pax, node_axis=plan.problem.node_axis)
        ex_f = make_executor(flat_plan.executor, mesh, pax)
        SCATTERS.calls = 0
        hier = _sweeps(plan.problem, plan, ex_h, x, fs, HIER_SWEEPS)
        out[f"{key}/sweep/scatters"] = np.array(SCATTERS.calls)
        again = _sweeps(plan.problem, plan, ex_h, x, fs, HIER_SWEEPS)
        flat_states = _sweeps(flat_prob, flat_plan, ex_f, x, fs, HIER_SWEEPS)
        repeat = True
        for it, (a, b, c) in enumerate(zip(hier, again, flat_states)):
            repeat = repeat and all(torch.equal(u, w) for u, w in zip(a.factors, b.factors))
            out[f"{key}/sweep/{it}/fits"] = np.array([float(a.fit), float(c.fit)])
            for j in range(4):
                for label, st in (("hier", a), ("flat", c)):
                    out[f"{key}/sweep/{it}/{label}/f{j}"], ok = _assemble(
                        st.factors[j], [pax.get(j), None], mesh)
                    same = same and ok
        out[f"{key}/sweep/repeat"] = np.array(_all_true(repeat))
    # the two-level tuner: both collectives timed where a reduction spans both levels
    xa = data["xa"]
    cache = TuningCache()
    entry = tune(xa, 7, mesh=mesh, mode_axes=HIER_AXES, intra_axes=("device",), cache=cache,
                 budget_ms=1500.0, reps=1)
    out["tune/agree"] = np.array(len(set(_gathered_json(entry))) == 1)
    out["tune/colls"] = np.array(sorted({r["collective"] for r in entry["nodes"]}))
    out["tune/hier_keys"] = np.array(
        all(r["key"].endswith("|coll=hierarchical") == (r["collective"] == "hierarchical")
            for r in entry["nodes"]))
    problem = Problem.from_tensor(xa, 7, mode_axes=HIER_AXES, mesh=mesh, intra_axes=("device",))
    out["tune/found"] = np.array(lookup_measurements(problem, cache) is not None)
    tuned = plan_sweep(problem, "autotune", tuning_cache=cache)
    out["tune/plan/agree"] = np.array(len(set(_gathered_json(tuned.describe()))) == 1)
    out["replicas"] = np.array(same)


class _PPRecorder:
    """Records one PP run's exact ('E') and approximate ('a') sweeps, the
    host-gate reads and each sweep's output factors (the engine looks its
    steps up by name at call time)."""

    def __init__(self):
        from repro_torch.plan import sweep

        self.sweep = sweep
        self.real = {k: getattr(sweep, k) for k in ("_exact_sweep", "_pp_sweep", "_host_gate")}
        self.seq, self.reads, self.factors = [], [], []

    def __enter__(self):
        real = self.real

        def exact(*a, **k):
            self.seq.append("E")
            st = real["_exact_sweep"](*a, **k)
            self.factors.append(st.factors)
            return st

        def approx(*a, **k):
            self.seq.append("a")
            st = real["_pp_sweep"](*a, **k)
            self.factors.append(st.factors)
            return st

        def gate(d):
            self.reads.append(real["_host_gate"](d))
            return self.reads[-1]

        self.sweep._exact_sweep, self.sweep._pp_sweep, self.sweep._host_gate = exact, approx, gate
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.sweep, k, fn)

    @property
    def pattern(self) -> str:
        return "".join(self.seq)


def _case_pp(mesh, data, out):
    from repro_torch.dist import dist_pp_pairs
    from repro_torch.plan import (
        Problem,
        TuningCache,
        cp_als,
        make_executor,
        plan_sweep,
        tune,
    )
    from repro_torch.serve import CPService

    same = True
    for key, x, init, batch in (("u", data["x"], _factors(data), None),
                                ("b", data["xb"], _factors(data, "fb"), 2)):
        bx = None if batch is None else ()  # a batch whole on every rank
        kw = {} if batch is None else {"batch": batch}
        problem = Problem.from_tensor(x, 3, PP_AXES, mesh, pp_tol=PP_TOL, **kw)
        plan = plan_sweep(problem, "pp")
        ex = make_executor("sharded", mesh, plan.problem.mode_axes,
                           batch_axes=plan.problem.batch_axes)
        out[f"{key}/placement"] = np.array(plan.describe()["placement"])
        # the pair cache at the inits: the executor on the blocks, the global entry
        xs, fs = ex.prepare(plan.problem, x, init)
        pairs = ex.pp_pairs(plan.problem, xs, fs)
        entry = dist_pp_pairs(x, init, PP_AXES, mesh)
        out[f"{key}/pairs/entry_same"] = np.array(
            _all_true(all(torch.equal(pairs[k], entry[k]) for k in pairs)))
        for (n, m), blk in pairs.items():
            out[f"{key}/pairs/{n}{m}"], ok = _assemble(
                blk, [None, PP_AXES.get(n), PP_AXES.get(m)], mesh, bx)
            same = same and ok
        runs = []
        for _ in range(2):
            with _PPRecorder() as rec:
                st = cp_als(x, plan, executor=ex, n_iters=PP_SWEEPS, tol=0.0, init_factors=init)
            runs.append((rec, st))
        rec, st = runs[0]
        out[f"{key}/pattern"] = np.array(rec.pattern)
        out[f"{key}/exact"] = np.array(st.pp_exact_sweeps)
        out[f"{key}/reads"] = np.array(rec.reads)
        out[f"{key}/reads_agree"] = np.array(
            len(set(_gathered_json([float(r) for r in rec.reads]))) == 1)
        out[f"{key}/repeat"] = np.array(_all_true(
            runs[1][0].pattern == rec.pattern
            and all(torch.equal(a, b) for fa, fb in zip(rec.factors, runs[1][0].factors)
                    for a, b in zip(fa, fb))))
        for it, blocks in enumerate(rec.factors):
            for j, b in enumerate(blocks):
                out[f"{key}/sweep/{it}/f{j}"], ok = _assemble(b, [PP_AXES.get(j), None], mesh, bx)
                same = same and ok
    # the sharded tuner's PP rows, agreed over the ranks, and the plan priced on them
    x = data["x"]
    cache = TuningCache()
    entry = tune(x, 3, mesh=mesh, mode_axes=PP_AXES, pp_tol=PP_TOL, cache=cache, budget_ms=None,
                 reps=1)
    out["tune/agree"] = np.array(len(set(_gathered_json(entry))) == 1)
    out["tune/pp"] = np.array(json.dumps(entry["pp"]))
    tuned = plan_sweep(Problem.from_tensor(x, 3, PP_AXES, mesh, pp_tol=PP_TOL), "autotune",
                       tuning_cache=cache)
    out["tune/basis"] = np.array(tuned.describe()["pp"]["basis"])
    # the service: a PP fleet batch-parallel over the 8 ranks
    svc = CPService(batch_size=FLEET, n_iters=FLEET_SWEEPS, tol=0.0, pp_tol=FLEET_TOL,
                    strategy="pp", mesh=mesh, device="cpu")
    futures = [svc.submit(t, 2, seed=i) for i, t in enumerate(data["fleet"])]
    with _PPRecorder() as rec:
        svc.flush()
    results = [f.result() for f in futures]
    payload = [[u.tolist() for u in r.factors] + [r.weights.tolist(), r.fit] for r in results]
    out["serve/agree"] = np.array(len(set(_gathered_json(payload))) == 1)
    out["serve/pattern"] = np.array(rec.pattern)
    out["serve/plan"] = np.array(json.dumps([st.plan.pp for st in svc._states.values()]))
    for i, r in enumerate(results):
        out[f"serve/{i}/fit"] = np.array(r.fit)
        for j, u in enumerate(r.factors):
            out[f"serve/{i}/f{j}"] = u.numpy()
    out["replicas"] = np.array(same)


CASES = {"hierarchical": _case_hierarchical, "pp": _case_pp}


def _rank_main(rank: int, case: str, root: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_node_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    try:
        if case == "hierarchical":
            mesh = make_node_mesh(*NODE_MESH, device="cpu")
        else:
            mesh = make_host_mesh(2, 4, device="cpu")
        data = {k: torch.from_numpy(v) for k, v in np.load(f"{root}/inputs.npz").items()}
        out = {}
        CASES[case](mesh, data, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- the reference's side
def _reference(root: str) -> None:
    """The reference's ``case_hierarchical_psum`` functions and its
    ``dist_pp_pairs`` on 8 host devices, on the inputs of both cases
    (``XLA_FLAGS`` is set by the caller before JAX starts)."""
    import importlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core.tensor_ops import tensor_norm
    from repro.dist.collectives import hierarchical_psum
    from repro.launch.mesh import make_node_mesh
    from repro.plan import Problem, SweepState, als_sweep, make_executor, plan_sweep

    dm = importlib.import_module("repro.dist.dist_mttkrp")
    assert jax.device_count() == WORLD, jax.device_count()
    out = {}
    hd = dict(np.load(f"{root}/hierarchical.npz"))
    mesh = make_node_mesh(*NODE_MESH)

    def raw(blk):
        blk = blk[0]
        h = hierarchical_psum(blk, ("node", "device"), mesh, node_axis="device")
        return h[None]

    out["raw/hier"] = np.asarray(compat.shard_map(
        raw, mesh=mesh, in_specs=P(("node", "device")), out_specs=P(("node", "device")),
        check_vma=False)(jnp.asarray(hd["v"])))
    for key in REFERENCE_KEYS:
        x = jnp.asarray(hd[f"x{key}"])
        fs = [jnp.asarray(u) for u in _factors(hd, f"f{key}")]
        xs, fss = dm.shard_problem(x, fs, HIER_AXES, mesh)
        for n in range(4):
            out[f"{key}/hier/{n}"] = np.asarray(dm.dist_mttkrp(
                xs, fss, n, HIER_AXES, mesh, collective="hierarchical", node_axis="device"))
            out[f"{key}/ov/{n}"] = np.asarray(dm.dist_mttkrp_overlapped(
                xs, fss, n, HIER_AXES, mesh, n_chunks=2, collective="hierarchical",
                node_axis="device"))
        n = 1
        err = dm.init_mttkrp_error_state(x.shape, 7, HIER_AXES, mesh)[n]
        c1, e1 = dm.dist_mttkrp_compressed(xs, fss, n, HIER_AXES, mesh, err,
                                           collective="hierarchical", node_axis="device")
        c2, _ = dm.dist_mttkrp_compressed(xs, fss, n, HIER_AXES, mesh, e1,
                                          collective="hierarchical", node_axis="device")
        out[f"{key}/c1"], out[f"{key}/c2"] = np.asarray(c1), np.asarray(c2)
        problem = Problem.from_tensor(x, 7, mode_axes=HIER_AXES, mesh=mesh,
                                      intra_axes=("device",))
        plan = plan_sweep(problem, **PLANS[key])
        pax = plan.problem.mode_axes
        ex = make_executor(plan.executor, mesh, pax, node_axis=plan.problem.node_axis)
        xs2, f_h = dm.shard_problem(x, fs, pax, mesh)
        w, norm_x = jnp.ones((7,), x.dtype), tensor_norm(x)
        sweep = jax.jit(lambda st: als_sweep(plan.problem, plan, ex, st))  # one compile
        for it in range(HIER_SWEEPS):
            st = sweep(SweepState(x=xs2, factors=f_h, weights=w, norm_x=norm_x,
                                  it=jnp.asarray(it)))
            f_h, w = st.factors, st.weights
            out[f"{key}/sweep/{it}/fit"] = np.asarray(st.fit)
            for j, u in enumerate(f_h):
                out[f"{key}/sweep/{it}/f{j}"] = np.asarray(u)
    pd = dict(np.load(f"{root}/pp.npz"))
    pmesh = jax.make_mesh((2, 4), ("data", "model"))
    for key, xk, fk in (("u", "x", "f"), ("b", "xb", "fb")):
        x = jnp.asarray(pd[xk])
        fs = [jnp.asarray(u) for u in _factors(pd, fk)]
        xs, fss = dm.shard_problem(x, fs, PP_AXES, pmesh)
        for (n, m), p in dm.dist_pp_pairs(xs, fss, PP_AXES, pmesh).items():
            out[f"{key}/pairs/{n}{m}"] = np.asarray(p)
    np.savez(f"{root}/out.npz", **out)


# -------------------------------------------------------- the pytest side
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(case)``: the case's results.  The first call starts the
    reference's process and runs the 8-rank cases beside it, one after the
    other; a failure is kept and raised to every test of the case."""
    done, jobs = {}, {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def start_reference():
        if "reference" in jobs:
            return
        root = tmp_path_factory.mktemp("reference")
        for case in CASES:
            np.savez(root / f"{case}.npz", **_inputs(case))
        ref_env = {**env, "JAX_PLATFORMS": "cpu",
                   "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
        jobs["reference"] = (root, subprocess.Popen(
            [sys.executable, __file__, "reference", str(root)], cwd=ROOT, env=ref_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def finish(case, root, proc):
        try:
            _, err = proc.communicate(timeout=CASE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            return AssertionError(f"case {case} ran over {CASE_TIMEOUT} s")
        if proc.returncode != 0:
            return AssertionError(f"case {case} failed:\n{err[-4000:]}")
        return dict(np.load(root / "out.npz"))

    def get(case):
        start_reference()
        if case == "reference" and case not in done:
            done[case] = finish(case, *jobs["reference"])
        for c in CASES if case not in done else ():
            if c not in done:
                root = tmp_path_factory.mktemp(c)
                np.savez(root / "inputs.npz", **_inputs(c))
                proc = subprocess.Popen([sys.executable, __file__, c, str(root)], cwd=ROOT,
                                        env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                done[c] = finish(c, root, proc)
        if isinstance(done[case], Exception):
            raise done[case]
        return done[case]

    yield get
    for _, proc in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _decomposes(shape, n: int) -> bool:
    """Whether mode ``n``'s reduction on the node mesh spans both levels and
    its local rows divide by the 4 devices (else the flat fallback)."""
    axes = [HIER_AXES[m] for m in sorted(HIER_AXES) if m != n]
    sizes = dict(zip(("node", "device"), NODE_MESH))
    rows = shape[n] // sizes.get(HIER_AXES.get(n), 1)
    return set(axes) == {"node", "device"} and rows % sizes["device"] == 0


# ---------------------------------------------------------- hierarchical
def test_hierarchical_psum_is_the_flat_sum_and_repeats_bitwise(run):
    res, ref = run("hierarchical"), run("reference")
    v = _inputs("hierarchical")["v"]
    _close(res["raw/flat"], res["raw/hier"], tol=RAW_TOL)
    _close(v.sum(0)[None].repeat(8, 0), res["raw/hier"], tol=RAW_TOL)
    _close(ref["raw/hier"], res["raw/hier"], tol=RAW_TOL)
    assert bool(res["raw/repeat"])
    # one reduce-scatter (12 rows over 4 devices: 3 a chunk, 9 floats sent),
    # the cross-node gather of the shard and the gather back
    assert res["raw/counts"].tolist() == [1, 9 * 4, 2]
    assert (res["raw/hier"] == res["raw/hier"][0]).all()  # every rank the same bits


def test_reduce_scatter_and_all_gather_split_and_join_a_node_sum(run):
    res, v = run("hierarchical"), _inputs("hierarchical")["v"]
    for r in range(WORLD):
        node, dev = divmod(r, NODE_MESH[1])
        node_sum = v[node * 4:(node + 1) * 4].sum(0)
        _close(node_sum[3 * dev:3 * dev + 3], res["raw/rs"][r], tol=RAW_TOL)
        _close(node_sum, res["raw/ag"][r], tol=RAW_TOL)


def test_hierarchical_psum_falls_back_to_the_flat_sum(run):
    """The only reduced axis, no node axis, a node axis not reduced, rows
    the node axis does not divide: the flat ordered sum, bitwise, and no
    reduce-scatter."""
    assert run("hierarchical")["raw/fallbacks"].tolist() == [0, 1]


@pytest.mark.parametrize("key", sorted(SHAPES))
@pytest.mark.parametrize("n", range(4))
def test_hierarchical_dist_mttkrp_matches_flat_and_the_reference(run, key, n):
    """Against the port's flat entry and the reference's hierarchical
    entries on 8 host devices (its case's tensor), or the reference's local
    MTTKRP at the fp32 tolerance (the second tensor)."""
    from repro.core.mttkrp import mttkrp as jmttkrp

    res, ref, data = run("hierarchical"), run("reference"), _inputs("hierarchical")
    flat = res[f"{key}/flat/{n}"]
    want = np.asarray(jmttkrp(data[f"x{key}"], _factors(data, f"f{key}"), n))
    for label in ("hier", "ov"):
        got = res[f"{key}/{label}/{n}"]
        _close(flat, got, tol=MTTKRP_TOL, msg=label)
        _close(want, got, tol=TOL, msg=label)
        if key in REFERENCE_KEYS:
            _close(ref[f"{key}/{label}/{n}"], got, tol=MTTKRP_TOL, msg=label)
    assert bool(res[f"{key}/repeat/{n}"]) and bool(res["replicas"])
    # one reduce-scatter where the sum decomposes; the overlapped entry's two
    # slabs decompose where their rows divide by the devices too
    shape = SHAPES[key]
    rows = shape[n] // (2 if HIER_AXES.get(n) == "node" else 4 if n in HIER_AXES else 1)
    slabs = [rows // 2 + rows % 2, rows // 2] if rows > 1 else [rows]
    want_ov = sum(1 for s in slabs if _decomposes(shape, n) and s % 4 == 0) if rows > 1 else (
        int(_decomposes(shape, n)))
    assert res[f"{key}/scatters/{n}"].tolist() == [int(_decomposes(shape, n)), want_ov]


def test_the_second_tensor_decomposes_and_the_reference_tensor_falls_back():
    assert [_decomposes(SHAPES["a"], n) for n in range(4)] == [False] * 4
    assert [_decomposes(SHAPES["b"], n) for n in range(4)] == [False, True, False, True]


@pytest.mark.parametrize("key", sorted(SHAPES))
def test_compressed_hierarchical_stays_within_a_step(run, key):
    """The intra-node stage exact, the cross-node one int8 with error
    feedback: within ``max|exact| / 127 x 8`` of the exact sum after one and
    two rounds, the residual's shape kept and bounded by ``2.1 max|exact| /
    127``; the reference's compressed results within the same bound."""
    res, ref = run("hierarchical"), run("reference")
    exact = res[f"{key}/flat/1"]
    scale = float(np.abs(exact).max()) / 127.0 * 8
    for label in ("c1", "c2"):
        np.testing.assert_allclose(res[f"{key}/{label}"], exact, rtol=0, atol=scale + 1e-5)
        if key in REFERENCE_KEYS:
            np.testing.assert_allclose(ref[f"{key}/{label}"], exact, rtol=0, atol=scale + 1e-5)
    shapes = res[f"{key}/err/shapes"].tolist()
    assert shapes[0] == shapes[1] == shapes[2] == [SHAPES[key][1], 7]
    assert float(res[f"{key}/err/max"]) <= 2.1 * float(np.abs(exact).max()) / 127.0 + 1e-6


@pytest.mark.parametrize("key", sorted(SHAPES))
def test_auto_plan_runs_hierarchical_sweeps_that_match_the_flat_plan(run, key):
    """The two-level plan (the reference case's ``executor="auto"`` on its
    tensor) has a hierarchical node and a positive bound; its 3 sweeps
    match the same tree planned flat, and the reference's sweeps on its
    tensor; a second run is bitwise the first."""
    res, ref = run("hierarchical"), run("reference")
    plan = json.loads(str(res[f"{key}/plan"]))
    assert bool(res[f"{key}/plan/agree"])
    assert "hierarchical" in plan["collectives"], plan
    assert plan["lower_bound_bytes"] is not None and plan["lower_bound_bytes"] > 0
    assert res[f"{key}/flat_plan/collectives"].tolist() == ["flat"]
    assert bool(res[f"{key}/sweep/repeat"]) and bool(res["replicas"])
    for it in range(HIER_SWEEPS):
        fits = res[f"{key}/sweep/{it}/fits"]
        np.testing.assert_allclose(fits[0], fits[1], rtol=0, atol=1e-5)
        if key in REFERENCE_KEYS:
            np.testing.assert_allclose(fits[0], ref[f"{key}/sweep/{it}/fit"], rtol=0, atol=1e-5)
        for j in range(4):
            got = res[f"{key}/sweep/{it}/hier/f{j}"]
            _close(res[f"{key}/sweep/{it}/flat/f{j}"], got, tol=SWEEP_TOL, msg=f"{it} {j}")
            if key in REFERENCE_KEYS:
                _close(ref[f"{key}/sweep/{it}/f{j}"], got, tol=SWEEP_TOL, msg=f"ref {it} {j}")


def test_the_second_tensor_runs_hierarchical_reductions_in_its_sweeps(run):
    """One reduce-scatter a sweep for each leaf planned hierarchical whose
    rows divide by the devices (the flat schedule: node ``n`` is mode
    ``n``'s leaf)."""
    res = run("hierarchical")
    plan = json.loads(str(res["b/plan"]))
    assert plan["schedule"] == "flat" and plan["mode_axes"] == {"0": "node", "2": "device"}
    want = sum(1 for n, c in enumerate(plan["collectives"])
               if c == "hierarchical" and _decomposes(SHAPES["b"], n))
    assert want == 2 and int(res["b/sweep/scatters"]) == HIER_SWEEPS * want


def test_two_level_tune_times_both_collectives_on_every_rank(run):
    res = run("hierarchical")
    assert bool(res["tune/agree"]) and bool(res["tune/found"]) and bool(res["tune/plan/agree"])
    assert res["tune/colls"].tolist() == ["flat", "hierarchical"]
    assert bool(res["tune/hier_keys"])


# ------------------------------------------------------------ sharded PP
def _local_pp(x, init, batch=None):
    """The port's local PP run from ``init``: (pattern, host-gate reads,
    each sweep's factors), and its pairs at the inits."""
    from repro_torch.plan import LocalExecutor, Problem, cp_als, plan_sweep

    xt = torch.from_numpy(x)
    ft = [torch.from_numpy(u) for u in init]
    kw = {} if batch is None else {"batch": batch}
    problem = Problem.from_tensor(xt, 3, pp_tol=PP_TOL, **kw)
    with _PPRecorder() as rec:
        cp_als(xt, plan_sweep(problem, "pp"), n_iters=PP_SWEEPS, tol=0.0, init_factors=ft)
    pairs = LocalExecutor().pp_pairs(problem, xt, ft)
    return rec, pairs


@pytest.mark.parametrize("key", ["u", "b"])
def test_sharded_pairs_match_the_local_and_the_reference_pairs(run, key):
    res, ref, data = run("pp"), run("reference"), _inputs("pp")
    x, init = (data["x"], _factors(data)) if key == "u" else (data["xb"], _factors(data, "fb"))
    _, pairs = _local_pp(x, init, None if key == "u" else 2)
    assert bool(res[f"{key}/pairs/entry_same"]) and bool(res["replicas"])
    assert str(res[f"{key}/placement"]) == "mode-parallel"
    for (n, m), p in pairs.items():
        got = res[f"{key}/pairs/{n}{m}"]
        _close(p.numpy(), got, tol=PAIR_TOL, msg=f"pair {n}{m}")
        _close(ref[f"{key}/pairs/{n}{m}"], got, tol=PAIR_TOL, msg=f"ref pair {n}{m}")


@pytest.mark.parametrize("key", ["u", "b"])
def test_sharded_pp_takes_the_local_sequence_sweep_by_sweep(run, key):
    """The same exact/approximate sequence as the port's local PP (every
    gate value of the local run at least 5% away from pp_tol), the factors
    of every sweep within the PP tolerance, the same host reads on every
    rank, and a second run bitwise the first."""
    res, data = run("pp"), _inputs("pp")
    x, init = (data["x"], _factors(data)) if key == "u" else (data["xb"], _factors(data, "fb"))
    rec, _ = _local_pp(x, init, None if key == "u" else 2)
    margins = [abs(g - PP_TOL) / PP_TOL for g in rec.reads if np.isfinite(g)]
    assert min(margins) >= GATE_MARGIN, rec.reads
    assert "a" in rec.pattern and "E" in rec.pattern
    assert str(res[f"{key}/pattern"]) == rec.pattern
    assert int(res[f"{key}/exact"]) == rec.pattern.count("E")
    assert bool(res[f"{key}/reads_agree"]) and bool(res[f"{key}/repeat"])
    np.testing.assert_allclose(res[f"{key}/reads"], rec.reads, rtol=1e-4, atol=1e-6)
    for it, fs in enumerate(rec.factors):
        for j, u in enumerate(fs):
            _close(u.numpy(), res[f"{key}/sweep/{it}/f{j}"], tol=PP_FACTOR_TOL,
                   msg=f"sweep {it} factor {j}")


def test_sharded_tune_measures_pp_rows_on_every_rank(run):
    res = run("pp")
    pp = json.loads(str(res["tune/pp"]))
    assert set(pp) == {"build_s", "correct_sweep_s"} and all(v > 0 for v in pp.values())
    assert bool(res["tune/agree"]) and str(res["tune/basis"]) == "measured"


def test_sharded_pp_service_serves_the_single_device_results(run):
    """``CPService(mesh=, pp_tol=)`` batch-parallel over 8 ranks: every rank
    resolves the same results, which are the single-device PP service's at
    tolerance, after the same exact/approximate sequence."""
    from repro_torch.serve import CPService

    res, data = run("pp"), _inputs("pp")
    assert bool(res["serve/agree"]) and json.loads(str(res["serve/plan"])) == [True]
    svc = CPService(batch_size=FLEET, n_iters=FLEET_SWEEPS, tol=0.0, pp_tol=FLEET_TOL,
                    strategy="pp", device="cpu")
    futures = [svc.submit(torch.from_numpy(t), 2, seed=i) for i, t in enumerate(data["fleet"])]
    with _PPRecorder() as rec:
        svc.flush()
    margins = [abs(g - FLEET_TOL) / FLEET_TOL for g in rec.reads if np.isfinite(g)]
    assert min(margins) >= GATE_MARGIN, rec.reads
    assert "a" in rec.pattern and str(res["serve/pattern"]) == rec.pattern
    for i, f in enumerate(futures):
        r = f.result()
        _close(r.fit, res[f"serve/{i}/fit"], tol=PP_FACTOR_TOL)
        for j, u in enumerate(r.factors):
            _close(u.numpy(), res[f"serve/{i}/f{j}"], tol=PP_FACTOR_TOL, msg=f"{i} {j}")


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    if case_ == "reference":
        _reference(root_)
    else:
        torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
