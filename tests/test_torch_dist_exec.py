"""The sharded executor menu of the port in 8-rank gloo worlds, on the CPU.

Distribution slices 2 and 3 -- the overlapping executor (each node's
reduction issued slab by slab behind the contraction) and the compressed
one (the int8 error-feedback gather, its residuals carried through the
sweep), ``executor="auto"`` on a sharded problem -- and the sharded tuner
and service on top of them (``tune(mesh=)``, ``CPService(mesh=)``,
``serve_cp --mesh``).

The harness is ``tests/test_torch_dist.py``'s: one subprocess a case,
``python tests/test_torch_dist_exec.py <case> <dir>``, spawning 8 gloo
ranks on the 2 x 4 ``("data", "model")`` mesh, the inputs made once with
numpy from a seed in this process.  The reference's distributed functions
run in one more subprocess on 8 host devices (``python
tests/test_torch_dist_exec.py reference <dir>``, reading the same inputs;
``XLA_FLAGS`` must be set before JAX starts).  Tolerances: a full-MTTKRP
leaf cut into slabs ``rtol=1e-5, atol=1e-6`` (the reference's own case's);
sweeps the port's fp32 ``rtol=2e-4, atol=2e-5``; tree partials under the
overlapping executor bitwise the sharded executor's (port against port);
compressed results within one quantization step per participant of the
reference's (``max|val| / 127 x p``), residuals within one step.  Neither
the reference's bitwise overlap claim nor its failing ``compressed_psum``
test is an oracle: the reference's ``compressed_psum`` is called directly
here, its result read through ``np.asarray``.
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
    CPALS_AXES,
    MESH,
    MTTKRP_AXES,
    ROOT,
    TOL,
    WORLD,
    _all_true,
    _assemble,
    _close,
    _factors,
    _normal,
)

CASE_TIMEOUT = 180  # seconds a case subprocess may take
LEAF_TOL = dict(rtol=1e-5, atol=1e-6)  # a full MTTKRP cut into slabs
OVERLAP_CHUNKS = (1, 2, 3, 8)
REFERENCE_CHUNKS = 3  # the chunk count the reference's overlapped entry runs at
BATCH_AXES = {0: "model"}  # the batched case: mode 0 on "model", the batch on "data"
SCHEDULES = ("flat", "binary", "chain")
TREE_SWEEPS = 3
COMPRESSED_SWEEPS = 40  # the reference's compressed_cpals budget
RANGE_NODES = ((0, 2), (2, 4), (1, 3))
PARTIAL_NODES = (((0, 2), (1, 2)), ((2, 4), (3, 4)), ((1, 4), (1, 2)))
FLEET = 12  # requests served by the 8-rank service: two batches of 8, the second padded


# ------------------------------------------------------------------ inputs
def _inputs(case: str) -> dict:
    rng = np.random.default_rng({"overlap": 11, "compressed": 12, "front": 13}[case])
    out = {}
    if case in ("overlap", "compressed"):
        out["x"] = _normal(rng, (8, 6, 4, 5))  # the reference's dist_mttkrp shape, rank 7
        out.update({f"f{k}": _normal(rng, (d, 7)) for k, d in enumerate(out["x"].shape)})
        out["xt"] = _normal(rng, (8, 6, 8, 4))  # the reference's dist_dimtree shape, rank 3
        out.update({f"ft{k}": _normal(rng, (d, 3)) for k, d in enumerate(out["xt"].shape)})
    if case == "overlap":
        out["xb"] = _normal(rng, (4, 8, 6, 5))  # 4 problems of (8, 6, 5)
        out.update({f"fb{k}": _normal(rng, (4, d, 3)) for k, d in enumerate((8, 6, 5))})
    if case == "compressed":
        out["xp"] = np.arange(64, dtype=np.float32).reshape(8, 8) / 7.0  # the reference's
        planted = [_normal(rng, (8, 3)) for _ in range(3)]
        out["xc"] = np.einsum("ic,jc,kc->ijk", *planted).astype(np.float32)
        out.update({f"fc{k}": _normal(rng, (8, 3)) for k in range(3)})
    if case == "front":
        out["xs"] = _normal(rng, (8, 8, 8))
        out["fleet"] = _normal(rng, (FLEET, 6, 5, 4))
    return out


def _overlap_gathers(plan, n_chunks: int) -> int:
    """Gathers of one overlapping sweep's node reductions: a node reducing
    over ``a`` axes in ``k`` slabs makes ``a * k``; ``k`` is ``n_chunks``
    capped by the local extent of the node's first kept mode."""
    local = plan.problem.local_shape
    total = 0
    for node in plan.resolved_schedule.walk():
        if node.reduce_axes:
            k = max(1, min(n_chunks, local[node.lo])) if n_chunks > 1 else 1
            total += len(node.reduce_axes) * k
    return total


def _to_reference_layout(err, reduce_axes, kept, mesh):
    """This rank's residual block laid into the reference's global layout:
    one leading axis a reduced mesh axis, then the output's dims."""
    block = err.reshape((1,) * len(reduce_axes) + tuple(err.shape))
    return _assemble(block, list(reduce_axes) + list(kept) + [None], mesh)


# ---------------------------------------------------------- the rank side
def _case_overlap(mesh, data, out):
    from repro_torch.dist import (
        GATHERS,
        SLAB_COPIES,
        dist_mttkrp,
        dist_mttkrp_overlapped,
    )
    from repro_torch.plan import Problem, cp_als, make_executor, plan_sweep
    from repro_torch.plan.schedule import ROOT as TREE_ROOT

    x, fs, ax = data["x"], _factors(data), MTTKRP_AXES
    same = True
    for n in range(4):
        out[f"plain/{n}"], ok = _assemble(dist_mttkrp(x, fs, n, ax, mesh), [ax.get(n), None], mesh)
        same = same and ok
        for c in OVERLAP_CHUNKS:
            GATHERS.calls = SLAB_COPIES.calls = 0
            blk = dist_mttkrp_overlapped(x, fs, n, ax, mesh, n_chunks=c)
            out[f"calls/{n}/{c}"] = np.array([GATHERS.calls, SLAB_COPIES.calls])
            out[f"ov/{n}/{c}"], ok = _assemble(blk, [ax.get(n), None], mesh)
            same = same and ok
        for m in ("fused", "matrix_free"):
            blk = dist_mttkrp_overlapped(x, fs, n, ax, mesh, method=m, n_chunks=3)
            out[f"ov/{m}/{n}"], ok = _assemble(blk, [ax.get(n), None], mesh)
            same = same and ok
    xb, fb, bx = data["xb"], _factors(data, "fb"), ("data",)
    for n in range(3):
        for c in (2, 3):
            GATHERS.calls = 0
            blk = dist_mttkrp_overlapped(xb, fb, n, BATCH_AXES, mesh, n_chunks=c, batch_axes=bx)
            out[f"calls/b/{n}/{c}"] = np.array(GATHERS.calls)
            out[f"ovb/{n}/{c}"], ok = _assemble(blk, [BATCH_AXES.get(n), None], mesh, bx)
            same = same and ok
    # tree nodes from one source under both executors, then whole sweeps
    xt, ft = data["xt"], _factors(data, "ft")
    prob = Problem.from_tensor(xt, 3, ax, mesh)
    sh = make_executor("sharded", mesh, ax)
    ov = make_executor("overlapping", mesh, ax, n_chunks=2)
    xs, fs_ = sh.prepare(prob, xt, ft)
    for name in SCHEDULES:
        plan = plan_sweep(prob, "1step", executor="overlapping", schedule=name)
        cache = {TREE_ROOT: xs}
        bitwise, close = True, True
        for node in plan.resolved_schedule.walk():
            a = sh.contract(node, cache[node.parent], fs_, "1step")
            b = ov.contract(node, cache[node.parent], fs_, "1step")
            if node.from_root and node.is_leaf:
                close = close and torch.allclose(b, a, **LEAF_TOL)
            else:
                bitwise = bitwise and torch.equal(a, b) and a.stride() == b.stride()
            cache[node.id] = a
        out[f"nodes/{name}"] = np.array([_all_true(bitwise), _all_true(close)])
        for kind in ("sharded", "overlapping"):
            fits = []
            GATHERS.calls = 0
            kplan = plan_sweep(prob, "1step", executor=kind, schedule=name)
            st = cp_als(xt, kplan, executor=make_executor(kind, mesh, ax, n_chunks=2),
                        n_iters=TREE_SWEEPS, tol=0.0, init_factors=ft,
                        callback=lambda it, f, dt: fits.append(f))
            out[f"sweep/{name}/{kind}/calls"] = np.array(GATHERS.calls)
            out[f"sweep/{name}/{kind}/want"] = np.array(_overlap_gathers(kplan, 2)
                                                        if kind == "overlapping" else -1)
            out[f"sweep/{name}/{kind}/fits"] = np.array(fits)
            for j, b in enumerate(st.factors):
                out[f"sweep/{name}/{kind}/f{j}"], ok = _assemble(b, [ax.get(j), None], mesh)
                same = same and ok
            out[f"sweep/{name}/{kind}/w"] = st.weights.numpy()
    out["replicas"] = np.array(same)


def _case_compressed(mesh, data, out):
    import torch.distributed as dist

    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.dist import (
        GATHERS,
        INT8_GATHERS,
        compressed_psum,
        dist_contract_partial,
        dist_contract_partial_compressed,
        dist_contract_range,
        dist_contract_range_compressed,
        dist_cp_als,
        dist_mttkrp_compressed,
        init_mttkrp_error_state,
    )
    from repro_torch.core.dimtree import partial_mttkrp_range
    from repro_torch.plan import Problem, SweepState, als_sweep, cp_als, make_executor, plan_sweep

    same = True
    # compressed_psum over both axes (8 participants), two rounds
    row = data["xp"][dist.get_rank()]
    INT8_GATHERS.calls = GATHERS.calls = 0
    s1, e1 = compressed_psum(row, ("data", "model"), torch.zeros(8), mesh)
    s2, e2 = compressed_psum(row, ("data", "model"), e1, mesh)
    out["psum/calls"] = np.array([INT8_GATHERS.calls, GATHERS.calls])
    out["psum/s1"], ok1 = _assemble(s1, [None], mesh)
    out["psum/s2"], ok2 = _assemble(s2, [None], mesh)
    same = same and ok1 and ok2  # every rank holds the same sum
    for key, e in (("psum/e1", e1), ("psum/e2", e2)):
        g, ok = _assemble(e.reshape(1, 1, 8), ["data", "model", None], mesh)
        out[key] = g.reshape(8, 8)
    # dist_mttkrp_compressed, every mode, from zero residuals
    x, fs, ax = data["x"], _factors(data), MTTKRP_AXES
    errs = init_mttkrp_error_state(x.shape, 7, ax, mesh)
    out["err_modes"] = np.array(sorted(errs))
    for n in range(4):
        axes = tuple(ax[m] for m in sorted(ax) if m != n)
        INT8_GATHERS.calls = 0
        m_, e = dist_mttkrp_compressed(x, fs, n, ax, mesh, errs[n])
        out[f"mttkrp/calls/{n}"] = np.array(INT8_GATHERS.calls)
        out[f"mttkrp/{n}"], ok = _assemble(m_, [ax.get(n), None], mesh)
        same = same and ok
        out[f"mttkrp/err/{n}"], _ = _to_reference_layout(e, axes, [ax.get(n)], mesh)
    for lo, hi in RANGE_NODES:
        kept = [ax.get(k) for k in range(lo, hi)]
        axes = tuple(ax[m] for m in sorted(ax) if not lo <= m < hi)
        exact = dist_contract_range(x, fs, lo, hi, ax, mesh)
        t, e = dist_contract_range_compressed(x, fs, lo, hi, ax, mesh, torch.zeros_like(exact))
        out[f"range/{lo}{hi}"], ok = _assemble(t, kept + [None], mesh)
        same = same and ok
        out[f"range/err/{lo}{hi}"], _ = _to_reference_layout(e, axes, kept, mesh)
    for (plo, phi), (lo, hi) in PARTIAL_NODES:
        kept = [ax.get(k) for k in range(lo, hi)]
        axes = tuple(ax[m] for m in sorted(ax) if plo <= m < phi and not lo <= m < hi)
        tg = partial_mttkrp_range(x, fs, plo, phi)
        exact = dist_contract_partial(tg, fs, lo, hi, plo, phi, ax, mesh)
        t, e = dist_contract_partial_compressed(tg, fs, lo, hi, plo, phi, ax, mesh,
                                                torch.zeros_like(exact))
        key = f"{plo}{phi}/{lo}{hi}"
        out[f"partial/{key}"], ok = _assemble(t, kept + [None], mesh)
        same = same and ok
        out[f"partial/err/{key}"], _ = _to_reference_layout(e, axes, kept, mesh)
    # convergence: the planted rank-3 problem, exact against compressed
    xc, fc = data["xc"], _factors(data, "fc")
    for kind in ("sharded", "compressed", "auto"):
        INT8_GATHERS.calls = 0
        blocks, w, fit = dist_cp_als(xc, 3, CPALS_AXES, mesh, n_iters=COMPRESSED_SWEEPS,
                                     tol=1e-9, init_factors=fc, executor=kind)
        out[f"cpals/{kind}/fit"] = fit.numpy()
        out[f"cpals/{kind}/int8"] = np.array(INT8_GATHERS.calls)
        for j, b in enumerate(blocks):
            out[f"cpals/{kind}/f{j}"], ok = _assemble(b, [CPALS_AXES.get(j), None], mesh)
            same = same and ok
    # the carry on a tree: the binary split of the order-4 tensor
    xt, ft = data["xt"], _factors(data, "ft")
    prob = Problem.from_tensor(xt, 3, ax, mesh)
    plan = plan_sweep(prob, "dimtree", executor="compressed")
    ex = make_executor("compressed", mesh, ax)
    xs, fs_ = ex.prepare(prob, xt, ft)
    carry = ex.init_carry(plan, xs, fs_)
    out["carry/nodes"] = np.array(sorted(carry))
    out["carry/want"] = np.array(sorted(n.id for n in plan.resolved_schedule.walk()
                                        if n.reduce_axes))
    st = als_sweep(prob, plan, ex, SweepState(x=xs, factors=list(fs_), weights=torch.ones(3),
                                              norm_x=tensor_norm(xt), it=0, carry=carry))
    moved = all(bool(st.carry[k].abs().max() > 0) for k in carry)
    finite = all(bool(torch.isfinite(u).all()) for u in st.factors)
    out["carry/moved"] = np.array([_all_true(moved and st.carry is not carry), _all_true(finite)])
    for kind in ("sharded", "compressed"):
        fits = []
        cp_als(xt, plan_sweep(prob, "dimtree", executor=kind),
               executor=make_executor(kind, mesh, ax), n_iters=TREE_SWEEPS, tol=0.0,
               init_factors=ft, callback=lambda it, f, dt: fits.append(f))
        out[f"tree/{kind}/fits"] = np.array(fits)
    out["replicas"] = np.array(same)


def _gathered_json(obj) -> list:
    """``obj`` (JSON-ready) from every rank."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, json.dumps(obj, sort_keys=True))
    return parts


def _case_front(mesh, data, out):
    import torch.distributed as dist

    from repro_torch.plan import (
        Problem,
        TuningCache,
        cp_als,
        lookup_measurements,
        make_executor,
        plan_sweep,
        select_executor,
        tune,
    )
    from repro_torch.serve import CPService

    x, ax = data["xs"], CPALS_AXES
    problem = Problem.from_tensor(x, 3, ax, mesh)
    plans = _gathered_json(plan_sweep(problem).describe())
    out["plan/agree"] = np.array(len(set(plans)) == 1)
    out["plan/executor"] = np.array(select_executor(problem))
    # the tuner: every rank stores the same entry, with and without a budget
    entries = {}
    for label, budget in (("full", None), ("tight", 150.0)):
        cache = TuningCache()
        entry = tune(x, 3, mesh=mesh, mode_axes=ax, cache=cache, budget_ms=budget, reps=1)
        got = _gathered_json(entry)
        out[f"tune/{label}/agree"] = np.array(len(set(got)) == 1)
        out[f"tune/{label}/kinds"] = np.array(sorted({r["executor"] for r in entry["nodes"]}))
        out[f"tune/{label}/rows"] = np.array(len(entry["nodes"]))
        entries[label] = (entry, cache)
    entry, cache = entries["full"]
    out["tune/entry"] = np.array(json.dumps(entry, sort_keys=True))
    out["tune/measured_sf"] = np.array(json.dumps(lookup_measurements(problem, cache)
                                                  .serial_fractions, sort_keys=True))
    plan = plan_sweep(problem, "autotune", tuning_cache=cache)
    out["tune/plan/agree"] = np.array(len(set(_gathered_json(plan.describe()))) == 1)
    out["tune/plan/sf"] = np.array(json.dumps(plan.describe()["serial_fractions"],
                                              sort_keys=True))
    fits = []
    st = cp_als(x, plan, executor=make_executor(plan.executor, mesh, ax), n_iters=4, tol=0.0,
                seed=1, callback=lambda it, f, dt: fits.append(f))
    same = True
    for j, b in enumerate(st.factors):
        _, ok = _assemble(b, [ax.get(j), None], mesh)
        same = same and ok
    out["tune/cp_als/fits"] = np.array(fits)
    out["tune/cp_als/executor"] = np.array(plan.executor)
    # the service: batch-parallel over all 8 ranks, every rank submits alike
    svc = CPService(batch_size=8, n_iters=4, tol=0.0, strategy="auto", mesh=mesh, device="cpu")
    futures = [svc.submit(t, 3, seed=i) for i, t in enumerate(data["fleet"])]
    svc.flush()
    results = [f.result() for f in futures]
    payload = [[u.tolist() for u in r.factors] + [r.weights.tolist(), r.fit, r.sweeps]
               for r in results]
    out["serve/agree"] = np.array(len(set(_gathered_json(payload))) == 1)
    stats = svc.stats()
    out["serve/stats"] = np.array([stats[k] for k in ("completed", "batches", "padded_slots",
                                                      "compiles", "signatures")])
    out["serve/executor"] = np.array(next(iter(svc._states.values())).plan.executor)
    for i, r in enumerate(results):
        for j, u in enumerate(r.factors):
            out[f"serve/{i}/f{j}"] = u.numpy()
        out[f"serve/{i}/fit"] = np.array(r.fit)
    out["replicas"] = np.array(same and dist.get_world_size() == WORLD)


CASES = {"overlap": _case_overlap, "compressed": _case_compressed, "front": _case_front}


def _rank_main(rank: int, case: str, root: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_host_mesh(*MESH, device="cpu")
        data = {k: torch.from_numpy(v) for k, v in np.load(f"{root}/inputs.npz").items()}
        out = {}
        CASES[case](mesh, data, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- the reference's side
def _reference(root: str) -> None:
    """The reference's distributed functions on 8 host devices, on the
    inputs of the overlap and compressed cases (``XLA_FLAGS`` is set by the
    caller before JAX starts)."""
    import importlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.core.dimtree import partial_mttkrp_range
    from repro.dist.collectives import compressed_psum

    dm = importlib.import_module("repro.dist.dist_mttkrp")
    assert jax.device_count() == WORLD, jax.device_count()
    out = {}
    ov = dict(np.load(f"{root}/overlap.npz"))
    cp = dict(np.load(f"{root}/compressed.npz"))
    mesh = jax.make_mesh(MESH, ("data", "model"))
    ax = MTTKRP_AXES
    # dist_mttkrp_overlapped, every mode and chunk count, and batched
    x, fs = jnp.asarray(ov["x"]), [jnp.asarray(u) for u in _factors(ov)]
    xs, fss = dm.shard_problem(x, fs, ax, mesh)
    for n in range(4):  # one chunk count: each is a compile of its own
        out[f"ov/{n}/{REFERENCE_CHUNKS}"] = np.asarray(dm.dist_mttkrp_overlapped(
            xs, fss, n, ax, mesh, n_chunks=REFERENCE_CHUNKS))
    xb, fb = jnp.asarray(ov["xb"]), [jnp.asarray(u) for u in _factors(ov, "fb")]
    xbs, fbs = dm.shard_problem(xb, fb, BATCH_AXES, mesh, batch_axes=("data",))
    for n in range(3):
        out[f"ovb/{n}/2"] = np.asarray(dm.dist_mttkrp_overlapped(
            xbs, fbs, n, BATCH_AXES, mesh, n_chunks=2, batch_axes=("data",)))
    # compressed_psum on a mesh of 8, called directly
    mesh1 = jax.make_mesh((WORLD,), ("data",))

    def one(x_blk, err):
        s, ne = compressed_psum(x_blk[0], "data", err[0])
        return s[None], ne[None]

    s, ne = compat.shard_map(one, mesh=mesh1, in_specs=(P("data"), P("data")),
                             out_specs=(P("data"), P("data")), check_vma=False)(
        jnp.asarray(cp["xp"]), jnp.zeros((8, 8), jnp.float32))
    out["psum/s1"], out["psum/e1"] = np.asarray(s), np.asarray(ne)
    # dist_mttkrp_compressed and the compressed node contractions
    x, fs = jnp.asarray(cp["x"]), [jnp.asarray(u) for u in _factors(cp)]
    xs, fss = dm.shard_problem(x, fs, ax, mesh)
    errs = dm.init_mttkrp_error_state(x.shape, 7, ax, mesh)
    for n in range(4):
        m_, e = dm.dist_mttkrp_compressed(xs, fss, n, ax, mesh, errs[n])
        out[f"mttkrp/{n}"], out[f"mttkrp/err/{n}"] = np.asarray(m_), np.asarray(e)
    sizes = dict(zip(("data", "model"), MESH))
    for lo, hi in RANGE_NODES:
        axes = tuple(ax[m] for m in sorted(ax) if not lo <= m < hi)
        err = jnp.zeros(tuple(sizes[a] for a in axes) + x.shape[lo:hi] + (7,), jnp.float32)
        t, e = dm.dist_contract_range_compressed(xs, fss, lo, hi, ax, mesh, err)
        out[f"range/{lo}{hi}"], out[f"range/err/{lo}{hi}"] = np.asarray(t), np.asarray(e)
    for (plo, phi), (lo, hi) in PARTIAL_NODES:
        axes = tuple(ax[m] for m in sorted(ax) if plo <= m < phi and not lo <= m < hi)
        tg = partial_mttkrp_range(x, fs, plo, phi)
        err = jnp.zeros(tuple(sizes[a] for a in axes) + x.shape[lo:hi] + (7,), jnp.float32)
        t, e = dm.dist_contract_partial_compressed(tg, fss, lo, hi, plo, phi, ax, mesh, err)
        key = f"{plo}{phi}/{lo}{hi}"
        out[f"partial/{key}"], out[f"partial/err/{key}"] = np.asarray(t), np.asarray(e)
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
        for case in ("overlap", "compressed"):
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
        # the 8-rank cases one after the other, all while the reference runs
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


@pytest.fixture
def reference_constants(monkeypatch):
    """Price the port's plans with all three of the reference's roofline
    constants (the interconnect rate is the reference's ``ICI_BW``)."""
    import repro.analysis.roofline as jroof
    import repro_torch.plan.cost as tcost

    monkeypatch.setattr(tcost, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tcost, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(tcost, "NVLINK_BW", jroof.ICI_BW)


def _step(a) -> float:
    """One int8 quantization step of the values ``a`` reaches."""
    return float(np.max(np.abs(a))) / 127.0


def _participant_step(contract, src, blocks) -> tuple[float, int]:
    """``(largest step, participants)`` of one reduction: a participant's
    partial is ``contract`` of ``src`` zeroed outside its index block along
    each reduced dim (``blocks``: ``(dim of src, blocks along it)``)."""
    import itertools

    steps = []
    for combo in itertools.product(*[range(b) for _, b in blocks]):
        index = [slice(None)] * src.ndim
        for (d, b), i in zip(blocks, combo):
            w = src.shape[d] // b
            index[d] = slice(i * w, (i + 1) * w)
        mask = np.zeros_like(src)
        mask[tuple(index)] = 1
        steps.append(_step(contract(src * mask)))
    return max(steps), len(steps)


SIZES = {"data": 2, "model": 4}


def _node_bound(node: str, data) -> tuple[float, float]:
    """``(p x the largest step, the largest step)`` of one compressed
    reduction of the compressed case: the result's and the residual's
    bounds against the reference."""
    from repro_torch.core.dimtree import contract_from_partial, partial_mttkrp_range
    from repro_torch.core.mttkrp import mttkrp

    x, fs = data["x"], [torch.from_numpy(u) for u in _factors(data)]
    ax = MTTKRP_AXES
    kind, key = node.split("/", 1)
    if kind == "mttkrp":
        n = int(key)
        blocks = [(m, SIZES[ax[m]]) for m in sorted(ax) if m != n]
        step, p = _participant_step(lambda t: mttkrp(torch.from_numpy(t), fs, n).numpy(), x, blocks)
    elif kind == "range":
        lo, hi = int(key[0]), int(key[1])
        blocks = [(m, SIZES[ax[m]]) for m in sorted(ax) if not lo <= m < hi]
        step, p = _participant_step(
            lambda t: partial_mttkrp_range(torch.from_numpy(t), fs, lo, hi).numpy(), x, blocks)
    else:
        plo, phi, lo, hi = int(key[0]), int(key[1]), int(key[3]), int(key[4])
        tg = partial_mttkrp_range(torch.from_numpy(x), fs, plo, phi).numpy()
        contracted = [m for m in range(plo, phi) if not lo <= m < hi]
        blocks = [(m - plo, SIZES[ax[m]]) for m in contracted if m in ax]
        step, p = _participant_step(lambda t: contract_from_partial(
            torch.from_numpy(t), {m: fs[m] for m in contracted}, lo, hi, plo).numpy(), tg, blocks)
    return step * p, step


# ----------------------------------------------------------- overlapping
@pytest.mark.parametrize("n", range(4))
def test_dist_mttkrp_overlapped_matches_the_reference_and_the_plain_entry(run, n):
    from repro.core.mttkrp import mttkrp as jmttkrp

    res, ref, data = run("overlap"), run("reference"), _inputs("overlap")
    assert bool(res["replicas"])
    local = res[f"plain/{n}"]
    want = np.asarray(jmttkrp(*_jax_problem(data["x"], _factors(data)), n))
    _close(ref[f"ov/{n}/{REFERENCE_CHUNKS}"], res[f"ov/{n}/{REFERENCE_CHUNKS}"], tol=TOL)
    sizes = {"data": 2, "model": 4}
    axes = [MTTKRP_AXES[m] for m in sorted(MTTKRP_AXES) if m != n]
    extent = _inputs("overlap")["x"].shape[n] // sizes.get(MTTKRP_AXES.get(n), 1)
    for c in OVERLAP_CHUNKS:
        got = res[f"ov/{n}/{c}"]
        _close(local, got, tol=LEAF_TOL, msg=f"chunks {c}")
        _close(want, got, tol=TOL, msg=f"chunks {c}")
        k = min(c, extent) if c > 1 and extent > 1 else 1
        # one gather an axis a slab; a slab of a mode past the first is copied
        assert res[f"calls/{n}/{c}"].tolist() == [len(axes) * k, k if k > 1 and n > 0 else 0]
    for m in ("fused", "matrix_free"):  # the kernels' plain versions, slab by slab
        _close(local, res[f"ov/{m}/{n}"], tol=LEAF_TOL)


@pytest.mark.parametrize("n", range(3))
def test_batched_dist_mttkrp_overlapped_matches_the_reference(run, n):
    from repro.core.mttkrp import mttkrp_batched as jbatched

    res, ref, data = run("overlap"), run("reference"), _inputs("overlap")
    want = np.asarray(jbatched(*_jax_problem(data["xb"], _factors(data, "fb")), n))
    for c in (2, 3):
        _close(want, res[f"ovb/{n}/{c}"], tol=TOL, msg=f"chunks {c}")
        # the batch axis is never reduced; mode 0 is the only mapped mode
        axes = 0 if n == 0 else 1
        k = min(c, data["xb"].shape[1 + n]) if axes else 1
        assert int(res[f"calls/b/{n}/{c}"]) == axes * k
    _close(ref[f"ovb/{n}/2"], res[f"ovb/{n}/2"], tol=TOL)


def _jax_problem(x, fs):
    import jax.numpy as jnp

    return jnp.asarray(x), [jnp.asarray(u) for u in fs]


@pytest.mark.parametrize("name", SCHEDULES)
def test_overlapping_tree_nodes_are_the_sharded_executors_bitwise(run, name):
    """One source, both executors, node by node: a tree partial (one local
    contraction, slab reductions of disjoint rows) bitwise equal, strides
    included; a full-MTTKRP leaf (its own contraction a slab) at the leaf
    tolerance."""
    bitwise, close = run("overlap")[f"nodes/{name}"].tolist()
    assert bitwise and close


@pytest.mark.parametrize("name", SCHEDULES)
def test_overlapping_sweeps_match_the_sharded_executor(run, name):
    res = run("overlap")
    sh, ov = f"sweep/{name}/sharded", f"sweep/{name}/overlapping"
    for j in range(4):
        if name == "binary":  # every node a tree partial: bitwise
            assert res[f"{ov}/f{j}"].tobytes() == res[f"{sh}/f{j}"].tobytes()
        else:
            _close(res[f"{sh}/f{j}"], res[f"{ov}/f{j}"], msg=f"factor {j}")
    if name == "binary":
        assert res[f"{ov}/fits"].tobytes() == res[f"{sh}/fits"].tobytes()
    _close(res[f"{sh}/fits"], res[f"{ov}/fits"])
    # set-up and algebra as the sharded run's; node reductions slab by slab
    from repro_torch.plan import Problem, plan_sweep

    axes_calls = int(res[f"{sh}/calls"])
    prob = Problem((8, 6, 8, 4), 3, mode_axes=MTTKRP_AXES, axis_sizes={"data": 2, "model": 4})
    plain = sum(len(n_.reduce_axes) for n_ in
                plan_sweep(prob, "1step", executor="sharded", schedule=name)
                .resolved_schedule.walk())
    assert int(res[f"{ov}/calls"]) == axes_calls + TREE_SWEEPS * (int(res[f"{ov}/want"]) - plain)


# ------------------------------------------------------------ compressed
def test_compressed_psum_matches_the_reference_within_a_step(run):
    res, ref, data = run("compressed"), run("reference"), _inputs("compressed")
    xp, p = data["xp"], WORLD
    step = _step(xp)
    exact = xp.sum(0)
    assert bool(res["replicas"])
    # every rank holds one sum; the reference's every row, within p steps
    _close(ref["psum/s1"][0], res["psum/s1"], tol=dict(rtol=0, atol=step * p + 1e-5))
    _close(exact, res["psum/s1"], tol=dict(rtol=0, atol=step * p + 1e-5))
    _close(ref["psum/e1"], res["psum/e1"], tol=dict(rtol=0, atol=step + 1e-6))
    assert np.abs(res["psum/e1"]).max() <= step / 2 + 1e-6  # half a step, round to nearest
    # error feedback: two rounds miss twice the sum by the last residuals only
    both = res["psum/s1"] + res["psum/s2"]
    assert np.allclose(both, 2 * exact - res["psum/e2"].sum(0), rtol=0, atol=1e-4)
    # one gather an axis, of one uint8 buffer (payload and scale)
    assert res["psum/calls"].tolist() == [4, 4]


@pytest.mark.parametrize("node", [f"mttkrp/{n}" for n in range(4)]
                         + [f"range/{lo}{hi}" for lo, hi in RANGE_NODES]
                         + [f"partial/{a}{b}/{c}{d}" for (a, b), (c, d) in PARTIAL_NODES])
def test_compressed_contractions_match_the_reference_within_a_step(run, node):
    """``dist_mttkrp_compressed`` and both ``dist_contract_*_compressed``
    from zero residuals: results within one quantization step per
    participant of the reference's (the codes of partials that agree only
    to fp32 may differ by one), residuals within one step, both in the
    reference's layout."""
    from repro.core.dimtree import contract_from_partial as jpartial
    from repro.core.dimtree import partial_mttkrp_range as jrange
    from repro.core.mttkrp import mttkrp as jmttkrp

    res, ref, data = run("compressed"), run("reference"), _inputs("compressed")
    bound, step = _node_bound(node, data)
    got = res[node]
    _close(ref[node], got, tol=dict(rtol=0, atol=bound + 1e-5))
    jx, jfs = _jax_problem(data["x"], _factors(data))
    kind, key = node.split("/", 1)
    if kind == "mttkrp":
        exact = jmttkrp(jx, jfs, int(key))
        assert int(res[f"mttkrp/calls/{key}"]) == sum(1 for m in MTTKRP_AXES if m != int(key))
        assert res["err_modes"].tolist() == [0, 1, 2, 3]
    elif kind == "range":
        exact = jrange(jx, jfs, int(key[0]), int(key[1]))
    else:
        plo, phi, lo, hi = int(key[0]), int(key[1]), int(key[3]), int(key[4])
        contracted = [m for m in range(plo, phi) if not lo <= m < hi]
        exact = jpartial(jrange(jx, jfs, plo, phi), {m: jfs[m] for m in contracted}, lo, hi, plo)
    _close(np.asarray(exact), got, tol=dict(rtol=0, atol=bound / 2 + 1e-5))
    e, e_ref = res[f"{kind}/err/{key}"], ref[f"{kind}/err/{key}"]
    assert e.shape == e_ref.shape
    _close(e_ref, e, tol=dict(rtol=0, atol=step + 1e-6))
    assert np.abs(e).max() <= step / 2 + 1e-6


def test_compressed_cp_als_reaches_the_exact_fit(run):
    """The reference's compressed_cpals bounds on the port: a planted
    8 x 8 x 8 rank-3 problem over {0: data, 1: model}, 40 sweeps."""
    res = run("compressed")
    exact, comp = float(res["cpals/sharded/fit"]), float(res["cpals/compressed/fit"])
    assert comp > 0.75 and abs(comp - exact) < 2e-2, (comp, exact)
    assert int(res["cpals/compressed/int8"]) > 0 and int(res["cpals/sharded/int8"]) == 0
    for j in range(3):
        assert np.isfinite(res[f"cpals/compressed/f{j}"]).all()


def test_compressed_carry_threads_through_a_tree(run):
    res = run("compressed")
    assert res["carry/nodes"].tolist() == res["carry/want"].tolist()
    moved, finite = res["carry/moved"].tolist()
    assert moved and finite
    exact, comp = res["tree/sharded/fits"], res["tree/compressed/fits"]
    assert np.isfinite(comp).all() and np.abs(comp - exact).max() < 2e-2


# --------------------------------------------- executor choice and costs
PLAN_CASES = [
    ((8, 6, 4, 5), 7, {0: "data", 2: "model"}, 1, ()),
    ((12, 8, 8), 3, {0: "data", 1: "model"}, 1, ()),
    ((8, 6, 8), 3, {0: "model"}, 8, ()),
    ((8, 6, 8), 3, {0: "model"}, 4, ("data",)),
    ((6, 4, 5), 3, {}, 8, ("data", "model")),
    ((2, 64, 2), 4096, {0: "data"}, 1, ()),  # the reference's compressed pick
]


@pytest.mark.parametrize("shape,rank,mode_axes,batch,batch_axes", PLAN_CASES)
@pytest.mark.parametrize("strategy", ["auto", "1step", "dimtree"])
def test_select_executor_matches_the_reference(reference_constants, shape, rank, mode_axes,
                                               batch, batch_axes, strategy):
    import repro.plan as jplan
    import repro_torch.plan as tplan

    sizes = {"data": 2} if shape == (2, 64, 2) else {"data": 2, "model": 4}
    kw = dict(shape=shape, rank=rank, mode_axes=mode_axes, axis_sizes=sizes, batch=batch,
              batch_axes=batch_axes)
    jp = jplan.plan_sweep(jplan.Problem(**kw), strategy, tuning_cache=jplan.TuningCache())
    tp = tplan.plan_sweep(tplan.Problem(**kw), strategy, tuning_cache=tplan.TuningCache())
    assert tp.executor == jp.executor
    assert tp.resolved_schedule.name == jp.resolved_schedule.name
    assert tplan.select_executor(tplan.Problem(**kw), strategy) == tp.executor
    if shape == (2, 64, 2):
        assert tp.executor == "compressed"
    jd, td = jp.describe(), tp.describe()
    for a, b in zip(jd["nodes"], td["nodes"]):
        for key in ("collective_bytes", "bytes", "serial_fraction",
                    "predicted_overlap_efficiency"):
            assert b[key] == pytest.approx(a[key], rel=1e-12), key
        assert b["predicted_s"] == pytest.approx(a["predicted_s"], rel=1e-9)


@pytest.mark.parametrize("executor", ["sharded", "overlapping", "compressed"])
@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
def test_executor_costs_match_the_reference(reference_constants, executor, n_chunks):
    import repro.plan as jplan
    import repro_torch.plan as tplan

    kw = dict(shape=(8, 6, 4, 5), rank=7, mode_axes={0: "data", 2: "model"},
              axis_sizes={"data": 2, "model": 4})
    jprob, tprob = jplan.Problem(**kw), tplan.Problem(**kw)
    for sf in (None, {"overlapping": 0.3, "compressed": 0.7}):
        for n in range(4):
            for alg in ("1step", "fused", "matrix_free"):
                jc = jplan.executor_mode_cost(jprob, n, alg, executor, n_chunks=n_chunks,
                                              serial_fractions=sf)
                tc = tplan.executor_mode_cost(tprob, n, alg, executor, n_chunks=n_chunks,
                                              serial_fractions=sf)
                ja, ta = jc.as_dict(), tc.as_dict()
                for key in ("collective_bytes", "bytes", "flops", "serial_fraction",
                            "predicted_overlap_efficiency"):
                    assert ta[key] == ja[key], (n, alg, key)
                assert ta["predicted_s"] == pytest.approx(ja["predicted_s"], rel=1e-12)
        for sched in (jplan.binary_schedule(jprob, 2), jplan.chain_schedule(jprob)):
            tsched = {"binary@2": tplan.binary_schedule(tprob, 2),
                      "chain": tplan.chain_schedule(tprob)}[sched.name]
            for jn, tn in zip(sched.walk(), tsched.walk()):
                if jn.is_root:
                    continue
                ja = jplan.node_cost(jprob, jn, executor, n_chunks=n_chunks,
                                     serial_fractions=sf).as_dict()
                ta = tplan.node_cost(tprob, tn, executor, n_chunks=n_chunks,
                                     serial_fractions=sf).as_dict()
                for key in ("collective_bytes", "bytes", "serial_fraction"):
                    assert ta[key] == ja[key], (sched.name, jn.id, key)


def test_compressed_bytes_and_overlap_constants_match_the_reference():
    import repro.plan as jplan
    import repro.plan.cost as jcost
    import repro_torch.dist as tdist
    import repro_torch.plan as tplan
    import repro_torch.plan.cost as tcost

    assert tplan.DEFAULT_OVERLAP_CHUNKS == jplan.DEFAULT_OVERLAP_CHUNKS
    assert tdist.DEFAULT_OVERLAP_CHUNKS == jplan.DEFAULT_OVERLAP_CHUNKS
    assert (tcost._INT8_ITEMSIZE, tcost._SCALE_BYTES) == (jcost._INT8_ITEMSIZE, jcost._SCALE_BYTES)
    for block in (0.0, 4.0, 1e6):
        for p in (1, 2, 8, 16):
            for item in (2.0, 4.0, 8.0):
                assert tplan.compressed_allgather_bytes(block, p, item) == (
                    jplan.compressed_allgather_bytes(block, p, item))
    with pytest.raises(ValueError, match="serial_fractions"):
        tplan.plan_sweep(tplan.Problem((8, 6, 4), 3), serial_fractions={"overlapping": 2.0})


def test_serial_fractions_are_fitted_as_the_reference_fits_them(reference_constants):
    """The same measured rows give the same fit (clamped to [0, 1]), and
    the planner prices and records them."""
    import repro.plan as jplan
    import repro.plan.autotune as jautotune
    import repro_torch.plan as tplan
    import repro_torch.plan.autotune as tautotune

    kw = dict(shape=(8, 6, 4, 5), rank=7, mode_axes={0: "data", 2: "model"},
              axis_sizes={"data": 2, "model": 4})
    jprob, tprob = jplan.Problem(**kw), tplan.Problem(**kw)
    rows = []
    for i, node in enumerate(tplan.flat_schedule(tprob).walk()):
        if node.is_root:
            continue
        for kind, scale in (("sharded", 1.0), ("overlapping", 0.2 + 0.3 * i)):
            rows.append({"key": tautotune.node_key(node, "1step", kind), "executor": kind,
                         "algorithm": "1step", "measured_s": 1e-3 * scale})
    got = tautotune._recalibrate_serial_fractions(tprob, rows)
    assert got == jautotune._recalibrate_serial_fractions(jprob, rows)
    assert set(got) == {"sharded", "overlapping"} and 0.0 <= got["overlapping"] <= 1.0
    plan = tplan.plan_sweep(tprob, executor="overlapping", serial_fractions=got)
    assert plan.describe()["serial_fractions"] == got == plan.serial_fractions
    assert all(m.cost.serial_fraction == got["overlapping"] for m in plan.modes)


def test_the_h100_constants_choose_an_executor():
    """Under the port's H100 constants the argmin may differ from the
    reference's; it is recorded, not asserted."""
    import repro_torch.plan as tplan

    for shape, rank, mode_axes, batch, batch_axes in PLAN_CASES:
        sizes = {"data": 2} if shape == (2, 64, 2) else {"data": 2, "model": 4}
        p = tplan.Problem(shape, rank, mode_axes=mode_axes, axis_sizes=sizes, batch=batch,
                          batch_axes=batch_axes)
        kind = tplan.select_executor(p)
        assert kind in ("sharded", "overlapping", "compressed")
        print(f"H100 constants: {shape} rank {rank} {mode_axes} batch {batch} -> {kind}")


# ------------------------------------------------ the tuner and the service
def test_sharded_plans_agree_on_every_rank(run):
    res = run("front")
    assert bool(res["plan/agree"]) and bool(res["replicas"])
    assert str(res["plan/executor"]) in ("sharded", "overlapping", "compressed")


@pytest.mark.parametrize("label", ["full", "tight"])
def test_sharded_tune_stores_one_entry_on_every_rank(run, label):
    res = run("front")
    assert bool(res[f"tune/{label}/agree"])
    if label == "full":
        assert res["tune/full/kinds"].tolist() == ["compressed", "overlapping", "sharded"]
    else:  # a budget spent partway, at the same node on every rank
        assert int(res["tune/tight/rows"]) <= int(res["tune/full/rows"])


def test_sharded_tune_fits_serial_fractions_and_plans_from_them(run):
    res = run("front")
    entry = json.loads(str(res["tune/entry"]))
    sf = entry["serial_fractions"]
    assert set(sf) == {"sharded", "overlapping"} and 0.0 <= sf["overlapping"] <= 1.0
    assert entry["n_devices"] == WORLD
    assert json.loads(str(res["tune/measured_sf"])) == sf
    assert json.loads(str(res["tune/plan/sf"])) == sf and bool(res["tune/plan/agree"])
    # every node of the plan's executor measured, kernel leaves included
    keys = {r["key"].split("|")[1] for r in entry["nodes"] if r["executor"] == "compressed"}
    assert {"fused", "matrix_free"} <= keys
    fits = res["tune/cp_als/fits"]
    assert np.isfinite(fits).all() and len(fits) == 4


def test_sharded_service_serves_whole_problems_on_every_rank(run):
    """Batch-parallel over 8 ranks: every rank resolves the same results,
    and they are the single-device service's at tolerance."""
    from repro_torch.serve import CPService

    res, data = run("front"), _inputs("front")
    assert bool(res["serve/agree"])
    assert str(res["serve/executor"]) == "sharded"
    # 12 completed in 2 batches, 4 padded slots, one signature planned once
    assert res["serve/stats"].tolist() == [FLEET, 2, 4, 1, 1]
    svc = CPService(batch_size=8, n_iters=4, tol=0.0, strategy="auto", device="cpu")
    futures = [svc.submit(torch.from_numpy(t), 3, seed=i) for i, t in enumerate(data["fleet"])]
    svc.flush()
    for i, f in enumerate(futures):
        r = f.result()
        _close(r.fit, res[f"serve/{i}/fit"])
        for j, u in enumerate(r.factors):
            _close(u.numpy(), res[f"serve/{i}/f{j}"], msg=f"request {i} factor {j}")


def test_serve_cp_mesh_serves_on_two_gloo_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve_cp", "--mesh", "--device", "cpu", "--requests", "8",
         "--batch-size", "4"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=CASE_TIMEOUT,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    log = proc.stderr + proc.stdout
    assert log.count("batch-parallel over 2 ranks (gloo)") == 2
    served = [line.split("mean fit ")[1] for line in log.splitlines() if "served 8 problems" in line]
    assert len(served) == 2 and served[0] == served[1]  # the ranks hold the same results
    assert log.count("signatures=2 compiles=2") == 2


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    if case_ == "reference":
        _reference(root_)
    else:
        torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
