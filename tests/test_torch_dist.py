"""Flat sharded CP-ALS of the port in 8-rank gloo worlds, on the CPU.

Each multi-rank case is one subprocess, ``python tests/test_torch_dist.py
<case> <dir>``: it spawns 8 gloo ranks (``init_method="file://<dir>/store"``:
no TCP port, so parallel test workers never collide) on the 2 x 4
``("data", "model")`` mesh of the reference's own cases
(``tests/dist_worker.py``).  The inputs are made once with numpy from a seed
in this process and written to ``<dir>``; every rank assembles the ranks'
blocks (checking that ranks holding the same block hold the same bits) and
rank 0 writes the results back.  This process holds them against the
reference's *local* functions (JAX, on the same numpy inputs) at the fp32
tolerance ``rtol=2e-4, atol=2e-5`` -- or at the reference case's own bound
where it has one -- and against the port's single-device engine.  The
reference's failing dist cases are not used as oracles.

By hand, one case (prints nothing; the results land in ``<dir>/out.npz``,
the inputs must be there first as ``inputs.npz``):

    PYTHONPATH=src python tests/test_torch_dist.py <case> <dir>

The worker imports no jax: ``torch.multiprocessing.spawn`` re-imports this
file in each rank.
"""

import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
WORLD = 8
MESH = (2, 4)  # ("data", "model"), as the reference's cases
CASE_TIMEOUT = 120  # seconds a case subprocess may take
SWEEPS = 6  # sweeps of the CP-ALS runs
MTTKRP_AXES = {0: "data", 2: "model"}
CPALS_AXES = {0: "data", 1: "model"}
BATCH_MODE_AXES = {0: "model"}


# ------------------------------------------------------------------ inputs
def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(case: str) -> dict:
    """The numpy inputs of one case, from its seed."""
    if case == "mttkrp":  # the reference's dist_mttkrp / matrix_free_sharded shapes
        rng = np.random.default_rng(0)
        x = _normal(rng, (8, 6, 4, 5))
        return {"x": x, **{f"f{k}": _normal(rng, (d, 7)) for k, d in enumerate(x.shape)}}
    if case == "cpals":  # the reference's dist_cpals: planted (12, 8, 8) at rank 3
        rng = np.random.default_rng(2)
        planted = [_normal(rng, (d, 3)) for d in (12, 8, 8)]
        x = np.einsum("ic,jc,kc->ijk", *planted).astype(np.float32)
        return {"x": x, **{f"f{k}": _normal(rng, (d, 3)) for k, d in enumerate(x.shape)}}
    if case == "dimtree":  # the reference's dist_dimtree: (8, 6, 8, 4) at rank 3
        rng = np.random.default_rng(5)
        x = _normal(rng, (8, 6, 8, 4))
        return {"x": x, **{f"f{k}": _normal(rng, (d, 3)) for k, d in enumerate(x.shape)}}
    if case == "batched":
        rng = np.random.default_rng(7)
        xa = _normal(rng, (8, 6, 4, 5))  # 8 problems of (6, 4, 5), batch over both axes
        xb = _normal(rng, (4, 8, 6, 5))  # 4 problems of (8, 6, 5), mode 0 on "model"
        out = {"xa": xa, "xb": xb}
        out.update({f"fa{k}": _normal(rng, (8, d, 3)) for k, d in enumerate(xa.shape[1:])})
        out.update({f"fb{k}": _normal(rng, (4, d, 3)) for k, d in enumerate(xb.shape[1:])})
        return out
    raise ValueError(case)


def _factors(data, prefix="f"):
    return [data[k] for k in sorted(data) if k.startswith(prefix) and k[len(prefix):].isdigit()]


# ---------------------------------------------------------- the rank side
def _assemble(block, dims, mesh, batch_axes=None):
    """``(global array, replicas equal)`` from every rank's ``block``, on
    every rank: ``dims[i]`` is the mesh axis dim ``i`` of the block is cut
    over (``None``: whole), after a leading batch dim cut over
    ``batch_axes`` when given.  Ranks holding the same block must hold the
    same bytes."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, block.detach().cpu().contiguous().numpy())
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    lead = 0 if batch_axes is None else 1
    shape = list(parts[0].shape)
    if lead:
        shape[0] *= math.prod(sizes[a] for a in batch_axes)
    for d, axis in enumerate(dims):
        if axis is not None:
            shape[lead + d] *= sizes[axis]
    out = np.full(shape, np.nan, parts[0].dtype)
    seen, same = {}, True
    for r, part in enumerate(parts):
        coord = dict(zip(names, (mesh.mesh == r).nonzero()[0].tolist()))
        index = []
        if lead:
            b = 0
            for a in batch_axes:
                b = b * sizes[a] + coord[a]
            index.append(slice(b * part.shape[0], (b + 1) * part.shape[0]))
        for d, axis in enumerate(dims):
            c, n = (coord[axis] if axis is not None else 0), part.shape[lead + d]
            index.append(slice(c * n, (c + 1) * n))
        key = tuple((s.start, s.stop) for s in index)
        if key in seen:
            same = same and seen[key].tobytes() == part.tobytes()
        else:
            seen[key] = part
            out[tuple(index)] = part
    return out, same


def _all_true(flag: bool) -> bool:
    """``flag`` on every rank."""
    import torch.distributed as dist

    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(flag))
    return all(flags)


def _case_mttkrp(mesh, data, out):
    from repro_torch.core.dimtree import partial_mttkrp_range
    from repro_torch.dist import GATHERS, dist_contract_partial, dist_contract_range, dist_mttkrp
    from repro_torch.plan import Problem

    x, fs, ax = data["x"], _factors(data), MTTKRP_AXES
    out["axis_sizes"] = np.array(
        sorted(Problem.from_tensor(x, 7, ax, mesh).axis_sizes.items()) == [("data", 2), ("model", 4)]
    )
    same = True
    for method, tiles in (("auto", None), ("1step", None), ("fused", None),
                          ("matrix_free", {"block_i": 4, "block_r": 2})):
        for n in range(4):
            GATHERS.calls = 0
            blk = dist_mttkrp(x, fs, n, ax, mesh, method=method, tiles=tiles)
            out[f"calls/mttkrp/{method}/{n}"] = np.array(GATHERS.calls)
            out[f"mttkrp/{method}/{n}"], ok = _assemble(blk, [ax.get(n), None], mesh)
            same = same and ok
    again = dist_mttkrp(x, fs, 1, ax, mesh, method="auto")
    first = dist_mttkrp(x, fs, 1, ax, mesh, method="auto")
    out["repeat"] = np.array(_all_true(torch.equal(again, first)))
    for lo, hi in ((0, 2), (2, 4), (1, 3), (0, 1), (3, 4)):
        kept = [ax.get(k) for k in range(lo, hi)] + [None]
        for chunks in (1, 2):
            GATHERS.calls = 0
            blk = dist_contract_range(x, fs, lo, hi, ax, mesh, n_chunks=chunks)
            out[f"calls/range/{lo}{hi}/{chunks}"] = np.array(GATHERS.calls)
            out[f"range/{lo}{hi}/{chunks}"], ok = _assemble(blk, kept, mesh)
            same = same and ok
    for (plo, phi), (lo, hi) in (((0, 2), (0, 1)), ((0, 2), (1, 2)), ((2, 4), (2, 3)),
                                 ((2, 4), (3, 4)), ((1, 4), (1, 3))):
        t = partial_mttkrp_range(x, fs, plo, phi)  # the global partial, on every rank
        kept = [ax.get(k) for k in range(lo, hi)] + [None]
        for chunks in (1, 2):
            blk = dist_contract_partial(t, fs, lo, hi, plo, phi, ax, mesh, n_chunks=chunks)
            out[f"partial/{plo}{phi}/{lo}{hi}/{chunks}"], ok = _assemble(blk, kept, mesh)
            same = same and ok
    out["replicas"] = np.array(same)


def _case_cpals(mesh, data, out):
    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.dist import GATHERS, dist_als_sweep, dist_cp_als

    x, init, ax = data["x"], _factors(data), CPALS_AXES
    same = True
    f, w, norm_x = list(init), torch.ones(3), tensor_norm(x)
    for k in range(SWEEPS):
        blocks, w, fit = dist_als_sweep(x, f, w, norm_x, k, ax, mesh)
        f = []
        for j, b in enumerate(blocks):
            g, ok = _assemble(b, [ax.get(j), None], mesh)
            same = same and ok
            f.append(torch.from_numpy(g))
            out[f"sweep/{k}/f{j}"] = g
        out[f"sweep/{k}/w"], out[f"sweep/{k}/fit"] = w.numpy(), fit.numpy()
    runs = {}
    for label, kw in (("auto", {}), ("fused", {"method": "fused"}),
                      ("matrix_free", {"method": "matrix_free"}), ("dimtree", {"dimtree": True})):
        GATHERS.calls = 0
        runs[label] = blocks, w, fit = dist_cp_als(x, 3, ax, mesh, n_iters=SWEEPS, tol=0.0,
                                                   init_factors=init, **kw)
        out[f"calls/cp_als/{label}"] = np.array(GATHERS.calls)
        for j, b in enumerate(blocks):
            out[f"cp_als/{label}/f{j}"], ok = _assemble(b, [ax.get(j), None], mesh)
            same = same and ok
        out[f"cp_als/{label}/w"], out[f"cp_als/{label}/fit"] = w.numpy(), fit.numpy()
    # no init given: every rank draws the global factors from the seed
    blocks, w, fit = dist_cp_als(x, 3, ax, mesh, n_iters=SWEEPS, tol=0.0, seed=4)
    for j, b in enumerate(blocks):
        out[f"seeded/f{j}"], ok = _assemble(b, [ax.get(j), None], mesh)
        same = same and ok
    out["seeded/fit"] = fit.numpy()
    again = dist_cp_als(x, 3, ax, mesh, n_iters=SWEEPS, tol=0.0, init_factors=init)
    first = runs["auto"]
    out["repeat"] = np.array(_all_true(
        all(torch.equal(a, b) for a, b in zip(first[0], again[0]))
        and torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
    ))
    out["replicas"] = np.array(same)


def _case_dimtree(mesh, data, out):
    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.dist import GATHERS, dist_dimtree_sweep
    from repro_torch.plan import Problem, cp_als, make_executor, plan_sweep

    x, init, ax = data["x"], _factors(data), MTTKRP_AXES
    same = True
    f, w, norm_x = list(init), torch.ones(3), tensor_norm(x)
    for k in range(3):
        GATHERS.calls = 0
        blocks, w, fit = dist_dimtree_sweep(x, f, w, norm_x, k, ax, mesh)
        out[f"calls/sweep/{k}"] = np.array(GATHERS.calls)
        f = []
        for j, b in enumerate(blocks):
            g, ok = _assemble(b, [ax.get(j), None], mesh)
            same = same and ok
            f.append(torch.from_numpy(g))
            out[f"sweep/{k}/f{j}"] = g
        out[f"sweep/{k}/w"], out[f"sweep/{k}/fit"] = w.numpy(), fit.numpy()
    problem = Problem.from_tensor(x, 3, ax, mesh)
    for label, strategy, schedule in (("binary", "dimtree", None), ("chain", "1step", "chain")):
        plan = plan_sweep(problem, strategy, executor="sharded", schedule=schedule)
        fits = []
        st = cp_als(x, plan, executor=make_executor("sharded", mesh, ax), n_iters=3, tol=0.0,
                    init_factors=init, callback=lambda it, fit_, dt: fits.append(fit_))
        for j, b in enumerate(st.factors):
            out[f"engine/{label}/f{j}"], ok = _assemble(b, [ax.get(j), None], mesh)
            same = same and ok
        out[f"engine/{label}/fits"] = np.array(fits)
    out["replicas"] = np.array(same)


def _case_batched(mesh, data, out):
    from repro_torch.dist import GATHERS, dist_mttkrp
    from repro_torch.plan import Problem, cp_als, make_executor, plan_sweep

    same = True
    runs = (("a", data["xa"], _factors(data, "fa"), {}, ("data", "model")),
            ("b", data["xb"], _factors(data, "fb"), BATCH_MODE_AXES, ("data",)))
    for label, x, fs, ax, bx in runs:
        for n in range(3):
            GATHERS.calls = 0
            blk = dist_mttkrp(x, fs, n, ax, mesh, batch_axes=bx)
            out[f"calls/mttkrp/{label}/{n}"] = np.array(GATHERS.calls)
            out[f"mttkrp/{label}/{n}"], ok = _assemble(blk, [ax.get(n), None], mesh, bx)
            same = same and ok
        problem = Problem.from_tensor(x, 3, ax, mesh, batch=x.shape[0], batch_axes=bx)
        plan = plan_sweep(problem, "auto", executor="sharded")
        out[f"placement/{label}"] = np.array(plan.describe()["placement"])
        fits = []
        GATHERS.calls = 0
        st = cp_als(x, plan, executor=make_executor("sharded", mesh, ax, batch_axes=bx),
                    n_iters=SWEEPS, tol=0.0, init_factors=fs,
                    callback=lambda it, fit_, dt: fits.append(fit_))
        out[f"calls/cp_als/{label}"] = np.array(GATHERS.calls)
        for j, b in enumerate(st.factors):
            out[f"cp_als/{label}/f{j}"], ok = _assemble(b, [ax.get(j), None], mesh, bx)
            same = same and ok
        out[f"cp_als/{label}/fit"], ok = _assemble(st.fit, [], mesh, bx)
        same = same and ok
        out[f"cp_als/{label}/fits"] = np.array(fits)
    out["replicas"] = np.array(same)


CASES = {"mttkrp": _case_mttkrp, "cpals": _case_cpals, "dimtree": _case_dimtree,
         "batched": _case_batched}


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


# -------------------------------------------------------- the pytest side
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(case)``: the case's results, from one subprocess of 8 ranks a
    case (run once a module; a failure is kept and raised to every test of
    the case)."""
    done = {}

    def get(case):
        if case not in done:
            root = tmp_path_factory.mktemp(case)
            np.savez(root / "inputs.npz", **_inputs(case))
            env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
            proc = subprocess.run([sys.executable, __file__, case, str(root)], cwd=ROOT, env=env,
                                  capture_output=True, text=True, timeout=CASE_TIMEOUT)
            if proc.returncode != 0:
                done[case] = AssertionError(f"case {case} failed:\n{proc.stderr[-4000:]}")
            else:
                done[case] = dict(np.load(root / "out.npz"))
        if isinstance(done[case], Exception):
            raise done[case]
        return done[case]

    return get


def _close(ref, got, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), err_msg=msg, **tol)


def _jax(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


@pytest.mark.parametrize("method", ["auto", "1step", "fused", "matrix_free"])
def test_dist_mttkrp_matches_the_reference_and_the_local_engine(run, method):
    from repro.core.mttkrp import mttkrp as jmttkrp
    from repro_torch.core.mttkrp import mttkrp as tmttkrp

    res, data = run("mttkrp"), _inputs("mttkrp")
    x, fs = data["x"], _factors(data)
    assert bool(res["replicas"]) and bool(res["axis_sizes"])
    for n in range(4):
        got = res[f"mttkrp/{method}/{n}"]
        _close(jmttkrp(_jax(x), [_jax(u) for u in fs], n), got, msg=f"mode {n}")
        local = tmttkrp(torch.from_numpy(x), [torch.from_numpy(u) for u in fs], n, method=method)
        _close(local.numpy(), got, msg=f"mode {n}")
        # one gather a mesh axis of the contracted mapped modes
        want = sum(1 for m in MTTKRP_AXES if m != n)
        assert int(res[f"calls/mttkrp/{method}/{n}"]) == want


def test_dist_mttkrp_repeats_bitwise(run):
    assert bool(run("mttkrp")["repeat"])


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 3), (0, 1), (3, 4)])
def test_dist_contract_range_matches_the_reference(run, lo, hi):
    from repro.core.dimtree import partial_mttkrp_range as jrange

    res, data = run("mttkrp"), _inputs("mttkrp")
    x, fs = data["x"], _factors(data)
    ref = jrange(_jax(x), [_jax(u) for u in fs], lo, hi)
    _close(ref, res[f"range/{lo}{hi}/1"])
    # reduced slab by slab: the values of one reduction
    assert res[f"range/{lo}{hi}/2"].tobytes() == res[f"range/{lo}{hi}/1"].tobytes()
    axes = sum(1 for m in MTTKRP_AXES if not lo <= m < hi)
    assert int(res[f"calls/range/{lo}{hi}/1"]) == axes
    slabs = min(2, x.shape[lo] // (2 if lo == 0 else 4 if lo == 2 else 1))
    assert int(res[f"calls/range/{lo}{hi}/2"]) == axes * slabs


@pytest.mark.parametrize("plo,phi,lo,hi", [(0, 2, 0, 1), (0, 2, 1, 2), (2, 4, 2, 3),
                                           (2, 4, 3, 4), (1, 4, 1, 3)])
def test_dist_contract_partial_matches_the_reference(run, plo, phi, lo, hi):
    from repro.core.dimtree import contract_from_partial as jpartial
    from repro.core.dimtree import partial_mttkrp_range as jrange

    res, data = run("mttkrp"), _inputs("mttkrp")
    x, fs = _jax(data["x"]), [_jax(u) for u in _factors(data)]
    t = jrange(x, fs, plo, phi)
    contracted = [m for m in range(plo, phi) if not lo <= m < hi]
    ref = jpartial(t, {m: fs[m] for m in contracted}, lo, hi, plo)
    got = res[f"partial/{plo}{phi}/{lo}{hi}/1"]
    _close(ref, got)
    assert res[f"partial/{plo}{phi}/{lo}{hi}/2"].tobytes() == got.tobytes()


def _local_sweeps(x, init, sweeps, strategy="auto"):
    """Per-sweep (factors, weights, fit) of the port's local engine."""
    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.plan import legacy_sweep

    xt = torch.from_numpy(x)
    f, w, nx = [torch.from_numpy(u) for u in init], torch.ones(init[0].shape[1]), tensor_norm(xt)
    out = []
    for k in range(sweeps):
        f, w, fit = legacy_sweep(xt, f, w, nx, k, strategy=strategy)
        out.append(([u.numpy() for u in f], w.numpy(), float(fit)))
    return out


def test_dist_als_sweeps_match_the_local_engine_sweep_by_sweep(run):
    res, data = run("cpals"), _inputs("cpals")
    assert bool(res["replicas"])
    for k, (f, w, fit) in enumerate(_local_sweeps(data["x"], _factors(data), SWEEPS)):
        for j, u in enumerate(f):
            _close(u, res[f"sweep/{k}/f{j}"], msg=f"sweep {k} factor {j}")
        _close(w, res[f"sweep/{k}/w"])
        _close(fit, res[f"sweep/{k}/fit"])


@pytest.mark.parametrize("label", ["auto", "fused", "matrix_free", "dimtree"])
def test_dist_cp_als_matches_the_reference_and_the_local_engine(run, label):
    import repro.core as jcore
    from repro_torch.plan import Problem, cp_als, plan_sweep

    res, data = run("cpals"), _inputs("cpals")
    x, init = data["x"], _factors(data)
    method = "auto" if label == "dimtree" else label
    # the reference's local cp_als from the same init: the final fit
    jst = jcore.cp_als(_jax(x), jcore.CPConfig(rank=3, n_iters=SWEEPS, tol=0.0, method=method),
                       init_factors=[_jax(u) for u in init])
    _close(float(jst.fit), res[f"cp_als/{label}/fit"])
    # the port's local engine on the same plan: factors, weights and fit
    plan = plan_sweep(Problem.from_tensor(torch.from_numpy(x), 3),
                      "dimtree" if label == "dimtree" else method,
                      schedule=None if label == "dimtree" else "flat")
    st = cp_als(torch.from_numpy(x), plan, n_iters=SWEEPS, tol=0.0,
                init_factors=[torch.from_numpy(u) for u in init])
    for j, u in enumerate(st.factors):
        _close(u.numpy(), res[f"cp_als/{label}/f{j}"], msg=f"factor {j}")
    _close(st.weights.numpy(), res[f"cp_als/{label}/w"])
    _close(float(st.fit), res[f"cp_als/{label}/fit"])


def test_dist_cp_als_from_a_seed_starts_where_one_device_does(run):
    """Without ``init_factors`` every rank draws the global factors from the
    seed and keeps its block: the run is the single-device run's."""
    from repro_torch.plan import Problem, cp_als, plan_sweep

    res, data = run("cpals"), _inputs("cpals")
    x = torch.from_numpy(data["x"])
    st = cp_als(x, plan_sweep(Problem.from_tensor(x, 3), "auto", schedule="flat"),
                n_iters=SWEEPS, tol=0.0, seed=4)
    for j, u in enumerate(st.factors):
        _close(u.numpy(), res[f"seeded/f{j}"], msg=f"factor {j}")
    _close(float(st.fit), res["seeded/fit"])


def test_dist_cp_als_collectives_are_those_the_schedule_states(run):
    """Flat sweep, mode 0 on data and mode 1 on model, order 3: per sweep
    mode 0 reduces its MTTKRP over model, its column norms and Gram over
    data (3); mode 1 likewise (3); mode 2 its MTTKRP over both (2); the
    fit's inner product runs over mode 2, unmapped (0) -- 8 a sweep.  Set
    up: the tensor norm over both axes and the Grams of modes 0 and 1 (4).
    The binary tree of an order-3 problem: 2 node reductions and the same
    4 of the algebra, 6 a sweep."""
    res = run("cpals")
    for label in ("auto", "fused", "matrix_free"):
        assert int(res[f"calls/cp_als/{label}"]) == 4 + 8 * SWEEPS
    # binary split at 2 of (12, 8, 8): T_L keeps modes 0-1 and contracts
    # mode 2 (unmapped: none), leaves 0 and 1 contract modes 1 (model) and
    # 0 (data); leaf 2 contracts modes 0-1 from the root (both axes)
    assert int(res["calls/cp_als/dimtree"]) == 4 + (0 + 1 + 1 + 2 + 4) * SWEEPS


def test_dist_cp_als_repeats_bitwise(run):
    assert bool(run("cpals")["repeat"])


def test_dist_dimtree_sweeps_match_the_reference_and_the_local_engine(run):
    """At the reference case's own bounds (rtol 5e-3, atol 5e-4; fit atol
    1e-4) against its local 2-step sweep, at the fp32 tolerance against the
    port's local dimension-tree sweep."""
    import jax.numpy as jnp

    from repro.core.cpals import als_sweep as jsweep
    from repro.core.tensor_ops import tensor_norm as jnorm

    res, data = run("dimtree"), _inputs("dimtree")
    x, init = data["x"], _factors(data)
    assert bool(res["replicas"])
    jx = _jax(x)
    jf, jw, jn = [_jax(u) for u in init], jnp.ones((3,), jnp.float32), jnorm(jx)
    local = _local_sweeps(x, init, 3, strategy="dimtree")
    for k in range(3):
        jf, jw, jfit = jsweep(jx, jf, jw, jn, jnp.asarray(k), method="2step", normalize=True)
        for j in range(4):
            got = res[f"sweep/{k}/f{j}"]
            _close(jf[j], got, tol=dict(rtol=5e-3, atol=5e-4), msg=f"sweep {k} factor {j}")
            _close(local[k][0][j], got, msg=f"sweep {k} factor {j}")
        _close(float(jfit), res[f"sweep/{k}/fit"], tol=dict(rtol=0, atol=1e-4))
        _close(local[k][2], res[f"sweep/{k}/fit"])
        # node reductions T_L (model), leaf 1 (data), T_R (data), leaf 3
        # (model); norms and Grams of modes 0 and 2 (4); the Grams a legacy
        # sweep starts from (2)
        assert int(res[f"calls/sweep/{k}"]) == 4 + 4 + 2


@pytest.mark.parametrize("label,strategy,schedule", [("binary", "dimtree", None),
                                                     ("chain", "1step", "chain")])
def test_sharded_tree_schedules_match_the_local_engine(run, label, strategy, schedule):
    from repro_torch.plan import Problem, cp_als, plan_sweep

    res, data = run("dimtree"), _inputs("dimtree")
    x, init = torch.from_numpy(data["x"]), [torch.from_numpy(u) for u in _factors(data)]
    fits = []
    st = cp_als(x, plan_sweep(Problem.from_tensor(x, 3), strategy, schedule=schedule),
                n_iters=3, tol=0.0, init_factors=init,
                callback=lambda it, f, dt: fits.append(f))
    for j, u in enumerate(st.factors):
        _close(u.numpy(), res[f"engine/{label}/f{j}"], msg=f"factor {j}")
    _close(np.array(fits), res[f"engine/{label}/fits"])


@pytest.mark.parametrize("label", ["a", "b"])
def test_batched_dist_mttkrp_matches_the_reference(run, label):
    from repro.core.mttkrp import mttkrp_batched as jbatched

    res, data = run("batched"), _inputs("batched")
    assert bool(res["replicas"])
    x, fs = data[f"x{label}"], _factors(data, f"f{label}")
    for n in range(3):
        _close(jbatched(_jax(x), [_jax(u) for u in fs], n), res[f"mttkrp/{label}/{n}"],
               msg=f"mode {n}")
        # batch axes are never reduced
        want = sum(1 for m in (BATCH_MODE_AXES if label == "b" else {}) if m != n)
        assert int(res[f"calls/mttkrp/{label}/{n}"]) == want


@pytest.mark.parametrize("label", ["a", "b"])
def test_batched_sharded_cp_als_matches_the_reference_and_the_local_engine(run, label):
    import repro.plan as jplan
    from repro_torch.plan import Problem, cp_als, plan_sweep

    res, data = run("batched"), _inputs("batched")
    x, fs = data[f"x{label}"], _factors(data, f"f{label}")
    batch = x.shape[0]
    assert str(res[f"placement/{label}"]) == ("batch-parallel" if label == "a" else "mode-parallel")
    fits = []
    st = cp_als(torch.from_numpy(x), plan_sweep(Problem.from_tensor(torch.from_numpy(x), 3,
                                                                    batch=batch), "auto"),
                n_iters=SWEEPS, tol=0.0, init_factors=[torch.from_numpy(u) for u in fs],
                callback=lambda it, f, dt: fits.append(f))
    for j, u in enumerate(st.factors):
        _close(u.numpy(), res[f"cp_als/{label}/f{j}"], msg=f"factor {j}")
    _close(st.fit.numpy(), res[f"cp_als/{label}/fit"])
    _close(np.array(fits), res[f"cp_als/{label}/fits"])
    jst = jplan.cp_als(_jax(x), jplan.plan_sweep(jplan.Problem.from_tensor(_jax(x), 3, batch=batch),
                                                 "auto"),
                       n_iters=SWEEPS, tol=0.0, init_factors=[_jax(u) for u in fs])
    _close(np.asarray(jst.fit), res[f"cp_als/{label}/fit"])
    # a: no reduction anywhere; the fits of a sweep gathered over both batch
    # axes (2).  b: mode 0 on model adds the MTTKRP reductions of modes 1
    # and 2, the norms and Gram of mode 0, and set-up's norm and Gram (2).
    per_sweep = 2 if label == "a" else 1 + 2 + 2
    assert int(res[f"calls/cp_als/{label}"]) == per_sweep * SWEEPS + (0 if label == "a" else 2)


# ------------------------------------------------------- in-process checks
def _dist_modules():
    """Both packages' ``dist.dist_mttkrp`` modules (the package attribute of
    that name is the function)."""
    import importlib

    return (importlib.import_module("repro.dist.dist_mttkrp"),
            importlib.import_module("repro_torch.dist.dist_mttkrp"))


def _meshes(sizes: dict):
    """Stand-ins of one mesh for both packages' validation, which reads
    only axis names and sizes."""
    jmesh = types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))
    tmesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))
    return jmesh, tmesh


@pytest.mark.parametrize("shape,mode_axes", [
    ((8, 6, 4), {3: "data"}),  # mode out of range
    ((8, 6, 4), {0: "pipe"}),  # no such axis
    ((8, 6, 4), {0: "data", 1: "data"}),  # one axis, two modes
    ((7, 6, 4), {0: "data"}),  # not divisible
])
def test_validate_raises_as_the_reference(shape, mode_axes):
    jd, td = _dist_modules()
    jmesh, tmesh = _meshes({"data": 2, "model": 4})
    with pytest.raises(ValueError) as jerr:
        jd._validate(shape, mode_axes, jmesh)
    with pytest.raises(ValueError) as terr:
        td._validate(shape, mode_axes, tmesh)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("batch,batch_axes,mode_axes", [
    (8, ("pipe",), {}),  # no such axis
    (8, ("data",), {0: "data"}),  # an axis for a mode and the batch
    (8, ("data", "data"), {}),  # duplicate
    (6, ("data", "model"), {}),  # not divisible
])
def test_validate_batch_raises_as_the_reference(batch, batch_axes, mode_axes):
    jd, td = _dist_modules()
    jmesh, tmesh = _meshes({"data": 2, "model": 4})
    with pytest.raises(ValueError) as jerr:
        jd._validate_batch(batch, batch_axes, mode_axes, jmesh)
    with pytest.raises(ValueError) as terr:
        td._validate_batch(batch, batch_axes, mode_axes, tmesh)
    assert str(terr.value) == str(jerr.value)


def test_problem_from_tensor_reads_a_device_mesh():
    import repro_torch.plan as tplan

    _, tmesh = _meshes({"data": 2, "model": 4})
    p = tplan.Problem.from_tensor(torch.zeros(8, 6, 4), 3, {0: "data", 2: "model"}, tmesh)
    assert p.axis_sizes == {"data": 2, "model": 4} and p.local_shape == (4, 6, 1)


PLAN_CASES = [
    ((8, 6, 4, 5), 7, {0: "data", 2: "model"}, 1, ()),
    ((12, 8, 8), 3, {0: "data", 1: "model"}, 1, ()),
    ((8, 6, 8), 3, {0: "model"}, 8, ()),  # batched mode-parallel: the batch-parallel remap
    ((8, 6, 8), 3, {0: "model"}, 4, ("data",)),
    ((6, 4, 5), 3, {}, 8, ("data", "model")),
]


@pytest.mark.parametrize("shape,rank,mode_axes,batch,batch_axes", PLAN_CASES)
@pytest.mark.parametrize("strategy", ["1step", "dimtree", "matrix_free"])
def test_sharded_plans_match_the_reference(shape, rank, mode_axes, batch, batch_axes, strategy):
    """The placements compared and every node's flat collective bytes (exact:
    bytes do not depend on constants).  The chosen placement may differ
    with the H100 constants: the candidates and their bytes may not."""
    import repro.plan as jplan
    import repro_torch.plan as tplan

    kw = dict(shape=shape, rank=rank, mode_axes=mode_axes, axis_sizes={"data": 2, "model": 4},
              batch=batch, batch_axes=batch_axes)
    jp = jplan.plan_sweep(jplan.Problem(**kw), strategy, executor="sharded",
                          tuning_cache=jplan.TuningCache())
    tp = tplan.plan_sweep(tplan.Problem(**kw), strategy, executor="sharded",
                          tuning_cache=tplan.TuningCache())
    jd, td = jp.describe(), tp.describe()
    keys = ("placement", "mode_axes", "batch_axes", "executor", "schedule", "collective_bytes")
    assert [{k: r[k] for k in keys} for r in td["placements"]] == [
        {k: r[k] for k in keys} for r in jd["placements"]]
    assert sum(r["selected"] for r in td["placements"]) == (1 if td["placements"] else 0)
    for p in (tp.problem,) + tuple(tplan.Problem(**{**kw, "mode_axes": r["mode_axes"] and {
            int(m): a for m, a in r["mode_axes"].items()}, "batch_axes": tuple(r["batch_axes"])})
            for r in td["placements"]):
        jprob = jplan.Problem(**{**kw, "mode_axes": p.mode_axes, "batch_axes": p.batch_axes})
        jq = jplan.plan_sweep(jprob, strategy, executor="sharded", schedule=tp.resolved_schedule.name
                              if strategy != "dimtree" else None, tuning_cache=jplan.TuningCache())
        tq = tplan.plan_sweep(p, strategy, executor="sharded", schedule=tp.resolved_schedule.name
                              if strategy != "dimtree" else None, tuning_cache=tplan.TuningCache())
        assert [n["collective_bytes"] for n in tq.describe()["nodes"]] == [
            n["collective_bytes"] for n in jq.describe()["nodes"]]
        assert tq.describe()["local_shape"] == jq.describe()["local_shape"]
        assert tq.describe()["placement"] == jq.describe()["placement"]


@pytest.mark.parametrize("n", range(4))
@pytest.mark.parametrize("algorithm", ["1step", "2step", "fused", "matrix_free", "dimtree"])
def test_collective_bytes_match_the_reference(n, algorithm):
    import repro.plan as jplan
    import repro_torch.plan as tplan

    kw = dict(shape=(8, 6, 4, 5), rank=7, mode_axes={0: "data", 2: "model"},
              axis_sizes={"data": 2, "model": 4})
    jc = jplan.executor_mode_cost(jplan.Problem(**kw), n, algorithm, "sharded")
    tc = tplan.executor_mode_cost(tplan.Problem(**kw), n, algorithm, "sharded")
    assert tc.collective_bytes == jc.collective_bytes and tc.intra_bytes == jc.intra_bytes
    assert (tc.flops, tc.bytes) == (jc.flops, jc.bytes)
    assert tc.collective_s > 0 or jc.collective_bytes == 0


def test_later_distribution_slices_raise_naming_their_slice():
    """Every distribution slice is ported: the overlapping and compressed
    executors and the argmin among them (2, 3), the hierarchical collective
    and two-level planning (4), sharded pairwise perturbation (5) -- they
    plan and build; only unknown names raise."""
    import repro_torch.plan as tplan

    _, td = _dist_modules()
    sharded = tplan.Problem((8, 6, 4), 3, mode_axes={0: "data"}, axis_sizes={"data": 2})
    assert tplan.plan_sweep(sharded).executor in ("sharded", "overlapping", "compressed")
    assert tplan.select_executor(sharded) == tplan.plan_sweep(sharded).executor
    assert tplan.select_executor(tplan.Problem((8, 6, 4), 3)) == "local"
    assert isinstance(tplan.make_executor("overlapping", object(), {}), tplan.OverlappingExecutor)
    assert tplan.plan_sweep(sharded, executor="compressed").executor == "compressed"
    td._validate_collective("hierarchical")
    with pytest.raises(ValueError, match="unknown collective"):
        td._validate_collective("ring")
    two_level = tplan.Problem((8, 6, 4), 3, mode_axes={0: "device"},
                              axis_sizes={"node": 2, "device": 2}, intra_axes=("device",))
    plan = tplan.plan_sweep(two_level, executor="sharded")
    assert plan.executor == "sharded" and plan.lower_bound_bytes is not None
    pp = tplan.plan_sweep(tplan.Problem((8, 6, 4), 3, mode_axes={0: "data"},
                                        axis_sizes={"data": 2}, pp_tol=0.1), executor="sharded")
    assert pp.describe()["pp"]["tol"] == 0.1
    # with no mapped mode to reduce over, the sharded pairs are the local ones
    mesh = types.SimpleNamespace(mesh_dim_names=("data",), shape=(1,),
                                 get_group=lambda axis: None)
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4) / 50.0
    fs = [torch.full((d, 3), 0.5) for d in x.shape]
    local = tplan.LocalExecutor().pp_pairs(sharded, x, fs)
    ex = tplan.ShardedExecutor(mesh, {})
    assert all(torch.equal(local[k], v) for k, v in ex.pp_pairs(sharded, x, fs).items())
    with pytest.raises(ValueError, match="needs mesh"):
        tplan.make_executor("sharded")
    assert isinstance(tplan.make_executor("sharded", object(), {}), tplan.ShardedExecutor)


def test_port_modules_of_this_slice_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch, repro_torch.dist, repro_torch.launch.mesh, "
            "repro_torch.core.cp_layers")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
