"""The port's CP serving layer (``repro_torch.serve``) and its driver, on the
CPU: the cases of ``tests/test_cp_service.py`` that need no mesh and no
pairwise perturbation, ported to the port's service, plus parity with the
reference's ``CPService`` on the same tensors and initial factors.

Inputs are made once with numpy from a seed; float32 tolerance
``rtol=2e-4, atol=2e-5`` for factors and weights, ``rtol=1e-4, atol=1e-5``
for fits, as in the reference's tests.  Bitwise claims hold port against
port only.
"""

import ast
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jplan
import repro.serve as jserve
from repro_torch.interop import cpresult_from_numpy, cpresult_to_numpy
from repro_torch.plan import Problem, cp_als, plan_sweep
from repro_torch.plan.autotune import TuningCache, problem_key
from repro_torch.serve import CPService, PendingRequest, QueueFull, RequestQueue

RANK = 3
N_ITERS = 5
TOL = dict(rtol=2e-4, atol=2e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def _request(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    init = [rng.standard_normal((d, RANK)).astype(np.float32) for d in shape]
    return x, init


def _service(**kw):
    kw.setdefault("device", "cpu")
    return CPService(**kw)


def _direct(x, init):
    """The per-tensor reference within the port: same init, same sweep
    budget, tol=0, unbatched."""
    plan = plan_sweep(Problem(x.shape, RANK))
    return cp_als(torch.from_numpy(x), plan, n_iters=N_ITERS, tol=0.0,
                  init_factors=[torch.from_numpy(u) for u in init])


def _assert_matches_direct(fut, x, init):
    res = fut.result()
    ref = _direct(x, init)
    for a, b in zip(res.factors, ref.factors):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    np.testing.assert_allclose(res.weights.numpy(), ref.weights.numpy(), **TOL)
    np.testing.assert_allclose(res.fit, float(ref.fit), **FIT_TOL)
    assert res.sweeps == N_ITERS


# ------------------------------------------------------------ service numerics
def test_mixed_signature_stream_matches_per_tensor():
    """A mixed-signature stream (two shapes interleaved, full + padded
    batches) returns the per-tensor cp_als results, with one dispatch-cache
    miss (compile) per signature."""
    svc = _service(batch_size=4, n_iters=N_ITERS)
    shapes = [(8, 9, 10), (6, 6, 6)]
    reqs = []
    for i in range(10):  # 5 per signature: one full batch + one padded each
        x, init = _request(shapes[i % 2], seed=i)
        reqs.append((x, init, svc.submit(x, RANK, init_factors=init)))
    done = svc.flush()
    assert len(done) == len(reqs) and all(f.done() for _, _, f in reqs)
    for x, init, fut in reqs:
        _assert_matches_direct(fut, x, init)
        assert fut.result().factors[0].device.type == "cpu"
    stats = svc.stats()
    assert stats["signatures"] == 2
    assert stats["compiles"] == 2
    assert stats["batches"] == 4
    assert stats["completed"] == 10 and stats["queue_depth"] == 0


def test_padded_partial_batch_is_exact():
    """Dummy slots (real requests cycled into the padding) cannot perturb the
    real problems: a 3-request batch in an 8-slot dispatch gives each real
    request the bits of the same request in a full batch."""
    reqs = [_request((7, 6, 5), seed=20 + i) for i in range(8)]
    partial = _service(batch_size=8, n_iters=N_ITERS)
    futs = [partial.submit(x, RANK, init_factors=init) for x, init in reqs[:3]]
    partial.flush()
    full = _service(batch_size=8, n_iters=N_ITERS)
    full_futs = [full.submit(x, RANK, init_factors=init) for x, init in reqs]
    full.flush()
    for (x, init), fut, ff in zip(reqs, futs, full_futs):
        _assert_matches_direct(fut, x, init)
        assert all(torch.equal(a, b) for a, b in zip(fut.result().factors, ff.result().factors))
        assert fut.result().fit == ff.result().fit
    stats = partial.stats()
    assert stats["padded_slots"] == 5
    assert stats["batch_occupancy"] == pytest.approx(3 / 8)


def test_one_compile_per_signature_across_flushes():
    """Re-submitting a served signature reuses its dispatch state: the
    compile counter stays put across flushes and only a new signature (or
    new update options) bumps it."""
    svc = _service(batch_size=2, n_iters=N_ITERS)
    for round_ in range(3):
        x, init = _request((6, 5, 4), seed=30 + round_)
        svc.submit(x, RANK, init_factors=init)
        svc.flush()
        assert svc.stats()["compiles"] == 1
    x, _ = _request((5, 5, 5), seed=40)  # new shape -> new signature
    svc.submit(x, RANK)
    svc.flush()
    assert svc.stats()["compiles"] == 2
    x, _ = _request((5, 5, 5), seed=41)
    svc.submit(x, RANK, n_iters=N_ITERS + 1)
    svc.flush()
    assert svc.stats()["signatures"] == 3 and svc.stats()["compiles"] == 3


def test_batch_size_one_serves_unbatched_problems():
    """batch_size=1 dispatches the unbatched problem (no batch axis)."""
    svc = _service(batch_size=1, n_iters=N_ITERS, strategy="fused")
    reqs = [_request((6, 7, 5), seed=45 + i) for i in range(2)]
    futs = [svc.submit(x, RANK, init_factors=init) for x, init in reqs]
    svc.flush()
    for (x, init), fut in zip(reqs, futs):
        _assert_matches_direct(fut, x, init)
        assert tuple(fut.result().weights.shape) == (RANK,)
    assert svc.stats()["batches"] == 2 and svc.stats()["padded_slots"] == 0


def test_seeded_init_is_repeatable_and_per_request():
    """Without init_factors a request draws its factors from a generator
    seeded with its seed: the same seed gives the same result."""
    x, _ = _request((6, 5, 4), seed=48)
    svc = _service(batch_size=3, n_iters=N_ITERS)
    a, b, c = (svc.submit(x, RANK, seed=s) for s in (7, 7, 8))
    svc.flush()
    assert all(torch.equal(u, v) for u, v in zip(a.result().factors, b.result().factors))
    assert not torch.equal(a.result().factors[0], c.result().factors[0])


# ---------------------------------------------------------------- scheduling
def test_fifo_within_signature_and_priority_across():
    """step() serves the bucket owning the most urgent request; within a
    bucket, higher priority first and FIFO (submission order) on ties."""
    svc = _service(batch_size=2, n_iters=2)
    xa, _ = _request((6, 6, 6), seed=50)
    xb, _ = _request((7, 7, 7), seed=51)
    fa1 = svc.submit(xa, RANK)
    fb1 = svc.submit(xb, RANK, priority=5)
    fa2 = svc.submit(xa, RANK, priority=3)
    fa3 = svc.submit(xa, RANK)

    assert [f.rid for f in svc.step()] == [fb1.rid]
    assert [f.rid for f in svc.step()] == [fa2.rid, fa1.rid]
    assert [f.rid for f in svc.step()] == [fa3.rid]
    assert svc.step() == []


@pytest.mark.parametrize("queue_cls", [RequestQueue, jserve.RequestQueue],
                         ids=["port", "reference"])
def test_request_queue_ordering_and_buckets(queue_cls):
    """The scheduler, port and reference alike: priority-descending, FIFO
    within, per-key buckets, next_key() = bucket of the globally most
    urgent request."""
    q = queue_cls()
    a0 = q.submit("a0", key="A")
    b0 = q.submit("b0", key="B", priority=2)
    a1 = q.submit("a1", key="A", priority=2)
    a2 = q.submit("a2", key="A")
    assert len(q) == q.depth == 4
    assert q.next_key() == "B"
    assert q.keys() == ["B", "A"]
    assert [r.payload for r in q] == ["b0", "a1", "a0", "a2"]
    assert q.take(10, "A") == [a1, a0, a2]
    assert q.take(10) == [b0]
    assert q.take(10) == [] and q.next_key() is None
    with pytest.raises(ValueError, match="batch_size"):
        q.take(0)


def test_request_queue_matches_reference_on_a_random_stream():
    """The same stream of submits and takes gives the same serving order in
    the port's queue and the reference's."""
    rng = np.random.default_rng(3)
    tq, jq = RequestQueue(), jserve.RequestQueue()
    served = {"port": [], "reference": []}
    for step in range(60):
        if rng.random() < 0.6:
            key, prio = "ABC"[rng.integers(3)], int(rng.integers(3))
            tq.submit(step, key=key, priority=prio)
            jq.submit(step, key=key, priority=prio)
        else:
            size = int(rng.integers(1, 4))
            served["port"].append([r.payload for r in tq.take(size)])
            served["reference"].append([r.payload for r in jq.take(size)])
    assert served["port"] == served["reference"]
    assert PendingRequest(rid=3, payload=None, priority=1).sort_index() == (-1, 3)


def test_bounded_queue_backpressure():
    """A full queue rejects submission with QueueFull (counted), and
    capacity frees up after a flush."""
    svc = _service(batch_size=2, n_iters=2, max_pending=2)
    x, _ = _request((6, 6, 6), seed=60)
    svc.submit(x, RANK)
    svc.submit(x, RANK)
    with pytest.raises(QueueFull, match="max_pending=2"):
        svc.submit(x, RANK)
    assert svc.stats()["rejected"] == 1
    assert svc.stats()["queue_depth"] == 2
    svc.flush()
    svc.submit(x, RANK)
    assert svc.stats()["queue_depth"] == 1
    with pytest.raises(ValueError, match="max_pending"):
        RequestQueue(0)


# ----------------------------------------------------------------- warm plans
def test_warm_plan_hits_from_tuning_cache(tmp_path):
    """The persistent TuningCache is the warm-plan store keyed by the same
    signature: a signature with an entry on disk counts a warm_plan_hit, an
    untuned one plans analytically (no hit)."""
    shape, B = (6, 5, 4), 2
    cache = TuningCache(tmp_path / "tuning.json")
    cache.put(
        problem_key(Problem(shape=shape, rank=RANK, batch=B)),
        {"nodes": [], "tiles": {}, "serial_fractions": {}},
    )
    svc = _service(batch_size=B, n_iters=2, strategy="autotune",
                   tuning_cache=TuningCache(tmp_path / "tuning.json"))
    x, _ = _request(shape, seed=70)
    svc.submit(x, RANK)
    svc.flush()
    assert svc.stats()["warm_plan_hits"] == 1
    y, _ = _request((8, 8, 8), seed=71)
    svc.submit(y, RANK)
    svc.flush()
    stats = svc.stats()
    assert stats["signatures"] == 2 and stats["warm_plan_hits"] == 1


def test_service_signature_is_the_canonical_problem_signature():
    """The batch bucket key extends Problem.signature()/problem_key (the
    tuning-cache key) with the update options -- and equals the reference
    service's key for the same request."""
    svc = _service(batch_size=4, n_iters=7, tol=0.0)
    x, _ = _request((6, 5, 4), seed=0)
    sig = svc.signature_of(x, RANK)
    base = problem_key(Problem(shape=(6, 5, 4), rank=RANK, batch=4))
    assert sig == f"{base}|i7|t0"
    assert svc.signature_of(x, RANK, n_iters=9) == f"{base}|i9|t0"
    jsvc = jserve.CPService(batch_size=4, n_iters=7, tol=0.0)
    assert jsvc.signature_of(jnp.asarray(x), RANK) == sig


def test_submit_validation_and_future_protocol():
    """Bad submissions fail loudly; futures refuse to resolve early."""
    svc = _service(batch_size=2, n_iters=2)
    with pytest.raises(ValueError, match="order"):
        svc.submit(np.zeros((4,), np.float32), RANK)
    x, _ = _request((5, 4, 3), seed=0)
    with pytest.raises(ValueError, match="init_factors"):
        svc.submit(x, RANK, init_factors=[np.zeros((5, RANK), np.float32)] * 3)
    fut = svc.submit(x, RANK)
    assert not fut.done()
    with pytest.raises(RuntimeError, match="pending"):
        fut.result()
    svc.flush()
    assert fut.done() and fut.result().rid == fut.rid
    with pytest.raises(ValueError, match="batch_size"):
        CPService(batch_size=0)


def test_mesh_and_pp_raise_not_implemented():
    # a mesh serves batch-parallel (8-rank worlds: tests/test_torch_dist_exec.py);
    # its device count must divide the batch, as in the reference
    mesh = types.SimpleNamespace(mesh_dim_names=("b",), shape=(2,), device_type="cpu")
    with pytest.raises(ValueError, match="not divisible by the mesh's 2 devices"):
        CPService(batch_size=3, mesh=mesh, device="cpu")
    # PP requests are ported: they are taken and bucket under a |pp signature
    assert CPService(batch_size=2, pp_tol=0.25, device="cpu").pp_tol == 0.25
    svc = _service(batch_size=2)
    x, _ = _request((5, 4, 3), seed=1)
    fut = svc.submit(x, RANK, pp_tol=0.25)
    assert "|pp0.25|" in fut.signature
    assert svc.stats()["submitted"] == 1


def test_service_runs_on_the_card_unless_told_otherwise():
    assert CPService().device == torch.device("cuda")
    svc = _service(batch_size=2)
    x, _ = _request((5, 4, 3), seed=2)
    fut = svc.submit(torch.from_numpy(x), RANK)
    svc.flush()
    assert fut.result().factors[0].device.type == "cpu"


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("strategy", ["autotune", "fused", "matrix_free"])
def test_service_matches_reference_service(strategy):
    """The port's service and the reference's, on the same tensors and
    initial factors (two signatures, a padded batch): every result agrees at
    tolerance, and the counters agree exactly."""
    shapes = [(6, 7, 5), (4, 5, 3, 4)]
    reqs = [_request(shapes[i % 2], seed=200 + i) for i in range(7)]
    tsvc = _service(batch_size=3, n_iters=4, strategy=strategy, tuning_cache=TuningCache())
    jsvc = jserve.CPService(batch_size=3, n_iters=4, strategy=strategy,
                            tuning_cache=jplan.TuningCache())
    tf = [tsvc.submit(x, RANK, init_factors=init) for x, init in reqs]
    jf = [jsvc.submit(jnp.asarray(x), RANK, init_factors=[jnp.asarray(u) for u in init])
          for x, init in reqs]
    tsvc.flush()
    jsvc.flush()
    for a, b in zip(tf, jf):
        ta, jb = cpresult_to_numpy(a.result()), cpresult_to_numpy(b.result())
        for u, v in zip(ta["factors"], jb["factors"]):
            np.testing.assert_allclose(u, v, **TOL)
        np.testing.assert_allclose(ta["weights"], jb["weights"], **TOL)
        np.testing.assert_allclose(ta["fit"], jb["fit"], **FIT_TOL)
        assert (ta["rid"], ta["sweeps"], ta["signature"]) == (jb["rid"], jb["sweeps"],
                                                              jb["signature"])
    keys = ("submitted", "completed", "batches", "compiles", "padded_slots", "signatures",
            "warm_plan_hits", "queue_depth")
    assert {k: tsvc.stats()[k] for k in keys} == {k: jsvc.stats()[k] for k in keys}


def test_served_result_crosses_packages():
    x, init = _request((5, 6, 4), seed=300)
    svc = _service(batch_size=2, n_iters=2)
    fut = svc.submit(x, RANK, init_factors=init)
    svc.flush()
    fields = cpresult_to_numpy(fut.result())
    back = cpresult_from_numpy(fields, device="cpu")
    assert back.rid == fut.rid and back.fit == fut.result().fit
    assert all(torch.equal(a, b) for a, b in zip(back.factors, fut.result().factors))


# ---------------------------------------------------------------- the driver
def test_serve_cp_driver_runs_on_the_cpu():
    from repro_torch.launch import serve_cp

    stats = serve_cp.main(["--device", "cpu", "--requests", "5", "--batch-size", "2",
                           "--rank", "3", "--dim", "6", "--n-iters", "2"])
    assert stats["completed"] == 5 and stats["signatures"] == 2 and stats["batches"] == 3
    assert stats["padded_slots"] == 1 and stats["compiles"] == 2
    # --mesh runs one rank a process under torchrun (tests/test_torch_dist_exec.py);
    # outside one the environment names no rank
    with pytest.raises(ValueError, match="RANK"):
        serve_cp.main(["--device", "cpu", "--mesh"])


def test_import_check_covers_serve_and_launch():
    """The AST import check of tests/test_torch_core.py reads every module
    of the port; serve/ and launch/ are among them and import neither jax
    nor the reference."""
    from test_torch_core import _port_sources

    sources = {p.relative_to(ROOT / "src" / "repro_torch").parts[0] for p in _port_sources()
               if p.is_relative_to(ROOT / "src" / "repro_torch")}
    assert {"serve", "launch"} <= sources
    for path in _port_sources():
        if path.parent.name in ("serve", "launch"):
            tree = ast.parse(path.read_text())
            mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            mods += [n.module or "" for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.level == 0]
            assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")], path
