"""The port's kernel wrappers take the reference's keywords, and the tuner
leaves out the kernels where they do not take a problem, on the CPU.

Every wrapper is called through both packages with the reference's own
keyword values (tile sizes, ``interpret=True``, ``pad_rank_to``) on shared
numpy inputs; the JAX side runs the Pallas kernels in interpret mode.  On
the CPU the port takes its plain versions: the tile keywords change nothing
there or on the card, and ``interpret`` never decides the device.  float32
tolerance ``rtol=2e-4, atol=2e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.plan as tplan
import repro_torch.plan.autotune as tautotune
from repro.kernels import fused_mttkrp as jfused
from repro.kernels import krp_kernel as jkrp
from repro.kernels import matrix_free as jmf
from repro.kernels import multi_ttv as jmt
from repro.kernels import ops as jops
from repro_torch.kernels import _tiling as ttiling
from repro_torch.kernels import fused_mttkrp as tfused
from repro_torch.kernels import krp_kernel as tkrp
from repro_torch.kernels import matrix_free as tmf
from repro_torch.kernels import multi_ttv as tmt
from repro_torch.kernels import ops as tops
from repro_torch.plan.schedule import enumerate_schedules

TOL = dict(rtol=2e-4, atol=2e-5)
KERNELS = (tfused.KERNEL, tfused.BATCHED_KERNEL, tmf.KERNEL, tmf.BATCHED_KERNEL, tmt.KERNEL,
           tmt.BATCHED_KERNEL, tkrp.KERNEL)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **TOL)


@pytest.fixture
def no_launch():
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before  # CPU tensors never reach a CUDA kernel


# ---- A1: the reference's keywords, through both packages


@pytest.mark.parametrize("kw", [
    {}, {"block_i": 4, "block_b": 8, "interpret": True, "pad_rank_to": 8},
    {"block_i": 128, "block_b": 256, "interpret": True, "pad_rank_to": 128},
])
def test_fused_mttkrp_takes_the_reference_keywords(kw, no_launch):
    shape = (8, 6, 8, 4)
    x, *fs = _arrays([shape] + [(d, 3) for d in shape], seed=1)
    (jx, *jfs), (tx, *tfs) = _pair([x] + fs)
    for n in range(4):
        _close(jops.fused_mttkrp(jx, jfs, n, **kw), tops.fused_mttkrp(tx, tfs, n, **kw))


@pytest.mark.parametrize("kw", [
    {"block_i": 4, "block_b": 8, "block_batch": 2, "interpret": True, "pad_rank_to": 8},
    {"block_batch": 8, "interpret": True},
])
def test_fused_mttkrp_batched_takes_the_reference_keywords(kw, no_launch):
    shape = (8, 6, 4)
    x, *fs = _arrays([(4,) + shape] + [(4, d, 3) for d in shape], seed=2)
    (jx, *jfs), (tx, *tfs) = _pair([x] + fs)
    for n in range(3):
        _close(jops.fused_mttkrp_batched(jx, jfs, n, **kw),
               tops.fused_mttkrp_batched(tx, tfs, n, **kw))


@pytest.mark.parametrize("kw", [
    {}, {"block_i": 4, "block_r": 2, "interpret": True, "pad_rank_to": 8},
    {"block_i": 128, "block_r": 8, "interpret": True, "pad_rank_to": 128},
])
def test_matrix_free_mttkrp_takes_the_reference_keywords(kw, no_launch):
    shape = (6, 5, 4, 7)
    x, *fs = _arrays([shape] + [(d, 3) for d in shape], seed=3)
    (jx, *jfs), (tx, *tfs) = _pair([x] + fs)
    for n in range(4):
        _close(jmf.matrix_free_mttkrp(jx, jfs, n, **kw), tmf.matrix_free_mttkrp(tx, tfs, n, **kw))


@pytest.mark.parametrize("kw", [
    {"block_i": 4, "block_r": 2, "block_batch": 2, "interpret": True, "pad_rank_to": 8},
    {"block_batch": 8, "interpret": True},
])
def test_matrix_free_mttkrp_batched_takes_the_reference_keywords(kw, no_launch):
    shape = (6, 5, 7)
    x, *fs = _arrays([(3,) + shape] + [(3, d, 3) for d in shape], seed=4)
    (jx, *jfs), (tx, *tfs) = _pair([x] + fs)
    for n in range(3):
        _close(jmf.matrix_free_mttkrp_batched(jx, jfs, n, **kw),
               tmf.matrix_free_mttkrp_batched(tx, tfs, n, **kw))


def test_matrix_free_raw_kernels_take_the_reference_keywords(no_launch):
    """The raw grids: the reference needs every axis padded to its block,
    so the shapes here divide the blocks."""
    shape = (4, 6, 8)
    x, *fs = _arrays([shape] + [(d, 3) for d in shape], seed=5)
    xb, *fbs = _arrays([(4,) + shape] + [(4, d, 3) for d in shape], seed=6)
    (jx, *jfs), (tx, *tfs) = _pair([x] + fs)
    (jxb, *jfbs), (txb, *tfbs) = _pair([xb] + fbs)
    for n, blocks in ((0, [2, 4]), (1, [2, 4]), (2, [4, 3])):
        others = [k for k in range(3) if k != n]
        kw = {"block_i": 2, "blocks": blocks, "interpret": True}
        _close(jmf.matrix_free_kernel(jx, [jfs[k] for k in others], n, **kw),
               tmf.matrix_free_kernel(tx, [tfs[k] for k in others], n, **kw))
        _close(jmf.matrix_free_batched_kernel(jxb, [jfbs[k] for k in others], n,
                                              block_batch=2, **kw),
               tmf.matrix_free_batched_kernel(txb, [tfbs[k] for k in others], n,
                                              block_batch=2, **kw))
    with pytest.raises(ValueError):
        tmf.matrix_free_kernel(tx, [tfs[1], tfs[2]], 0, blocks=[2])  # one block per mode
    with pytest.raises(ValueError):
        tmf.matrix_free_kernel(tx, [tfs[1], tfs[2]], 0, block_i=0)


@pytest.mark.parametrize("pos", [0, 1, 2])
def test_fused_bilinear_raw_kernels_take_the_reference_keywords(pos, no_launch):
    dims = [6, 4, 8]
    dims.insert(pos, 8)
    dims = dims[:3]  # (i at pos) x a x b, every extent divisible by its block
    t, a, b = _arrays([tuple(dims), (dims[1 if pos == 0 else 0], 3),
                       (dims[1 if pos == 2 else 2], 3)], seed=7 + pos)
    tb, ab, bb = _arrays([(4,) + tuple(dims), (4, a.shape[0], 3), (4, b.shape[0], 3)],
                         seed=17 + pos)
    kw = {"block_i": 4, "block_b": b.shape[0] // 2, "interpret": True}
    (jt, ja, jb), (tt, ta, tb_) = _pair([t, a, b])
    _close(jfused.fused_mttkrp_bilinear(jt, ja, jb, pos=pos, **kw),
           tfused.fused_mttkrp_bilinear(tt, ta, tb_, pos=pos, **kw))
    (jtb, jab, jbb), (ttb, tab, tbb) = _pair([tb, ab, bb])
    _close(jfused.fused_mttkrp_bilinear_batched(jtb, jab, jbb, pos=pos, block_batch=2, **kw),
           tfused.fused_mttkrp_bilinear_batched(ttb, tab, tbb, pos=pos, block_batch=2, **kw))
    with pytest.raises(ValueError):
        tfused.fused_mttkrp_bilinear(tt, ta, tb_, pos=pos, block_b=0)


def test_krp_takes_the_reference_keywords(no_launch):
    a, b, c = _arrays([(5, 4), (8, 4), (3, 4)], seed=8)
    (ja, jb, jc), (ta, tb, tc) = _pair([a, b, c])
    _close(jkrp.krp_pair(ja, jb, block_b=4, interpret=True),
           tkrp.krp_pair(ta, tb, block_b=4, interpret=True))
    _close(jops.krp_materialize([ja, jb, jc], block_b=2, interpret=True),
           tops.krp_materialize([ta, tb, tc], block_b=2, interpret=True))


@pytest.mark.parametrize("block_i", [8, 100, 2048])
def test_multi_ttv_takes_any_block_i(block_i, no_launch):
    """The reference clamps any block_i; the port maps it to a legal tile."""
    t, w, tb, wb = _arrays([(6, 37, 5), (6, 5), (3, 4, 21, 6), (3, 4, 6)], seed=block_i)
    (jt, jw, jtb, jwb), (tt, tw, ttb, twb) = _pair([t, w, tb, wb])
    _close(jmt.multi_ttv(jt, jw, block_i=block_i, interpret=True),
           tmt.multi_ttv(tt, tw, block_i=block_i, interpret=True))
    _close(jmt.multi_ttv_batched(jtb, jwb, block_i=block_i, block_batch=2, interpret=True),
           tmt.multi_ttv_batched(ttb, twb, block_i=block_i, block_batch=2, interpret=True))
    x, *fs = _arrays([(5, 6, 7, 4)] + [(d, 3) for d in (5, 6, 7, 4)], seed=block_i + 1)
    (jx, *jfs), (tx, *tfs) = _pair([x] + fs)
    for n in range(4):
        _close(jops.mttkrp_2step_kernel(jx, jfs, n, block_i=block_i, interpret=True),
               tops.mttkrp_2step_kernel(tx, tfs, n, block_i=block_i, interpret=True))


def test_multi_ttv_block_i_maps_to_the_nearest_legal_tile():
    # every legal block_i keeps its tile, hence its launch
    for b in range(32, 1025, 32):
        assert tmt.tile_rows(5000, b) == b
        assert tmt.launch_shape(200, 200, 10, b) == tmt.launch_shape(200, 200, 10, b + 1)
    assert [tmt.tile_rows(5000, b) for b in (1, 8, 47, 48, 100, 2048)] == [32, 32, 32, 64, 96, 1024]
    assert tmt.tile_rows(20, 100) == 20  # then clamped to the rows there are
    with pytest.raises(ValueError):
        tmt.tile_rows(20, 0)


# ---- A2: the kernels' predicate and tune() where the kernels do not take a problem


def test_kernels_take_float32_at_rank_1_to_64_on_the_card():
    """On the card the kernels take float32, bfloat16, float16 and float64
    at any rank >= 1 (ranks 1..64 in one column block, above that in
    several; the name is the one this test had when float32 at rank 1..64
    was the limit), and no other dtype."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ttiling.kernels_take(cuda, torch.float32, 10)
    assert ttiling.kernels_take(cuda, torch.float32, 1) and ttiling.kernels_take(cuda, torch.float32, 64)
    for rank in (65, 80, 1000):
        assert ttiling.kernels_take(cuda, torch.float32, rank)
    assert not ttiling.kernels_take(cuda, torch.float32, 0)
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        assert ttiling.kernels_take(cuda, dtype, 10) and ttiling.kernels_take(cuda, dtype, 80)
        assert not ttiling.kernels_take(cuda, dtype, 0)
    for dtype in (torch.int32, torch.complex64, torch.float8_e4m3fn):
        assert not ttiling.kernels_take(cuda, dtype, 10)
    # the plain versions take any rank and dtype
    for dtype, rank in ((torch.float32, 80), (torch.float64, 10), (torch.float64, 200)):
        assert ttiling.kernels_take(cpu, dtype, rank)
    assert ttiling.kernels_take("cpu", torch.float32, 80)
    assert not ttiling.kernels_take(torch.device("meta"), torch.float32, 10)


ENTRY_KEYS = {
    "backend", "n_devices", "budget_ms", "reps", "elapsed_ms", "tiles", "nodes",
    "serial_fractions", "pp",
}
SUMMARY_KEYS = {"mode", "default_s", "tuned_s", "speedup_vs_default", "rows"}
KNOBS = {"fused_mttkrp": ("blocks_per_sm", 4), "matrix_free": ("blocks_per_sm", 4),
         "multi_ttv": ("block_i", 256)}


def _tensor(shape, rank, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    fs = [torch.from_numpy(rng.standard_normal((d, rank)).astype(np.float32)) for d in shape]
    return x, fs


def test_tune_at_rank_80_on_the_cpu_keeps_the_reference_layout():
    """On the CPU the plain versions take rank 80: every table and both
    kernel leaves are timed, in the reference's layout."""
    x, fs = _tensor((8, 6, 4), 80)
    entry = tplan.tune(x, 80, factors=fs, cache=tplan.TuningCache(), budget_ms=None, reps=1)
    assert set(entry) == ENTRY_KEYS
    for name, (knob, default) in KNOBS.items():
        summary = entry["tiles"][name]
        assert set(summary) == SUMMARY_KEYS | {knob} and summary[knob] == default
        assert len(summary["rows"]) == 1
    algs = {r["algorithm"] for r in entry["nodes"]}
    assert {"fused", "matrix_free"} <= algs


def test_tune_leaves_out_the_kernels_they_do_not_take(monkeypatch):
    """What tune() does where the kernels do not take a problem (on the
    card, a dtype outside ``KERNEL_DTYPES``), shown here by the predicate's
    answer: no kernel timed, the default knobs kept in the
    reference's layout, no kernel leaf measured, so the tuned plan runs the
    GEMM algorithms, and cp_als under it matches the untuned plan."""
    monkeypatch.setattr(tautotune, "kernels_take", lambda device, dtype, rank: False)
    x, fs = _tensor((8, 6, 5, 4), 5, seed=1)
    cache = tplan.TuningCache()
    before = [k.launches for k in KERNELS]
    entry = tplan.tune(x, 5, factors=fs, cache=cache, budget_ms=None, reps=1)
    assert [k.launches for k in KERNELS] == before
    assert set(entry) == ENTRY_KEYS
    for name, (knob, default) in KNOBS.items():
        summary = entry["tiles"][name]
        assert set(summary) == SUMMARY_KEYS | {knob}
        assert summary[knob] == default and summary["rows"] == []
        assert summary["mode"] == 2
    algs = {r["algorithm"] for r in entry["nodes"]}
    assert algs and not algs & {"fused", "matrix_free"}
    problem = tplan.Problem.from_tensor(x, 5)
    plan = tplan.plan_sweep(problem, "autotune", tuning_cache=cache)
    assert not {np_.algorithm for np_ in plan.nodes} & {"fused", "matrix_free"}
    tuned = tplan.cp_als(x, plan, n_iters=3, tol=0.0, init_factors=fs)
    auto = tplan.cp_als(x, tplan.plan_sweep(problem, "auto", tuning_cache=tplan.TuningCache()),
                        n_iters=3, tol=0.0, init_factors=fs)
    assert abs(float(tuned.fit) - float(auto.fit)) < 1e-4


def test_leaf_algorithms_drop_the_kernels_on_request():
    problem = tplan.Problem((8, 6, 5, 4), 5)
    for sched in enumerate_schedules(problem):
        for node in sched.walk():
            if node.from_root and node.is_leaf:
                full = tautotune._leaf_algorithms(problem, node)
                cut = tautotune._leaf_algorithms(problem, node, kernels=False)
                assert cut == tuple(a for a in full if a not in ("fused", "matrix_free"))
                assert {"fused", "matrix_free"} <= set(full)
