"""The port's CUDA kernels and CP-ALS on the card.

Marked ``gpu``: each test skips, with its reason, where no CUDA card is
attached (the decision is taken in the fixture, never at import).  On the
card each kernel is held against its plain PyTorch version (norm-wise
relative error under 1e-4: fp32 sums in two orders) and must launch; the
main path runs through both kernels.  Run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import ctypes

import pytest
import torch

from repro_torch.kernels import fused_mttkrp as fm
from repro_torch.kernels import krp_kernel as kk
from repro_torch.kernels import matrix_free as mf
from repro_torch.kernels import multi_ttv as mt
from repro_torch.kernels import ops, ref
from repro_torch.plan import Problem, TuningCache, cp_als, plan_sweep, tune
from repro_torch.plan.autotune import (
    FUSED_TILE_CANDIDATES,
    MATRIX_FREE_TILE_CANDIDATES,
    TTV_TILE_CANDIDATES,
)

pytestmark = pytest.mark.gpu
REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(k, p):
    return float((k.double() - p.double()).norm() / p.double().norm())


@pytest.mark.parametrize("rank", [1, 3, 10, 25, 64])
@pytest.mark.parametrize("shape", [(5, 6, 7), (33, 70, 129), (65, 3, 40, 7), (3, 4, 2, 3, 2)])
def test_fused_kernel_matches_plain(cuda, shape, rank):
    g = torch.Generator(device=cuda).manual_seed(rank)
    x = torch.randn(shape, generator=g, device=cuda)
    fs = [torch.randn((d, rank), generator=g, device=cuda) for d in shape]
    for n in range(len(shape)):
        t, a, b, pos = ops.bilinear_operands(x, fs, n)
        before = fm.KERNEL.launches
        out = fm.fused_mttkrp_bilinear(t, a, b, pos=pos)
        assert fm.KERNEL.launches == before + 1
        assert _rel(out, fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos)) < REL
        assert torch.equal(out, fm.fused_mttkrp_bilinear(t, a, b, pos=pos))  # no atomics


@pytest.mark.parametrize("rank", [1, 3, 10, 25, 64])
@pytest.mark.parametrize(
    "shape", [(5, 6, 7), (7, 9, 130), (65, 3, 40, 7), (3, 4, 2, 3, 2), (2, 3, 2, 3, 2, 3)]
)
def test_matrix_free_kernel_matches_plain(cuda, shape, rank):
    g = torch.Generator(device=cuda).manual_seed(rank)
    x = torch.randn(shape, generator=g, device=cuda)
    fs = [torch.randn((d, rank), generator=g, device=cuda) for d in shape]
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        before = mf.KERNEL.launches
        out = mf.matrix_free_kernel(x, us, n)
        assert mf.KERNEL.launches == before + 1
        assert _rel(out, mf.matrix_free_kernel_plain(x, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_kernel(x, us, n))


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 5, 6, device=cuda)
    fs = [torch.randn(d, 3, device=cuda) for d in x.shape]
    t, a, b, pos = ops.bilinear_operands(x, fs, 1)
    with pytest.raises(TypeError):  # a mix of dtypes
        fm.fused_mttkrp_bilinear(t.double(), a, b, pos=pos)
    with pytest.raises(ValueError):
        fm.fused_mttkrp_bilinear(t, a.cpu(), b, pos=pos)
    with pytest.raises(ValueError):
        mf.matrix_free_kernel(x.transpose(0, 1), [fs[0], fs[2]], 1)  # shape mismatch
    # rank 65 is taken (two column blocks): one launch, the plain version's sums
    big = [torch.randn(d, 65, device=cuda) for d in x.shape]
    before = mf.KERNEL.launches
    out = mf.matrix_free_kernel(x, [big[0], big[1]], 2)
    assert mf.KERNEL.launches == before + 1
    assert _rel(out, mf.matrix_free_kernel_plain(x, [big[0], big[1]], 2)) < REL


@pytest.mark.parametrize("strategy", ["fused", "matrix_free"])
def test_cp_als_on_the_card_runs_the_kernels_and_matches_cpu(cuda, strategy):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((12, 9, 10, 8), generator=g)
    init = [torch.randn((d, 4), generator=g) for d in x.shape]
    plan = plan_sweep(Problem.from_tensor(x, 4), strategy=strategy)
    kernel = fm.KERNEL if strategy == "fused" else mf.KERNEL
    fits = {}
    for dev in ("cpu", cuda):
        got = []
        before = kernel.launches
        st = cp_als(x.to(dev), plan, n_iters=4, tol=0.0, init_factors=[u.to(dev) for u in init],
                    callback=lambda it, f, dt: got.append(f))
        fits[str(dev)] = got
        assert kernel.launches - before == (16 if dev == cuda else 0)
        assert all(u.device.type == torch.device(dev).type for u in st.factors)
    assert max(abs(a - b) for a, b in zip(fits["cpu"], fits[str(cuda)])) < 1e-4


# ---- batched kernels (one slab per block along the grid's z axis)


def _batched_inputs(cuda, slabs, shape, rank, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((slabs,) + shape, generator=g, device=cuda)
    fs = [torch.randn((slabs, d, rank), generator=g, device=cuda) for d in shape]
    return x, fs


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
@pytest.mark.parametrize("slabs", [1, 3, 5])
@pytest.mark.parametrize("shape", [(5, 6, 7), (33, 70, 129), (65, 3, 40, 7), (3, 4, 2, 3, 2)])
def test_fused_batched_kernel_matches_plain(cuda, shape, slabs, rank):
    x, fs = _batched_inputs(cuda, slabs, shape, rank, seed=slabs * 100 + rank)
    for n in range(len(shape)):
        t, a, b, pos = ops.bilinear_operands_batched(x, fs, n)
        before = (fm.KERNEL.launches, fm.BATCHED_KERNEL.launches)
        out = fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos)
        assert (fm.KERNEL.launches, fm.BATCHED_KERNEL.launches) == (before[0], before[1] + 1)
        assert tuple(out.shape) == (slabs, shape[n], rank)
        assert _rel(out, fm.fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos)) < REL
        assert torch.equal(out, fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos))


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
@pytest.mark.parametrize("slabs", [1, 3, 5])
@pytest.mark.parametrize(
    "shape", [(5, 6, 7), (7, 9, 130), (65, 3, 40, 7), (3, 4, 2, 3, 2), (2, 3, 2, 3, 2, 3)]
)
def test_matrix_free_batched_kernel_matches_plain(cuda, shape, slabs, rank):
    x, fs = _batched_inputs(cuda, slabs, shape, rank, seed=slabs * 100 + rank + 1)
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        before = (mf.KERNEL.launches, mf.BATCHED_KERNEL.launches)
        out = mf.matrix_free_batched_kernel(x, us, n)
        assert (mf.KERNEL.launches, mf.BATCHED_KERNEL.launches) == (before[0], before[1] + 1)
        assert tuple(out.shape) == (slabs, shape[n], rank)
        assert _rel(out, mf.matrix_free_batched_kernel_plain(x, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_batched_kernel(x, us, n))


@pytest.mark.parametrize("kernel", ["fused", "matrix_free"])
def test_batched_slab_is_bitwise_independent_of_other_slabs(cuda, kernel):
    """Slab 0's output keeps its bits when slabs 1..S-1 hold other data."""
    x, fs = _batched_inputs(cuda, 5, (37, 41, 29), 10, seed=7)
    y, gs = _batched_inputs(cuda, 5, (37, 41, 29), 10, seed=8)
    y[0], gs = x[0], [torch.cat([f[:1], g[1:]]) for f, g in zip(fs, gs)]
    run = ops.fused_mttkrp_batched if kernel == "fused" else ops.matrix_free_mttkrp_batched
    for n in range(3):
        assert torch.equal(run(x, fs, n)[0], run(y, gs, n)[0])


def test_batched_kernels_refuse_what_they_do_not_take(cuda):
    x, fs = _batched_inputs(cuda, 2, (4, 5, 6), 3, seed=0)
    t, a, b, pos = ops.bilinear_operands_batched(x, fs, 1)
    with pytest.raises(ValueError):
        fm.fused_mttkrp_bilinear_batched(t, a[:1], b, pos=pos)  # slab mismatch
    with pytest.raises(ValueError):
        fm.fused_mttkrp_bilinear_batched(t, a.cpu(), b, pos=pos)
    with pytest.raises(TypeError):  # a mix of dtypes
        mf.matrix_free_batched_kernel(x.double(), [f.half() for f in fs[1:]], 0)
    with pytest.raises(ValueError):
        mf.matrix_free_batched_kernel(x, [fs[1], fs[2][:1]], 0)


@pytest.mark.parametrize("strategy", ["fused", "matrix_free"])
def test_cp_service_on_the_card_matches_cpu(cuda, strategy):
    """A small CPService run on the card launches the batched kernel (one per
    mode, sweep and batch) and matches the same run on the CPU."""
    from repro_torch.serve import CPService

    g = torch.Generator().manual_seed(1)
    reqs = [(torch.randn((9, 8, 7), generator=g), [torch.randn((d, 4), generator=g) for d in (9, 8, 7)])
            for _ in range(5)]
    kernel = fm.BATCHED_KERNEL if strategy == "fused" else mf.BATCHED_KERNEL
    fits = {}
    for dev in ("cpu", cuda):
        svc = CPService(batch_size=4, n_iters=4, strategy=strategy, device=dev)
        before = kernel.launches
        futs = [svc.submit(x, 4, init_factors=init) for x, init in reqs]
        svc.flush()
        fits[str(dev)] = [f.result().fit for f in futs]
        assert kernel.launches - before == (3 * 4 * 2 if dev == cuda else 0)
        assert svc.stats()["padded_slots"] == 3
    assert max(abs(a - b) for a, b in zip(fits["cpu"], fits[str(cuda)])) < 1e-4


# ---- the split knob of the fused and matrix-free kernels (blocks_per_sm)

# Another split count only reorders fp32 sums of up to a few thousand terms.
KNOB_REL = 1e-5


@pytest.mark.parametrize("shape", [(33, 70, 129), (65, 3, 40, 7), (3, 4, 2, 3, 2)])
def test_blocks_per_sm_candidates_agree_with_the_default(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda)
    fs = [torch.randn((d, 10), generator=g, device=cuda) for d in shape]
    for n in range(len(shape)):
        for run, cands in ((ops.fused_mttkrp, FUSED_TILE_CANDIDATES),
                           (ops.matrix_free_mttkrp, MATRIX_FREE_TILE_CANDIDATES)):
            default = run(x, fs, n)
            assert torch.equal(default, run(x, fs, n, blocks_per_sm=cands[0]))  # 4: today's call
            for b in cands[1:]:
                assert _rel(run(x, fs, n, blocks_per_sm=b), default) < KNOB_REL


def test_blocks_per_sm_reaches_the_batched_kernels(cuda):
    x, fs = _batched_inputs(cuda, 3, (37, 41, 29), 10, seed=11)
    for run in (ops.fused_mttkrp_batched, ops.matrix_free_mttkrp_batched):
        for n in range(3):
            default = run(x, fs, n)
            assert torch.equal(default, run(x, fs, n, blocks_per_sm=4))
            assert _rel(run(x, fs, n, blocks_per_sm=16), default) < KNOB_REL
    with pytest.raises(ValueError):
        ops.fused_mttkrp(x[0], [f[0] for f in fs], 0, blocks_per_sm=0)


# ---- multi-TTV and the KRP pair


@pytest.mark.parametrize("rank", [1, 3, 7, 10, 16, 48, 64])
@pytest.mark.parametrize(
    "shape", [(1, 5), (3, 59), (6, 37), (225, 59), (200, 200), (3000, 40), (7, 1100)]
)
def test_multi_ttv_kernel_matches_plain(cuda, shape, rank):
    g = torch.Generator(device=cuda).manual_seed(rank)
    t = torch.randn(shape + (rank,), generator=g, device=cuda)
    w = torch.randn((shape[0], rank), generator=g, device=cuda)
    plain = mt.multi_ttv_plain(t, w)
    default = mt.multi_ttv(t, w)
    for block_i in TTV_TILE_CANDIDATES + (32, 1024):  # 1024 rows at rank 48 and 64 too
        before = mt.KERNEL.launches
        out = mt.multi_ttv(t, w, block_i=block_i)
        assert mt.KERNEL.launches == before + 1
        assert _rel(out, plain) < REL
        assert _rel(out, default) < KNOB_REL
        assert torch.equal(out, mt.multi_ttv(t, w, block_i=block_i))  # no atomics


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
@pytest.mark.parametrize("slabs", [1, 3, 5, 8])
def test_multi_ttv_batched_kernel_matches_plain(cuda, slabs, rank):
    g = torch.Generator(device=cuda).manual_seed(slabs * 10 + rank)
    t = torch.randn((slabs, 45, 70, rank), generator=g, device=cuda)
    w = torch.randn((slabs, 45, rank), generator=g, device=cuda)
    before = (mt.KERNEL.launches, mt.BATCHED_KERNEL.launches)
    out = mt.multi_ttv_batched(t, w)
    assert (mt.KERNEL.launches, mt.BATCHED_KERNEL.launches) == (before[0], before[1] + 1)
    assert tuple(out.shape) == (slabs, 70, rank)
    assert _rel(out, mt.multi_ttv_batched_plain(t, w)) < REL
    assert torch.equal(out, mt.multi_ttv_batched(t, w))
    for block_i in TTV_TILE_CANDIDATES:
        assert _rel(mt.multi_ttv_batched(t, w, block_i=block_i), out) < KNOB_REL


@pytest.mark.parametrize("shape", [(3, 59, 7), (1, 59, 7), (225, 59, 10), (40, 33, 64)])
def test_multi_ttv_batched_kernel_ragged_and_short_l(cuda, shape):
    # I * C % 4 != 0 (the scalar path and its masked tail), L shorter than a cluster
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    t = torch.randn((5,) + shape, generator=g, device=cuda)
    w = torch.randn((5, shape[0], shape[2]), generator=g, device=cuda)
    plain = mt.multi_ttv_batched_plain(t, w)
    for block_i in TTV_TILE_CANDIDATES + (32, 1024):
        out = mt.multi_ttv_batched(t, w, block_i=block_i)
        assert _rel(out, plain) < REL
        assert torch.equal(out, mt.multi_ttv_batched(t, w, block_i=block_i))
        assert torch.equal(out[1], mt.multi_ttv(t[1], w[1], block_i=block_i))  # same sum order


def test_multi_ttv_kernel_takes_any_geometry(cuda):
    # The kernel masks what the wrapper's geometry never makes: a cluster of 8
    # over L = 3 (five empty ranks), more warp groups than l, a tile of rows
    # that is not a multiple of 4 outputs on the scalar path, a misaligned T.
    g = torch.Generator(device=cuda).manual_seed(0)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for big_l, dim_i, c, rows, tx, groups, cl in ((3, 59, 7, 59, 128, 4, 8),
                                                  (3, 200, 10, 33, 96, 8, 8),
                                                  (17, 64, 3, 64, 64, 16, 4)):
        t = torch.randn((big_l, dim_i, c), generator=g, device=cuda)
        w = torch.randn((big_l, c), generator=g, device=cuda)
        out = torch.full((dim_i, c), float("nan"), device=cuda)
        mt.KERNEL.launch(t.data_ptr(), w.data_ptr(), out.data_ptr(), big_l, dim_i, c, rows, tx,
                         groups, cl, 0, stream)
        assert _rel(out, mt.multi_ttv_plain(t, w)) < REL
    base = torch.randn(1 + 8 * 50 * 12, generator=g, device=cuda)
    t = base[1:].view(8, 50, 12)  # contiguous, 4 bytes past a 16-byte line
    w = torch.randn((8, 12), generator=g, device=cuda)
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    assert _rel(mt.multi_ttv(t, w), mt.multi_ttv_plain(t, w)) < REL
    with pytest.raises(RuntimeError):  # vec on a misaligned T is refused, not run
        mt.KERNEL.launch(t.data_ptr(), w.data_ptr(), torch.empty(50, 12, device=cuda).data_ptr(),
                         8, 50, 12, 50, 160, 1, 1, 1, stream)


def test_multi_ttv_batched_slab_is_bitwise_independent_of_other_slabs(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    t = torch.randn((5, 60, 90, 10), generator=g, device=cuda)
    w = torch.randn((5, 60, 10), generator=g, device=cuda)
    u, v = torch.randn_like(t), torch.randn_like(w)
    u[0], v[0] = t[0], w[0]
    assert torch.equal(mt.multi_ttv_batched(t, w)[0], mt.multi_ttv_batched(u, v)[0])


KRP_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


def _krp_launch_once(a, b, block_b, vector):
    """One ``krp_pair`` call: one launch, on the 16-byte path iff ``vector``,
    bitwise the plain version (one multiply an entry, rounded once to the
    dtype) and bitwise repeatable."""
    before = (kk.KERNEL.launches, kk.KERNEL.vector_launches)
    out = kk.krp_pair(a, b, block_b=block_b)
    assert (kk.KERNEL.launches, kk.KERNEL.vector_launches) == (before[0] + 1,
                                                              before[1] + int(vector))
    assert out.dtype == a.dtype
    assert torch.equal(out, kk.krp_pair_plain(a, b))
    assert torch.equal(out, kk.krp_pair(a, b, block_b=block_b))


@pytest.mark.parametrize("dtype", KRP_DTYPES)
@pytest.mark.parametrize("block_b", [1, 7, 64, 512])
@pytest.mark.parametrize("dims,rank", [((3, 5), 1), ((59, 200), 10), ((130, 17), 16), ((4, 1000), 64),
                                       ((7, 13), 3), ((59, 200), 128)])
def test_krp_pair_kernel_matches_plain(cuda, dims, rank, block_b, dtype):
    g = torch.Generator(device=cuda).manual_seed(rank + block_b)
    a = torch.randn((dims[0], rank), generator=g, device=cuda, dtype=dtype)
    b = torch.randn((dims[1], rank), generator=g, device=cuda, dtype=dtype)
    whole = dims[1] * rank * a.element_size() % 16 == 0  # (fresh allocations: aligned)
    _krp_launch_once(a, b, block_b, vector=whole)


@pytest.mark.parametrize("dtype", KRP_DTYPES)
def test_krp_pair_kernel_on_row_blocks_of_a_stack(cuda, dtype):
    """A factor that is the second row block of a contiguous (2, 13, 3)
    stack starts off a 16-byte line: as B it takes the one-element path,
    as A (read an element at a time on either path) it does not."""
    g = torch.Generator(device=cuda).manual_seed(34)
    stack = torch.randn((2, 13, 3), generator=g, device=cuda, dtype=dtype)
    assert stack[1].data_ptr() % 16 != 0
    _krp_launch_once(torch.randn((5, 3), generator=g, device=cuda, dtype=dtype), stack[1], 512,
                     vector=False)
    _krp_launch_once(stack[1], torch.randn((200, 3), generator=g, device=cuda, dtype=dtype), 512,
                     vector=True)
    flat = torch.randn(1 + 200 * 10, generator=g, device=cuda, dtype=dtype)
    _krp_launch_once(torch.randn((3, 10), generator=g, device=cuda, dtype=dtype),
                     flat[1:].view(200, 10), 512, vector=False)  # whole units, off a line


def test_krp_materialize_and_2step_kernel_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    shape = (13, 6, 9, 11)
    x = torch.randn(shape, generator=g, device=cuda)
    fs = [torch.randn((d, 10), generator=g, device=cuda) for d in shape]
    before = kk.KERNEL.launches
    assert torch.equal(ops.krp_materialize(fs[1:]), ref.krp_ref(fs[1:]))
    assert kk.KERNEL.launches == before + 2
    before = (mt.KERNEL.launches, fm.KERNEL.launches)
    for n in range(4):
        assert _rel(ops.mttkrp_2step_kernel(x, fs, n), ref.fused_mttkrp_ref(x, fs, n)) < REL
    assert (mt.KERNEL.launches, fm.KERNEL.launches) == (before[0] + 2, before[1] + 2)


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    t, w = torch.randn(4, 5, 3, device=cuda), torch.randn(4, 3, device=cuda)
    with pytest.raises(TypeError):  # a mix of dtypes
        mt.multi_ttv(t.double(), w)
    with pytest.raises(ValueError):
        mt.multi_ttv(t, w.cpu())
    with pytest.raises(ValueError):
        mt.multi_ttv(t.transpose(0, 1).contiguous().transpose(0, 1), w)  # not contiguous
    t65, w65 = torch.randn(4, 5, 65, device=cuda), torch.randn(4, 65, device=cuda)
    before = mt.KERNEL.launches  # rank 65 is taken: one launch
    assert _rel(mt.multi_ttv(t65, w65), mt.multi_ttv_plain(t65, w65)) < REL
    assert mt.KERNEL.launches == before + 1
    t64, w64 = torch.randn(4, 1100, 64, device=cuda), torch.randn(4, 64, device=cuda)
    # rank 64 at 1024 rows a CTA: one launch that matches the plain version
    before = mt.KERNEL.launches
    assert _rel(mt.multi_ttv(t64, w64, block_i=1024), mt.multi_ttv_plain(t64, w64)) < REL
    assert mt.KERNEL.launches == before + 1
    # 70000 rows of b at block_b=1: one launch (the grid has no 65535-tile limit)
    _krp_launch_once(w, torch.randn(70000, 3, device=cuda), 1, vector=True)
    with pytest.raises(TypeError):
        kk.krp_pair(w.int(), w.int(), block_b=4)


# ---- tune() on the card


def test_tune_on_the_card_times_distinct_launches(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((30, 17, 40, 25), generator=g, device=cuda)
    cache = TuningCache()
    entry = tune(x, 10, cache=cache, budget_ms=None, reps=2)
    assert entry["backend"] == f"cuda:{torch.cuda.get_device_name(0)}"
    for summary in entry["tiles"].values():
        effective = [tuple(r["effective"]) for r in summary["rows"]]
        assert effective and len(effective) == len(set(effective)) and all(effective)
        assert summary["rows"][0]["is_default"]
    plan = plan_sweep(Problem.from_tensor(x, 10), "autotune", tuning_cache=cache)
    assert all(np_.cost.measured_s is not None for np_ in plan.nodes)
    init = [torch.randn((d, 10), generator=g, device=cuda) for d in x.shape]
    tuned = cp_als(x, plan, n_iters=3, tol=0.0, init_factors=init)
    flat = cp_als(x, plan_sweep(Problem.from_tensor(x, 10), "auto", schedule="flat"),
                  n_iters=3, tol=0.0, init_factors=init)
    assert abs(float(tuned.fit) - float(flat.fit)) < 1e-4


# ---- the batched matrix-free kernel: one launch, the split summed in a cluster

MFB_SHAPES = [(5, 6, 7), (33, 70, 129), (37, 23, 41, 30), (65, 3, 40, 8), (3, 4, 2, 3, 2),
              (2, 3, 2, 3, 2, 3)]


@pytest.mark.parametrize("rank", [1, 7, 10, 48, 64])
@pytest.mark.parametrize("slabs", [1, 5, 8])
@pytest.mark.parametrize("shape", MFB_SHAPES)
def test_matrix_free_batched_cluster_kernel_matches_plain(cuda, shape, slabs, rank):
    """Ragged shapes of orders 3-6, every mode: one launch a call, within
    1e-4 of the plain version, bitwise repeatable."""
    x, fs = _batched_inputs(cuda, slabs, shape, rank, seed=slabs * 1000 + rank)
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        before = mf.BATCHED_KERNEL.launches
        out = mf.matrix_free_batched_kernel(x, us, n)
        assert mf.BATCHED_KERNEL.launches == before + 1
        assert tuple(out.shape) == (slabs, shape[n], rank)
        assert _rel(out, mf.matrix_free_batched_kernel_plain(x, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_batched_kernel(x, us, n))


@pytest.mark.parametrize("shape", [(225, 200, 200), (37, 23, 41, 28), (33, 70, 128)])
def test_matrix_free_batched_kernel_on_a_misaligned_view(cuda, shape):
    """A contiguous view 4 bytes off a 16-byte line takes 4-byte copies: the
    same sums as the aligned call's 16-byte copies, bit for bit."""
    slabs = 3
    x, fs = _batched_inputs(cuda, slabs, shape, 10, seed=21)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 4
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        out = mf.matrix_free_batched_kernel(xm, us, n)
        assert _rel(out, mf.matrix_free_batched_kernel_plain(xm, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_batched_kernel(x, us, n))


def test_matrix_free_batched_kernel_refuses_16_byte_copies_of_a_misaligned_x(cuda):
    import ctypes

    x, fs = _batched_inputs(cuda, 2, (8, 6, 12), 4, seed=3)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xm = buf[1:].view(x.shape)
    out = torch.empty((2, 8, 4), device=cuda)
    ptrs = (ctypes.c_void_p * 3)(0, fs[1].data_ptr(), fs[2].data_ptr())
    shape = (ctypes.c_int64 * 3)(8, 6, 12)
    args = [ptrs, shape, 3, 0, 4, 2, 2, 12]
    before = mf.BATCHED_KERNEL.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        mf.BATCHED_KERNEL.launch(xm.data_ptr(), *args, 1, out.data_ptr(), 0)
    mf.BATCHED_KERNEL.launch(xm.data_ptr(), *args, 0, out.data_ptr(), 0)  # 4-byte copies run
    assert mf.BATCHED_KERNEL.launches == before + 1


def test_matrix_free_batched_kernel_is_one_cuda_kernel_and_no_workspace(cuda):
    """Counted in a CUDA graph of one call, which drops no kernel."""
    x, fs = _batched_inputs(cuda, 8, (45, 40, 44), 10, seed=5)
    for n in range(3):
        us = [fs[k] for k in range(3) if k != n]
        names = _graph_kernel_names(lambda: mf.matrix_free_batched_kernel(x, us, n))
        assert names == [names[0]]
        assert "matrix_free_cluster_kernel" in names[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = mf.matrix_free_batched_kernel(x, us, n)
        grew = torch.cuda.max_memory_allocated() - base
        assert grew <= 512 * -(-out.numel() * 4 // 512)  # the output alone


def test_matrix_free_batched_slab_is_independent_on_a_ragged_order_4_stack(cuda):
    x, fs = _batched_inputs(cuda, 5, (37, 23, 41, 28), 7, seed=9)
    y, gs = _batched_inputs(cuda, 5, (37, 23, 41, 28), 7, seed=10)
    y[0], gs = x[0], [torch.cat([f[:1], g[1:]]) for f, g in zip(fs, gs)]
    for n in range(4):
        assert torch.equal(ops.matrix_free_mttkrp_batched(x, fs, n)[0],
                           ops.matrix_free_mttkrp_batched(y, gs, n)[0])


@pytest.mark.parametrize("rank", [1, 10, 16, 32, 48, 64])
@pytest.mark.parametrize("shape,slabs", [((225, 200, 200), 8), ((37, 23, 41, 30), 5),
                                         ((5, 6, 7), 1)])
def test_matrix_free_batched_residency_matches_the_occupancy_query(cuda, shape, slabs, rank):
    """The residency launch_shape sizes the split by (CTAs an SM) is what the
    CUDA occupancy query gives; its SM count is the card's."""
    assert torch.cuda.get_device_properties(0).multi_processor_count == mf.SMS
    for n in range(len(shape)):
        g = mf.launch_shape(shape, n, rank, slabs)
        per_sm, clusters = mf.occupancy(g, rank)
        assert per_sm >= g.residency and clusters >= 1
        if shape == (225, 200, 200):  # the serving shapes: exactly the constant
            assert per_sm == g.residency


# ---- the unbatched matrix-free kernel: groups x splits parts, clusters summed on chip

# Orders 3-6, every mode: groups of 1 and more, clusters of 1, 2, 4 and 8,
# a single group of 8 (one launch), a target mode of 282 row blocks (two
# waves of clusters of one), 4- and 16-byte copies.
MF_SHAPES = [(5, 6, 7), (33, 70, 129), (33, 8, 12), (3, 5, 9000), (37, 23, 41, 30),
             (40, 50, 60, 8), (65, 3, 40, 8), (12, 10, 8, 9, 11), (3, 4, 2, 3, 2),
             (6, 7, 5, 8, 6, 7), (2, 3, 2, 3, 2, 3)]


def _unbatched_inputs(cuda, shape, rank, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda)
    return x, [torch.randn((d, rank), generator=g, device=cuda) for d in shape]


@pytest.mark.parametrize("rank", [1, 7, 10, 16, 48, 64])
@pytest.mark.parametrize("shape", MF_SHAPES)
def test_matrix_free_cluster_kernel_unbatched_matches_plain(cuda, shape, rank):
    """Every mode: one counted launch a call, within 1e-4 of the plain
    version, bitwise repeatable."""
    x, fs = _unbatched_inputs(cuda, shape, rank, seed=rank)
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        before = (mf.KERNEL.launches, mf.BATCHED_KERNEL.launches)
        out = mf.matrix_free_kernel(x, us, n)
        assert (mf.KERNEL.launches, mf.BATCHED_KERNEL.launches) == (before[0] + 1, before[1])
        assert tuple(out.shape) == (shape[n], rank)
        assert _rel(out, mf.matrix_free_kernel_plain(x, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_kernel(x, us, n))


@pytest.mark.parametrize("shape", [(225, 8, 200, 200), (37, 23, 41, 28), (33, 70, 128)])
def test_matrix_free_kernel_on_a_misaligned_view(cuda, shape):
    """A contiguous view 4 bytes off a 16-byte line takes 4-byte copies: the
    same sums as the aligned call's 16-byte copies, bit for bit."""
    x, fs = _unbatched_inputs(cuda, shape, 10, seed=23)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 4
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        out = mf.matrix_free_kernel(xm, us, n)
        assert _rel(out, mf.matrix_free_kernel_plain(xm, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_kernel(x, us, n))


def test_matrix_free_kernel_refuses_16_byte_copies_of_a_misaligned_x(cuda):
    import ctypes

    x, fs = _unbatched_inputs(cuda, (8, 6, 12), 4, seed=3)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xm = buf[1:].view(x.shape)
    out = torch.empty((8, 4), device=cuda)
    ws = torch.empty((3, 8, 4), device=cuda)
    ptrs = (ctypes.c_void_p * 3)(0, fs[1].data_ptr(), fs[2].data_ptr())
    shape = (ctypes.c_int64 * 3)(8, 6, 12)
    args = [ptrs, shape, 3, 0, 4, 3, 2, 12]  # 3 groups of 2 over the 6 outer indices
    before = mf.KERNEL.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        mf.KERNEL.launch(xm.data_ptr(), *args, 1, ws.data_ptr(), out.data_ptr(), 0)
    with pytest.raises(RuntimeError, match="invalid argument"):  # more groups, no workspace
        mf.KERNEL.launch(x.data_ptr(), *args, 1, None, out.data_ptr(), 0)
    mf.KERNEL.launch(xm.data_ptr(), *args, 0, ws.data_ptr(), out.data_ptr(), 0)  # 4-byte copies
    assert mf.KERNEL.launches == before + 1
    us = [fs[1], fs[2]]
    assert _rel(out, mf.matrix_free_kernel_plain(xm, us, 0)) < REL


def test_matrix_free_kernel_launches_the_cuda_kernels_its_design_states(cuda):
    """One kernel a call with one group (the clusters write the output),
    two with more (the groups' partials, then their sum in group order);
    no workspace with one group.  Counted in a CUDA graph of one call."""
    for shape in [(33, 8, 12), (45, 40, 44), (3, 5, 9000)]:
        x, fs = _unbatched_inputs(cuda, shape, 10, seed=5)
        for n in range(3):
            us = [fs[k] for k in range(3) if k != n]
            g = mf.unbatched_launch_shape(shape, n, 10)
            names = _graph_kernel_names(lambda: mf.matrix_free_kernel(x, us, n))
            # the graph's nodes come in no set order: the cluster kernel, then
            # (with groups) the sum of the groups' partials, which depends on it
            names = sorted(names, key=lambda name: "sum_splits_kernel" in name)
            assert "matrix_free_cluster_kernel" in names[0]
            if g.groups == 1:
                assert len(names) == 1
            else:
                assert len(names) == 2 and "sum_splits_kernel" in names[1]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = mf.matrix_free_kernel(x, us, n)
            grew = torch.cuda.max_memory_allocated() - base
            ws = 0 if g.groups == 1 else 512 * -(-g.groups * shape[n] * 10 * 4 // 512)
            assert grew <= 512 * -(-out.numel() * 4 // 512) + ws


@pytest.mark.parametrize("rank", [1, 10, 16, 32, 48, 64])
@pytest.mark.parametrize("shape", [(225, 59, 200, 200), (225, 59, 20100), (37, 23, 41, 30),
                                   (5, 6, 7)])
def test_matrix_free_unbatched_residency_and_cluster_slots_match_the_occupancy_query(
        cuda, shape, rank):
    """The residency and the clusters a wave that unbatched_launch_shape
    counts are what the CUDA occupancy queries give on this card."""
    assert torch.cuda.get_device_properties(0).multi_processor_count == mf.SMS
    for n in range(len(shape)):
        g = mf.unbatched_launch_shape(shape, n, rank)
        per_sm, clusters = mf.occupancy(g, rank)
        assert per_sm == g.residency
        assert clusters == mf.CLUSTER_SLOTS[g.residency][g.splits]
        assert g.row_blocks * g.groups <= clusters or g.groups == 1  # one wave, or groups of 1


@pytest.mark.parametrize("rank,dtype", [(80, torch.float32), (10, torch.float64),
                                        (10, torch.bfloat16)])
def test_tune_on_the_card_falls_back_to_the_gemms_where_the_kernels_do_not_go(cuda, rank, dtype):
    """The kernels take float32 at rank 80 (two column blocks) and float64
    and bf16 at rank 10 (the name is the one this test had when float64
    fell back to the GEMMs): tune() times the kernels (every tile table has
    rows, both kernel leaves are measured), and forced ``fused`` and
    ``matrix_free`` runs match ``auto``'s fits within 1e-3, each launching
    its kernel once a mode a sweep.  ``cp_als`` does not run in bf16 (its
    pseudo-inverse refuses bf16, as the reference's does), so there only
    tune() is checked."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((20, 17, 12, 9), generator=g, device=cuda).to(dtype)
    cache = TuningCache()
    launches = [k.launches for k in (fm.KERNEL, mf.KERNEL, mt.KERNEL)]
    entry = tune(x, rank, cache=cache, budget_ms=None, reps=1)
    assert all(now > was for now, was in zip(
        [k.launches for k in (fm.KERNEL, mf.KERNEL, mt.KERNEL)], launches))
    assert all(summary["rows"] for summary in entry["tiles"].values())
    assert {"fused", "matrix_free"} <= {r["algorithm"] for r in entry["nodes"]}
    if dtype == torch.bfloat16:
        return
    problem = Problem.from_tensor(x, rank)
    init = [torch.randn((d, rank), generator=g, device=cuda).to(dtype) for d in x.shape]
    fits = {}
    for strategy, kernel in (("auto", None), ("fused", fm.KERNEL),
                             ("matrix_free", mf.KERNEL)):
        before = kernel.launches if kernel else 0
        got = []
        st = cp_als(x, plan_sweep(problem, strategy), n_iters=3, tol=0.0, init_factors=init,
                    callback=lambda it, f, dt: got.append(f))
        assert all(u.dtype == dtype and bool(torch.isfinite(u).all()) for u in st.factors)
        fits[strategy] = got
        if kernel:
            assert kernel.launches - before == 3 * x.ndim
    for strategy in ("fused", "matrix_free"):
        assert max(abs(a - b) for a, b in zip(fits[strategy], fits["auto"])) < 1e-3


# ---- the fused bilinear kernels on the cluster body: the order-3 fold of the view

# Views (d0, d1, d2): B's axis fits one stage, or is cut into chunks
# (4000 at pos 0 and 1 of (6, 5, 4000), and at pos 2 of (6, 4000, 8)).
FUSED_VIEWS = [(5, 6, 7), (33, 70, 128), (37, 41, 30), (6, 5, 4000), (6, 4000, 8),
               (3, 9000, 12)]


def _view_inputs(cuda, view, pos, rank, seed, slabs=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lead = () if slabs is None else (slabs,)
    ab = [d for k, d in enumerate(view) if k != pos]
    t = torch.randn(lead + view, generator=g, device=cuda)
    a = torch.randn(lead + (ab[0], rank), generator=g, device=cuda)
    b = torch.randn(lead + (ab[1], rank), generator=g, device=cuda)
    return t, a, b


@pytest.mark.parametrize("rank", [1, 7, 10, 16, 48, 64])
@pytest.mark.parametrize("view", FUSED_VIEWS)
def test_fused_kernels_on_the_cluster_body_match_plain(cuda, view, rank):
    """Both entries at pos 0, 1 and 2: one counted launch a call, within
    1e-4 of the plain version, bitwise repeatable."""
    for pos in range(3):
        t, a, b = _view_inputs(cuda, view, pos, rank, seed=rank + pos)
        before = (fm.KERNEL.launches, fm.BATCHED_KERNEL.launches)
        out = fm.fused_mttkrp_bilinear(t, a, b, pos=pos)
        assert (fm.KERNEL.launches, fm.BATCHED_KERNEL.launches) == (before[0] + 1, before[1])
        assert _rel(out, fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos)) < REL
        assert torch.equal(out, fm.fused_mttkrp_bilinear(t, a, b, pos=pos))
        t, a, b = _view_inputs(cuda, view, pos, rank, seed=rank + pos + 50, slabs=3)
        before = (fm.KERNEL.launches, fm.BATCHED_KERNEL.launches)
        out = fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos)
        assert (fm.KERNEL.launches, fm.BATCHED_KERNEL.launches) == (before[0], before[1] + 1)
        assert tuple(out.shape) == (3, view[pos], rank)
        assert _rel(out, fm.fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos)) < REL
        assert torch.equal(out, fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos))


@pytest.mark.parametrize("view", [(225, 200, 200), (37, 41, 28), (6, 5, 4000)])
def test_fused_kernels_on_a_misaligned_view(cuda, view):
    """A contiguous view 4 bytes off a 16-byte line takes 4-byte copies: the
    same sums as the aligned call's 16-byte copies, bit for bit."""
    for pos in range(3):
        for slabs in (None, 2):
            t, a, b = _view_inputs(cuda, view, pos, 10, seed=pos, slabs=slabs)
            buf = torch.empty(t.numel() + 1, device=cuda)
            tm = buf[1:].view(t.shape)
            tm.copy_(t)
            assert tm.data_ptr() % 16 == 4
            if slabs is None:
                run, plain = fm.fused_mttkrp_bilinear, fm.fused_mttkrp_bilinear_plain
            else:
                run, plain = fm.fused_mttkrp_bilinear_batched, fm.fused_mttkrp_bilinear_batched_plain
            out = run(tm, a, b, pos=pos)
            assert _rel(out, plain(tm, a, b, pos=pos)) < REL
            assert torch.equal(out, run(t, a, b, pos=pos))


@pytest.mark.parametrize("shape,slabs", [((225, 200, 200), 8), ((37, 41, 30), 5), ((6, 5, 4000), 3)])
def test_fused_batched_equals_matrix_free_batched_on_a_3_way_stack(cuda, shape, slabs):
    """The fused views of a 3-way stack are the stack itself: the same
    launch as the batched matrix-free kernel, the same bits."""
    x, fs = _batched_inputs(cuda, slabs, shape, 10, seed=31)
    for n in range(3):
        assert torch.equal(ops.fused_mttkrp_batched(x, fs, n), ops.matrix_free_mttkrp_batched(x, fs, n))


def _graph_kernels(fn):
    """The kinds of the device operations one call of ``fn`` puts on its
    stream (0: a kernel), read from a CUDA graph captured from the call
    (never replayed) through libcuda: an exact count, where a profiler
    window may drop events.  ``fn`` runs once before the capture."""
    import ctypes

    fn()
    cu = ctypes.CDLL("libcuda.so.1")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    del graph
    torch.cuda.synchronize()
    return kinds


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of libcuda."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _graph_kernel_names(fn):
    """The names of the CUDA kernels one call of ``fn`` launches, read from
    a CUDA graph captured from the call (never replayed): every node must be
    a kernel, and each kernel node's function name comes from libcuda
    (``cuFuncGetName``, or ``cuKernelGetName`` for a library kernel).  An
    exact list, where a profiler window may drop events; in no set order.
    ``fn`` runs once before the capture."""
    fn()
    cu = ctypes.CDLL("libcuda.so.1")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    names = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        assert kind.value == 0, f"a graph node of type {kind.value}, not a kernel"
        params = _KernelNodeParams()
        assert cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)) == 0
        name = ctypes.c_char_p()
        if params.func:
            assert cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)) == 0
        else:
            assert cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)) == 0
        names.append(name.value.decode())
    del graph
    torch.cuda.synchronize()
    return names


def test_fused_kernels_launch_the_cuda_kernels_their_design_states(cuda):
    """Batched: one kernel a call, no workspace.  Unbatched: one with one
    group, two with more (the groups' partials, then their sum).  Counted
    in a CUDA graph of one call."""
    for view in [(33, 8, 12), (45, 40, 44), (6, 5, 4000)]:
        for pos in range(3):
            for slabs in (None, 4):
                t, a, b = _view_inputs(cuda, view, pos, 10, seed=5, slabs=slabs)
                if slabs is None:
                    run = lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos)  # noqa: E731
                    g = fm.launch_geometry(view, pos, 10)
                else:
                    run = lambda: fm.fused_mttkrp_bilinear_batched(t, a, b, pos=pos)  # noqa: E731
                    g = fm.launch_geometry(view, pos, 10, slabs)
                assert _graph_kernels(run) == [0] * (1 if g.groups == 1 else 2)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                out = run()
                grew = torch.cuda.max_memory_allocated() - base
                ws = 0 if g.groups == 1 else 512 * -(-g.groups * view[pos] * 10 * 4 // 512)
                assert grew <= 512 * -(-out.numel() * 4 // 512) + ws


def test_fused_kernels_refuse_what_they_cannot_run(cuda):
    """vec on a misaligned T and more parts than a row block has steps are
    refused by the C entries, not run."""
    t, a, b = _view_inputs(cuda, (8, 6, 12), 0, 4, seed=3)
    buf = torch.empty(t.numel() + 1, device=cuda)
    tm = buf[1:].view(t.shape)
    out = torch.empty((8, 4), device=cuda)
    ws = torch.empty((4, 8, 4), device=cuda)
    before = fm.KERNEL.launches
    with pytest.raises(RuntimeError, match="invalid argument"):  # vec, misaligned
        fm.KERNEL.launch(tm.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), 0, 8, 6, 12, 4, 3, 2, 12, 1, 0)
    with pytest.raises(RuntimeError, match="invalid argument"):  # 8 parts, 6 steps
        fm.KERNEL.launch(t.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), 0, 8, 6, 12, 4, 4, 2, 12, 1, 0)
    with pytest.raises(RuntimeError, match="invalid argument"):  # pos 3
        fm.KERNEL.launch(t.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), 3, 8, 6, 12, 4, 1, 1, 12, 1, 0)
    fm.KERNEL.launch(tm.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                     out.data_ptr(), 0, 8, 6, 12, 4, 3, 2, 12, 0, 0)  # 4-byte copies run
    assert fm.KERNEL.launches == before + 1
    assert _rel(out, fm.fused_mttkrp_bilinear_plain(tm, a, b, pos=0)) < REL


@pytest.mark.parametrize("rank", [1, 10, 64])
@pytest.mark.parametrize("shape", [(6, 5, 4000), (4, 3, 5, 4000), (3, 4000, 8), (225, 59, 2010)])
def test_matrix_free_kernels_cut_the_steps_of_a_chunked_q(cuda, shape, rank):
    """Contracted modes cut into chunks: parts cut the flat (chunk, outer
    index) steps; both entries within 1e-4 of their plain versions and
    bitwise repeatable."""
    x, fs = _unbatched_inputs(cuda, shape, rank, seed=rank + 7)
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        out = mf.matrix_free_kernel(x, us, n)
        assert _rel(out, mf.matrix_free_kernel_plain(x, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_kernel(x, us, n))
    xb, fb = _batched_inputs(cuda, 3, shape, rank, seed=rank + 8)
    for n in range(len(shape)):
        us = [fb[k] for k in range(len(shape)) if k != n]
        out = mf.matrix_free_batched_kernel(xb, us, n)
        assert _rel(out, mf.matrix_free_batched_kernel_plain(xb, us, n)) < REL
        assert torch.equal(out, mf.matrix_free_batched_kernel(xb, us, n))


def test_both_libraries_of_the_shared_body_prepare_their_own_kernels(cuda):
    """fused_mttkrp.cu and matrix_free.cu are two libraries built from one
    header: each must raise its own kernels' shared-memory limit, whichever
    library launches an instance first (launches here need over 48 KB)."""
    runs = {"fused": ops.fused_mttkrp_batched, "matrix_free": ops.matrix_free_mttkrp_batched}
    for rank, first in ((7, "fused"), (20, "matrix_free")):
        x, fs = _batched_inputs(cuda, 2, (33, 70, 1000), rank, seed=rank)
        assert mf.launch_shape((33, 70, 1000), 0, rank, 2).smem > 48 * 1024
        order = [first] + [k for k in runs if k != first]
        outs = [runs[k](x, fs, 0) for k in order]
        assert torch.equal(outs[0], outs[1])
        assert _rel(outs[0], mf.matrix_free_batched_kernel_plain(x, [fs[1], fs[2]], 0)) < REL


# ---- the legacy front door and PP sweeps on the card
@pytest.mark.parametrize("method,kernel", [("fused", fm.KERNEL), ("matrix_free", mf.KERNEL)])
def test_legacy_cp_als_runs_the_kernels_and_is_the_engine_bitwise(cuda, method, kernel):
    from repro_torch.core import CPConfig
    from repro_torch.core import cp_als as legacy_cp_als
    from repro_torch.core.cpals import als_sweep
    from repro_torch.core.dimtree import dimtree_sweep
    from repro_torch.core.tensor_ops import tensor_norm
    from repro_torch.plan import LocalExecutor, SweepState
    from repro_torch.plan import als_sweep as engine_sweep

    g = torch.Generator(device=cuda).manual_seed(7)
    shape, rank, sweeps = (33, 20, 40, 30), 10, 3
    x = torch.randn(shape, generator=g, device=cuda)
    init = [torch.randn((d, rank), generator=g, device=cuda) for d in shape]
    before = kernel.launches
    a = legacy_cp_als(x, CPConfig(rank, n_iters=sweeps, tol=0.0, method=method),
                      init_factors=init)
    assert kernel.launches - before == len(shape) * sweeps
    b = cp_als(x, plan_sweep(Problem.from_tensor(x, rank), method), n_iters=sweeps, tol=0.0,
               init_factors=init)
    assert all(torch.equal(u, v) for u, v in zip(a.factors, b.factors))
    assert torch.equal(a.weights, b.weights) and torch.equal(a.fit, b.fit)
    w, nx = torch.ones(rank, device=cuda), tensor_norm(x)
    for strategy, legacy in ((method, lambda: als_sweep(x, init, w, nx, 0, method, True)),
                             ("dimtree", lambda: dimtree_sweep(x, init, w, nx, 0))):
        plan = plan_sweep(Problem.from_tensor(x, rank), strategy,
                          schedule=None if strategy == "dimtree" else "flat")
        st = engine_sweep(plan.problem, plan, LocalExecutor(),
                          SweepState(x=x, factors=init, weights=w, norm_x=nx, it=0))
        out = legacy()
        assert all(torch.equal(u, v) for u, v in zip(out[0], st.factors))
        assert torch.equal(out[2], st.fit)


@pytest.mark.parametrize("batch", [None, 3])
def test_pp_run_on_the_card_agrees_with_the_cpu(cuda, batch):
    """The same PP run on the card and on the CPU: the same exact-sweep
    count (on the CPU every gate value of these data lies at least 1.4x
    away from ``pp_tol``, so no rounding difference flips one) and fits
    within 1e-4."""
    g = torch.Generator().manual_seed(5)
    shape, rank, sweeps, pp_tol = (12, 10, 8, 6), 3, 12, 0.05
    lead = () if batch is None else (batch,)
    true = [torch.randn(lead + (d, rank), generator=g) for d in shape]
    x = torch.einsum("...ac,...bc,...dc,...ec->...abde", *true)
    x = (x + 0.1 * x.std() * torch.randn(x.shape, generator=g)).contiguous()
    init = [torch.randn(lead + (d, rank), generator=g) for d in shape]
    problem = Problem(shape, rank, batch=batch or 1, pp_tol=pp_tol)
    runs = {}
    for where in ("cpu", cuda):
        fits = []
        st = cp_als(x.to(where), plan_sweep(problem, "pp"), n_iters=sweeps, tol=0.0,
                    init_factors=[u.to(where) for u in init],
                    callback=lambda i, f, s: fits.append(f))
        runs[str(where)] = (st.pp_exact_sweeps, fits)
    (n_cpu, f_cpu), (n_card, f_card) = runs.values()
    assert n_card == n_cpu and 0 < n_card < sweeps
    assert max(abs(a - b) for a, b in zip(f_cpu, f_card)) < 1e-4


def test_sharded_cp_als_in_an_nccl_world_of_one_is_the_local_engine(cuda, tmp_path):
    """The flat sharded path on the card: an NCCL world of one on a (1, 1)
    mesh, mode-parallel and batch-parallel, bitwise equal to the local
    engine (a gather of one rank copies its partial), its reductions made
    through NCCL."""
    import torch.distributed as tdist

    from repro_torch.dist import GATHERS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.plan import make_executor

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        g = torch.Generator(device=cuda).manual_seed(3)
        x = torch.randn((8, 6, 4, 5), generator=g, device=cuda)
        init = [torch.randn((d, 3), generator=g, device=cuda) for d in x.shape]
        xb = torch.randn((4, 6, 4, 5), generator=g, device=cuda)
        initb = [torch.randn((4, d, 3), generator=g, device=cuda) for d in xb.shape[1:]]
        axes = {0: "data", 2: "model"}
        runs = [
            (x, init, Problem.from_tensor(x, 3), Problem.from_tensor(x, 3, axes, mesh),
             dict(mode_axes=axes)),
            (xb, initb, Problem.from_tensor(xb, 3, batch=4),
             Problem.from_tensor(xb, 3, {}, mesh, batch=4, batch_axes=("data",)),
             dict(mode_axes={}, batch_axes=("data",))),
        ]
        for xs, fs, local, sharded, kw in runs:
            for m in ("matrix_free", "fused"):
                lfits, fits = [], []
                lst = cp_als(xs, plan_sweep(local, m), n_iters=4, tol=0.0, init_factors=fs,
                             callback=lambda it, f, dt: lfits.append(f))
                GATHERS.calls = 0
                st = cp_als(xs, plan_sweep(sharded, m, executor="sharded"),
                            executor=make_executor("sharded", mesh, **kw), n_iters=4, tol=0.0,
                            init_factors=fs, callback=lambda it, f, dt: fits.append(f))
                assert GATHERS.calls > 0
                assert fits == lfits and st.weights.equal(lst.weights)
                assert all(u.equal(v) for u, v in zip(st.factors, lst.factors))
    finally:
        tdist.destroy_process_group()


def test_overlapped_kernel_leaves_on_strided_slabs_in_an_nccl_world_of_one(cuda, tmp_path):
    """The overlapping executor's leaf on the card: every mode cut into 3
    slabs, each slab past mode 0 copied contiguous (a strided view of the
    block), one kernel launch and one asynchronous NCCL gather a slab, the
    result within the kernels' bound of the unsplit kernel's."""
    import torch.distributed as tdist

    from repro_torch.core.mttkrp import mttkrp
    from repro_torch.dist import GATHERS, SLAB_COPIES, dist_mttkrp_overlapped
    from repro_torch.launch.mesh import make_host_mesh

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        g = torch.Generator(device=cuda).manual_seed(5)
        x = torch.randn((9, 14, 7, 12), generator=g, device=cuda)
        fs = [torch.randn((d, 6), generator=g, device=cuda) for d in x.shape]
        axes = {0: "data", 2: "model"}
        for method, kernel in (("fused", fm.KERNEL), ("matrix_free", mf.KERNEL)):
            for n in range(4):
                before = kernel.launches
                GATHERS.calls = SLAB_COPIES.calls = 0
                out = dist_mttkrp_overlapped(x, fs, n, axes, mesh, method=method, n_chunks=3)
                assert kernel.launches == before + 3
                assert SLAB_COPIES.calls == (0 if n == 0 else 3)
                assert GATHERS.calls == 3 * sum(1 for m in axes if m != n)
                whole = mttkrp(x, fs, n, method=method)
                assert _rel(out, whole) < REL
                plain = mttkrp(x.double(), [f.double() for f in fs], n, method="1step")
                assert _rel(out, plain.float()) < REL
    finally:
        tdist.destroy_process_group()


def test_compressed_cp_als_in_an_nccl_world_of_one(cuda, tmp_path):
    """The compressed executor on the card: int8 payloads through NCCL, the
    residuals carried, the kernel leaves launched, the fit within the
    reference's compressed bound (2e-2) of the exact sharded run's."""
    import torch.distributed as tdist

    from repro_torch.dist import INT8_GATHERS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.plan import make_executor

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        g = torch.Generator(device=cuda).manual_seed(7)
        planted = [torch.randn((d, 3), generator=g, device=cuda) for d in (16, 12, 10)]
        x = torch.einsum("ic,jc,kc->ijk", *planted)
        init = [torch.randn((d, 3), generator=g, device=cuda) for d in x.shape]
        axes = {0: "data", 1: "model"}
        problem = Problem.from_tensor(x, 3, axes, mesh)
        fits = {}
        for kind in ("sharded", "compressed"):
            INT8_GATHERS.calls = 0
            before = mf.KERNEL.launches
            st = cp_als(x, plan_sweep(problem, "matrix_free", executor=kind),
                        executor=make_executor(kind, mesh, axes), n_iters=40, tol=1e-9,
                        init_factors=init)
            assert mf.KERNEL.launches - before == 3 * st.it
            assert (INT8_GATHERS.calls > 0) == (kind == "compressed")
            fits[kind] = float(st.fit)
        assert fits["compressed"] > 0.75 and abs(fits["compressed"] - fits["sharded"]) < 2e-2
    finally:
        tdist.destroy_process_group()


def test_two_level_sharded_cp_als_in_an_nccl_world_of_one_is_the_local_engine(cuda, tmp_path):
    """The two-level path on the card: ``make_node_mesh(1, 1)`` with
    ``intra_axes=("device",)``.  One node has no level to split, so every
    node plans flat, nothing is certified, and the sweeps are bitwise the
    local engine's with no reduce-scatter; ``reduce_scatter`` (an NCCL
    all-to-all), ``all_gather`` and ``hierarchical_psum`` on the one-rank
    group are the identity, bitwise."""
    import torch.distributed as tdist

    from repro_torch.core.mttkrp import mttkrp
    from repro_torch.dist import SCATTERS, all_gather, hierarchical_psum, reduce_scatter
    from repro_torch.launch.mesh import make_node_mesh
    from repro_torch.plan import make_executor

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = make_node_mesh(1, 1)
        g = torch.Generator(device=cuda).manual_seed(11)
        x = torch.randn((8, 6, 4, 5), generator=g, device=cuda)
        init = [torch.randn((d, 3), generator=g, device=cuda) for d in x.shape]
        axes = {0: "node", 2: "device"}
        problem = Problem.from_tensor(x, 3, axes, mesh, intra_axes=("device",))
        for m in ("matrix_free", "fused"):
            plan = plan_sweep(problem, m, executor="sharded")
            assert {np_.collective for np_ in plan.nodes} == {"flat"}
            assert plan.lower_bound_bytes is None and not plan.certified_bandwidth_optimal
            lfits, fits = [], []
            lst = cp_als(x, plan_sweep(Problem.from_tensor(x, 3), m), n_iters=4, tol=0.0,
                         init_factors=init, callback=lambda it, f, dt: lfits.append(f))
            SCATTERS.calls = 0
            st = cp_als(x, plan, executor=make_executor("sharded", mesh, plan.problem.mode_axes,
                                                        node_axis=plan.problem.node_axis),
                        n_iters=4, tol=0.0, init_factors=init,
                        callback=lambda it, f, dt: fits.append(f))
            assert SCATTERS.calls == 0
            assert fits == lfits and st.weights.equal(lst.weights)
            assert all(u.equal(v) for u, v in zip(st.factors, lst.factors))
        t = mttkrp(x, init, 1)
        SCATTERS.calls = SCATTERS.bytes = 0
        rs = reduce_scatter(t, "device", mesh)
        assert torch.equal(rs, t) and torch.equal(all_gather(rs, "device", mesh), t)
        assert torch.equal(hierarchical_psum(t, ("node", "device"), mesh, node_axis="device"), t)
        assert (SCATTERS.calls, SCATTERS.bytes) == (1, 0)
    finally:
        tdist.destroy_process_group()


def test_sharded_pp_in_an_nccl_world_of_one_is_the_local_pp(cuda, tmp_path):
    """Sharded pairwise perturbation on the card: in an NCCL world of one
    every allsum copies its one partial, so the pairs, the
    exact/approximate sequence and the fits are bitwise the local PP run's,
    mode-parallel and batch-parallel (the PP service's placement)."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.plan import LocalExecutor, make_executor
    from repro_torch.plan import sweep as tsweep

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        g = torch.Generator(device=cuda).manual_seed(13)
        planted = [torch.randn((4, d, 3), generator=g, device=cuda) for d in (12, 10, 8)]
        xb = torch.einsum("sic,sjc,skc->sijk", *planted)
        xb = xb + 0.1 * xb.std() * torch.randn(xb.shape, generator=g, device=cuda)
        initb = [torch.randn((4, d, 3), generator=g, device=cuda) for d in (12, 10, 8)]
        runs = [
            (xb[0], [u[0] for u in initb], Problem.from_tensor(xb[0], 3, pp_tol=0.05),
             Problem.from_tensor(xb[0], 3, {0: "data", 2: "model"}, mesh, pp_tol=0.05), {}),
            (xb, initb, Problem.from_tensor(xb, 3, batch=4, pp_tol=0.05),
             Problem.from_tensor(xb, 3, {}, mesh, batch=4, batch_axes=("data",), pp_tol=0.05),
             {"batch_axes": ("data",)}),
        ]
        for x, init, local, sharded, kw in runs:
            ex = make_executor("sharded", mesh, sharded.mode_axes, **kw)
            xs, fs = ex.prepare(sharded, x, init)
            lp, sp = LocalExecutor().pp_pairs(local, x, init), ex.pp_pairs(sharded, xs, fs)
            assert all(torch.equal(lp[k], sp[k]) for k in lp)
            out = []
            for plan, executor in ((plan_sweep(local, "pp"), None),
                                   (plan_sweep(sharded, "pp", executor="sharded"), ex)):
                fits, seq = [], []
                real = tsweep._pp_sweep
                tsweep._pp_sweep = lambda *a, **k: (seq.append(1), real(*a, **k))[1]
                try:
                    st = cp_als(x, plan, executor=executor, n_iters=12, tol=0.0,
                                init_factors=init, callback=lambda it, f, dt: fits.append(f))
                finally:
                    tsweep._pp_sweep = real
                out.append((fits, len(seq), st.pp_exact_sweeps, st.factors))
            (lfits, la, le, lf), (fits, a, e, f) = out
            assert la > 0 and (fits, a, e) == (lfits, la, le)
            assert all(u.equal(v) for u, v in zip(f, lf))
    finally:
        tdist.destroy_process_group()


def test_reduced_lm_on_the_card_agrees_with_the_cpu(cuda):
    """The LM serving path on the card: reduced olmo-1b (fp32 compute), the
    CPU model's parameters moved to the card; prefill and decode logits
    within the reference's 2e-3 of the CPU run, greedy tokens equal where
    the CPU run's top-2 gap exceeds it."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import GenerationConfig, generate

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("olmo-1b").reduced()
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    logits = {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        t = toks.to(m.device)
        cache, lg = m.prefill(m.params, {"tokens": t[:, :5]}, max_len=12)
        steps = [lg]
        for i in range(5, 9):
            lg, cache = m.decode_step(m.params, t[:, i : i + 1], cache)
            steps.append(lg)
        logits[name] = torch.cat(steps, 1).cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=2e-3, atol=2e-3)
    # greedy on the card against the CPU's argmax loop, while its top-2 gap exceeds 2e-3
    b = generate(card, card.params, {"tokens": toks.to(cuda)}, GenerationConfig(max_new_tokens=6))
    assert ((b >= 0) & (b < cfg.vocab)).all()
    cache, lg = cpu.prefill(cpu.params, {"tokens": toks}, max_len=16)
    live = [True, True]
    for step in range(6):
        top2 = lg[:, -1].topk(2, -1).values
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        for row in range(2):
            live[row] = live[row] and float(top2[row, 0] - top2[row, 1]) > 2e-3
            if live[row]:
                assert b[row, step] == int(tok[row])
        lg, cache = cpu.decode_step(cpu.params, tok[:, None], cache)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
                                  "whisper-base"])
def test_reduced_lm_families_on_the_card_agree_with_the_cpu(cuda, arch):
    """The SSM, hybrid, MoE and enc-dec serving paths on the card: the
    reduced model (fp32 compute) with the CPU model's parameters; prefill
    and 4 decode logits within the reference's 2e-3 of the CPU run (an
    enc-dec model fed frames made on the CPU), and the engine serves."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import GenerationConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=g, dtype=torch.int32)
    frames = torch.randn(2, 5, cfg.d_model, generator=g)
    logits = {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        t = toks.to(m.device)
        batch = {"tokens": t[:, :5]}
        if cfg.is_encdec:
            batch["frames"] = frames.to(m.device)
        cache, lg = m.prefill(m.params, batch, max_len=12)
        steps = [lg]
        for i in range(5, 9):
            lg, cache = m.decode_step(m.params, t[:, i : i + 1], cache)
            steps.append(lg)
        logits[name] = torch.cat(steps, 1).cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=2e-3, atol=2e-3)
    eng = ServeEngine(card, card.params, GenerationConfig(max_new_tokens=3), batch_size=2)
    rids = [eng.submit(toks[i, : 4 + i].numpy()) for i in range(2)]
    out = eng.flush()
    assert sorted(out) == rids and all(((o >= 0) & (o < cfg.vocab)).all() for o in out.values())


@pytest.mark.parametrize("arch", ["olmo-1b", "falcon-mamba-7b", "recurrentgemma-2b",
                                  "qwen2-moe-a2.7b", "whisper-base"])
def test_reduced_train_step_on_the_card_agrees_with_the_cpu(cuda, arch):
    """The training step on the card: the reduced model (fp32 compute, remat
    on) with the CPU model's parameters; loss and gradient norm at the fp32
    bound ``rtol=2e-4, atol=2e-5`` of the CPU step, and the step repeats
    bitwise on the card (remat on against off too)."""
    import dataclasses

    import numpy as np

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 257)).astype(np.int32))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(
            np.float32))
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    out = {}
    for name, m in (("cpu", cpu), ("cuda", card), ("again", card),
                    ("no_remat", build_model(dataclasses.replace(cfg, remat=False),
                                             device="meta"))):
        p = card.params if name == "no_remat" else m.params
        b = {k: v.to(p["embed"].device) for k, v in batch.items()}
        out[name] = make_train_step(m, opt)(p, init_opt_state(p), b)
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(out["cuda"][2][k].cpu(), out["cpu"][2][k], rtol=2e-4,
                                   atol=2e-5)
    for other in ("again", "no_remat"):
        assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(out["cuda"]),
                                                     _tree.leaves(out[other])))


def test_sharded_lm_in_an_nccl_world_of_one_is_the_local_path(cuda, tmp_path, monkeypatch):
    """The sharded LM on the card, in an NCCL world of one on a (1, 1)
    mesh, at olmo-1b's width cut to 2 layers: ``make_compressed_dp_step(
    compress=False)`` bitwise ``make_train_step`` step by step, and
    ``launch.train --distributed --dp 1 --tp 1`` bitwise the local
    ``launch.train`` (the checkpoint's every array), through the sharded
    path's collectives."""
    import dataclasses

    import numpy as np
    import torch.distributed as tdist

    import repro_torch.configs as tconfigs
    from repro_torch import _tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    real = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config",
                        lambda arch: dataclasses.replace(real(arch), n_layers=2))
    cfg = tconfigs.get_config("olmo-1b")
    model = build_model(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    data = SyntheticLM(DataConfig(cfg.vocab, 256, 4))
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in data.batch(i).items()}
               for i in range(3)]
    opt = OptConfig(lr=3e-4, warmup_steps=0)
    flags = ["--arch", "olmo-1b", "--steps", "2", "--batch", "2", "--seq", "256",
             "--ckpt-every", "2", "--device", "cuda:0"]
    p, s = model.params, init_opt_state(model.params)
    local = []
    for b in batches:
        p, s, met = make_train_step(model, opt)(p, s, b)
        local.append((float(met["loss"]), p))
    train_driver.main([*flags, "--ckpt-dir", str(tmp_path / "local")])
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        step = coll.make_compressed_dp_step(model, opt, mesh, compress=False)
        p, s, err = model.params, init_opt_state(model.params), coll.init_error_state(
            model.params, mesh)
        for b, (loss, want) in zip(batches, local):
            p, s, err, met = step(p, s, err, b)
            assert float(met["loss"]) == loss
            assert all(torch.equal(x, y) for x, y in zip(_tree.leaves(p), _tree.leaves(want)))
        coll.TP.calls = 0
        train_driver.main([*flags, "--ckpt-dir", str(tmp_path / "sharded"), "--distributed",
                           "--dp", "1", "--tp", "1"])
        assert coll.TP.calls > 0
    finally:
        tdist.destroy_process_group()
    arrays = [np.load(tmp_path / d / "step_00000002" / "arrays.npz") for d in ("local", "sharded")]
    assert set(arrays[0].files) == set(arrays[1].files)
    assert all(np.array_equal(arrays[0][k], arrays[1][k]) for k in arrays[0].files)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen2-moe-a2.7b"])
def test_sharded_families_in_an_nccl_world_of_one_are_the_local_step(cuda, tmp_path, arch):
    """The SSM's channel-parallel and the MoE's expert-parallel paths on the
    card, in an NCCL world of one on a (1, 1) mesh: one ``make_train_step``
    of the reduced model bitwise the local step (loss and every parameter),
    through the family's collectives (``dist.TP`` counted)."""
    import torch.distributed as tdist

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 65), generator=gen, device=cuda)}
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(model, opt)
    p0, s0 = model.params, init_opt_state(model.params)
    want_p, _, want = step(p0, s0, batch)
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = meshlib.make_host_mesh(1, 1)
        blocks = meshlib.shard_tree(p0, model.partition_specs(mesh, drop_fsdp=True), mesh)
        coll.TP.calls = 0
        with meshlib.use_mesh(mesh):
            got_p, _, got = step(blocks, init_opt_state(blocks), batch)
        assert coll.TP.calls > 0
    finally:
        tdist.destroy_process_group()
    assert float(got["loss"]) == float(want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(got_p), _tree.leaves(want_p)))


def _olmo_two_layers():
    import dataclasses

    import repro_torch.configs as tconfigs

    return dataclasses.replace(tconfigs.get_config("olmo-1b"), n_layers=2)


def test_fsdp_step_in_an_nccl_world_of_one_is_the_local_step(cuda, tmp_path):
    """``make_train_step(fsdp=True)`` on the card (chip_smoke phase 19a at
    olmo-1b's width cut to 2 layers, bf16 compute): on a (1, 1) mesh of an
    NCCL world of one, bitwise the local step and the ``drop_fsdp`` step for
    two steps, its layers gathered through ``fsdp_gather``."""
    import torch.distributed as tdist

    from repro_torch import _tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = _olmo_two_layers()
    model = build_model(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    data = SyntheticLM(DataConfig(cfg.vocab, 256, 4))
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in data.batch(i).items()}
               for i in range(2)]
    opt = OptConfig(lr=3e-4, warmup_steps=0)

    def run(step, p, ctx):
        s, losses = init_opt_state(p), []
        with ctx:
            for b in batches:
                p, s, met = step(p, s, b)
                losses.append(float(met["loss"]))
        return losses, p

    import contextlib

    want = run(make_train_step(model, opt), model.params, contextlib.nullcontext())
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = meshlib.make_host_mesh(1, 1)
        for fsdp in (False, True):
            coll.FSDP.calls = 0
            p = meshlib.shard_tree(model.params, model.partition_specs(mesh, drop_fsdp=not fsdp),
                                   mesh)
            got = run(make_train_step(model, opt, fsdp=fsdp), p, meshlib.use_mesh(mesh))
            assert got[0] == want[0]
            assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(got[1]),
                                                          _tree.leaves(want[1])))
            assert (coll.FSDP.calls > 0) == fsdp
    finally:
        tdist.destroy_process_group()


def test_dry_run_trace_is_the_cards_program(cuda, tmp_path):
    """chip_smoke phase 19b at olmo-1b's width cut to 2 layers: the FSDP
    step traced on fake tensors in a fake world of one counts the flops,
    HBM bytes and collective operand bytes the card's run of it counts."""
    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = _olmo_two_layers()
    shape = ShapeConfig("t", 256, 4, "train")
    opt = OptConfig(lr=3e-4, warmup_steps=0)
    dryrun.start_fake_world(1)
    try:
        mesh = meshlib.make_host_mesh(1, 1, device="cpu")
        with FakeTensorMode(), meshlib.use_mesh(mesh):
            meta = build_model(cfg, device="meta")
            args = (specs.blocks(specs.param_structs(meta, mesh)),
                    specs.blocks(specs.opt_structs(meta, mesh)),
                    specs.blocks(specs.train_batch_structs(cfg, shape, mesh)))
            _, fake = dryrun.measure(make_train_step(meta, opt, fsdp=True), args)
    finally:
        tdist.destroy_process_group()
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = meshlib.make_host_mesh(1, 1)
        model = build_model(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
        batch = {k: torch.from_numpy(v).to(cuda)
                 for k, v in SyntheticLM(DataConfig(cfg.vocab, 256, 4)).batch(0).items()}
        p = meshlib.shard_tree(model.params, model.partition_specs(mesh), mesh)
        with meshlib.use_mesh(mesh):
            _, real = dryrun.measure(make_train_step(model, opt, fsdp=True),
                                     (p, init_opt_state(p), batch))
    finally:
        tdist.destroy_process_group()
    for k in ("flops", "bytes", "coll_bytes", "coll_issued_bytes", "coll_counts",
              "argument_size_in_bytes", "temp_size_in_bytes"):
        assert fake[k] == real[k], k


def test_kernel_entries_launch_on_a_strided_tensor(cuda):
    """The quickstart's tensor is ``cp_full``'s output plus noise, which
    ``einsum`` would leave strided: ``cp_full`` makes it row-major, so the
    fused and matrix-free entries launch their kernels on it, as the
    quickstart example does on the card."""
    from repro_torch.core import cp_full, mttkrp_einsum, random_factors

    g = torch.Generator(device=cuda).manual_seed(5)
    fs = random_factors(g, (12, 10, 8, 6), 4, device=cuda)
    x = cp_full(None, fs) + 0.1 * torch.randn((12, 10, 8, 6), generator=g, device=cuda)
    assert x.is_contiguous()
    for mod, fn in ((fm, ops.fused_mttkrp), (mf, ops.matrix_free_mttkrp)):
        for n in range(4):
            before = mod.KERNEL.launches
            out = fn(x, fs, n)
            assert mod.KERNEL.launches == before + 1
            assert _rel(out, mttkrp_einsum(x, fs, n)) < REL


# ---- the MTTKRP kernels at any rank: a rank above 64 in column blocks of one launch

HIGH_RANKS = [65, 80, 128, 130]
HIGH_RANK_SHAPES = [(5, 6, 7), (33, 70, 129), (37, 23, 41, 30), (3, 4, 2, 3, 2), (2, 3, 2, 3, 2, 3)]


@pytest.mark.parametrize("rank", HIGH_RANKS)
@pytest.mark.parametrize("shape", HIGH_RANK_SHAPES)
def test_high_rank_mttkrp_kernels_match_plain(cuda, shape, rank):
    """Rows 1-4 above rank 64, every mode of ragged shapes of orders 3-6:
    one counted launch a call, within 1e-4 of the plain version, bitwise
    repeatable."""
    x, fs = _unbatched_inputs(cuda, shape, rank, seed=rank)
    xb, fb = _batched_inputs(cuda, 3, shape, rank, seed=rank + 1)
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        usb = [fb[k] for k in range(len(shape)) if k != n]
        t, a, b, pos = ops.bilinear_operands(x, fs, n)
        tb, ab, bb, _ = ops.bilinear_operands_batched(xb, fb, n)
        entries = [
            (mf.KERNEL, lambda: mf.matrix_free_kernel(x, us, n),
             mf.matrix_free_kernel_plain(x, us, n)),
            (mf.BATCHED_KERNEL, lambda: mf.matrix_free_batched_kernel(xb, usb, n),
             mf.matrix_free_batched_kernel_plain(xb, usb, n)),
            (fm.KERNEL, lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos),
             fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos)),
            (fm.BATCHED_KERNEL, lambda: fm.fused_mttkrp_bilinear_batched(tb, ab, bb, pos=pos),
             fm.fused_mttkrp_bilinear_batched_plain(tb, ab, bb, pos=pos)),
        ]
        for kernel, run, plain in entries:
            before = kernel.launches
            out = run()
            assert kernel.launches == before + 1
            assert out.shape == plain.shape and out.shape[-1] == rank
            assert _rel(out, plain) < REL
            assert torch.equal(out, run())


@pytest.mark.parametrize("rank", HIGH_RANKS)
@pytest.mark.parametrize("big_l,dim_i", [(3, 59), (225, 59), (40, 1100), (7, 33)])
def test_high_rank_multi_ttv_kernels_match_plain(cuda, big_l, dim_i, rank):
    """Rows 5-6 above rank 64: a tile of block_i x C outputs still launches
    (one launch a call), within 1e-4 of the plain version, bitwise."""
    g = torch.Generator(device=cuda).manual_seed(rank + big_l)
    t = torch.randn((3, big_l, dim_i, rank), generator=g, device=cuda)
    w = torch.randn((3, big_l, rank), generator=g, device=cuda)
    for block_i in (256, 1024):
        for kernel, run, plain in (
            (mt.KERNEL, lambda: mt.multi_ttv(t[0], w[0], block_i=block_i),
             mt.multi_ttv_plain(t[0], w[0])),
            (mt.BATCHED_KERNEL, lambda: mt.multi_ttv_batched(t, w, block_i=block_i),
             mt.multi_ttv_batched_plain(t, w)),
        ):
            before = kernel.launches
            out = run()
            assert kernel.launches == before + 1
            assert _rel(out, plain) < REL
            assert torch.equal(out, run())


def _launch_unbatched_at(x, us, n, c, g, stream):
    """The unbatched matrix-free C entry at rank ``c`` with the groups,
    splits and stage of launch ``g`` (taken from another rank's geometry)."""
    shape = tuple(x.shape)
    others = [k for k in range(x.ndim) if k != n]
    out = x.new_empty((shape[n], c))
    ws = x.new_empty((g.groups, shape[n], c)) if g.groups > 1 else None
    mf.KERNEL.launch(x.data_ptr(), mf._factor_pointers(us, others, x.ndim),
                     (ctypes.c_int64 * x.ndim)(*shape), x.ndim, n, c, g.groups, g.splits,
                     g.q_chunk, int(g.vec), None if ws is None else ws.data_ptr(),
                     out.data_ptr(), stream)
    return out


def _launch_batched_at(x, us, n, c, g, stream):
    shape = tuple(x.shape[1:])
    others = [k for k in range(len(shape)) if k != n]
    out = x.new_empty((x.shape[0], shape[n], c))
    mf.BATCHED_KERNEL.launch(x.data_ptr(), mf._factor_pointers(us, others, len(shape)),
                             (ctypes.c_int64 * len(shape))(*shape), len(shape), n, c,
                             x.shape[0], g.splits, g.q_chunk, int(g.vec), out.data_ptr(), stream)
    return out


@pytest.mark.parametrize("rank", [65, 80, 128, 130])
@pytest.mark.parametrize("shape", [(37, 23, 41, 30), (33, 70, 129), (225, 8, 20, 200)])
def test_a_column_block_is_bitwise_a_call_on_its_columns_alone(cuda, shape, rank):
    """A column's sum runs in the same order whatever block holds it: a
    rank-C call's block of columns [lo, hi) is bitwise the C entry called
    on those factor columns alone at the same groups, splits and stage.  A
    wrapper call at rank hi - lo may take another split (its waves count
    one column block, the rank-C call's all of them), and is bitwise the
    block exactly where its geometry is the same."""
    stream = torch.cuda.current_stream().cuda_stream
    x, fs = _unbatched_inputs(cuda, shape, rank, seed=rank + 3)
    xb, fb = _batched_inputs(cuda, 3, shape, rank, seed=rank + 4)
    nb, w, _ = mf.column_blocks(rank)
    spans = [(b * w, min(rank, (b + 1) * w)) for b in range(nb)]
    for n in range(len(shape)):
        us = [fs[k] for k in range(len(shape)) if k != n]
        usb = [fb[k] for k in range(len(shape)) if k != n]
        g = mf.unbatched_launch_shape(shape, n, rank)
        gb = mf.launch_shape(shape, n, rank, 3)
        out = mf.matrix_free_kernel(x, us, n)
        outb = mf.matrix_free_batched_kernel(xb, usb, n)
        for lo, hi in spans:
            cols = [u[..., lo:hi].contiguous() for u in us]
            colsb = [u[..., lo:hi].contiguous() for u in usb]
            assert torch.equal(out[:, lo:hi], _launch_unbatched_at(x, cols, n, hi - lo, g, stream))
            assert torch.equal(outb[..., lo:hi],
                               _launch_batched_at(xb, colsb, n, hi - lo, gb, stream))
            alone = mf.unbatched_launch_shape(shape, n, hi - lo)
            if (alone.groups, alone.splits, alone.q_chunk) == (g.groups, g.splits, g.q_chunk):
                assert torch.equal(out[:, lo:hi], mf.matrix_free_kernel(x, cols, n))


def test_high_rank_kernels_launch_one_cuda_kernel_a_call(cuda):
    """Above rank 64 a call still launches what its design states: the
    batched entries one kernel, the unbatched ones one with one group and
    two with more, multi-TTV one.  Counted in a CUDA graph of one call."""
    for rank in (80, 128):
        shape = (37, 23, 41, 30)
        x, fs = _unbatched_inputs(cuda, shape, rank, seed=rank)
        xb, fb = _batched_inputs(cuda, 3, shape, rank, seed=rank)
        for n in range(4):
            us = [fs[k] for k in range(4) if k != n]
            usb = [fb[k] for k in range(4) if k != n]
            g = mf.unbatched_launch_shape(shape, n, rank)
            names = sorted(_graph_kernel_names(lambda: mf.matrix_free_kernel(x, us, n)),
                           key=lambda name: "sum_splits_kernel" in name)
            assert len(names) == (1 if g.groups == 1 else 2)
            assert "matrix_free_cluster_kernel" in names[0]
            names = _graph_kernel_names(lambda: mf.matrix_free_batched_kernel(xb, usb, n))
            assert len(names) == 1 and "matrix_free_cluster_kernel" in names[0]
            tb, ab, bb, pos = ops.bilinear_operands_batched(xb, fb, n)
            names = _graph_kernel_names(lambda: fm.fused_mttkrp_bilinear_batched(tb, ab, bb,
                                                                                 pos=pos))
            assert len(names) == 1 and "matrix_free_cluster_kernel" in names[0]
        t = torch.randn((40, 59, rank), device=cuda)
        w = torch.randn((40, rank), device=cuda)
        names = _graph_kernel_names(lambda: mt.multi_ttv(t, w))
        assert len(names) == 1 and "multi_ttv_kernel" in names[0]


@pytest.mark.parametrize("rank", [65, 80, 128, 200])
@pytest.mark.parametrize("shape", [(225, 59, 200, 200), (37, 23, 41, 30), (5, 6, 7)])
def test_high_rank_residency_and_cluster_slots_match_the_occupancy_query(cuda, shape, rank):
    """The residency and clusters a wave the geometry counts at a column
    block's padded width are what the CUDA occupancy queries give."""
    for n in range(len(shape)):
        for g in (mf.unbatched_launch_shape(shape, n, rank), mf.launch_shape(shape, n, rank, 8)):
            per_sm, clusters = mf.occupancy(g, rank)
            assert per_sm == g.residency
            assert clusters == mf.CLUSTER_SLOTS[g.residency][g.splits]


# ---- every entry in bf16, fp16 and float64: element-typed staging, fp32 sums

DTYPE_SHAPES = [(37, 23, 41, 30), (33, 70, 128), (5, 6, 7)]


def _misaligned(x):
    """A contiguous view of ``x``'s values that starts one element past an
    allocation's start: off a 16-byte line in every dtype."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _check_entry(kernel, run, plain, kernels_a_call):
    """One counted launch a call, float32 out (or the plain version's
    dtype), within REL of the plain version (bitwise for the KRP pair, whose
    plain version rounds each product once too), bitwise repeatable, and
    the CUDA kernels a call its design states (a CUDA graph of one call)."""
    before = kernel.launches
    out = run()
    assert kernel.launches == before + 1
    want = plain()
    assert out.dtype == want.dtype and out.shape == want.shape
    if kernel is kk.KERNEL:
        assert torch.equal(out, want)
    else:
        assert out.dtype == torch.float32 and _rel(out, want) < REL
    assert torch.equal(out, run())
    assert len(_graph_kernel_names(run)) == kernels_a_call


@pytest.mark.parametrize("rank", [10, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_every_entry_runs_in_each_dtype_at_every_rank(cuda, dtype, rank):
    """Rows 1-7 in bf16, fp16 and float64: each entry launches the kernel of
    its own dtype (no converted copy: the CUDA kernels a call are those of
    float32, 1 batched, 1 or 2 unbatched by the launch's groups), sums in
    fp32 and returns float32 (the KRP pair the operands' dtype), within
    1e-4 of its plain version.  The shapes take both copy paths: a
    contiguous extent of 30 is not 16 bytes in a 16-bit type (the scalar
    staging path), 128 is; and a view off a 16-byte line takes the scalar
    path in every dtype."""
    isz = torch.empty((), dtype=dtype).element_size()
    for shape in DTYPE_SHAPES:
        x, fs = _unbatched_inputs(cuda, shape, rank, seed=rank + len(shape))
        xb, fb = _batched_inputs(cuda, 3, shape, rank, seed=rank + 1)
        x, xb = x.to(dtype), xb.to(dtype)
        fs, fb = [u.to(dtype) for u in fs], [u.to(dtype) for u in fb]
        for xu in (x, _misaligned(x)) if shape == DTYPE_SHAPES[0] else (x,):
            for n in range(len(shape)):
                us = [fs[k] for k in range(len(shape)) if k != n]
                usb = [fb[k] for k in range(len(shape)) if k != n]
                g = mf.unbatched_launch_shape(shape, n, rank, itemsize=isz)
                _check_entry(mf.KERNEL, lambda: mf.matrix_free_kernel(xu, us, n),
                             lambda: mf.matrix_free_kernel_plain(xu, us, n),
                             1 if g.groups == 1 else 2)
                _check_entry(mf.BATCHED_KERNEL, lambda: mf.matrix_free_batched_kernel(xb, usb, n),
                             lambda: mf.matrix_free_batched_kernel_plain(xb, usb, n), 1)
                t, a, b, pos = ops.bilinear_operands(xu, fs, n)
                gv = fm.launch_geometry(tuple(t.shape), pos, rank, itemsize=isz)
                _check_entry(fm.KERNEL, lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos),
                             lambda: fm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos),
                             1 if gv.groups == 1 else 2)
                tb, ab, bb, pos = ops.bilinear_operands_batched(xb, fb, n)
                _check_entry(fm.BATCHED_KERNEL,
                             lambda: fm.fused_mttkrp_bilinear_batched(tb, ab, bb, pos=pos),
                             lambda: fm.fused_mttkrp_bilinear_batched_plain(tb, ab, bb, pos=pos),
                             1)
                out = ops.fused_mttkrp(xu, fs, n)  # the wrapper casts back to x.dtype
                assert out.dtype == dtype
    g = torch.Generator(device=cuda).manual_seed(rank)
    for big_l, dim_i in ((225, 59), (40, 1100), (3, 59), (7, 33)):
        t = torch.randn((3, big_l, dim_i, rank), generator=g, device=cuda).to(dtype)
        w = torch.randn((3, big_l, rank), generator=g, device=cuda).to(dtype)
        for tt in (t[0], _misaligned(t[0])):
            _check_entry(mt.KERNEL, lambda: mt.multi_ttv_kernel(tt, w[0], block_i=dim_i),
                         lambda: mt.multi_ttv_plain(tt, w[0]), 1)
        _check_entry(mt.BATCHED_KERNEL,
                     lambda: mt.multi_ttv_batched_kernel(t, w, block_i=dim_i, block_batch=1),
                     lambda: mt.multi_ttv_batched_plain(t, w), 1)
        assert mt.multi_ttv(t[0], w[0]).dtype == dtype
    a = torch.randn((59, rank), generator=g, device=cuda).to(dtype)
    for b in (torch.randn((201, rank), generator=g, device=cuda).to(dtype),
              _misaligned(torch.randn((7, rank), generator=g, device=cuda).to(dtype))):
        for block_b in (1, 64):
            _check_entry(kk.KERNEL, lambda: kk.krp_pair(a, b, block_b=block_b),
                         lambda: kk.krp_pair_plain(a, b), 1)


@pytest.mark.parametrize("rank", [10, 80])
@pytest.mark.parametrize("dtype", [torch.int32, torch.complex64, "mix"])
def test_other_dtypes_still_raise_at_every_rank(cuda, dtype, rank):
    """An int32 or complex64 operand, or a mix of dtypes (bf16 and float32),
    raises TypeError at every kernel entry, with no launch and no quiet
    conversion or fallback."""
    x, fs = _unbatched_inputs(cuda, (6, 5, 7, 4), rank, seed=1)
    xb, fb = _batched_inputs(cuda, 2, (6, 5, 7, 4), rank, seed=2)
    tw, ww = torch.randn((4, 5, rank), device=cuda), torch.randn((4, rank), device=cuda)
    if dtype == "mix":
        x, xb, tw = x.bfloat16(), xb.bfloat16(), tw.bfloat16()
    else:
        x, fs, xb, fb = x.to(dtype), [u.to(dtype) for u in fs], xb.to(dtype), [u.to(dtype) for u in fb]
        tw, ww = tw.to(dtype), ww.to(dtype)
    t, a, b, pos = ops.bilinear_operands(x, fs, 1)
    tb, ab, bb, _ = ops.bilinear_operands_batched(xb, fb, 1)
    kernels = (fm.KERNEL, fm.BATCHED_KERNEL, mf.KERNEL, mf.BATCHED_KERNEL, mt.KERNEL,
               mt.BATCHED_KERNEL, kk.KERNEL)
    before = [k.launches for k in kernels]
    for run in (lambda: fm.fused_mttkrp_bilinear(t, a, b, pos=pos),
                lambda: fm.fused_mttkrp_bilinear_batched(tb, ab, bb, pos=pos),
                lambda: mf.matrix_free_kernel(x, [fs[0], fs[2], fs[3]], 1),
                lambda: mf.matrix_free_batched_kernel(xb, [fb[0], fb[2], fb[3]], 1),
                lambda: ops.matrix_free_mttkrp(x, fs, 2),
                lambda: mt.multi_ttv(tw, ww),
                lambda: mt.multi_ttv_batched(tw[None], ww[None]),
                lambda: kk.krp_pair(tw[0], ww, block_b=4)):
        with pytest.raises(TypeError, match="bfloat16" if dtype != "mix" else "one dtype"):
            run()
    assert [k.launches for k in kernels] == before


def test_sharded_matrix_free_at_rank_80_in_an_nccl_world_of_one_is_the_local_engine(
        cuda, tmp_path):
    """The sharded executor's kernel leaves at rank 80 (two column blocks):
    an NCCL world of one on a (1, 1) mesh, bitwise the local engine."""
    import torch.distributed as tdist

    from repro_torch.dist import GATHERS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.plan import make_executor

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        g = torch.Generator(device=cuda).manual_seed(8)
        x = torch.randn((20, 17, 12, 9), generator=g, device=cuda)
        init = [torch.randn((d, 80), generator=g, device=cuda) for d in x.shape]
        axes = {0: "data", 2: "model"}
        for m, kernel in (("matrix_free", mf.KERNEL), ("fused", fm.KERNEL)):
            lfits, fits = [], []
            lst = cp_als(x, plan_sweep(Problem.from_tensor(x, 80), m), n_iters=3, tol=0.0,
                         init_factors=init, callback=lambda it, f, dt: lfits.append(f))
            GATHERS.calls = 0
            before = kernel.launches
            st = cp_als(x, plan_sweep(Problem.from_tensor(x, 80, axes, mesh), m,
                                      executor="sharded"),
                        executor=make_executor("sharded", mesh, mode_axes=axes), n_iters=3,
                        tol=0.0, init_factors=init, callback=lambda it, f, dt: fits.append(f))
            assert GATHERS.calls > 0 and kernel.launches - before == 12
            assert fits == lfits and st.weights.equal(lst.weights)
            assert all(u.equal(v) for u, v in zip(st.factors, lst.factors))
    finally:
        tdist.destroy_process_group()
