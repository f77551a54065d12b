"""The port's CUDA kernels and CP-ALS on the card.

Marked ``gpu``: each test skips, with its reason, where no CUDA card is
attached (the decision is taken in the fixture, never at import).  On the
card each kernel is held against its plain PyTorch version (norm-wise
relative error under 1e-4: fp32 sums in two orders) and must launch; the
main path runs through both kernels.  Run there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import fused_mttkrp as fm
from repro_torch.kernels import matrix_free as mf
from repro_torch.kernels import ops
from repro_torch.plan import Problem, cp_als, plan_sweep

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
    with pytest.raises(TypeError):
        fm.fused_mttkrp_bilinear(t.double(), a.double(), b.double(), pos=pos)
    with pytest.raises(ValueError):
        fm.fused_mttkrp_bilinear(t, a.cpu(), b, pos=pos)
    with pytest.raises(ValueError):
        mf.matrix_free_kernel(x.transpose(0, 1), [fs[0], fs[2]], 1)  # shape mismatch
    big = [torch.randn(d, 65, device=cuda) for d in x.shape]
    with pytest.raises(ValueError):
        mf.matrix_free_kernel(x, [big[0], big[1]], 2)


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
    with pytest.raises(TypeError):
        mf.matrix_free_batched_kernel(x.double(), [f.double() for f in fs[1:]], 0)
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
