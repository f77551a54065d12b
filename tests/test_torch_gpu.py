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
