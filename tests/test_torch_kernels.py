"""Parity of the port's kernel modules with the JAX Pallas wrappers, on the CPU.

On the CPU every kernel wrapper takes its plain PyTorch version (the CUDA
kernels run only on the card; ``tests/test_torch_gpu.py`` holds them against
these plain versions there).  The JAX side runs the Pallas kernels in
interpret mode, as the JAX package's own tests do.  Inputs are made once
with numpy from a seed; float32 tolerance ``rtol=2e-4, atol=2e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import _tiling as jtiling
from repro.kernels import fused_mttkrp as jfused
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _tiling as ttiling
from repro_torch.kernels import fused_mttkrp as tfused
from repro_torch.kernels import matrix_free as tmf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-4, atol=2e-5)


def _arrays(shape, rank, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    fs = [rng.standard_normal((d, rank)).astype(np.float32) for d in shape]
    return x, fs


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **TOL)


def _launches():
    return tfused.KERNEL.launches, tmf.KERNEL.launches


@pytest.mark.parametrize(
    "shape", [(5, 7, 6), (3, 4, 5, 6), (2, 3, 4, 3, 2)], ids=["order3", "order4", "order5"]
)
def test_fused_mttkrp_matches_pallas_every_mode(shape):
    x, fs = _arrays(shape, 3, seed=len(shape))
    before = _launches()
    for n in range(len(shape)):
        ref = jops.fused_mttkrp(jnp.asarray(x), [jnp.asarray(u) for u in fs], n)
        out = tops.fused_mttkrp(torch.from_numpy(x), [torch.from_numpy(u) for u in fs], n)
        assert out.dtype == torch.float32 and tuple(out.shape) == (shape[n], 3)
        _close(ref, out)
    assert _launches() == before  # CPU tensors never reach a CUDA kernel


@pytest.mark.parametrize(
    "shape",
    [(5, 7, 6), (3, 4, 5, 6), (2, 3, 4, 3, 2), (2, 3, 2, 3, 2, 3)],
    ids=["order3", "order4", "order5", "order6"],
)
def test_matrix_free_matches_pallas_every_mode(shape):
    x, fs = _arrays(shape, 4, seed=10 + len(shape))
    before = _launches()
    for n in range(len(shape)):
        ref = jops.matrix_free_mttkrp(jnp.asarray(x), [jnp.asarray(u) for u in fs], n)
        out = tops.matrix_free_mttkrp(torch.from_numpy(x), [torch.from_numpy(u) for u in fs], n)
        assert tuple(out.shape) == (shape[n], 4)
        _close(ref, out)
    assert _launches() == before


@pytest.mark.parametrize("pos", [0, 1, 2])
def test_bilinear_plain_matches_pallas_kernel(pos):
    rng = np.random.default_rng(20 + pos)
    dims = [6, 5, 7]
    t = rng.standard_normal(dims).astype(np.float32)
    ab = [d for k, d in enumerate(dims) if k != pos]
    a = rng.standard_normal((ab[0], 3)).astype(np.float32)
    b = rng.standard_normal((ab[1], 3)).astype(np.float32)
    bi = dims[pos]  # one block along i; b blocks must divide dim_b
    ref = jfused.fused_mttkrp_bilinear(
        jnp.asarray(t), jnp.asarray(a), jnp.asarray(b), pos=pos,
        block_i=bi, block_b=ab[1], interpret=True,
    )
    tt, ta, tb = (torch.from_numpy(v) for v in (t, a, b))
    _close(ref, tfused.fused_mttkrp_bilinear(tt, ta, tb, pos=pos))
    _close(jref.bilinear_ref(jnp.asarray(t), jnp.asarray(a), jnp.asarray(b), pos),
           tref.bilinear_ref(tt, ta, tb, pos))


def test_kernel_wrappers_reject_bad_operands():
    t = torch.zeros(4, 5, 6)
    with pytest.raises(ValueError):
        tfused.fused_mttkrp_bilinear(t, torch.zeros(4, 2), torch.zeros(5, 2), pos=1)
    with pytest.raises(ValueError):
        tfused.fused_mttkrp_bilinear(t[0], torch.zeros(4, 2), torch.zeros(6, 2), pos=0)
    x = torch.zeros(3, 4, 5)
    with pytest.raises(ValueError):
        tmf.matrix_free_kernel(x, [torch.zeros(3, 2), torch.zeros(4, 2)], 2 + 5)
    with pytest.raises(ValueError):
        tmf.matrix_free_kernel(x, [torch.zeros(3, 2), torch.zeros(5, 2)], 2)
    with pytest.raises(ValueError):
        tops.matrix_free_mttkrp(torch.zeros(2, 2), [torch.zeros(2, 1)] * 2, 0)
    with pytest.raises(ValueError):
        ttiling.use_kernel(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        ttiling.check_kernel_operand("t", torch.zeros(2))  # a CPU tensor is no kernel operand


def test_reduction_blocks_fit_shared_memory():
    rb = tmf._reduction_blocks((225, 59, 200, 200), 1, 10)
    assert rb == {0: 1, 2: 1, 3: tmf.BLOCK_R}
    assert tmf._reduction_blocks((225, 59, 200, 200), 3, 10) == {0: 1, 1: 1, 2: tmf.BLOCK_R}
    assert tmf._reduction_blocks((4, 5, 3), 0, 2) == {1: 1, 2: 3}
    with pytest.raises(ValueError):
        tmf._reduction_blocks((4, 5, 3), 0, 100_000)


@pytest.mark.parametrize("dims", [[3], [3, 4], [59, 200, 200], [225, 59, 200], [2, 9, 2, 9]])
def test_balanced_split_matches_reference(dims):
    assert tops.balanced_split(dims) == jops.balanced_split(dims)


@pytest.mark.parametrize("axis,mult", [(0, 4), (1, 3), (1, 5), (0, 1)])
def test_tiling_helpers_match_reference(axis, mult):
    x = np.arange(15, dtype=np.float32).reshape(3, 5)
    _close(jtiling.pad_axis(jnp.asarray(x), axis, mult),
           ttiling.pad_axis(torch.from_numpy(x), axis, mult))
    assert ttiling.block(7, mult) == jtiling.block(7, mult)


def test_oracles_match_reference():
    x, fs = _arrays((3, 4, 5), 2, seed=30)
    jf = [jnp.asarray(u) for u in fs]
    tf = [torch.from_numpy(u) for u in fs]
    _close(jref.fused_mttkrp_ref(jnp.asarray(x), jf, 1),
           tref.fused_mttkrp_ref(torch.from_numpy(x), tf, 1))
    _close(jref.krp_ref(jf), tref.krp_ref(tf))
    t = np.random.default_rng(31).standard_normal((3, 4, 2)).astype(np.float32)
    _close(jref.multi_ttv_ref(jnp.asarray(t), jf[0]),
           tref.multi_ttv_ref(torch.from_numpy(t), tf[0]))
