"""Parity of the port's multi-TTV and KRP kernel modules, and of the
kernelized 2-step MTTKRP, with the JAX Pallas wrappers, on the CPU.

On the CPU the wrappers take their plain PyTorch versions (the CUDA kernels
run only on the card; ``tests/test_torch_gpu.py`` holds them against these
plain versions there).  The JAX side runs the Pallas kernels in interpret
mode, as the JAX package's own tests do.  Inputs are made once with numpy
from a seed; float32 tolerance ``rtol=2e-4, atol=2e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_mttkrp as tfused
from repro_torch.kernels import krp_kernel as tkrp
from repro_torch.kernels import multi_ttv as tmt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.plan.autotune import TTV_TILE_CANDIDATES

TOL = dict(rtol=2e-4, atol=2e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **TOL)


def _launches():
    return (tmt.KERNEL.launches, tmt.BATCHED_KERNEL.launches, tkrp.KERNEL.launches,
            tfused.KERNEL.launches)


@pytest.mark.parametrize("block_i", TTV_TILE_CANDIDATES)
def test_multi_ttv_matches_pallas_ragged_rows(block_i):
    rng = _rng(block_i)
    t = rng.standard_normal((6, 37, 5)).astype(np.float32)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    before = _launches()
    ref = jops.multi_ttv(jnp.asarray(t), jnp.asarray(w), block_i=block_i)
    out = tops.multi_ttv(torch.from_numpy(t), torch.from_numpy(w), block_i=block_i)
    assert out.dtype == torch.float32 and tuple(out.shape) == (37, 5)
    _close(ref, out)
    _close(jref.multi_ttv_ref(jnp.asarray(t), jnp.asarray(w)), out)
    assert _launches() == before  # CPU tensors never reach a CUDA kernel


def test_multi_ttv_batched_matches_pallas_ragged_slabs():
    rng = _rng(3)
    t = rng.standard_normal((3, 4, 21, 6)).astype(np.float32)  # S=3 < block_batch=8
    w = rng.standard_normal((3, 4, 6)).astype(np.float32)
    before = _launches()
    ref = jops.multi_ttv_batched(jnp.asarray(t), jnp.asarray(w))
    tt, tw = torch.from_numpy(t), torch.from_numpy(w)
    out = tops.multi_ttv_batched(tt, tw)
    assert tuple(out.shape) == (3, 21, 6)
    _close(ref, out)
    torch.testing.assert_close(out, tref.multi_ttv_batched_ref(tt, tw))
    for s in range(3):  # each slab is the unbatched multi-TTV of its own operands
        torch.testing.assert_close(out[s], tops.multi_ttv(tt[s], tw[s]))
    assert _launches() == before


def test_multi_ttv_refuses_bad_operands():
    t, w = torch.zeros(3, 5, 2), torch.zeros(3, 2)
    for bad in (0, 48, 1056):
        with pytest.raises(ValueError):
            tops.multi_ttv(t, w, block_i=bad)
    with pytest.raises(ValueError):
        tops.multi_ttv(t, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        tops.multi_ttv_batched(t[None], w)  # w lacks the slab axis
    with pytest.raises(ValueError):
        tops.multi_ttv_batched(t[None], w[None], block_batch=0)
    assert tmt.block_threads(37, 256) == 64 and tmt.block_threads(500, 256) == 256


@pytest.mark.parametrize("dims", [(5, 7), (4, 3, 6)], ids=["two", "three"])
def test_krp_materialize_matches_pallas(dims):
    rng = _rng(len(dims))
    mats = [rng.standard_normal((d, 4)).astype(np.float32) for d in dims]
    before = _launches()
    ref = jops.krp_materialize([jnp.asarray(m) for m in mats], block_b=4)
    out = tops.krp_materialize([torch.from_numpy(m) for m in mats], block_b=4)
    assert tuple(out.shape) == (int(np.prod(dims)), 4)
    _close(ref, out)
    torch.testing.assert_close(out, tref.krp_ref([torch.from_numpy(m) for m in mats]))
    assert _launches() == before


def test_krp_pair_plain_and_checks():
    rng = _rng(9)
    a = torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((5, 2)).astype(np.float32))
    out = tkrp.krp_pair(a, b, block_b=2)
    assert torch.equal(out.view(3, 5, 2)[1, 4], a[1] * b[4])  # a's index slow
    with pytest.raises(ValueError):
        tkrp.krp_pair(a, torch.zeros(5, 3), block_b=2)
    with pytest.raises(ValueError):
        tkrp.krp_pair(a, b, block_b=0)


@pytest.mark.parametrize(
    "shape", [(9, 14, 11), (4, 5, 3, 6)], ids=["order3", "order4"]
)
def test_mttkrp_2step_kernel_matches_pallas_every_mode(shape):
    rng = _rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    fs = [rng.standard_normal((d, 5)).astype(np.float32) for d in shape]
    jx, jf = jnp.asarray(x), [jnp.asarray(u) for u in fs]
    tx, tf = torch.from_numpy(x), [torch.from_numpy(u) for u in fs]
    before = _launches()
    for n in range(len(shape)):
        ref = jops.mttkrp_2step_kernel(jx, jf, n)
        out = tops.mttkrp_2step_kernel(tx, tf, n)
        assert tuple(out.shape) == (shape[n], 5)
        _close(ref, out)
    assert _launches() == before


def test_multi_ttv_operands_take_both_orders():
    rng = _rng(11)
    shape = (4, 5, 3, 6)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    fs = [torch.from_numpy(rng.standard_normal((d, 5)).astype(np.float32)) for d in shape]
    t1, w1 = tops.multi_ttv_operands(x, fs, 1)  # L=4 <= R=18: right-first over l
    t2, w2 = tops.multi_ttv_operands(x, fs, 2)  # L=20 > R=6: left-first over r
    assert tuple(t1.shape) == (4, 5, 5) and tuple(w1.shape) == (4, 5)
    assert tuple(t2.shape) == (6, 3, 5) and tuple(w2.shape) == (6, 5)
    assert t2.is_contiguous()  # the kernel reads a contiguous (R, I, C)
    for n, (t, w) in ((1, (t1, w1)), (2, (t2, w2))):
        torch.testing.assert_close(
            tops.multi_ttv(t, w), tref.fused_mttkrp_ref(x, fs, n), rtol=2e-4, atol=2e-5
        )
    for n in (0, 3):
        with pytest.raises(ValueError):
            tops.multi_ttv_operands(x, fs, n)
