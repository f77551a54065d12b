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
    for bad in (0, -32):
        with pytest.raises(ValueError):
            tops.multi_ttv(t, w, block_i=bad)
    with pytest.raises(ValueError):
        tops.multi_ttv(t, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        tops.multi_ttv_batched(t[None], w)  # w lacks the slab axis
    with pytest.raises(ValueError):
        tops.multi_ttv_batched(t[None], w[None], block_batch=0)
    assert tmt.tile_rows(37, 256) == 37 and tmt.tile_rows(500, 256) == 256


# ---- the CUDA launch's geometry (pure Python: checked here, run on the card)

_BLOCK_IS = sorted(set(TTV_TILE_CANDIDATES) | {32, 1024})


def _tile_outputs(g, n, rank, tile):
    """Outputs of one tile as the kernel walks them (multi_ttv.cu): chunks of
    4 * threads_x, thread tx owning e0 + 4 tx + k (vec) or e0 + tx + k tx."""
    lo, hi = tile * g.tile_rows * rank, min(n, (tile + 1) * g.tile_rows * rank)
    tx_n = g.threads_x
    owned = []
    for e0 in range(lo, hi, 4 * tx_n):
        for tx in range(tx_n):
            es = [e0 + 4 * tx + k if g.vec else e0 + tx + k * tx_n for k in range(4)]
            owned += [e for e in es if e < hi]
    return lo, hi, owned


def _l_slice(big_l, parts, k, lo=0):
    """Part ``k`` of ``parts`` balanced parts of ``[lo, lo + big_l)``, as the
    kernel cuts a cluster's L over its ranks and a rank's slice over its
    warp groups."""
    return lo + big_l * k // parts, lo + big_l * (k + 1) // parts


def _check_launch(dim_i, big_l, rank, slabs, block_i):
    g = tmt.launch_shape(dim_i, big_l, rank, block_i, slabs)
    assert g == tmt.launch_shape(dim_i, big_l, rank, block_i, slabs)  # the shape alone
    # grid and block limits; one cluster covers L along grid y
    assert g.cluster in (1, 2, 4, 8) and g.cluster <= big_l
    assert 1 <= g.tiles < 2**31 and 1 <= g.slabs == slabs <= 65535
    threads = g.threads_x * g.groups
    assert g.threads_x % 32 == 0 and threads % 32 == 0 and threads <= 1024
    assert g.tile_rows == min(block_i, dim_i) and g.vec == (dim_i * rank % 4 == 0)
    # every output element lies in exactly one tile and one thread's quad
    n = dim_i * rank
    seen = []
    for tile in range(g.tiles):
        lo, hi, owned = _tile_outputs(g, n, rank, tile)
        assert lo < hi  # no empty tile
        assert sorted(owned) == list(range(lo, hi))
        if g.vec:  # float4 reads: every quad starts on a 16-byte boundary
            assert lo % 4 == 0 and hi % 4 == 0
        seen += owned
    assert sorted(seen) == list(range(n))
    # every l lies in exactly one rank's slice, and in one warp group of it
    ls = []
    for r in range(g.cluster):
        r0, r1 = _l_slice(big_l, g.cluster, r)
        assert r1 - r0 >= g.groups  # no empty rank, no empty group
        for k in range(g.groups):
            ls += range(*_l_slice(r1 - r0, g.groups, k, r0))
    assert ls == list(range(big_l))


@pytest.mark.parametrize("rank", [1, 7, 10, 64])
@pytest.mark.parametrize("big_l", [1, 3, 225])
@pytest.mark.parametrize("dim_i", [1, 59, 200])
def test_launch_shape_tiles_every_output_and_every_l_once(dim_i, big_l, rank):
    for slabs in (1, 5):
        for block_i in _BLOCK_IS:
            _check_launch(dim_i, big_l, rank, slabs, block_i)


@pytest.mark.parametrize(
    "shape", [(1, 225, 59, 10), (1, 200, 200, 10), (8, 200, 200, 10), (8, 225, 200, 16)],
    ids=["mode1", "mode2", "batched", "batched-r16"],
)
def test_launch_shape_at_the_fmri_shapes(shape):
    slabs, big_l, dim_i, rank = shape
    for block_i in _BLOCK_IS:
        _check_launch(dim_i, big_l, rank, slabs, block_i)
    for block_i in _BLOCK_IS:  # a short plane spreads its L over a cluster of 8 SMs
        assert tmt.launch_shape(dim_i, big_l, rank, block_i, slabs).cluster == 8


def test_launch_shape_sizes_the_cta_to_the_tile():
    # rank 64 at block_i 1024: 16384 quads, 16 chunks of 1024 threads, one group
    g = tmt.launch_shape(1100, 4, 64, 1024)
    assert (g.tiles, g.tile_rows, g.threads_x, g.groups, g.cluster) == (2, 1024, 1024, 1, 1)
    # mode 1 of the fMRI tensor: 590 outputs, 148 quads, 5 warps a group
    g = tmt.launch_shape(59, 225, 10, 256)
    assert (g.tiles, g.threads_x, g.groups, g.cluster, g.vec) == (1, 160, 4, 8, False)
    # mode 2: 2000 outputs in one tile at block_i 256, four tiles at 64
    g = tmt.launch_shape(200, 200, 10, 256)
    assert (g.tiles, g.threads_x, g.groups, g.cluster, g.vec) == (1, 512, 2, 8, True)
    g = tmt.launch_shape(200, 200, 10, 64)
    assert (g.tiles, g.threads_x, g.groups, g.cluster) == (4, 160, 4, 8)
    # L = 3: no cluster, one group; L = 1 likewise
    assert tmt.launch_shape(59, 3, 7, 256)[1:] == (1, 1, 59, 128, 1, False)
    # any other block_i maps to the nearest legal tile (a tie goes up); below 1 raises
    assert tmt.launch_shape(59, 225, 10, 48) == tmt.launch_shape(59, 225, 10, 64)
    with pytest.raises(ValueError):
        tmt.launch_shape(59, 225, 10, 0)


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


@pytest.mark.parametrize("block_i", [8, 16, 48])
def test_multi_ttv_kernel_matches_the_reference_entry(block_i):
    """The low-level entry the package exports: unpadded, float32 out."""
    from repro.kernels import multi_ttv_kernel as jkernel
    from repro_torch.kernels import multi_ttv_kernel

    rng = _rng(block_i + 1)
    t = rng.standard_normal((5, 48, 6)).astype(np.float32)
    w = rng.standard_normal((5, 6)).astype(np.float32)
    before = _launches()
    out = multi_ttv_kernel(torch.from_numpy(t), torch.from_numpy(w), block_i=block_i)
    assert out.dtype == torch.float32 and tuple(out.shape) == (48, 6)
    _close(jkernel(jnp.asarray(t), jnp.asarray(w), block_i=block_i, interpret=True), out)
    assert _launches() == before


@pytest.mark.parametrize("block_i,block_batch", [(8, 1), (16, 2), (48, 4)])
def test_multi_ttv_batched_kernel_matches_the_reference_entry(block_i, block_batch):
    from repro.kernels import multi_ttv_batched_kernel as jkernel
    from repro_torch.kernels import multi_ttv_batched_kernel

    rng = _rng(block_i + block_batch)
    t = rng.standard_normal((4, 3, 48, 5)).astype(np.float32)
    w = rng.standard_normal((4, 3, 5)).astype(np.float32)
    before = _launches()
    out = multi_ttv_batched_kernel(torch.from_numpy(t), torch.from_numpy(w),
                                   block_i=block_i, block_batch=block_batch)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 48, 5)
    _close(jkernel(jnp.asarray(t), jnp.asarray(w), block_i=block_i, block_batch=block_batch,
                   interpret=True), out)
    assert _launches() == before


@pytest.mark.parametrize("case", ["w_shape", "unpadded_i", "batched_w_shape",
                                  "batched_unpadded_i", "batched_unpadded_s"])
def test_multi_ttv_kernels_raise_where_the_reference_raises(case):
    from repro.kernels import multi_ttv_batched_kernel as jbatched
    from repro.kernels import multi_ttv_kernel as jkernel
    from repro_torch.kernels import multi_ttv_batched_kernel, multi_ttv_kernel

    rng = _rng(7)
    t3 = rng.standard_normal((3, 10, 4)).astype(np.float32)
    t4 = rng.standard_normal((3, 2, 10, 4)).astype(np.float32)
    calls = {
        "w_shape": (jkernel, multi_ttv_kernel, t3, np.ones((3, 5), np.float32),
                    dict(block_i=5)),
        "unpadded_i": (jkernel, multi_ttv_kernel, t3, np.ones((3, 4), np.float32),
                       dict(block_i=4)),
        "batched_w_shape": (jbatched, multi_ttv_batched_kernel, t4,
                            np.ones((3, 4), np.float32), dict(block_i=5, block_batch=1)),
        "batched_unpadded_i": (jbatched, multi_ttv_batched_kernel, t4,
                               np.ones((3, 2, 4), np.float32), dict(block_i=4, block_batch=1)),
        "batched_unpadded_s": (jbatched, multi_ttv_batched_kernel, t4,
                               np.ones((3, 2, 4), np.float32), dict(block_i=5, block_batch=2)),
    }
    jfn, tfn, t, w, kw = calls[case]
    with pytest.raises(ValueError) as jerr:
        jfn(jnp.asarray(t), jnp.asarray(w), interpret=True, **kw)
    with pytest.raises(ValueError) as terr:
        tfn(torch.from_numpy(t), torch.from_numpy(w), **kw)
    assert str(terr.value) == str(jerr.value)
