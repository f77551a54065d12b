"""The Hopper kernels' entries in bfloat16, float16 and float64, on the CPU.

The reference's Pallas kernels take every float dtype: its MTTKRP and
multi-TTV kernels declare a float32 output whatever they read (the
matrix-free one casts every tile to float32, the fused one forms its KRP
tile and each step's product in the operands' dtype, multi-TTV forms
``t * w`` in it and adds it to the float32 output), the KRP pair writes the
operands' dtype, and the wrappers cast back to ``x.dtype``.  The port's
CUDA kernels read each dtype at its own width and sum in fp32; they run only
on the card (``tests/test_torch_gpu.py``), and here the same entries take
their plain versions.  Checked, for each of the three dtypes:

- the result dtype of every kernel-level entry (rows 1-7 of PERF.md's
  kernel table, the batched twins included), of the ``ops`` wrappers and of
  ``matrix_free_mttkrp*``, against the reference's;
- the values against the reference's kernels (interpret mode), float64
  under ``jax.enable_x64(True)``: rows 2 and 4-6, which have the
  reference's algebra, at the port's fp32 tolerance ``rtol=2e-4,
  atol=2e-5``; row 7 bitwise.  Rows 1 and 3 sum in fp32 where the
  reference rounds each step to the operands' dtype: in float64 they are
  held at the fp32 tolerance; in 16 bits they are held to the reference's
  kernel run on the same values in float32, at the reference's bf16
  tolerance (``tests/test_kernels.py::TOL``), and must be no farther from it
  than the reference's 16-bit run.  The wrappers' 16-bit results, rounded
  to the operands' dtype, are held at the reference's bf16 tolerance;
- the dtype table and checks of ``kernels._tiling``, and the launch
  geometry at 2- and 8-byte elements: every column-block width's shared
  memory within the budget, the row padding and the 16-byte copies counted
  in bytes, the float32 geometry unchanged.

Inputs are made once in numpy float32 and rounded once on each side to the
dtype; both roundings are asserted equal.  The reference runs compiled with
XLA's ``xla_allow_excess_precision`` off (:func:`_ref`): by default XLA on
the CPU may drop a rounding to bf16 inside a compiled computation (it keeps
``(t * w).astype(float32)`` of bf16 operands at the exact product), where
the reference's code forms the product in bf16.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_mttkrp as jfused
from repro.kernels import krp_kernel as jkrp
from repro.kernels import matrix_free as jmf
from repro.kernels import multi_ttv as jmt
from repro.kernels import ops as jops
from repro_torch.kernels import _tiling as ttiling
from repro_torch.kernels import fused_mttkrp as tfm
from repro_torch.kernels import krp_kernel as tkrp
from repro_torch.kernels import matrix_free as tmf
from repro_torch.kernels import multi_ttv as tmt
from repro_torch.kernels import ops as tops

TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)  # the reference's TOL[jnp.bfloat16]
DTYPES = {
    "bf16": (torch.bfloat16, jnp.bfloat16),
    "f16": (torch.float16, jnp.float16),
    "f64": (torch.float64, jnp.float64),
}
VIEW = (6, 5, 7)
ORDER4 = (4, 5, 3, 6)
RANK = 5
SLABS = 2


def _ref(fn, *arrays):
    """``fn(*arrays)`` of the reference, compiled with excess precision off,
    so each operation rounds to the dtype its code states."""
    return jax.jit(fn).lower(*arrays).compile({"xla_allow_excess_precision": False})(*arrays)


def _x64(name):
    """The reference's float64 runs under ``jax.enable_x64`` (scoped)."""
    return jax.enable_x64(True) if name == "f64" else contextlib.nullcontext()


def _pair(a, name):
    """``a`` (numpy float32) rounded once to the dtype on each side: (jax
    array, torch tensor), asserted equal.  Call inside :func:`_x64`."""
    tdt, jdt = DTYPES[name]
    j = jnp.asarray(a).astype(jdt)
    t = torch.from_numpy(a).to(tdt)
    assert j.dtype == jdt
    assert np.array_equal(np.asarray(j, np.float64), t.double().numpy())
    return j, t


def _data(shape, rank, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + tuple(shape)).astype(np.float32)
    fs = [rng.standard_normal(lead + (d, rank)).astype(np.float32) for d in shape]
    return x, fs


def _np(v):
    return np.asarray(v.detach().double().numpy() if isinstance(v, torch.Tensor) else v,
                      np.float64)


def _close(want, got, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _check_dtype(want, got):
    """The port's result has the reference's dtype."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


# ---- the dtype table and checks


def test_kernels_take_the_four_dtypes_at_any_rank():
    cuda = torch.device("cuda")
    assert set(ttiling.KERNEL_DTYPES) == {torch.float32, torch.bfloat16, torch.float16,
                                         torch.float64}
    for dtype, (suffix, itemsize) in ttiling.KERNEL_DTYPES.items():
        assert torch.empty((), dtype=dtype).element_size() == itemsize
        assert suffix in ("f32", "bf16", "f16", "f64")
        for rank in (1, 10, 64, 80, 200):
            assert ttiling.kernels_take(cuda, dtype, rank)
        assert not ttiling.kernels_take(cuda, dtype, 0)
    for dtype in (torch.int32, torch.int64, torch.complex64, torch.uint8):
        assert not ttiling.kernels_take(cuda, dtype, 10)
        assert ttiling.kernels_take("cpu", dtype, 10)  # the plain versions take any
    assert not ttiling.kernels_take(torch.device("meta"), torch.bfloat16, 10)


@pytest.mark.parametrize("bad", [torch.int32, torch.complex64])
def test_check_kernel_operand_refuses_other_dtypes_naming_the_four(bad):
    with pytest.raises(TypeError, match="float32, bfloat16, float16, float64"):
        ttiling.check_kernel_operand("x", torch.zeros(3, dtype=bad))
    with pytest.raises(TypeError, match="float32, bfloat16, float16, float64"):
        ttiling.kernel_suffix(("x", torch.zeros(3, dtype=bad)))
    for dtype in ttiling.KERNEL_DTYPES:  # the dtype passes; the CPU device does not
        with pytest.raises(ValueError, match="on the card"):
            ttiling.check_kernel_operand("x", torch.zeros(3, dtype=dtype))


@pytest.mark.parametrize("second", [torch.float32, torch.float64, torch.float16, torch.int32])
def test_a_mix_of_dtypes_raises_naming_both(second):
    first = torch.bfloat16
    with pytest.raises(TypeError, match=r"y is torch\.\w+ and x torch\.bfloat16"):
        ttiling.kernel_suffix(("x", torch.zeros(3, dtype=first)), ("y", torch.zeros(3, dtype=second)))


# ---- the launch geometry at 2- and 8-byte elements

GEOMETRY_SHAPES = [(225, 59, 200, 200), (225, 200, 200), (225, 59, 20100), (33, 70, 129),
                   (37, 23, 41, 30), (5, 6, 7), (2, 3, 2, 3, 2, 3), (6, 5, 4000)]
RANKS = [1, 4, 10, 16, 24, 32, 48, 64, 80, 128]


def _budget(g):
    return min(tmf.SMEM_BYTES, tmf.SM_SMEM_BYTES // g.residency - tmf.BLOCK_RESERVED_SMEM)


@pytest.mark.parametrize("itemsize", [2, 8])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_the_geometry_at_2_and_8_byte_elements(shape, itemsize):
    """Every column-block width's stages fit the shared memory that lets
    its residency share an SM; the chunk of q is a multiple of the
    element type's need and covers q; the 16-byte copies and the row
    padding are counted in bytes; the rest of the launch is the float32
    one's (the element type changes only the stage)."""
    for rank in RANKS:
        for n in range(len(shape)):
            for g, g32 in ((tmf.unbatched_launch_shape(shape, n, rank, itemsize=itemsize),
                            tmf.unbatched_launch_shape(shape, n, rank)),
                           (tmf.launch_shape(shape, n, rank, 8, itemsize=itemsize),
                            tmf.launch_shape(shape, n, rank, 8))):
                eq = shape[tmf.contracted_mode(len(shape), n)]
                mult = tmf.q_multiple(g.i_contig, itemsize)
                assert mult == (8 if itemsize == 2 and not g.i_contig else 4)
                assert g.q_chunk % mult == 0 and g.q_chunk <= mult * -(-eq // mult)
                assert g.chunks == -(-eq // g.q_chunk)
                assert g.smem == tmf.cluster_smem(g.q_chunk, g.padded_rank, g.i_contig, itemsize)
                assert g.smem <= _budget(g)
                assert g.vec == (shape[-1] * itemsize % 16 == 0)
                qs = tmf.row_stride(g.q_chunk, itemsize)
                assert qs >= g.q_chunk and qs * itemsize % 128 == 16
                assert (g.row_blocks, g.residency, g.col_blocks, g.block_width, g.padded_rank,
                        g.i_contig, g.outer) == (g32.row_blocks, g32.residency, g32.col_blocks,
                                                 g32.block_width, g32.padded_rank,
                                                 g32.i_contig, g32.outer)


def test_every_column_block_width_fits_at_each_itemsize():
    """The widest stage a launch can ask for (the whole of a long q, one
    CTA an SM at width 64) still fits: the chunking loop ends within the
    budget at every padded width and itemsize."""
    for itemsize in (2, 4, 8):
        for cp in ttiling.PADDED_RANKS:
            rank = cp
            for shape, n in (((3, 5, 100000), 0), ((100000, 5, 3), 2), ((40, 7, 9000), 1)):
                g = tmf.unbatched_launch_shape(shape, n, rank, itemsize=itemsize)
                assert g.padded_rank == cp and g.smem <= _budget(g)
                assert tmf.cluster_smem(g.q_chunk, cp, g.i_contig, itemsize) <= _budget(g)


def test_row_padding_and_copies_in_bytes():
    """The row stride is 16 mod 128 bytes at every element size (4 mod 32
    floats, as before; 8 mod 64 16-bit elements; 2 mod 16 doubles), and a
    16-byte copy needs the contiguous extent's bytes a multiple of 16."""
    for qc in range(4, 400, 4):
        assert tmf.row_stride(qc, 4) == qc + (36 - qc % 32) % 32  # the float32 rule
        assert tmf.row_stride(qc, 2) % 64 == 8 and tmf.row_stride(qc, 8) % 16 == 2
        for isz in (2, 4, 8):
            assert 0 <= tmf.row_stride(qc, isz) - qc < 128 // isz
    assert tmf.cluster_smem(200, 12, False) == tmf.cluster_smem(200, 12, False, 4)
    for extent, want in ((200, (True, True, True)), (20100, (False, True, True)),
                         (4, (False, True, True)), (8, (True, True, True)),
                         (129, (False, False, False)), (2, (False, False, True))):
        got = tuple(tmf.unbatched_launch_shape((3, 5, extent), 0, 10, itemsize=isz).vec
                    for isz in (2, 4, 8))
        assert got == want, extent
    # the fMRI tensor at rank 10: in 16 bits the whole q fits a stage, as in
    # float32; in float64 a stage holds half of it (two chunks of 100)
    for n in range(4):
        g2, g8 = (tmf.unbatched_launch_shape((225, 59, 200, 200), n, 10, itemsize=isz)
                  for isz in (2, 8))
        assert (g2.q_chunk, g2.chunks, g8.q_chunk, g8.chunks) == (200, 1, 100, 2)


def test_the_float32_geometry_is_the_default():
    """``itemsize`` 4 is the default, and the float32 launch of every shape
    and rank is the one its callers got before (the frozen copies of
    tests/test_torch_high_rank.py hold it field for field)."""
    for shape in GEOMETRY_SHAPES:
        for rank in RANKS:
            for n in range(len(shape)):
                assert (tmf.unbatched_launch_shape(shape, n, rank)
                        == tmf.unbatched_launch_shape(shape, n, rank, 4, 4))
                assert tmf.launch_shape(shape, n, rank, 8) == tmf.launch_shape(shape, n, rank, 8, 4, 4)
                pos = n if len(shape) == 3 else None
                if pos is not None:
                    assert tfm.launch_geometry(shape, pos, rank, 8, itemsize=2) == tmf.launch_shape(
                        shape, n, rank, 8, itemsize=2)


# ---- the kernel-level entries against the reference's kernels


def _fused_operands(pos, name, lead=()):
    rng = np.random.default_rng(10 + pos + 3 * len(lead))
    dims = list(VIEW)
    ab = [d for k, d in enumerate(dims) if k != pos]
    t = rng.standard_normal(lead + tuple(dims)).astype(np.float32)
    a = rng.standard_normal(lead + (ab[0], RANK)).astype(np.float32)
    b = rng.standard_normal(lead + (ab[1], RANK)).astype(np.float32)
    return t, a, b, dims[pos], ab[1]


def _fused_ref(t, a, b, pos, dim_i, dim_b, batched):
    if batched:
        return _ref(lambda t, a, b: jfused.fused_mttkrp_bilinear_batched(
            t, a, b, pos=pos, block_i=dim_i, block_b=dim_b, block_batch=SLABS, interpret=True),
            t, a, b)
    return _ref(lambda t, a, b: jfused.fused_mttkrp_bilinear(
        t, a, b, pos=pos, block_i=dim_i, block_b=dim_b, interpret=True), t, a, b)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("pos", [0, 1, 2])
@pytest.mark.parametrize("name", list(DTYPES))
def test_fused_kernels_in_each_dtype(name, pos, batched):
    """Rows 1 and 3: float32 out, as the reference's; float64 at the fp32
    tolerance; 16 bits held to the reference's kernel on the same values in
    float32 at its bf16 tolerance, and no farther from it than the
    reference's own 16-bit run (which rounds each KRP tile and each step's
    product to 16 bits)."""
    lead = (SLABS,) if batched else ()
    t, a, b, dim_i, dim_b = _fused_operands(pos, name, lead)
    port = tfm.fused_mttkrp_bilinear_batched if batched else tfm.fused_mttkrp_bilinear
    with _x64(name):
        (jt, tt), (ja, ta), (jb, tb) = _pair(t, name), _pair(a, name), _pair(b, name)
        want = _fused_ref(jt, ja, jb, pos, dim_i, dim_b, batched)
        exact = _fused_ref(*(v.astype(jnp.float32) for v in (jt, ja, jb)), pos, dim_i, dim_b,
                           batched)
    got = port(tt, ta, tb, pos=pos)
    _check_dtype(want, got)
    assert got.dtype == torch.float32
    if name == "f64":
        _close(want, got, TOL)
        return
    _close(exact, got, BF16_TOL)
    assert np.linalg.norm(_np(got) - _np(exact)) <= np.linalg.norm(_np(want) - _np(exact))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("shape", [VIEW, ORDER4])
@pytest.mark.parametrize("name", list(DTYPES))
def test_matrix_free_kernels_in_each_dtype(name, shape, batched):
    """Rows 2 and 4, every mode: both cast every operand to float32 and
    fold in fp32, so the reference's algebra at the fp32 tolerance."""
    lead = (SLABS,) if batched else ()
    x, fs = _data(shape, RANK, seed=len(shape) + 7 * batched, lead=lead)
    with _x64(name):
        jx, tx = _pair(x, name)
        pairs = [_pair(u, name) for u in fs]
        for n in range(len(shape)):
            others = [k for k in range(len(shape)) if k != n]
            jus = [pairs[k][0] for k in others]
            tus = [pairs[k][1] for k in others]
            blocks = [shape[k] for k in others]
            if batched:
                want = _ref(lambda x, *us: jmf.matrix_free_batched_kernel(
                    x, us, n, block_i=shape[n], blocks=blocks, block_batch=SLABS,
                    interpret=True), jx, *jus)
                got = tmf.matrix_free_batched_kernel(tx, tus, n)
            else:
                want = _ref(lambda x, *us: jmf.matrix_free_kernel(
                    x, us, n, block_i=shape[n], blocks=blocks, interpret=True), jx, *jus)
                got = tmf.matrix_free_kernel(tx, tus, n)
            _check_dtype(want, got)
            assert got.dtype == torch.float32
            _close(want, got, TOL)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(DTYPES))
def test_multi_ttv_kernels_in_each_dtype(name, batched):
    """Rows 5 and 6: ``t * w`` rounded to the dtype (a product of doubles
    to float32), summed in fp32, float32 out, as the reference's."""
    rng = np.random.default_rng(30 + batched)
    lead = (SLABS,) if batched else ()
    big_l, dim_i = 5, 8
    t = rng.standard_normal(lead + (big_l, dim_i, RANK)).astype(np.float32)
    w = rng.standard_normal(lead + (big_l, RANK)).astype(np.float32)
    with _x64(name):
        (jt, tt), (jw, tw) = _pair(t, name), _pair(w, name)
        if batched:
            want = _ref(lambda t, w: jmt.multi_ttv_batched_kernel(
                t, w, block_i=dim_i, block_batch=SLABS, interpret=True), jt, jw)
            got = tmt.multi_ttv_batched_kernel(tt, tw, block_i=dim_i, block_batch=SLABS)
        else:
            want = _ref(lambda t, w: jmt.multi_ttv_kernel(t, w, block_i=dim_i, interpret=True),
                        jt, jw)
            got = tmt.multi_ttv_kernel(tt, tw, block_i=dim_i)
    _check_dtype(want, got)
    assert got.dtype == torch.float32
    _close(want, got, TOL)
    # the products are rounded to the dtype before the fp32 sum: the plain
    # version is that sum, not a sum of exact products
    prods = (tt * (tw[..., None, :])).to(torch.float32)
    assert torch.equal(tmt.multi_ttv_batched_plain(tt, tw) if batched
                       else tmt.multi_ttv_plain(tt, tw), prods.sum(-3))


@pytest.mark.parametrize("name", list(DTYPES))
def test_krp_pair_in_each_dtype_is_the_reference_bitwise(name):
    """Row 7: the operands' dtype out, each product rounded once to it,
    bitwise the reference's."""
    rng = np.random.default_rng(40)
    a = rng.standard_normal((7, RANK)).astype(np.float32)
    b = rng.standard_normal((9, RANK)).astype(np.float32)
    with _x64(name):
        (ja, ta), (jb, tb) = _pair(a, name), _pair(b, name)
        want = _ref(lambda a, b: jkrp.krp_pair(a, b, block_b=9, interpret=True), ja, jb)
    got = tkrp.krp_pair(ta, tb, block_b=4)
    _check_dtype(want, got)
    assert got.dtype == DTYPES[name][0]
    assert np.array_equal(_np(got), _np(want))


# ---- the wrappers


def _wrapper_tol(name):
    return TOL if name == "f64" else BF16_TOL


@pytest.mark.parametrize("name", list(DTYPES))
def test_ops_mttkrp_wrappers_in_each_dtype(name):
    """``ops.fused_mttkrp``, ``matrix_free_mttkrp`` and their batched twins
    return ``x.dtype`` as the reference's do; values at the fp32 tolerance
    in float64, at the reference's bf16 tolerance in 16 bits (a result
    rounded to 16 bits)."""
    x, fs = _data(ORDER4, RANK, seed=50)
    xb, fb = _data(VIEW, RANK, seed=51, lead=(SLABS,))
    tol = _wrapper_tol(name)
    with _x64(name):
        jx, tx = _pair(x, name)
        jf, tf = zip(*(_pair(u, name) for u in fs))
        jxb, txb = _pair(xb, name)
        jfb, tfb = zip(*(_pair(u, name) for u in fb))
        for n in range(len(ORDER4)):
            for jfn, tfn in ((jops.fused_mttkrp, tops.fused_mttkrp),
                             (jmf.matrix_free_mttkrp, tmf.matrix_free_mttkrp)):
                want = _ref(lambda x, *f: jfn(x, f, n, interpret=True), jx, *jf)
                got = tfn(tx, list(tf), n)
                _check_dtype(want, got)
                assert got.dtype == DTYPES[name][0]
                _close(want, got, tol)
        for n in range(len(VIEW)):
            for jfn, tfn in ((jops.fused_mttkrp_batched, tops.fused_mttkrp_batched),
                             (jmf.matrix_free_mttkrp_batched, tmf.matrix_free_mttkrp_batched)):
                want = _ref(lambda x, *f: jfn(x, f, n, interpret=True), jxb, *jfb)
                got = tfn(txb, list(tfb), n)
                _check_dtype(want, got)
                assert got.dtype == DTYPES[name][0]
                _close(want, got, tol)


@pytest.mark.parametrize("name", list(DTYPES))
def test_2step_multi_ttv_and_krp_wrappers_in_each_dtype(name):
    """``mttkrp_2step_kernel`` (its partial product a plain matmul in the
    operands' dtype, as the reference's ``@``; modes 1 and 2, and the fused
    fallback of mode 0), ``multi_ttv*`` and ``krp_materialize`` return the
    operands' dtype as the reference's do."""
    x, fs = _data(ORDER4, RANK, seed=60)
    rng = np.random.default_rng(61)
    t = rng.standard_normal((SLABS, 5, 9, RANK)).astype(np.float32)
    w = rng.standard_normal((SLABS, 5, RANK)).astype(np.float32)
    tol = _wrapper_tol(name)
    with _x64(name):
        jx, tx = _pair(x, name)
        jf, tf = zip(*(_pair(u, name) for u in fs))
        for n in (0, 1, 2):
            want = _ref(lambda x, *f: jops.mttkrp_2step_kernel(x, f, n, interpret=True), jx, *jf)
            got = tops.mttkrp_2step_kernel(tx, list(tf), n)
            _check_dtype(want, got)
            _close(want, got, tol)
        (jt, tt), (jw, tw) = _pair(t, name), _pair(w, name)
        for want, got in ((_ref(lambda t, w: jmt.multi_ttv(t, w, interpret=True), jt[0], jw[0]),
                           tmt.multi_ttv(tt[0], tw[0])),
                          (_ref(lambda t, w: jmt.multi_ttv_batched(t, w, interpret=True), jt, jw),
                           tmt.multi_ttv_batched(tt, tw))):
            _check_dtype(want, got)
            assert got.dtype == DTYPES[name][0]
            _close(want, got, tol)
        want = _ref(lambda *f: jops.krp_materialize(f, interpret=True), *jf[:3])
    got = tops.krp_materialize(list(tf[:3]))
    _check_dtype(want, got)
    assert np.array_equal(_np(got), _np(want))  # each fold rounded once to the dtype


def test_float64_mttkrp_is_accurate_to_float32_as_the_reference():
    """In float64 every MTTKRP kernel entry sums in fp32, exactly as the
    reference's kernels do under x64: the ``ops`` result is float64 at
    float32 accuracy, bitwise the float32 run's value widened."""
    x, fs = _data(ORDER4, RANK, seed=70)
    tx64 = torch.from_numpy(x).double()
    tf64 = [torch.from_numpy(u).double() for u in fs]
    tx32 = torch.from_numpy(x)
    tf32 = [torch.from_numpy(u) for u in fs]
    for n in range(len(ORDER4)):
        for fn in (tops.fused_mttkrp, tmf.matrix_free_mttkrp):
            got = fn(tx64, tf64, n)
            assert got.dtype == torch.float64
            assert torch.equal(got, fn(tx32, tf32, n).double())
    exact = np.einsum("abcd,bz,cz,dz->az", x.astype(np.float64),
                      *(u.astype(np.float64) for u in fs[1:]))
    with jax.enable_x64(True):
        want = _ref(lambda x, *f: jops.fused_mttkrp(x, f, 0, interpret=True),
                    jnp.asarray(x, jnp.float64), *(jnp.asarray(u, jnp.float64) for u in fs))
    assert want.dtype == jnp.float64
    scale = np.abs(exact).max()
    assert 0 < np.abs(np.asarray(want) - exact).max() / scale < 1e-5  # float32 accuracy
    got = tops.fused_mttkrp(tx64, tf64, 0)
    assert np.abs(got.numpy() - exact).max() / scale < 1e-5


def test_every_dtype_of_a_row_counts_on_one_counter():
    """One counter a row: every element type's entry of a kernel is one
    ``CudaKernel`` (its float32 source and the other types' sources), so a
    launch in any dtype counts on the row's counter."""
    for kernel in (tfm.KERNEL, tfm.BATCHED_KERNEL, tmf.KERNEL, tmf.BATCHED_KERNEL, tmf.OCCUPANCY,
                   tmt.KERNEL, tmt.BATCHED_KERNEL, tkrp.KERNEL):
        assert set(kernel.entries) == {"f32", "bf16", "f16", "f64"}
        stem = kernel.symbol.removesuffix("f32")
        for suffix, (source, symbol) in kernel.entries.items():
            assert symbol == stem + suffix and source.exists()
    assert {s.name for s in tmf.KERNEL.sources} == {
        "matrix_free.cu", "mttkrp_bf16.cu", "mttkrp_f16.cu", "mttkrp_f64.cu"}
    assert tfm.KERNEL.sources[1:] == tmf.KERNEL.sources[1:]
    assert [s.name for s in tmt.KERNEL.sources] == ["multi_ttv.cu"]


def test_the_2step_partial_product_stays_in_the_operands_dtype():
    """The 2-step algorithm's partial MTTKRP is a plain matmul in the
    operands' dtype (the reference's ``@``): the multi-TTV operands are of
    ``x.dtype``."""
    x, fs = _data(ORDER4, RANK, seed=80)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        t, w = tops.multi_ttv_operands(torch.from_numpy(x).to(dtype),
                                       [torch.from_numpy(u).to(dtype) for u in fs], 1)
        assert t.dtype == w.dtype == dtype
        assert math.prod(t.shape) > 0
