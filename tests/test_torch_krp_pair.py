"""The Khatri-Rao pair kernel's launch geometry and CPU entry, on the CPU.

``krp_kernel.launch_shape`` is the whole of the CUDA kernel's geometry, so
the CPU can check it: :func:`_emulate` walks the grid as
``csrc/krp_pair.cu::krp_pair_kernel`` does (each block's tile and walker,
each thread's positions worked out once, the masked tail and last row
group) and writes every product it would write, counting the writes.  Every
output position of every row of A must be written exactly once, with
``a[ja, c] * b[jb, c]`` rounded once to the dtype, bitwise the plain
version.  The wrapper is driven through that emulation too, in place of
the launch, so its allocation, alignment test and counters run here.  The
CPU entry (the plain version) is held bitwise to the reference's Pallas
kernel in interpret mode.  The kernel itself runs on the card only
(``tests/test_torch_gpu.py``).
"""

import ctypes
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import given, settings, st
from repro.kernels import krp_kernel as jkrp
from repro_torch.kernels import krp_kernel as kk

ITEMSIZES = (2, 4, 8)
# The fMRI KRP's folds (225 x 59 x 200 x 200): U1 (.) U2, and the last fold
# (U1 (.) U2) (.) U3 at the main path's rank 10 and at rank 128.
FMRI_FOLDS = ((59, 200, 10), (11800, 200, 10), (11800, 200, 128))
DTYPES = {2: torch.bfloat16, 4: torch.float32, 8: torch.float64}


def _tile_positions(g, tile, threads=kk.THREADS):
    """Span positions of tile ``tile``'s vectors, as each thread works them
    out once: ``(per_thread * threads,)`` starts, thread-major within a
    vector index as in the kernel (vector ``k`` of thread ``t`` at
    ``tile * g.tile + t * vec + k * threads * vec``)."""
    t = np.arange(threads, dtype=np.int64)
    k = np.arange(g.per_thread, dtype=np.int64)
    return (tile * g.tile + t[None, :] * g.vec + k[:, None] * threads * g.vec).ravel()


def _emulate(g, dims, a, b, out=None):
    """The kernel's walk over the grid of ``g`` for ``a (ja, c)``, ``b (jb,
    c)`` (``dims``; flat tensors of one dtype), writing into ``out`` (flat;
    a new one if None).  Returns ``(out, writes)``, ``writes`` the count of
    stores a position took."""
    ja, jb, c = dims
    row = jb * c
    span = g.rows_per_step * row
    assert kk.HELD // g.vec >= g.per_thread
    out = torch.full((ja * row,), float("nan"), dtype=a.dtype) if out is None else out
    writes = torch.zeros(ja * row, dtype=torch.int32)
    groups = math.ceil(ja / g.rows_per_step)
    walkers = g.blocks // g.tiles
    v = np.arange(g.vec, dtype=np.int64)
    for tile in range(g.tiles):
        q = _tile_positions(g, tile)  # each vector's first position
        setup = q < span
        r, p = q // row, q % row
        c0 = p % c
        # the kernel's incremental column: cc = c0, then ++cc wrapping at c
        aoff = r[:, None] * c + (c0[:, None] + v[None, :]) % c
        bidx = p[:, None] + v[None, :]
        bval = b[torch.from_numpy(np.where(setup[:, None], bidx, 0))]
        for blk in range(tile, g.blocks, g.tiles):
            for grp in range(blk // g.tiles, groups, walkers):
                ja0 = grp * g.rows_per_step
                end = (min(ja - ja0, g.rows_per_step)) * row  # positions of the group
                live = q < end  # vectors of the masked tail or the missing rows fall out
                assert not (live & ~setup).any()
                pos = torch.from_numpy((ja0 * row + q[live, None] + v[None, :]).ravel())
                aval = a[torch.from_numpy(ja0 * c + aoff[live].ravel())]
                prod = aval.double() * bval[torch.from_numpy(live)].ravel().double()
                out[pos] = prod.to(a.dtype)
                writes[pos] += 1
    return out, writes


def _run(ja, jb, c, itemsize, aligned, seed=0):
    rng = np.random.default_rng(seed)
    dtype = DTYPES[itemsize]
    a = torch.from_numpy(rng.standard_normal((ja, c))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((jb, c))).to(dtype)
    g = kk.launch_shape(ja, jb, c, itemsize, aligned)
    out, writes = _emulate(g, (ja, jb, c), a.ravel(), b.ravel())
    return g, a, b, out, writes


def _check_once(ja, jb, c, itemsize, aligned):
    g, a, b, out, writes = _run(ja, jb, c, itemsize, aligned)
    assert bool((writes == 1).all()), f"{g}: positions written {writes.unique().tolist()} times"
    assert torch.equal(out.view(ja * jb, c), kk.krp_pair_plain(a, b))
    return g


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 5, 1), (7, 13, 3), (59, 200, 10), (5, 1, 4099),
                                  (2, 3000, 1), (17, 4, 9), (3, 260, 8), (33, 2, 2)])
def test_launch_shape_writes_every_position_once(dims, itemsize, aligned):
    g = _check_once(*dims, itemsize, aligned)
    assert g.tile == kk.THREADS * g.per_thread * g.vec


@settings(max_examples=40, deadline=None)
@given(ja=st.integers(1, 40), jb=st.integers(1, 300), c=st.integers(1, 40),
       itemsize=st.sampled_from(ITEMSIZES), aligned=st.booleans())
def test_launch_shape_sweep_writes_every_position_once(ja, jb, c, itemsize, aligned):
    _check_once(ja, jb, c, itemsize, aligned)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("dims", FMRI_FOLDS, ids=["first_fold", "last_fold", "last_fold_r128"])
def test_launch_shape_covers_the_fmri_folds_once(dims, itemsize):
    """At the fMRI folds (up to 302 M positions) the coverage is checked by
    its two factors: the tiles' vectors cover one step's span exactly once
    (masked past it), and the walkers visit every row group exactly once;
    a position (row, p) is then written by the one vector holding span
    position (row % g) * J_B * C + p in the one step of group row // g,
    which the last group's row mask keeps since row < J_A."""
    ja, jb, c = dims
    g = kk.launch_shape(ja, jb, c, itemsize, True)
    assert g.vec == 16 // itemsize  # the timed shapes take the 16-byte path
    span = g.rows_per_step * jb * c
    hits = np.zeros(g.tiles * g.tile, dtype=np.int64)
    for tile in range(g.tiles):
        q = _tile_positions(g, tile)
        np.add.at(hits, (q[:, None] + np.arange(g.vec)[None, :]).ravel(), 1)
    assert (hits[:span] == 1).all() and (hits[span:] <= 1).all()
    assert span > (g.tiles - 1) * g.tile  # no tile lies wholly past the span
    groups = math.ceil(ja / g.rows_per_step)
    walkers = g.blocks // g.tiles
    seen = np.zeros(groups, dtype=np.int64)
    for w in range(walkers):
        seen[w::walkers] += 1
    assert (seen == 1).all()
    assert g.blocks % g.tiles == 0 and walkers <= groups
    # the step's A values stay within the group's rows, a 32-bit offset
    assert g.rows_per_step * c <= 2**31 - 1 and g.rows_per_step <= ja


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("jb,c", [(200, 10), (200, 128), (13, 3), (1, 1), (7, 8), (3, 2), (1, 4),
                                  (70000, 3), (5, 6)])
def test_vector_path_exactly_when_the_span_is_whole_units_and_aligned(jb, c, itemsize, aligned):
    g = kk.launch_shape(11, jb, c, itemsize, aligned)
    whole = jb * c * itemsize % 16 == 0
    assert g.vec == (16 // itemsize if whole and aligned else 1)


def _entry_accepts(g, ja, jb, c, itemsize) -> bool:
    """The C entry's checks (``run_krp`` in ``csrc/krp_pair.cu``): a
    geometry it would launch rather than refuse."""
    row = jb * c
    return (1 <= g.tiles <= g.blocks <= 2**31 - 1 and g.blocks % g.tiles == 0
            and g.vec in (1, 16 // itemsize) and 1 <= g.per_thread <= kk.HELD // g.vec
            and g.rows_per_step >= 1 and g.rows_per_step * c <= 2**31 - 1
            and g.tiles * kk.THREADS * g.per_thread * g.vec >= g.rows_per_step * row
            and (g.vec == 1 or row % g.vec == 0))


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("dims", [(4, 70000, 3), (1, 70000, 1), (70000, 1, 1), (2**31 + 5, 1, 1),
                                  (1, 2**31 + 7, 1), (3, 1, 2**20), (1, 10**6, 4096), *FMRI_FOLDS])
def test_grid_stays_within_cuda_limits(dims, itemsize):
    """Every grid is one-dimensional, at most 2^31 - 1 blocks of 256
    threads, and at most the SMs' resident blocks unless a tile needs its
    own block; the (4 x 70000) product that the first kernel refused (past
    65535 tiles of B at block_b=1) launches once."""
    for aligned in (True, False):
        g = kk.launch_shape(*dims, itemsize, aligned)
        assert _entry_accepts(g, *dims, itemsize), g
        assert g.blocks <= max(kk.SMS * kk.BLOCKS_PER_SM, g.tiles)
        assert kk.THREADS <= 1024


def test_launch_shape_refuses_what_no_kernel_takes():
    for args in ((0, 3, 3, 4), (3, 0, 3, 4), (3, 3, 0, 4), (3, 3, 3, 16)):
        with pytest.raises(ValueError):
            kk.launch_shape(*args, True)


def _as_tensor(ptr, n, dtype):
    """The ``n`` elements of ``dtype`` at address ``ptr`` (CPU memory), shared."""
    size = torch.empty(0, dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * (n * size)).from_address(ptr), dtype=dtype)


@pytest.fixture
def emulated_launch(monkeypatch):
    """Route :func:`krp_kernel.krp_pair` on CPU tensors through the
    launch, with :func:`_emulate` in place of the CUDA kernel: the
    wrapper's allocation, alignment test, geometry and counters run as on
    the card.  Yields the list of recorded launch arguments."""
    calls = []
    suffixes = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float64: "f64"}
    dtypes = {v: k for k, v in suffixes.items()}

    def launch(a_ptr, b_ptr, out_ptr, ja, jb, c, vec, per_thread, rows, tiles, blocks, stream,
               suffix):
        calls.append((ja, jb, c, vec, per_thread, rows, tiles, blocks, stream, suffix))
        dtype = dtypes[suffix]
        g = kk.Launch(vec, per_thread, kk.THREADS * per_thread * vec, rows, tiles, blocks)
        _, writes = _emulate(g, (ja, jb, c), _as_tensor(a_ptr, ja * c, dtype),
                             _as_tensor(b_ptr, jb * c, dtype), _as_tensor(out_ptr, ja * jb * c, dtype))
        assert bool((writes == 1).all())
        kk.KERNEL.launches += 1

    monkeypatch.setattr(kk, "use_kernel", lambda *ts: True)
    monkeypatch.setattr(kk, "kernel_suffix", lambda *ops: suffixes[ops[0][1].dtype])
    monkeypatch.setattr(kk.KERNEL, "launch", launch)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    yield calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_wrapper_through_the_emulated_kernel(emulated_launch, dtype):
    """Each path through the wrapper: the fMRI first fold (16-byte path), a
    span off the 16-byte unit (7 x 13 at rank 3), B and then A as the
    second block of a contiguous (2, 13, 3) stack (B's alignment decides the
    path, A's does not), B one element past a 16-byte line, and 70000 rows
    of B at block_b=1.  Each is one launch, bitwise the plain version, and
    counted on ``vector_launches`` exactly when it took the 16-byte path."""
    rng = np.random.default_rng(34)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    stack, flat = rnd(2, 13, 3), rnd(1 + 200 * 10)
    cases = [
        (rnd(59, 10), rnd(200, 10), 512),
        (rnd(7, 3), rnd(13, 3), 512),
        (rnd(5, 3), stack[1], 512),
        (stack[1], rnd(200, 3), 512),
        (rnd(3, 10), flat[1:].view(200, 10), 512),
        (rnd(4, 3), rnd(70000, 3), 1),
    ]
    paths = []
    for a, b, block_b in cases:
        whole = b.numel() * b.element_size() % 16 == 0
        want_vec = whole and b.data_ptr() % 16 == 0  # (a CPU allocation may sit off a line)
        before = (kk.KERNEL.launches, kk.KERNEL.vector_launches)
        out = kk.krp_pair(a, b, block_b=block_b)
        got = (kk.KERNEL.launches - before[0], kk.KERNEL.vector_launches - before[1])
        assert got == (1, int(want_vec)), (tuple(a.shape), tuple(b.shape))
        assert out.dtype == dtype and torch.equal(out, kk.krp_pair_plain(a, b))
        paths.append(want_vec)
    assert len(emulated_launch) == len(cases) and set(paths) == {True, False}


def test_launch_geometry_does_not_depend_on_block_b(emulated_launch):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((23, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((41, 6)).astype(np.float32))
    outs = [kk.krp_pair(a, b, block_b=bb) for bb in (1, 7, 512)]
    assert len(set(emulated_launch)) == 1
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert "block_b" not in inspect.signature(kk.launch_shape).parameters


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_cpu_entry_is_bitwise_the_same_for_every_block_b(dtype):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((9, 5))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((14, 5))).to(dtype)
    outs = [kk.krp_pair(a, b, block_b=bb) for bb in (1, 7, 512)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(outs[0], kk.krp_pair_plain(a, b)) and outs[0].dtype == dtype


@pytest.mark.parametrize("dims,block_b", [((7, 13, 3), 13), ((59, 20, 10), 4), ((4, 30, 1), 1)])
def test_cpu_entry_is_the_reference_bitwise(dims, block_b):
    """One float32 multiply an entry in both: bitwise the Pallas kernel in
    interpret mode (its J_B a multiple of its block_b, as it requires)."""
    ja, jb, c = dims
    rng = np.random.default_rng(ja + jb)
    a = rng.standard_normal((ja, c)).astype(np.float32)
    b = rng.standard_normal((jb, c)).astype(np.float32)
    want = np.asarray(jkrp.krp_pair(jnp.asarray(a), jnp.asarray(b), block_b=block_b,
                                    interpret=True))
    got = kk.krp_pair(torch.from_numpy(a), torch.from_numpy(b), block_b=block_b)
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_fake_operand_raises_and_a_plain_one_does_not():
    """The dispatch rule every wrapper shares (``_tiling.use_kernel``): a
    dry-run's fake tensor raises, through ``is_fake``, and a plain tensor
    takes the short way (``_tiling._plain``) to the CPU's plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _tiling

    a, b = torch.ones(3, 2), torch.ones(4, 2)
    assert _tiling._plain(a) and not _tiling.use_kernel(a, b)
    with FakeTensorMode() as mode:
        fa = mode.from_tensor(a)
    assert not _tiling._plain(fa)
    with pytest.raises(ValueError, match="fake tensor"):
        kk.krp_pair(fa, b, block_b=4)
