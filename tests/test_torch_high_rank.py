"""The MTTKRP kernels at any CP rank, on the CPU.

A CTA of the port's MTTKRP body (``csrc/mttkrp_cluster.cuh``) keeps a
``(1, CP)`` accumulator row a thread, CP <= 64, so a rank above 64 is cut
into column blocks (``matrix_free.column_blocks``), each a block of grid x
of its own.  The kernel runs only on the card (``tests/test_torch_gpu.py``
holds it against its plain version there); here:

- the launch geometry at ranks 1..200: the column blocks cover the rank
  once, each padded to a compiled width, the grid and shared memory stay
  within the card's limits, and at rank <= 64 every field is the one the
  geometry had before column blocks (a frozen copy of it below);
- a replay of the kernel's index map: every output ``(i, c)`` written by
  exactly one CTA, every factor column read by one column block;
- the multi-TTV launch at large ranks;
- parity with the JAX reference at rank 80 (its Pallas kernels in
  interpret mode, the port's plain versions) for ``plan.cp_als`` under
  ``fused`` and ``matrix_free`` sweep by sweep, ``mttkrp_2step_kernel`` and
  the batched entries, at ``rtol=2e-4, atol=2e-5``;
- the fused and matrix-free entries in bf16 against the reference's, at its
  own bf16 tolerance (``tests/test_kernels.py::TOL``; every dtype at every
  entry is in ``tests/test_torch_dtypes.py``).

Inputs are made once with numpy from a seed and handed to both packages.
"""

import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.roofline as jroof
import repro.plan as jplan
import repro_torch.plan as tplan
import repro_torch.plan.cost as tcost
from repro.core.tensor_ops import tensor_norm as j_tensor_norm
from repro.kernels import matrix_free as jmf
from repro.kernels import multi_ttv as jmt
from repro.kernels import ops as jops
from repro_torch.kernels import _tiling as ttiling
from repro_torch.kernels import fused_mttkrp as tfused
from repro_torch.kernels import matrix_free as tmf
from repro_torch.kernels import multi_ttv as tmt
from repro_torch.kernels import ops as tops

TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)  # the reference's TOL[jnp.bfloat16]
RANKS = [1, 10, 64, 65, 80, 128, 129, 200]
PADDED = (4, 8, 12, 16, 24, 32, 48, 64)
BLOCK_ROWS = 32
GRID_X, GRID_YZ = 2**31 - 1, 65535
FMRI = (225, 59, 200, 200)
FLEET, FLEET_BATCH = (225, 200, 200), 8
# ragged shapes of orders 3..6
SHAPES = [(5, 6, 7), (33, 70, 129), (37, 23, 41, 30), (3, 4, 2, 3, 2), (2, 3, 2, 3, 2, 3)]


@pytest.fixture
def reference_constants(monkeypatch):
    """Price the port's plans with the reference's roofline constants."""
    monkeypatch.setattr(tcost, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(tcost, "HBM_BW", jroof.HBM_BW)


# ---- (a) the launch geometry


def _seed_geometry(shape, n, rank, slabs, bps):
    """The launch before column blocks (rank 1..64), field for field: a
    frozen copy of ``matrix_free._cluster_launch`` and the two splits as
    they were, to hold today's geometry to at rank <= 64."""
    order = len(shape)
    q = order - 2 if n == order - 1 else order - 1
    i_contig = n == order - 1
    cp = next(p for p in PADDED if rank <= p)
    res = 2 if cp <= 32 else 1
    budget = min(tmf.SMEM_BYTES, tmf.SM_SMEM_BYTES // res - tmf.BLOCK_RESERVED_SMEM)
    eq, chunks = shape[q], 1
    while True:
        q_chunk = 4 * -(-(-(-eq // chunks)) // 4)
        qs = q_chunk if i_contig else q_chunk + (36 - q_chunk % 32) % 32
        smem = 4 * max(3 * 32 * qs + 3 * 4 * cp + q_chunk * cp, 8 * cp * 32)
        if smem <= budget:
            break
        chunks += 1
    chunks = -(-eq // q_chunk)
    outer = math.prod(shape[k] for k in range(order) if k not in (n, q))
    row_blocks, steps = -(-shape[n] // 32), chunks * outer
    slots = tmf.CLUSTER_SLOTS[min(bps, res)]
    if slabs is None:  # unbatched_launch_shape's split
        waves = -(-row_blocks // slots[1])
        best = (0, 0, 0)
        for s in (1, 2, 4, 8):
            groups = min(waves * slots[s] // row_blocks, steps // s, 65535 // s)
            if groups >= 1:
                best = max(best, (row_blocks * groups * s, s, groups))
        groups, splits, slabs = best[2], best[1], 1
    else:  # launch_shape's split
        waves = {s: -(-(row_blocks * slabs) // slots[s]) for s in (1, 2, 4, 8) if s <= steps}
        fewest = min(waves.values())
        groups, splits = 1, max(s for s, w in waves.items() if w == fewest)
    return (row_blocks, groups, splits, slabs, outer, q_chunk, chunks, i_contig,
            shape[-1] % 4 == 0, smem, res)


def _spans(rank):
    """Column block b's columns ``[lo, hi)`` by the kernel's rule."""
    nb, w, _ = tmf.column_blocks(rank)
    return [(b * w, min(rank, (b + 1) * w)) for b in range(nb)]


def _launch(shape, n, rank, slabs, bps=4):
    if slabs is None:
        return tmf.unbatched_launch_shape(shape, n, rank, bps)
    return tmf.launch_shape(shape, n, rank, slabs, bps)


def _check_geometry(shape, n, rank, slabs, bps=4):
    g = _launch(shape, n, rank, slabs, bps)
    nb, w, cp = tmf.column_blocks(rank)
    # the column blocks cover [0, rank) exactly once, each <= 64 wide and
    # padded to a compiled width; the last is never empty
    assert (g.col_blocks, g.block_width, g.padded_rank) == (nb, w, cp)
    assert nb == -(-rank // 64) and w <= 64 and cp in PADDED and w <= cp
    spans = _spans(rank)
    assert all(0 < hi - lo <= w for lo, hi in spans)
    cols = collections.Counter(c for lo, hi in spans for c in range(lo, hi))
    assert cols == collections.Counter(range(rank))
    # grid, shared memory and residency within the card's limits
    assert g.grid_x == g.row_blocks * nb <= GRID_X
    assert g.groups * g.splits <= GRID_YZ and g.slabs <= GRID_YZ
    assert g.residency == tmf.residency(cp)
    assert g.smem == tmf.cluster_smem(g.q_chunk, cp, g.i_contig) <= tmf.SMEM_BYTES == 232448
    assert g.residency * (g.smem + tmf.BLOCK_RESERVED_SMEM) <= tmf.SM_SMEM_BYTES
    # every step in one part of each (row block, column block)
    parts = g.groups * g.splits
    assert parts <= g.steps
    seen = collections.Counter()
    for p in range(parts):
        lo, hi = tmf.part_steps(g.steps, p, parts)
        assert lo < hi
        seen.update(range(lo, hi))
    assert seen == collections.Counter(range(g.steps))
    # the waves count every block of grid x: no legal split runs fewer
    slots = tmf.CLUSTER_SLOTS[min(bps, g.residency)]
    if slabs is None:
        def waves(s, k):
            return math.ceil(g.grid_x * k / slots[s])

        legal = [(s, k) for s in tmf.SPLITS for k in range(1, min(g.steps // s, GRID_YZ // s) + 1)]
        fewest = min(waves(s, k) for s, k in legal)
        assert waves(g.splits, g.groups) == fewest
        assert (g.grid_x * g.groups * g.splits, g.splits) == max(
            (g.grid_x * k * s, s) for s, k in legal if waves(s, k) <= fewest)
    else:
        def waves(s):
            return math.ceil(g.grid_x * slabs / slots[s])

        legal = [s for s in tmf.SPLITS if s <= g.steps]
        assert g.groups == 1 and waves(g.splits) == min(waves(s) for s in legal)
        assert all(waves(s) > waves(g.splits) for s in legal if s > g.splits)
    # up to rank 64: today's launch, field for field
    if rank <= 64:
        assert tuple(g)[:11] == _seed_geometry(shape, n, rank, slabs, bps)
        assert (nb, w) == (1, rank)
    return g


@pytest.mark.parametrize("rank", RANKS)
def test_unbatched_geometry_of_the_fmri_tensor(rank):
    for bps in (1, 4):
        for n in range(4):
            _check_geometry(FMRI, n, rank, None, bps)
            t, _, _, pos = tops.bilinear_operands(
                torch.empty(FMRI, device="meta"), [torch.empty(d, 1, device="meta") for d in FMRI],
                n)
            _check_geometry(tuple(t.shape), pos, rank, None, bps)  # the fused entry's fold


@pytest.mark.parametrize("rank", RANKS)
def test_batched_geometry_of_the_fleet(rank):
    for bps in (1, 4):
        for n in range(3):
            _check_geometry(FLEET, n, rank, FLEET_BATCH, bps)
            _check_geometry(FLEET, n, rank, 5, bps)


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_geometry_of_ragged_orders_3_to_6(shape, rank):
    for n in range(len(shape)):
        _check_geometry(shape, n, rank, None)
        _check_geometry(shape, n, rank, 3)


def test_column_blocks_at_ranks_65_to_130():
    """Rank 80 is two blocks of 40 at width 48, rank 130 three of 44 (the
    last 42) at 48; up to 64 one block of the whole rank."""
    assert tmf.column_blocks(80) == (2, 40, 48) and _spans(80) == [(0, 40), (40, 80)]
    assert tmf.column_blocks(130) == (3, 44, 48) and _spans(130) == [(0, 44), (44, 88), (88, 130)]
    assert tmf.column_blocks(128) == (2, 64, 64) and tmf.column_blocks(64) == (1, 64, 64)
    assert tmf.column_blocks(65) == (2, 33, 48) and _spans(65) == [(0, 33), (33, 65)]
    assert [tmf.column_blocks(r)[:2] for r in (1, 10, 33)] == [(1, 1), (1, 10), (1, 33)]
    for rank in range(1, 2000):
        nb, w, cp = tmf.column_blocks(rank)
        assert (nb - 1) * w < rank <= nb * w and w <= cp <= 64
    with pytest.raises(ValueError):
        tmf.column_blocks(0)
    # the waves count both blocks at rank 128: fMRI mode 0 runs 4 groups of 2
    # where rank 64 alone runs 8 (one wave of 128 CTAs either way)
    g128, g64 = tmf.unbatched_launch_shape(FMRI, 0, 128), tmf.unbatched_launch_shape(FMRI, 0, 64)
    assert (g128.grid_x, g128.groups, g128.splits) == (16, 4, 2)
    assert (g64.grid_x, g64.groups, g64.splits) == (8, 8, 2)
    assert g128[4:11] == g64[4:11]  # the stage and residency of one block of 64


def test_the_wrappers_take_any_rank_and_no_other_dtype():
    """The wrappers take any rank >= 1, in float32, bfloat16, float16 and
    float64 (the name is the one this test had when float32 was the only
    dtype); a CPU operand is refused by the card's check."""
    for rank in (1, 64, 65, 80, 128, 1000):
        ttiling.check_rank(rank)
    with pytest.raises(ValueError, match="rank >= 1"):
        ttiling.check_rank(0)
    with pytest.raises(ValueError, match="on the card"):
        ttiling.check_kernel_operand("x", torch.empty(4, 4))
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        assert ttiling.kernels_take("cuda", dtype, 80)


# ---- (b) the kernel's index map, replayed


def _replay(g, rows, rank):
    """The output offsets the kernel's CTAs write, as the kernel computes
    them: CTA (x, part, z) with x = row block * nb + column block; rank 0 of
    each cluster writes element e of its block at row e // width, column
    e % width of the (slab, group) plane.  Returns the count of writes of
    each offset of the (slabs, groups, rows, rank) output and, for each
    row block, the count of reads of each factor column."""
    nb, w = g.col_blocks, g.block_width
    writes = np.zeros(g.slabs * g.groups * rows * rank, dtype=np.int64)
    reads = np.zeros((g.row_blocks, rank), dtype=np.int64)
    for x in range(g.grid_x):
        rb, cb = x // nb, x % nb
        c0 = cb * w
        width = min(w, rank - c0)
        i0 = rb * BLOCK_ROWS
        ni = min(BLOCK_ROWS, rows - i0)
        e = np.arange(ni * width)
        row, col = e // width, e % width
        within = row * rank + col
        for z in range(g.slabs):
            for group in range(g.groups):  # cluster rank 0 of part group * splits
                base = ((z * g.groups + group) * rows + i0) * rank + c0
                writes[base + within] += 1
        # U_q's chunk and the outer rows: columns c0 + c for c < width (the
        # rest of the CP padding masked to zero, never read)
        cp_cols = np.arange(g.padded_rank)
        reads[rb, c0 + cp_cols[cp_cols < width]] += 1
    return writes, reads


@pytest.mark.parametrize("rank", [10, 64, 65, 80, 128, 130, 200])
def test_every_output_is_written_by_exactly_one_cta(rank):
    for shape, slabs in ((FMRI, None), (FLEET, FLEET_BATCH), ((37, 23, 41, 30), 3),
                         ((2, 3, 2, 3, 2, 3), None)):
        for n in range(len(shape)):
            g = _launch(shape, n, rank, slabs)
            writes, reads = _replay(g, shape[n], rank)
            assert (writes == 1).all()
            assert (reads == 1).all()  # each row block reads every column once
            if slabs is None:
                ws = tmf.workspace_shape(g, shape[n], rank)
                assert ws == (None if g.groups == 1 else (g.groups, shape[n], rank))


# ---- multi-TTV at large ranks


def _ttv_outputs(g, dim_i, rank):
    """The outputs of one slab's plane each thread writes (the kernel's
    loop over chunks of 4 * TX outputs, VEC or strided)."""
    count = np.zeros(dim_i * rank, dtype=np.int64)
    tile = g.tile_rows * rank
    tx = np.arange(g.threads_x)
    for t in range(g.tiles):
        tile0 = t * tile
        length = min(dim_i * rank - tile0, tile)
        for o0 in range(0, length, 4 * g.threads_x):
            for k in range(4):
                o = o0 + 4 * tx + k if g.vec else o0 + tx + k * g.threads_x
                np.add.at(count, tile0 + o[o < length], 1)
    return count


@pytest.mark.parametrize("rank", RANKS + [1000])
@pytest.mark.parametrize("big_l,dim_i", [(225, 59), (200, 200), (13275, 7), (3, 1100)])
def test_multi_ttv_launch_at_large_ranks(big_l, dim_i, rank):
    """The C entry's conditions (multi_ttv.cu: run) hold and every output is
    summed by exactly one thread, at the default and the largest row tile."""
    for block_i in (256, 1024):
        g = tmt.launch_shape(dim_i, big_l, rank, block_i)
        tiles = -(-dim_i // g.tile_rows)
        assert g.tiles == tiles <= GRID_X and 1 <= g.tile_rows <= dim_i
        assert g.tile_rows * rank <= 2**30
        assert g.threads_x >= 32 and g.threads_x % 32 == 0 and g.threads_x * g.groups <= 1024
        assert g.cluster in (1, 2, 4, 8) and g.cluster * g.groups <= max(1, big_l)
        if g.vec:
            assert dim_i * rank % 4 == 0 and (tiles == 1 or g.tile_rows * rank % 4 == 0)
        assert (_ttv_outputs(g, dim_i, rank) == 1).all()


# ---- (c) parity at rank 80: plan.cp_als, the 2-step kernel path


def _data(shape, rank, seed, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x = rng.standard_normal(lead + tuple(shape)).astype(np.float32)
    fs = [rng.standard_normal(lead + (d, rank)).astype(np.float32) for d in shape]
    return x, fs


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.detach().float().numpy(), **tol)


def _plans(shape, rank, strategy, batch=None):
    kw = {} if batch is None else {"batch": batch}
    jp = jplan.plan_sweep(jplan.Problem(shape, rank, **kw), strategy,
                          tuning_cache=jplan.TuningCache())
    tp = tplan.plan_sweep(tplan.Problem(shape, rank, **kw), strategy,
                          tuning_cache=tplan.TuningCache())
    assert [m.algorithm for m in tp.nodes] == [m.algorithm for m in jp.nodes]
    assert {m.algorithm for m in tp.nodes} == {strategy}
    return jp, tp


def _sweeps(jp, tp, x, init, batch=None, sweeps=3):
    """Sweep by sweep from the same factors: every factor, the weights and
    the fit within TOL after each sweep."""
    rank = init[0].shape[-1]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    lead = () if batch is None else (batch,)
    js = jplan.SweepState(
        x=jx, factors=[jnp.asarray(u) for u in init], weights=jnp.ones(lead + (rank,)),
        norm_x=j_tensor_norm(jx, batched=batch is not None), it=jnp.asarray(0),
    )
    dims = tuple(range(1, tx.ndim)) if batch else None
    ts = tplan.SweepState(
        x=tx, factors=[torch.from_numpy(u) for u in init], weights=torch.ones(lead + (rank,)),
        norm_x=torch.linalg.vector_norm(tx, dim=dims), it=0,
    )
    launches = tfused.KERNEL.launches, tmf.KERNEL.launches
    for sweep in range(sweeps):
        js = jplan.als_sweep(jp.problem, jp, jplan.LocalExecutor(), js)
        ts = tplan.als_sweep(tp.problem, tp, tplan.LocalExecutor(), ts)
        for ju, tu in zip(js.factors, ts.factors):
            _close(ju, tu)
        _close(js.weights, ts.weights)
        _close(js.fit, ts.fit)
        js.it, ts.it = jnp.asarray(sweep + 1), sweep + 1
    assert (tfused.KERNEL.launches, tmf.KERNEL.launches) == launches  # plain versions on the CPU


@pytest.mark.parametrize("strategy", ["fused", "matrix_free"])
def test_rank_80_cp_als_matches_the_reference_sweep_by_sweep(reference_constants, strategy):
    shape, rank = (9, 7, 6, 8), 80
    x, init = _data(shape, rank, seed=4)
    jp, tp = _plans(shape, rank, strategy)
    _sweeps(jp, tp, x, init)


def test_rank_80_cp_als_front_door_matches_the_reference():
    """``plan.cp_als`` itself (the front door a user calls) under both
    kernel strategies: per-sweep fits and the final factors."""
    shape, rank = (9, 7, 6, 8), 80
    x, init = _data(shape, rank, seed=5)
    for strategy in ("fused", "matrix_free"):
        jp, tp = _plans(shape, rank, strategy)
        jfits, tfits = [], []
        jst = jplan.cp_als(jnp.asarray(x), jp, n_iters=3, tol=0.0,
                           init_factors=[jnp.asarray(u) for u in init],
                           callback=lambda i, f, s: jfits.append(f))
        tst = tplan.cp_als(torch.from_numpy(x), tp, n_iters=3, tol=0.0,
                           init_factors=[torch.from_numpy(u) for u in init],
                           callback=lambda i, f, s: tfits.append(f))
        np.testing.assert_allclose(jfits, tfits, **TOL)
        for ju, tu in zip(jst.factors, tst.factors):
            _close(ju, tu)


@pytest.mark.parametrize("rank", [80, 130])
def test_high_rank_kernel_entries_match_the_reference(rank):
    """The fused and matrix-free MTTKRP entries and the 2-step kernel path
    at every mode, against the reference's Pallas kernels (interpret)."""
    shape = (9, 7, 6, 8)
    x, fs = _data(shape, rank, seed=rank)
    jx, jf = jnp.asarray(x), [jnp.asarray(u) for u in fs]
    tx, tf = torch.from_numpy(x), [torch.from_numpy(u) for u in fs]
    for n in range(len(shape)):
        _close(jops.fused_mttkrp(jx, jf, n, interpret=True), tops.fused_mttkrp(tx, tf, n))
        _close(jmf.matrix_free_mttkrp(jx, jf, n, interpret=True),
               tmf.matrix_free_mttkrp(tx, tf, n))
        _close(jops.mttkrp_2step_kernel(jx, jf, n, interpret=True),
               tops.mttkrp_2step_kernel(tx, tf, n))


# ---- (d) the batched entries at rank 80


@pytest.mark.parametrize("strategy", ["fused", "matrix_free"])
def test_rank_80_batched_cp_als_matches_the_reference_sweep_by_sweep(reference_constants,
                                                                     strategy):
    # every mode's other extents multiply to >= 210 columns, so each
    # Hadamard of Grams is well conditioned at rank 80 (on a 3-way (7, 6, 9)
    # the Grams' product has rank <= 54 < 80: pinv of a singular matrix,
    # where fp32 summation orders part by more than the tolerance)
    shape, rank, batch = (8, 6, 5, 7), 80, 2
    x, init = _data(shape, rank, seed=6, batch=batch)
    jp, tp = _plans(shape, rank, strategy, batch=batch)
    _sweeps(jp, tp, x, init, batch=batch)


def test_rank_80_batched_kernel_entries_match_the_reference():
    shape, rank, batch = (5, 6, 7, 4), 80, 3
    x, fs = _data(shape, rank, seed=8, batch=batch)
    jx, jf = jnp.asarray(x), [jnp.asarray(u) for u in fs]
    tx, tf = torch.from_numpy(x), [torch.from_numpy(u) for u in fs]
    for n in range(len(shape)):
        _close(jops.fused_mttkrp_batched(jx, jf, n, interpret=True),
               tops.fused_mttkrp_batched(tx, tf, n))
        _close(jmf.matrix_free_mttkrp_batched(jx, jf, n, interpret=True),
               tmf.matrix_free_mttkrp_batched(tx, tf, n))
    rng = np.random.default_rng(9)
    t = rng.standard_normal((batch, 11, 13, rank)).astype(np.float32)
    w = rng.standard_normal((batch, 11, rank)).astype(np.float32)
    _close(jmt.multi_ttv_batched(jnp.asarray(t), jnp.asarray(w), interpret=True),
           tmt.multi_ttv_batched(torch.from_numpy(t), torch.from_numpy(w)))
    _close(jmt.multi_ttv(jnp.asarray(t[0]), jnp.asarray(w[0]), interpret=True),
           tmt.multi_ttv(torch.from_numpy(t[0]), torch.from_numpy(w[0])))


# ---- (e) bf16 operands at the fused and matrix-free entries


@pytest.mark.parametrize("entry", ["fused", "matrix_free"])
def test_fused_mttkrp_dtypes(entry):
    """The port's counterpart of the reference's
    ``tests/test_kernels.py::test_fused_mttkrp_dtypes`` in bf16: the same
    bf16 operands through the port's entry (its plain version, on the CPU)
    and the reference's Pallas kernel (interpret), at the reference's bf16
    tolerance.  The matrix-free kernels of both cast every tile to float32,
    so they are held to each other.  The fused ones are not: the reference
    forms each KRP tile and each step's product in bf16, the port sums in
    fp32, as its matrix-free fold.  So the port's fused result is held to
    the reference's kernel run on the same values in float32, at the bf16
    tolerance, and must be no farther from it than the reference's bf16
    run.  On the card the kernels take bf16 too; ``tests/test_torch_gpu.py``
    holds them to their plain versions there."""
    x, fs = _data((12, 10, 14), 8, seed=0)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jf = [jnp.asarray(u).astype(jnp.bfloat16) for u in fs]
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tf = [torch.from_numpy(u).to(torch.bfloat16) for u in fs]
    assert np.array_equal(np.asarray(jx, np.float32), tx.float().numpy())  # one rounding
    for n in range(3):
        if entry == "fused":
            want, got = jops.fused_mttkrp(jx, jf, n, interpret=True), tops.fused_mttkrp(tx, tf, n)
            exact = np.asarray(jops.fused_mttkrp(jx.astype(jnp.float32),
                                                 [u.astype(jnp.float32) for u in jf], n,
                                                 interpret=True))
            _close(exact, got, BF16_TOL)
            port_err = np.linalg.norm(got.float().numpy() - exact)
            assert port_err <= np.linalg.norm(np.asarray(want, np.float32) - exact)
        else:
            want = jmf.matrix_free_mttkrp(jx, jf, n, interpret=True)
            got = tmf.matrix_free_mttkrp(tx, tf, n)
            _close(want, got, BF16_TOL)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
