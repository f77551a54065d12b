"""The matrix-free CUDA kernel's launch geometry, on the CPU.

``repro_torch.kernels.matrix_free.launch_shape`` (a stack of tensors) and
``unbatched_launch_shape`` (one tensor) are pure Python: they size the
launches of ``matrix_free_cluster_kernel`` (csrc/matrix_free.cu) from the
shape alone.  The kernel runs only on the card (``tests/test_torch_gpu.py``
holds it against its plain version there); here the geometry is checked to
cover the work exactly once and to stay inside the card's limits, and the
kernel's per-thread copy loop is replayed to show that it copies every
element of a tile exactly once.  A row block's work is its steps, one
(chunk of q, outer index) pair each, chunk outer; the parts of a launch
cut that flat step range (``tests/test_torch_fused.py`` replays the walk).
"""

import collections
import math

import numpy as np
import pytest

from repro_torch.kernels import matrix_free as tmf

THREADS = 256
BLOCK_ROWS = 32
GRID_X, GRID_YZ = 2**31 - 1, 65535

# Ragged shapes of orders 3..6 (extents that are and are not multiples of 4
# and of 32), and the serving fleet's subject tensor.
SHAPES = [
    (5, 6, 7),
    (33, 70, 129),
    (65, 3, 40, 8),
    (37, 23, 41, 30),
    (3, 4, 2, 3, 2),
    (12, 10, 8, 9, 11),
    (2, 3, 2, 3, 2, 3),
    (6, 7, 5, 8, 6, 7),
]
FLEET = (225, 200, 200)


def _cover(steps, splits):
    """Each step's cluster ranks, by the kernel's balanced cut of the flat
    step range ([S r / splits, S (r + 1) / splits) for rank r)."""
    seen = collections.Counter()
    for r in range(splits):
        lo, hi = tmf.part_steps(steps, r, splits)
        assert (lo, hi) == (steps * r // splits, steps * (r + 1) // splits)
        assert lo < hi, "an empty rank"
        seen.update(range(lo, hi))
    return seen


def _check(shape, n, rank, slabs):
    g = tmf.launch_shape(shape, n, rank, slabs)
    order = len(shape)
    q = tmf.contracted_mode(order, n)
    outer = math.prod(shape[k] for k in range(order) if k not in (n, q))
    # every (slab, row) in exactly one CTA: slab = grid z, BLOCK_ROWS rows a row block
    assert g.slabs == slabs and g.outer == outer and g.groups == 1
    assert (g.row_blocks - 1) * BLOCK_ROWS < shape[n] <= g.row_blocks * BLOCK_ROWS
    # every step (chunk of q, outer index) in exactly one rank of its cluster;
    # the cluster is grid y
    assert g.steps == g.chunks * outer
    assert g.splits in tmf.SPLITS and g.splits <= g.steps
    assert _cover(g.steps, g.splits) == collections.Counter(range(g.steps))
    # every index of q in exactly one chunk of a multiple of 4
    assert g.q_chunk % 4 == 0 and g.q_chunk >= 4
    assert (g.chunks - 1) * g.q_chunk < shape[q] <= g.chunks * g.q_chunk
    # shared memory and grid limits
    assert g.smem == tmf.cluster_smem(g.q_chunk, _padded(rank), g.i_contig)
    assert g.smem <= tmf.SMEM_BYTES
    assert g.residency * (g.smem + tmf.BLOCK_RESERVED_SMEM) <= tmf.SM_SMEM_BYTES
    assert g.row_blocks <= GRID_X and g.splits <= GRID_YZ and g.slabs <= GRID_YZ
    # 16-byte copies follow the contiguous axis' extent; the target is contiguous when last
    assert g.i_contig == (n == order - 1)
    assert g.vec == (shape[-1] % 4 == 0)
    return g


def _padded(rank):
    return next(p for p in (4, 8, 12, 16, 24, 32, 48, 64) if rank <= p)


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
@pytest.mark.parametrize("slabs", [1, 5, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_shape_covers_the_work_once_within_the_limits(shape, slabs, rank):
    for n in range(len(shape)):
        _check(shape, n, rank, slabs)


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
@pytest.mark.parametrize("slabs", [1, 5, 8])
def test_launch_shape_of_the_fleet(slabs, rank):
    for n in range(3):
        _check(FLEET, n, rank, slabs)


def test_the_fleet_batch_fits_the_cards_slots_with_whole_q_tiles():
    """8 subjects, rank 10: one wave each, the whole q extent of 200 in
    every stage.  Modes 1 and 2: 56 clusters of 4, 224 CTAs.  Mode 0: 64
    clusters of 2, 128 CTAs -- an H100 holds 62 clusters of 4 (248 of its
    264 CTA slots), so mode 0's 64 clusters of 4 (256 CTAs, the launch when
    slots were counted by SM) ran a second wave of 8 CTAs."""
    for n, row_blocks, splits in ((0, 8, 2), (1, 7, 4), (2, 7, 4)):
        g = tmf.launch_shape(FLEET, n, 10, 8)
        assert (g.row_blocks, g.splits, g.slabs, g.q_chunk, g.chunks) == (
            row_blocks, splits, 8, 200, 1)
        assert g.residency == 2 and g.vec
        assert g.row_blocks * g.splits * g.slabs <= tmf.SMS * g.residency
        assert g.row_blocks * g.slabs <= tmf.CLUSTER_SLOTS[2][g.splits]  # one wave
    assert 8 * 8 > tmf.CLUSTER_SLOTS[2][4]


@pytest.mark.parametrize("rank", [1, 10, 64])
@pytest.mark.parametrize("slabs", [1, 5, 8, 59])
@pytest.mark.parametrize("shape", SHAPES + [FLEET], ids=lambda s: "x".join(map(str, s)))
def test_splits_fill_whole_waves(shape, slabs, rank):
    """Wave slots counted by cluster: no other split in {1, 2, 4, 8} takes
    fewer waves of the clusters the card holds, and none as few runs more
    CTAs; blocks_per_sm caps the CTAs an SM counts."""
    for bps in (1, 2, 4, 16):
        for n in range(len(shape)):
            g = tmf.launch_shape(shape, n, rank, slabs, bps)
            slots = tmf.CLUSTER_SLOTS[min(bps, g.residency)]

            def waves(s):
                return math.ceil(g.row_blocks * slabs / slots[s])

            legal = [s for s in tmf.SPLITS if s <= g.steps]
            assert waves(g.splits) == min(waves(s) for s in legal)
            assert all(waves(s) > waves(g.splits) for s in legal if s > g.splits)
    # at and above the residency the knob changes nothing
    assert tmf.launch_shape(FLEET, 0, 10, 8, 2) == tmf.launch_shape(FLEET, 0, 10, 8, 16)
    with pytest.raises(ValueError):
        tmf.launch_shape(FLEET, 0, 10, 8, 0)


def test_long_contracted_modes_are_cut_into_equal_chunks():
    # the 3-way linearization's q (20100) does not fit a stage: equal chunks that do
    g = tmf.launch_shape((225, 59, 20100), 1, 10, 3)
    assert g.chunks > 1 and g.q_chunk * g.chunks - 20100 < 4 * g.chunks
    smem_budget = tmf.SM_SMEM_BYTES // g.residency - tmf.BLOCK_RESERVED_SMEM
    assert tmf.cluster_smem(g.q_chunk, 12, False) <= smem_budget
    assert tmf.cluster_smem(g.q_chunk + 4, 12, False) > smem_budget or g.chunks == 1
    # rank 64 keeps one CTA an SM and the whole fleet q extent
    g = tmf.launch_shape(FLEET, 0, 64, 8)
    assert (g.residency, g.chunks, g.q_chunk) == (1, 1, 200)


def _copies(g, ni):
    """Replay the kernel's copy loop (``issue`` in csrc/matrix_free.cu) for
    all 256 threads of one tile with ``ni`` rows: the count of each tile
    element copied, as ``(row, index of q)``."""
    width = 4 if g.vec else 1
    upr = BLOCK_ROWS // width if g.i_contig else g.q_chunk // width
    n_r = g.q_chunk if g.i_contig else ni
    c_step, u_step = divmod(THREADS, upr)
    seen = collections.Counter()
    for t in range(THREADS):
        r, u = divmod(t, upr)
        while r < n_r:
            if u >= upr:
                u -= upr
                r += 1
                if r >= n_r:
                    break
            i = u * width if g.i_contig else r
            j = r if g.i_contig else u * width
            if not (g.i_contig and i >= ni):
                for k in range(width):
                    seen[(i + k, j) if g.i_contig else (i, j + k)] += 1
            r += c_step
            u += u_step
    return seen


@pytest.mark.parametrize("rank", [10, 64])
@pytest.mark.parametrize(
    "shape", [FLEET, (225, 59, 20100)] + SHAPES, ids=lambda s: "x".join(map(str, s))
)
def test_the_copy_loop_copies_every_tile_element_once(shape, rank):
    for n in range(len(shape)):
        g = tmf.launch_shape(shape, n, rank, 1)
        tails = {BLOCK_ROWS, shape[n] - (g.row_blocks - 1) * BLOCK_ROWS}
        for ni in tails:
            if g.vec and g.i_contig:
                assert ni % 4 == 0  # a quad of rows is all in or all out
            want = collections.Counter(
                (i, j) for i in range(ni) for j in range(g.q_chunk)
            )
            assert _copies(g, ni) == want


# ---- the unbatched launch: groups x splits parts of one tensor's outer range

FMRI = (225, 59, 200, 200)
LINEAR3 = (225, 59, 20100)  # the fMRI tensor's 3-way linearization


def _check_unbatched(shape, n, rank, bps=4):
    """The unbatched launch at mode ``n``: every row, outer index and index
    of q in exactly one (row block, part, chunk), within the card's limits."""
    g = tmf.unbatched_launch_shape(shape, n, rank, bps)
    order = len(shape)
    q = tmf.contracted_mode(order, n)
    outer = math.prod(shape[k] for k in range(order) if k not in (n, q))
    parts = g.groups * g.splits
    assert g.slabs == 1 and g.outer == outer and g.steps == g.chunks * outer
    assert (g.row_blocks - 1) * BLOCK_ROWS < shape[n] <= g.row_blocks * BLOCK_ROWS
    # part blockIdx.y = group * splits + rank: every step in exactly one part
    assert g.splits in tmf.SPLITS and g.groups >= 1
    assert parts <= g.steps and parts <= GRID_YZ
    assert _cover(g.steps, parts) == collections.Counter(range(g.steps))
    assert g.q_chunk % 4 == 0 and (g.chunks - 1) * g.q_chunk < shape[q] <= g.chunks * g.q_chunk
    # shared memory within the residency, grid limits, copies
    assert g.smem == tmf.cluster_smem(g.q_chunk, _padded(rank), g.i_contig)
    assert g.smem <= tmf.SMEM_BYTES
    assert g.residency * (g.smem + tmf.BLOCK_RESERVED_SMEM) <= tmf.SM_SMEM_BYTES
    assert g.row_blocks <= GRID_X
    assert g.i_contig == (n == order - 1) and g.vec == (shape[-1] % 4 == 0)
    return g


def _boxes(g, shape, n):
    """How often the launch covers each (row, outer index, index of q): one
    box a (row block, step of a part), step s being chunk s // outer and
    outer index s % outer, counted on a dense grid."""
    q = tmf.contracted_mode(len(shape), n)
    parts = g.groups * g.splits
    count = np.zeros((shape[n], g.outer, shape[q]), dtype=np.int32)
    for b in range(g.row_blocks):
        for p in range(parts):
            lo, hi = tmf.part_steps(g.steps, p, parts)
            for s in range(lo, hi):
                ch, o = divmod(s, g.outer)
                count[b * BLOCK_ROWS:(b + 1) * BLOCK_ROWS, o,
                      ch * g.q_chunk:(ch + 1) * g.q_chunk] += 1
    return count


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_unbatched_launch_covers_every_row_outer_index_and_q_index_once(shape, rank):
    for n in range(len(shape)):
        g = _check_unbatched(shape, n, rank)
        assert (_boxes(g, shape, n) == 1).all()


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
@pytest.mark.parametrize("shape", [FMRI, LINEAR3, FLEET], ids=lambda s: "x".join(map(str, s)))
def test_unbatched_launch_of_the_fmri_shapes_within_the_limits(shape, rank):
    for n in range(len(shape)):
        _check_unbatched(shape, n, rank)


def _waves(row_blocks, groups, splits, per_sm):
    return math.ceil(row_blocks * groups / tmf.CLUSTER_SLOTS[per_sm][splits])


@pytest.mark.parametrize("rank", [1, 10, 64])
@pytest.mark.parametrize(
    "shape", SHAPES + [FMRI, LINEAR3, FLEET, (20100, 3, 5)], ids=lambda s: "x".join(map(str, s))
)
def test_unbatched_launch_fills_the_fewest_whole_waves_counted_by_cluster(shape, rank):
    """Against every legal (splits, groups): the launch takes the fewest
    waves, counting a wave as the clusters of its size the card holds, and
    no launch in that many waves runs more CTAs; on a tie the larger split."""
    for bps in (1, 2, 4, 16):
        for n in range(len(shape)):
            g = tmf.unbatched_launch_shape(shape, n, rank, bps)
            per_sm = min(bps, g.residency)
            legal = [(s, k) for s in tmf.SPLITS
                     for k in range(1, min(g.steps // s, GRID_YZ // s) + 1)]
            fewest = min(_waves(g.row_blocks, k, s, per_sm) for s, k in legal)
            within = [(g.row_blocks * k * s, s) for s, k in legal
                      if _waves(g.row_blocks, k, s, per_sm) <= fewest]
            assert _waves(g.row_blocks, g.groups, g.splits, per_sm) == fewest
            assert (g.row_blocks * g.groups * g.splits, g.splits) == max(within)


def test_unbatched_fmri_launches_fill_one_wave_of_cluster_slots():
    """Rank 10 on the fMRI tensor: one wave each, 264 / 264 / 259 / 259 CTAs
    of the 264 slots of 132 SMs at 2 CTAs each, the whole q extent of 200
    in every stage.  Clusters of 4 would hold 248 (62 on the card), so mode
    0 counted by SM (8 groups of 4: 64 clusters) would spill a second wave."""
    want = {0: (8, 33, 1), 1: (2, 66, 2), 2: (7, 37, 1), 3: (7, 37, 1)}
    for n, (row_blocks, groups, splits) in want.items():
        g = _check_unbatched(FMRI, n, 10)
        assert (g.row_blocks, g.groups, g.splits) == (row_blocks, groups, splits)
        assert (g.q_chunk, g.chunks, g.residency, g.vec) == (200, 1, 2, True)
        assert g.row_blocks * g.groups <= tmf.CLUSTER_SLOTS[2][g.splits]
    assert 8 * 8 > tmf.CLUSTER_SLOTS[2][4]


def test_unbatched_linearization_cuts_q_into_equal_chunks():
    """The 3-way linearization's q (20100 at modes 0 and 1) does not fit a
    stage: the fewest equal chunks that do; its mode 2 (20100 rows) needs
    three waves of clusters of one."""
    smem_budget = tmf.SM_SMEM_BYTES // 2 - tmf.BLOCK_RESERVED_SMEM
    for n in (0, 1):
        g = _check_unbatched(LINEAR3, n, 10)
        assert g.chunks > 1 and g.q_chunk * g.chunks - 20100 < 4 * g.chunks
        assert tmf.cluster_smem(g.q_chunk, 12, False) <= smem_budget
        assert tmf.cluster_smem(g.q_chunk + 4, 12, False) > smem_budget
    g = _check_unbatched(LINEAR3, 2, 10)
    assert (g.row_blocks, g.groups, g.splits, g.chunks) == (629, 1, 1, 1)
    assert math.ceil(g.row_blocks / tmf.CLUSTER_SLOTS[2][1]) == 3


@pytest.mark.parametrize("rank", [1, 10, 64])
def test_unbatched_workspace_holds_the_groups_partials(rank):
    for shape in [FMRI, LINEAR3] + SHAPES:
        for n in range(len(shape)):
            g = tmf.unbatched_launch_shape(shape, n, rank)
            ws = tmf.workspace_shape(g, shape[n], rank)
            if g.groups == 1:
                assert ws is None  # the clusters write the output
            else:
                assert ws == (g.groups, shape[n], rank)
            if shape == FMRI and rank == 10:
                assert 4 * math.prod(ws) < 0.3e6  # under 0.3 MB
    assert tmf.workspace_shape(tmf.unbatched_launch_shape(FMRI, 0, 10), 225, 10) == (33, 225, 10)


def test_unbatched_blocks_per_sm_caps_the_ctas_an_sm_counts():
    for shape in (FMRI, LINEAR3, (33, 70, 129)):
        for n in range(len(shape)):
            default = tmf.unbatched_launch_shape(shape, n, 10)
            assert tmf.unbatched_launch_shape(shape, n, 10, 4) == default  # the default knob
            assert tmf.unbatched_launch_shape(shape, n, 10, 2) == default  # the residency
            assert tmf.unbatched_launch_shape(shape, n, 10, 16) == default
            assert tmf.unbatched_launch_shape(shape, n, 64, 1) == tmf.unbatched_launch_shape(
                shape, n, 64)  # rank 64: one CTA an SM anyway
    # one CTA an SM counted: half the clusters a wave; 128 CTAs as 8 groups of 2
    # (16 groups of 1 run as many, and the larger split wins the tie)
    g = tmf.unbatched_launch_shape(FMRI, 0, 10, 1)
    assert (g.groups, g.splits) == (8, 2) and g.row_blocks * g.groups <= tmf.CLUSTER_SLOTS[1][2]
    with pytest.raises(ValueError):
        tmf.unbatched_launch_shape(FMRI, 0, 10, 0)


@pytest.mark.parametrize("rank", [10, 64])
@pytest.mark.parametrize(
    "shape", [FMRI, LINEAR3] + SHAPES, ids=lambda s: "x".join(map(str, s))
)
def test_the_copy_loop_copies_every_tile_element_once_at_the_unbatched_shapes(shape, rank):
    for n in range(len(shape)):
        g = tmf.unbatched_launch_shape(shape, n, rank)
        tails = {BLOCK_ROWS, shape[n] - (g.row_blocks - 1) * BLOCK_ROWS}
        for ni in tails:
            if g.vec and g.i_contig:
                assert ni % 4 == 0  # a quad of rows is all in or all out
            want = collections.Counter(
                (i, j) for i in range(ni) for j in range(g.q_chunk)
            )
            assert _copies(g, ni) == want
