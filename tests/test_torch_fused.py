"""The fused bilinear MTTKRP on the port's one MTTKRP body, on the CPU.

``M[i,c] = sum_{a,b} T * A[a,c] * B[b,c]`` with T's i-axis at ``pos`` is the
order-3 matrix-free fold of the view ``T`` at mode ``pos``, with ``A`` in
the one outer slot and ``B`` in the contracted one
(``repro_torch.kernels.fused_mttkrp.FOLD_MODES``).  Both fused CUDA entries
launch ``matrix_free_cluster_kernel`` (csrc/mttkrp_cluster.cuh) with the
matrix-free kernels' geometry of the view; the kernel runs only on the card
(``tests/test_torch_gpu.py``).  Here: the mapping, checked against the main
path's operands and against the reference's Pallas kernel (interpret
mode); the launches of the main path's views; and the kernel's split of a
row block's steps (one (chunk of q, outer index) pair each, chunk outer)
into parts, replayed step by step.  float32 tolerance ``rtol=2e-4,
atol=2e-5``.
"""

import collections
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_mttkrp as jfused
from repro_torch.kernels import _tiling as ttiling
from repro_torch.kernels import fused_mttkrp as tfm
from repro_torch.kernels import matrix_free as tmf
from repro_torch.kernels import ops as tops

TOL = dict(rtol=2e-4, atol=2e-5)
FMRI = (225, 59, 200, 200)
FLEET = (225, 200, 200)
LINEAR3 = (225, 59, 20100)
# The fused views of the fMRI tensor's modes (kernels/ops.py: _operands):
# (view, pos) and the rows of A and B.
FMRI_VIEWS = {
    0: ((225, 11800, 200), 0, 11800, 200),
    1: ((225, 59, 40000), 1, 225, 40000),
    2: ((13275, 200, 200), 1, 13275, 200),
    3: ((225, 11800, 200), 2, 225, 11800),
}


def _fold(t, a, b, pos, lead=0):
    """The plain fold of the view at mode ``pos``: A and B in their slots."""
    n, ma, mb = tfm.FOLD_MODES[pos]
    by_mode = {ma: a, mb: b}
    us = [by_mode[k] for k in range(3) if k != n]
    if lead:
        return tmf.matrix_free_batched_kernel_plain(t, us, n)
    return tmf.matrix_free_kernel_plain(t, us, n)


# ---- the mapping


@pytest.mark.parametrize("pos", [0, 1, 2])
def test_fold_modes_put_b_in_the_contracted_slot(pos):
    n, ma, mb = tfm.FOLD_MODES[pos]
    assert n == pos and {n, ma, mb} == {0, 1, 2}
    assert mb == tmf.contracted_mode(3, n)  # B's axis is contracted first
    assert ma < mb  # A's rows are the outer index, B's the inner one of T


@pytest.mark.parametrize("n", range(4))
def test_the_main_paths_views_map_onto_the_fold(n):
    """``ops.bilinear_operands`` at the fMRI tensor (shapes only: meta
    tensors) gives the view, pos, A and B of the table above, with A's rows
    on the fold's outer mode and B's on its contracted mode."""
    x = torch.empty(FMRI, device="meta")
    fs = [torch.empty((d, 10), device="meta") for d in FMRI]
    t, a, b, pos = tops.bilinear_operands(x, fs, n)
    view, want_pos, rows_a, rows_b = FMRI_VIEWS[n]
    assert (tuple(t.shape), pos, a.shape[0], b.shape[0]) == (view, want_pos, rows_a, rows_b)
    i, ma, mb = tfm.FOLD_MODES[pos]
    assert (view[i], view[ma], view[mb]) == (FMRI[n], rows_a, rows_b)


@pytest.mark.parametrize("n", range(3))
def test_the_fleet_views_are_the_batched_3_way_stack(n):
    """Each fleet mode's view is the 8-subject stack itself at pos = n, with
    A and B the stack's two other factors: the launch of the batched
    matrix-free kernel on that stack."""
    xb = torch.empty((8,) + FLEET, device="meta")
    fb = [torch.empty((8, d, 10), device="meta") for d in FLEET]
    t, a, b, pos = tops.bilinear_operands_batched(xb, fb, n)
    assert tuple(t.shape) == (8,) + FLEET and pos == n
    _, ma, mb = tfm.FOLD_MODES[pos]
    assert (a.shape[1], b.shape[1]) == (FLEET[ma], FLEET[mb])
    others = [k for k in range(3) if k != n]
    assert [ma, mb] == others  # A, B = the factors matrix_free_mttkrp_batched folds
    assert tfm.launch_geometry(FLEET, pos, 10, 8) == tmf.launch_shape(FLEET, n, 10, 8)


@pytest.mark.parametrize("pos", [0, 1, 2])
@pytest.mark.parametrize("dims", [(6, 5, 7), (3, 9, 4), (33, 4, 130)])
def test_the_fold_is_the_bilinear_form(dims, pos):
    """Both plain versions sum in float32 whatever their operands' dtype
    (as the reference's kernels do), so the identity is checked exactly on
    small integers, whose products and sums float32 holds without
    rounding."""
    rng = np.random.default_rng(sum(dims) + pos)
    t = torch.from_numpy(rng.integers(-3, 4, dims).astype(np.float64))
    ab = [d for k, d in enumerate(dims) if k != pos]
    a = torch.from_numpy(rng.integers(-3, 4, (ab[0], 3)).astype(np.float64))
    b = torch.from_numpy(rng.integers(-3, 4, (ab[1], 3)).astype(np.float64))
    want = tfm.fused_mttkrp_bilinear_plain(t, a, b, pos=pos)
    np.testing.assert_allclose(_fold(t, a, b, pos).numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    tb, ab_, bb = (torch.stack([v, 2 * v]) for v in (t, a, b))
    want_b = tfm.fused_mttkrp_bilinear_batched_plain(tb, ab_, bb, pos=pos)
    np.testing.assert_allclose(_fold(tb, ab_, bb, pos, lead=1).numpy(), want_b.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pos", [0, 1, 2])
def test_the_fold_matches_the_reference_pallas_kernel(pos):
    """The fold the CUDA entries run, in its plain version, against the
    reference's fused Pallas kernels (interpret mode), same numpy inputs."""
    rng = np.random.default_rng(40 + pos)
    dims = [6, 5, 7]
    t = rng.standard_normal(dims).astype(np.float32)
    ab = [d for k, d in enumerate(dims) if k != pos]
    a = rng.standard_normal((ab[0], 4)).astype(np.float32)
    b = rng.standard_normal((ab[1], 4)).astype(np.float32)
    ref = jfused.fused_mttkrp_bilinear(
        jnp.asarray(t), jnp.asarray(a), jnp.asarray(b), pos=pos,
        block_i=dims[pos], block_b=ab[1], interpret=True,
    )
    out = _fold(*(torch.from_numpy(v) for v in (t, a, b)), pos)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **TOL)
    ts, as_, bs = (np.stack([v, v[::-1].copy()]) for v in (t, a, b))
    ref_b = jfused.fused_mttkrp_bilinear_batched(
        jnp.asarray(ts), jnp.asarray(as_), jnp.asarray(bs), pos=pos,
        block_i=dims[pos], block_b=ab[1], block_batch=2, interpret=True,
    )
    out_b = _fold(*(torch.from_numpy(v) for v in (ts, as_, bs)), pos, lead=1)
    np.testing.assert_allclose(np.asarray(ref_b), out_b.numpy(), **TOL)


# ---- the launches of the main path's views


def test_the_fmri_views_launch_tuples():
    """Rank 10: modes 0 and 2 are the unbatched matrix-free kernel's
    launches at the same modes; modes 1 and 3 cut B's long axis into equal
    chunks that fit the stage (154 of 260 and 45 of 264)."""
    want = {  # (row_blocks, groups, splits, slabs, outer, q_chunk, chunks)
        0: (8, 33, 1, 1, 11800, 200, 1),
        1: (2, 66, 2, 1, 225, 260, 154),
        2: (7, 37, 1, 1, 13275, 200, 1),
        3: (7, 37, 1, 1, 225, 264, 45),
    }
    for n, (view, pos, _, _) in FMRI_VIEWS.items():
        g = tfm.launch_geometry(view, pos, 10)
        assert tuple(g[:7]) == want[n]
        assert g.residency == 2 and g.vec and g.i_contig == (pos == 2)
        assert (g.chunks - 1) * g.q_chunk < view[tfm.FOLD_MODES[pos][2]] <= g.chunks * g.q_chunk
        assert g.residency * (g.smem + tmf.BLOCK_RESERVED_SMEM) <= tmf.SM_SMEM_BYTES
        assert g.row_blocks * g.groups <= tmf.CLUSTER_SLOTS[2][g.splits]  # one wave
    for n in (0, 2):
        view, pos, _, _ = FMRI_VIEWS[n]
        assert tfm.launch_geometry(view, pos, 10) == tmf.unbatched_launch_shape(FMRI, n, 10)


@pytest.mark.parametrize("rank", [1, 10, 16, 64])
def test_the_knobs_default_is_no_knob(rank):
    for view, pos, _, _ in FMRI_VIEWS.values():
        assert tfm.launch_geometry(view, pos, rank, None, ttiling.BLOCKS_PER_SM) == (
            tfm.launch_geometry(view, pos, rank))
    for pos in range(3):
        assert tfm.launch_geometry(FLEET, pos, rank, 8, ttiling.BLOCKS_PER_SM) == (
            tfm.launch_geometry(FLEET, pos, rank, 8))
    for fn in (tfm.fused_mttkrp_bilinear, tfm.fused_mttkrp_bilinear_batched,
               tops.fused_mttkrp, tops.fused_mttkrp_batched):
        assert inspect.signature(fn).parameters["blocks_per_sm"].default == ttiling.BLOCKS_PER_SM


def _parent_launch_shape_splits(row_blocks, outer, slabs, per_sm):
    """The batched split as chosen before wave slots were counted by
    cluster: the best share of waves of SMS x per_sm CTA slots, the smaller
    split on a tie."""
    slots = tmf.SMS * per_sm
    best, best_use = 1, 0.0
    for s in tmf.SPLITS:
        if s > outer:
            break
        ctas = row_blocks * s * slabs
        use = ctas / (-(-ctas // slots) * slots)
        if use > best_use:
            best, best_use = s, use
    return best


def test_the_fleets_mode_0_wave_is_counted_by_cluster():
    """Mode 0 of the 8-subject batch: 8 row blocks x 8 slabs = 64 clusters.
    Counted by SM (264 slots), clusters of 4 looked like one wave of 256
    CTAs, but the card holds 62 clusters of 4: a second wave of 8 CTAs.
    Counted by cluster, the launch takes clusters of 2, 128 CTAs in one
    wave.  Modes 1 and 2 (56 clusters) keep clusters of 4."""
    before = {0: (8, 1, 4, 8), 1: (7, 1, 4, 8), 2: (7, 1, 4, 8)}
    after = {0: (8, 1, 2, 8), 1: (7, 1, 4, 8), 2: (7, 1, 4, 8)}
    for n in range(3):
        g = tmf.launch_shape(FLEET, n, 10, 8)
        assert tuple(g[:4]) == after[n]
        assert _parent_launch_shape_splits(g.row_blocks, g.outer, 8, 2) == before[n][2]
        assert tfm.launch_geometry(FLEET, n, 10, 8) == g  # row 3 launches the same
    assert 64 > tmf.CLUSTER_SLOTS[2][4] and 64 <= tmf.CLUSTER_SLOTS[2][2]
    assert 56 <= tmf.CLUSTER_SLOTS[2][4]


# ---- the split of a row block's steps into parts


def _walk(g, part, parts):
    """Replay one CTA's loops in matrix_free_cluster_kernel: the (chunk,
    outer index) of each step it issues and of each it computes, and the
    chunks of U_q it loads, in order."""
    steps = g.chunks * g.outer
    s_lo = steps * part // parts
    total = steps * (part + 1) // parts - s_lo
    ch_lo, o_lo = s_lo // g.outer, s_lo - (s_lo // g.outer) * g.outer
    issued, io_o, ich = [], o_lo, ch_lo
    for _ in range(total):
        issued.append((ich, io_o))
        io_o += 1
        if io_o == g.outer:  # the next chunk, from outer index 0
            io_o, ich = 0, ich + 1
    computed, loads, co_o, cch = [], [], o_lo, ch_lo
    for it in range(total):
        if it == 0 or co_o == 0:
            loads.append(cch)
        computed.append((cch, co_o))
        co_o += 1
        if co_o == g.outer:
            co_o, cch = 0, cch + 1
    return issued, computed, loads


def _parent_walk(g, part, parts):
    """The steps a part took when parts cut the outer range alone: every
    chunk, over the part's slice of outer indices."""
    o_lo, o_hi = g.outer * part // parts, g.outer * (part + 1) // parts
    return [(ch, o) for ch in range(g.chunks) for o in range(o_lo, o_hi)]


def _launches():
    out = [("fmri", n, tfm.launch_geometry(v, p, 10)) for n, (v, p, _, _) in FMRI_VIEWS.items()]
    out += [("linear3", n, tmf.unbatched_launch_shape(LINEAR3, n, 10)) for n in range(3)]
    out += [("fleet", n, tmf.launch_shape(FLEET, n, 10, 8)) for n in range(3)]
    out += [("small", n, tmf.unbatched_launch_shape((33, 70, 129), n, 64)) for n in range(3)]
    return out


@pytest.mark.parametrize("which", range(13))
def test_the_parts_cover_every_step_of_a_row_block_once(which):
    label, n, g = _launches()[which]
    parts = g.groups * g.splits
    assert 1 <= parts <= g.steps
    seen = collections.Counter()
    for p in range(parts):
        issued, computed, loads = _walk(g, p, parts)
        lo, hi = tmf.part_steps(g.steps, p, parts)
        want = [divmod(s, g.outer) for s in range(lo, hi)]
        assert issued == computed == want and hi > lo  # no empty part
        assert loads == sorted({ch for ch, _ in want})  # each chunk it touches, once
        seen.update(want)
    assert seen == collections.Counter(
        (ch, o) for ch in range(g.chunks) for o in range(g.outer))


def test_parts_equal_the_outer_split_where_q_fits_one_stage():
    """With one chunk the flat step range is the outer range: every part of
    every row-2 (fMRI, rank 10) and row-4 (fleet batch, rank 10) launch
    walks the steps it walked when parts cut the outer range alone, in the
    same order, so those kernels keep their sums bit for bit."""
    row2 = {0: (8, 33, 1, 200, 1), 1: (2, 66, 2, 200, 1), 2: (7, 37, 1, 200, 1),
            3: (7, 37, 1, 200, 1)}
    row4 = {0: (8, 1, 2, 200, 1), 1: (7, 1, 4, 200, 1), 2: (7, 1, 4, 200, 1)}
    launches = [(tmf.unbatched_launch_shape(FMRI, n, 10), want) for n, want in row2.items()]
    launches += [(tmf.launch_shape(FLEET, n, 10, 8), want) for n, want in row4.items()]
    for g, want in launches:
        assert (g.row_blocks, g.groups, g.splits, g.q_chunk, g.chunks) == want
        parts = g.groups * g.splits
        for p in range(parts):
            issued, computed, loads = _walk(g, p, parts)
            assert issued == computed == _parent_walk(g, p, parts) and loads == [0]


def test_a_part_of_a_chunked_view_touches_few_chunks():
    """The fMRI tensor's modes 1 and 3 under the fused entry: a part walks
    2-3 chunks of B and loads each once (cut over the outer range alone, it
    walked all 154 or 45, reloading U_q every 1.7 or 6 steps)."""
    for n in (1, 3):
        view, pos, _, _ = FMRI_VIEWS[n]
        g = tfm.launch_geometry(view, pos, 10)
        parts = g.groups * g.splits
        per_part = g.steps / parts
        loads = [len(_walk(g, p, parts)[2]) for p in range(parts)]
        assert max(loads) <= math.ceil(per_part / g.outer) + 1 <= 3
        old = [len({ch for ch, _ in _parent_walk(g, p, parts)}) for p in range(parts)]
        assert min(old) == g.chunks and g.chunks in (154, 45)
