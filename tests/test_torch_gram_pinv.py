"""The factor update's solve, ``kernels/gram_pinv.py`` and ``plan/sweep.py::_pinv``.

On the CPU ``_pinv`` is the plain definition, bitwise: ``hadamard_except``
then ``torch.linalg.pinv`` at the reference's cutoff, for real and fake
tensors, with neither counter moving.  The wrapper's refusals and its one
launch are driven through a stand-in for the launch.  The CUDA kernel's
algorithm is checked here by :func:`_emulate`, a numpy walk of
``csrc/gram_pinv.cu::gram_pinv_kernel`` round by round (the round-robin
pairs, the folded triangle of 2 x 2 blocks, the parity arrays that carry
each round's rotations, the stop and the cutoff), which must write every
array it reads exactly once a round and give the pseudo-inverse.

Marked ``gpu`` (skipped, with the reason, where no card is attached): the
kernel itself against a float64 pseudo-inverse at the same cutoff, NaN in
and out, bitwise repeats and independent slabs, the launch count of a
sweep, and whole sweeps and a service dispatch under
``torch.cuda.set_sync_debug_mode("error")`` with no host read but the
chunk's and the dispatch's.
"""

import re
import traceback
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.cpals import hadamard_except
from repro_torch.kernels import gram_pinv as gp
from repro_torch.plan import Problem, cp_als, plan_sweep
from repro_torch.plan import sweep as sw

SOURCE = gp.KERNEL.source.read_text()
ITEMSIZE = {torch.float32: 4, torch.float64: 8}
MAX_TASKS = int(re.search(r"MAX_TASKS = (\d+);", SOURCE).group(1))
# threads a block at most (Block<T> in the source)
THREADS = dict(zip((torch.float64, torch.float32), map(int, re.search(
    r"threads = sizeof\(T\) == 8 \? (\d+) : (\d+);", SOURCE).groups())))


def _warps(n):
    return -(-n // 32) * 32


def _tasks(c):
    """A round's tasks at order ``c`` (``tasks_of`` in the source): the 2 x 2
    blocks (k, l), k < l, of H's m / 2 pairs, padded to a warp; a row of V
    at a pair."""
    half = (c + c % 2) // 2
    return _warps(half * (half - 1) // 2) + c * half


def _fits(c, dtype):
    """Whether a block holds order ``c``: its shared memory and a round's
    tasks, ``MAX_TASKS`` a thread (``run`` in the source refuses the rest)."""
    return (gp.smem_bytes(c, ITEMSIZE[dtype]) <= gp.SMEM_LIMIT
            and _tasks(c) <= MAX_TASKS * THREADS[dtype])


def _grams(c, batch=None, order=4, rows=(9, 7, 6, 8), seed=0, dtype=torch.float32,
           device="cpu"):
    g = torch.Generator().manual_seed(seed)
    lead = () if batch is None else (batch,)
    fs = [torch.randn(lead + (rows[k % len(rows)], c), generator=g, dtype=torch.float64)
          for k in range(order)]
    return [(f.transpose(-1, -2) @ f).to(dtype).to(device) for f in fs]


# ---- (a) the CPU path: the plain definition, bitwise

@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("c", [1, 3, 10, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pinv_on_the_cpu_is_the_plain_definition_bitwise(c, batch, dtype):
    gs = _grams(c, batch, dtype=dtype, seed=c)
    before = gp.KERNEL.launches, sw.library_solves
    for n in range(len(gs)):
        want = torch.linalg.pinv(hadamard_except(gs, n), rtol=10.0 * c * torch.finfo(dtype).eps)
        assert torch.equal(sw._pinv(gs, n), want)
        assert torch.equal(gp.gram_pinv(gs, n), want)
        assert torch.equal(gp.gram_pinv_plain(gs, n), want)
    assert (gp.KERNEL.launches, sw.library_solves) == before


def test_fake_tensors_take_the_plain_path():
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = gp.KERNEL.launches, sw.library_solves
    with FakeTensorMode():
        gs = [torch.empty(5, 10, 10) for _ in range(3)]
        p = sw._pinv(gs, 1)
    assert tuple(p.shape) == (5, 10, 10) and p.dtype == torch.float32
    assert (gp.KERNEL.launches, sw.library_solves) == before


@pytest.mark.parametrize("strategy", ["auto", "matrix_free"])
@pytest.mark.parametrize("batch", [None, 2])
def test_cp_als_on_the_cpu_moves_neither_counter(strategy, batch):
    shape, rank = (6, 5, 4), 3
    g = torch.Generator().manual_seed(1)
    lead = () if batch is None else (batch,)
    x = torch.randn(lead + shape, generator=g)
    kw = {} if batch is None else {"batch": batch}
    plan = plan_sweep(Problem(shape, rank, **kw), strategy=strategy)
    before = gp.KERNEL.launches, sw.library_solves
    st = cp_als(x, plan, n_iters=3, tol=0.0)
    assert torch.isfinite(torch.as_tensor(st.fit)).all()
    assert (gp.KERNEL.launches, sw.library_solves) == before


# ---- (b) the wrapper's refusals and its launch, through a stand-in launch

@pytest.fixture
def card(monkeypatch):
    """The wrapper as on the card: ``use_kernel`` True, the launch recorded
    in place of the C call."""
    calls = []
    monkeypatch.setattr(gp, "use_kernel", lambda *ts: True)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(gp.KERNEL, "launch", lambda *a, **k: calls.append((a, k)))
    return calls


@pytest.mark.parametrize("batch", [None, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_wrapper_launches_once_with_the_grams_by_pointer(card, dtype, batch):
    gs = _grams(10, batch, dtype=dtype)
    out = gp.gram_pinv(gs, 2)
    assert out.shape == gs[0].shape and out.dtype == dtype
    (args, kw), = card
    ptrs, order, n, c, b, out_ptr, stream = args
    assert [ptrs[k] for k in range(order)] == [g.data_ptr() for g in gs]
    assert (order, n, c, b, out_ptr, stream) == (4, 2, 10, batch or 1, out.data_ptr(), 7)
    assert kw == {"suffix": {torch.float32: "f32", torch.float64: "f64"}[dtype]}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int32, torch.complex64])
def test_the_wrapper_refuses_other_dtypes(card, dtype):
    gs = [torch.ones(4, 4).to(dtype) for _ in range(3)]
    with pytest.raises(TypeError):
        gp.gram_pinv(gs, 0)
    assert not card


def test_the_wrapper_refuses_a_mix_of_dtypes(card):
    gs = [torch.ones(4, 4), torch.ones(4, 4, dtype=torch.float64), torch.ones(4, 4)]
    with pytest.raises(TypeError):
        gp.gram_pinv(gs, 0)
    assert not card


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_wrapper_refuses_c_above_c_max(card, dtype):
    c = gp.C_MAX
    gp.gram_pinv([torch.eye(c, dtype=dtype)] * 2, 0)
    assert len(card) == 1
    with pytest.raises(ValueError, match="C <="):
        gp.gram_pinv([torch.eye(c + 1, dtype=dtype)] * 2, 0)
    assert len(card) == 1


@pytest.mark.parametrize("shapes", [
    [(4,), (4,)],                   # not matrices
    [(4, 5), (4, 5)],               # not square
    [(2, 3, 4, 4), (2, 3, 4, 4)],   # a stack of stacks
    [(4, 4), (5, 5)],               # shapes differ
    [(2, 4, 4), (3, 4, 4)],         # batches differ
    [(0, 0), (0, 0)],               # C = 0
])
def test_the_wrapper_refuses_shapes(card, shapes):
    with pytest.raises(ValueError):
        gp.gram_pinv([torch.ones(s) for s in shapes], 0)
    assert not card


@pytest.mark.parametrize("order,n", [(1, 0), (gp.MAX_ORDER + 1, 0), (3, 3), (3, -1)])
def test_the_wrapper_refuses_orders_and_modes(card, order, n):
    with pytest.raises(ValueError):
        gp.gram_pinv([torch.eye(3)] * order, n)
    assert not card


def test_the_wrapper_refuses_a_strided_gram(card):
    gs = [torch.ones(4, 4), torch.ones(4, 8)[:, ::2]]
    with pytest.raises(ValueError, match="contiguous"):
        gp.gram_pinv(gs, 0)
    assert not card


@pytest.mark.parametrize("dtype,c,order,taken", [
    (torch.float32, 1, 2, True), (torch.float64, 10, 4, True),
    (torch.float32, gp.C_MAX, gp.MAX_ORDER, True), (torch.float64, gp.C_MAX, 3, True),
    (torch.float32, gp.C_MAX + 1, 3, False), (torch.float64, gp.C_MAX + 1, 3, False),
    (torch.float32, 10, gp.MAX_ORDER + 1, False), (torch.bfloat16, 10, 3, False),
    (torch.float16, 10, 3, False),
])
def test_takes_is_what_the_wrapper_launches(card, dtype, c, order, taken):
    gs = [torch.eye(c).to(dtype) for _ in range(order)]
    assert gp.takes(gs) is taken
    assert (gp.refusal(gs) is None) is taken
    if taken:
        gp.gram_pinv(gs, 0)
        assert len(card) == 1
    else:
        with pytest.raises((TypeError, ValueError)):
            gp.gram_pinv(gs, 0)
        assert not card


def test_takes_refuses_a_mix_of_dtypes():
    assert not gp.takes([torch.eye(3), torch.eye(3, dtype=torch.float64)])
    assert isinstance(gp.refusal([torch.eye(3), torch.eye(3, dtype=torch.float64)]), TypeError)


def test_the_wrapper_refuses_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        gs = [torch.empty(4, 4) for _ in range(3)]
        with pytest.raises(ValueError, match="fake"):
            gp.gram_pinv(gs, 0)


# ---- (c) the source's constants and shared memory

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_c_max_fits_a_blocks_shared_memory(dtype):
    c = gp.C_MAX
    assert c >= 64  # the MTTKRP body's column block
    assert gp.smem_bytes(c, ITEMSIZE[dtype]) <= 232448 == gp.SMEM_LIMIT
    assert _fits(c, dtype)
    in_smem = max(k for k in range(1, 400) if gp.smem_bytes(k, ITEMSIZE[dtype]) <= gp.SMEM_LIMIT)
    assert in_smem == {torch.float32: 169, torch.float64: 119}[dtype]
    held = max(k for k in range(1, 400) if _fits(k, dtype))
    assert held == {torch.float32: 161, torch.float64: 114}[dtype]


def test_the_constants_match_the_source():
    assert re.search(rf"MAX_ORDER = {gp.MAX_ORDER};", SOURCE)
    assert re.search(rf"SMEM_LIMIT = {gp.SMEM_LIMIT};", SOURCE)
    assert "return m * m + c * m + 2 * m + m / 2 + 33;" in SOURCE
    assert "return warps_of(half * (half - 1) / 2) + c * half;" in SOURCE
    for suffix in ("f32", "f64"):
        assert f"GRAM_PINV_ENTRY({'float' if suffix == 'f32' else 'double'}, {suffix})" in SOURCE


def test_the_kernel_has_one_entry_a_dtype_and_a_span():
    assert gp.KERNEL.span == "repro_torch.kernel.gram_pinv"
    assert sorted(gp.KERNEL.entries) == ["f32", "f64"]
    assert [p.name for p in gp.KERNEL.sources] == ["gram_pinv.cu"]


# ---- (d) the kernel's algorithm, walked in numpy

MAX_SWEEPS = int(re.search(r"MAX_SWEEPS = (\d+);", SOURCE).group(1))
OFF_TOL = float(re.search(r"OFF_TOL = ([\d.]+);", SOURCE).group(1))


def _pair(k, r, m):
    w = m - 1
    return (r, w) if k == 0 else ((r + k) % w, (r - k + w) % w)


def _partner(i, r, m):
    w = m - 1
    if i == w:
        return r
    if i == r:
        return w
    return (2 * r - i + 2 * w) % w


def _slot(i, r, m):
    w = m - 1
    if i in (w, r):
        return 0
    k = (i - r + w) % w
    return min(k, w - k)


def _task(t, c):
    """Task ``t`` of a round at order ``c`` as the kernel decodes it:
    ``("block", k, l)`` (k < l), ``("row", row, k)`` or ``None`` (the
    blocks' padding)."""
    half = (c + c % 2) // 2
    blocks = half * (half - 1) // 2
    if t < blocks:
        i, col = divmod(t, half)
        if col < half - 1 - i:
            return "block", i, i + 1 + col
        k = half - 2 - i
        return "block", k, k + 1 + col - (half - 1 - i)
    if t >= _warps(blocks):
        return ("row",) + divmod(t - _warps(blocks), half)
    return None


def _rotation(app, aqq, apq):
    """The kernel's rotation: x = aqq - app, y = 2 apq scaled by a power of
    two, t = sign(x) y / (|x| + sqrt(x^2 + y^2)), c = 1 / sqrt(1 + t^2)."""
    if apq == 0:
        return 1.0, 0.0, 0.0
    x, y = aqq - app, 2 * apq
    e = np.frexp(max(abs(x), abs(y)))[1] - 1  # ilogb
    x, y = np.ldexp(x, -e), np.ldexp(y, -e)
    t = (y if x >= 0 else -y) / (abs(x) + np.sqrt(x * x + y * y))
    c = 1 / np.sqrt(1 + t * t)
    return c, t * c, t


def _emulate(h_in, dtype=np.float64):
    """The kernel on one symmetric matrix, round by round in its two steps
    (each pair's rotation and diagonal, then the tasks); returns ``(P,
    sweeps)``.  Asserts that a round's tasks write each pair element of
    the next round exactly once, and touch no pair's own block."""
    c = h_in.shape[0]
    m = c + c % 2
    half = m // 2
    eps = np.finfo(dtype).eps
    h = np.zeros((m, m), dtype)
    h[:c, :c] = np.triu(h_in) + np.triu(h_in, 1).T
    if not np.isfinite(h).all():
        return np.full((c, c), np.nan, dtype), 0
    v = np.eye(c, m, dtype=dtype)
    d = np.diag(h).copy()
    o = np.zeros(half, dtype)
    for i in range(m):
        for j in range(i + 1, m):
            if _partner(i, 0, m) == j:
                o[_slot(i, 0, m)] = h[i, j]
    stop = (OFF_TOL * eps) ** 2 * np.sum(h * h)
    tasks = [_task(t, c) for t in range(_tasks(c))]
    sweeps = 0
    for sweeps in range(1, MAX_SWEEPS + 1):
        for r in range(m - 1):
            rn = r + 1 if r + 1 < m - 1 else 0
            wrote = np.zeros(half, int)
            rot = []
            for k in range(half):
                p, q = _pair(k, r, m)
                ca, sa, ta = _rotation(d[p], d[q], o[k])
                rot.append((ca, sa))
                d[p], d[q] = d[p] - ta * o[k], d[q] + ta * o[k]
                h[p, q] = h[q, p] = 0
                if _partner(p, rn, m) == q:  # m = 2 only
                    o[_slot(p, rn, m)] = 0
                    wrote[_slot(p, rn, m)] += 1
            for task in filter(None, tasks):
                if task[0] == "block":
                    _, k, l = task
                    (pk, qk), (pl, ql) = _pair(k, r, m), _pair(l, r, m)
                    (ca, sa), (cb, sb) = rot[k], rot[l]
                    b = h[np.ix_([pk, qk], [pl, ql])]
                    val = np.array([[ca, sa], [-sa, ca]]).T @ b @ np.array([[cb, sb], [-sb, cb]])
                    for x, i in enumerate((pk, qk)):
                        for y, j in enumerate((pl, ql)):
                            assert _partner(i, r, m) != j
                            h[i, j] = h[j, i] = val[x, y]
                            if _partner(i, rn, m) == j:
                                o[_slot(i, rn, m)] = val[x, y]
                                wrote[_slot(i, rn, m)] += 1
                else:
                    _, row, k = task
                    pk, qk = _pair(k, r, m)
                    ca, sa = rot[k]
                    vp, vq = v[row, pk], v[row, qk]
                    v[row, pk], v[row, qk] = ca * vp - sa * vq, sa * vp + ca * vq
            assert (wrote == 1).all()
        if 2 * np.sum(np.triu(h, 1) ** 2) <= stop:
            break
    lam = d[:c]
    cut = 10.0 * c * eps * np.max(np.abs(lam))
    w = np.where(np.abs(lam) > cut, 1 / np.where(lam == 0, 1, lam), 0)
    p = (v[:, :c] * w) @ v[:, :c].T
    return np.triu(p) + np.triu(p, 1).T, sweeps  # the upper triangle, mirrored


@pytest.mark.parametrize("m", range(2, 42, 2))
def test_the_round_robin_meets_every_pair_once_a_sweep(m):
    met = set()
    for r in range(m - 1):
        seen = []
        for k in range(m // 2):
            p, q = _pair(k, r, m)
            assert _partner(p, r, m) == q and _partner(q, r, m) == p
            assert _slot(p, r, m) == _slot(q, r, m) == k
            seen += [p, q]
            met.add(frozenset((p, q)))
        assert sorted(seen) == list(range(m))  # disjoint, every index once
    assert len(met) == m * (m - 1) // 2
    for r in range(m - 1):  # a pair meets again in the next round only at m = 2
        rn = r + 1 if r + 1 < m - 1 else 0
        again = [k for k in range(m // 2) if _partner(_pair(k, r, m)[0], rn, m) == _pair(k, r, m)[1]]
        assert again == ([0] if m == 2 else [])


@pytest.mark.parametrize("c", [1, 2, 3, 9, 10, 33, 64, 80, 117, 118, 161, 168])
def test_a_rounds_tasks_hold_every_block_and_row_once_in_warp_groups(c):
    half = (c + c % 2) // 2
    tasks = [_task(t, c) for t in range(_tasks(c))]
    blocks = sorted(t[1:] for t in tasks if t and t[0] == "block")
    assert blocks == [(k, l) for k in range(half) for l in range(k + 1, half)]
    rows = sorted(t[1:] for t in tasks if t and t[0] == "row")
    assert rows == [(row, k) for row in range(c) for k in range(half)]
    for w in range(0, len(tasks), 32):  # a warp's tasks are of one kind
        assert len({t[0] for t in tasks[w:w + 32] if t}) <= 1


@pytest.mark.parametrize("case", ["well", "cond1e6", "deficient", "asymmetric", "zero"])
@pytest.mark.parametrize("c", [1, 2, 3, 5, 10, 16])
def test_the_emulated_kernel_is_the_pseudo_inverse(c, case):
    rng = np.random.default_rng(c)
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    lam = {"well": np.linspace(1, 3, c), "cond1e6": np.logspace(0, -6, c),
           "deficient": np.r_[np.linspace(1, 2, (c + 1) // 2), np.zeros(c // 2)],
           "asymmetric": np.linspace(1, 3, c), "zero": np.zeros(c)}[case]
    h = (q * lam) @ q.T
    if case == "asymmetric":
        h = h + 1e-9 * np.tril(rng.standard_normal((c, c)), -1)  # only the upper triangle counts
    sym = np.triu(h) + np.triu(h, 1).T
    p, sweeps = _emulate(h)
    want = np.linalg.pinv(sym, rcond=10.0 * c * np.finfo(np.float64).eps)
    scale = max(np.linalg.norm(want), 1.0)
    assert np.linalg.norm(p - want) <= 1e-6 * scale
    assert np.array_equal(p, p.T)
    assert sweeps < MAX_SWEEPS


def test_the_emulated_kernel_writes_nan_for_a_non_finite_matrix():
    h = np.eye(4)
    h[1, 3] = np.inf
    p, _ = _emulate(h)
    assert np.isnan(p).all()


def _study(shape, rank=10, noise=0.05, seed=0):
    """A small tensor shaped as the paper's fMRI study (time points x
    subjects x regions x regions), with the benchmark's planted structure:
    positive temporal envelopes, softplus subject loadings and symmetric
    rank-one network maps, scaled to ``max |x| = 1``, plus Gaussian noise
    of ``noise`` times that."""
    t, subjects, regions, _ = shape
    g = torch.Generator().manual_seed(seed)
    tt = torch.linspace(0, 8 * np.pi, t)[:, None]
    phases = torch.rand((1, rank), generator=g) * 2 * np.pi
    temporal = 1.0 + torch.sin(tt / (1 + torch.arange(rank)) + phases)
    subj = torch.nn.functional.softplus(torch.randn((subjects, rank), generator=g))
    seeds = torch.randn((regions, rank), generator=g)
    x = torch.einsum("tr,sr,ar,br->tsab", temporal, subj, seeds, seeds)
    x /= x.abs().max()
    return x + noise * torch.randn(x.shape, generator=g)


def _iterate_grams(x, rank, strategy, sweeps, batch=None):
    """Each update's Grams and mode, and what ``_pinv`` returned, over
    ``sweeps`` sweeps of ``cp_als`` on ``x``."""
    seen = []
    real = sw._pinv

    def spy(gs, n):
        p = real(gs, n)
        seen.append(([g.clone() for g in gs], n, p.clone()))
        return p

    shape = tuple(x.shape[1:] if batch else x.shape)
    kw = {} if batch is None else {"batch": batch}
    plan = plan_sweep(Problem(shape, rank, **kw), strategy=strategy)
    sw._pinv = spy
    try:
        cp_als(x, plan, n_iters=sweeps, tol=0.0, sweeps_per_sync=sweeps)
    finally:
        sw._pinv = real
    return seen


def _penrose(h, p, dtype):
    """The largest of the Penrose residuals ``||H P H - H|| / ||H||`` and
    ``||P H P - P|| / ||P||`` (float64, each matrix of a batch), over its
    bound ``2 C eps (10 + cond)``, cond that of H's kept part in float64.

    A backward-stable solve leaves residuals of order eps cond; the cutoff
    keeps cond below ``1 / (10 C eps)``, so the bound stays below 0.3 at
    every C, and a zero P (a residual of 1) or the P of an unconverged
    eigensolver fails it however ill-conditioned H is.  The 10 covers an
    eigenvalue within rounding of the cutoff, which one solver keeps and
    another drops: dropped, it leaves up to ``10 C eps ||H||`` in H P H - H.
    """
    h = h.double().reshape(-1, *h.shape[-2:])
    p = p.double().reshape(-1, *p.shape[-2:])
    c, eps = h.shape[-1], torch.finfo(dtype).eps
    eig = torch.linalg.eigvalsh(h).abs()
    top = eig.max(-1).values
    kept = torch.where(eig > gp.pinv_rtol(c, dtype) * top[..., None], eig, torch.inf)
    cond = torch.where(top > 0, top / kept.min(-1).values, torch.ones_like(top))
    norm = lambda a: torch.linalg.matrix_norm(a)  # noqa: E731
    r1 = norm(h @ p @ h - h) / norm(h).clamp_min(1e-300)
    r2 = norm(p @ h @ p - p) / norm(p).clamp_min(1e-300)
    return float((torch.maximum(r1, r2) / (2 * c * eps * (10 + cond))).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_emulated_kernel_converges_on_cp_als_iterates(seed):
    """The numpy walk of the kernel in float32 on every update of 8 sweeps
    of CP-ALS on a study-shaped tensor at rank 10: it stops well before
    ``MAX_SWEEPS`` (4 to 6 sweeps here, where the random Grams of the smoke
    take 2 or 3) and holds the Penrose residuals."""
    for gs, n, _ in _iterate_grams(_study((40, 12, 24, 24), seed=seed), 10, "auto", 8):
        h = hadamard_except(gs, n)
        p, sweeps = _emulate(h.numpy(), np.float32)
        assert sweeps <= 8
        sym = torch.triu(h) + torch.triu(h, 1).transpose(-1, -2)
        assert _penrose(sym, torch.from_numpy(p), torch.float32) <= 1


# ---- (e) on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case_grams(case, c, batch, dtype, device, seed):
    """Grams whose Hadamard (mode 0 left out) is the case's H."""
    lead = () if batch is None else (batch,)
    g = torch.Generator().manual_seed(seed)
    if case == "rank80":  # test_torch_high_rank's: Grams of rank 6-9 at C = 80
        fs = [torch.randn(lead + (d, c), generator=g, dtype=torch.float64) for d in (9, 7, 6, 8)]
        return [(f.transpose(-1, -2) @ f).to(dtype).to(device) for f in fs]
    q, _ = torch.linalg.qr(torch.randn(lead + (c, c), generator=g, dtype=torch.float64))
    lam = torch.logspace(0, -6, c, dtype=torch.float64) if case == "cond1e6" else \
        torch.linspace(1, 3, c, dtype=torch.float64)
    h = (q * lam) @ q.transpose(-1, -2)
    if case == "asymmetric":  # a lower triangle off by rounding, as cuBLAS may leave it
        h = h + 1e-7 * torch.tril(torch.randn(h.shape, generator=g, dtype=torch.float64), -1)
    ones = torch.ones_like(h)
    return [ones.to(dtype).to(device), h.to(dtype).to(device), ones.to(dtype).to(device)]


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


# (dtype, C, case): every C of the list up to the dtype's C_MAX, and C_MAX;
# the rank-80 Grams at C = 80 only
CARD_CASES = [
    (dtype, c, case)
    for dtype in (torch.float32, torch.float64)
    for c in sorted({1, 2, 3, 10, 16, 33, 64, 80, gp.C_MAX})
    for case in ("well", "cond1e6", "rank80", "asymmetric")
    if c <= gp.C_MAX and (case != "rank80" or c == 80)
]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [None, 32, 59])
@pytest.mark.parametrize("dtype,c,case", CARD_CASES)
def test_the_kernel_is_a_float64_pinv_at_the_same_cutoff(cuda, dtype, c, batch, case):
    """Against ``torch.linalg.pinv`` in float64 of the same (upper-triangle)
    H at the cutoff of ``dtype``.  Tolerance: no worse than four times the
    library's own error in ``dtype`` (what the update computed before),
    plus ``C * eps * cond(H)`` of slack: both solvers are backward stable,
    so their errors are of the order eps * cond, and neither beats it.
    That bound is loose where the library's own error is large: in
    float32 at cond 1e6, and wherever an eigenvalue near the cutoff lands
    on either side of it in float32 and float64.  So P is also held to the
    Penrose residuals (:func:`_penrose`), which no zero or unconverged P
    meets at any condition."""
    gs = _case_grams(case, c, batch, dtype, cuda, seed=c)
    before = gp.KERNEL.launches
    p = gp.gram_pinv(gs, 0)
    assert gp.KERNEL.launches == before + 1
    h = hadamard_except(gs, 0)
    sym = torch.triu(h) + torch.triu(h, 1).transpose(-1, -2)
    rtol = gp.pinv_rtol(c, dtype)
    want = torch.linalg.pinv(sym.double(), rtol=rtol)
    lib = torch.linalg.pinv(sym, rtol=rtol)
    eig = torch.linalg.eigvalsh(sym.double()).abs()
    top = eig.max(-1).values
    kept = torch.where(eig > rtol * top[..., None], eig, torch.inf).min(-1).values
    cond = float((top / kept).max())
    eps = torch.finfo(dtype).eps
    assert torch.equal(p, p.transpose(-1, -2))
    assert _rel(p, want) <= 4 * _rel(lib, want) + c * eps * cond
    assert _penrose(sym, p, dtype) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,batch", [("matrix_free", None), ("auto", None),
                                            ("matrix_free", 6)])
def test_the_kernel_holds_on_cp_als_iterates(cuda, strategy, batch):
    """Every update of 12 sweeps of CP-ALS on a study-shaped tensor at rank
    10 (with ``batch``, its subject slices): the kernel ran, and each P
    holds the Penrose residuals and agrees with a float64 pinv of its H as
    in the test above."""
    x = _study((60, batch or 12, 32, 32), seed=7)
    x = (x.movedim(1, 0).contiguous() if batch else x).to(cuda)
    before = gp.KERNEL.launches
    seen = _iterate_grams(x, 10, strategy, 12, batch)
    assert len(seen) == gp.KERNEL.launches - before == 12 * (3 if batch else 4)
    eps = torch.finfo(torch.float32).eps
    for gs, n, p in seen:
        h = hadamard_except(gs, n)
        sym = torch.triu(h) + torch.triu(h, 1).transpose(-1, -2)
        assert torch.equal(p, p.transpose(-1, -2))
        assert _penrose(sym, p, torch.float32) <= 1
        rtol = gp.pinv_rtol(10, torch.float32)
        want = torch.linalg.pinv(sym.double(), rtol=rtol)
        lib = torch.linalg.pinv(sym, rtol=rtol)
        eig = torch.linalg.eigvalsh(sym.double()).abs()
        top = eig.max(-1).values
        kept = torch.where(eig > rtol * top[..., None], eig, torch.inf).min(-1).values
        assert _rel(p, want) <= 4 * _rel(lib, want) + 10 * eps * float((top / kept).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_in_gives_nan_out_and_leaves_the_other_slabs(cuda, dtype):
    gs = _case_grams("well", 10, 4, dtype, cuda, seed=3)
    clean = gp.gram_pinv(gs, 0)
    gs[1][2, 3, 5] = float("nan")
    gs[2][1, 0, 0] = float("inf")
    p = gp.gram_pinv(gs, 0)
    assert torch.isnan(p[1]).all() and torch.isnan(p[2]).all()
    assert torch.equal(p[0], clean[0]) and torch.equal(p[3], clean[3])


@pytest.mark.gpu
@pytest.mark.parametrize("c", [10, 64])
def test_repeats_are_bitwise_and_slabs_independent(cuda, c):
    gs = _grams(c, 32, rows=(300, 200, 250, 9), seed=c, device=cuda)
    first = gp.gram_pinv(gs, 1)
    assert torch.equal(first, gp.gram_pinv(gs, 1))
    other = [g.clone() for g in gs]
    for g in other:
        g[1:] = g[1:].flip(0) * 2
    assert torch.equal(gp.gram_pinv(other, 1)[0], first[0])
    alone = gp.gram_pinv([g[0] for g in gs], 1)
    assert torch.equal(alone, first[0])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [None, 4])
def test_a_sweep_launches_the_kernel_once_a_mode(cuda, batch):
    shape, rank = (20, 9, 12, 14), 10
    shape = shape[1:] if batch else shape
    lead = () if batch is None else (batch,)
    x = torch.randn(lead + shape, device=cuda)
    kw = {} if batch is None else {"batch": batch}
    plan = plan_sweep(Problem(shape, rank, **kw), strategy="matrix_free")
    before = gp.KERNEL.launches, sw.library_solves
    cp_als(x, plan, n_iters=5, tol=0.0, sweeps_per_sync=5)
    assert gp.KERNEL.launches - before[0] == 5 * len(shape)  # 4 a sweep (3 a batch sweep)
    assert sw.library_solves == before[1]


@pytest.mark.gpu
def test_above_c_max_the_update_takes_the_library_counted(cuda):
    shape = (20, 15, 12)
    rank = gp.C_MAX + 1
    x = torch.randn(shape, device=cuda, dtype=torch.float64)
    plan = plan_sweep(Problem.from_tensor(x, rank), strategy="auto")
    before = gp.KERNEL.launches, sw.library_solves
    cp_als(x, plan, n_iters=2, tol=0.0)
    assert (gp.KERNEL.launches, sw.library_solves) == (before[0], before[1] + 6)


def _no_host_read(fn, allowed):
    """Run ``fn`` under the sync debug mode ``error``, with the functions
    named in ``allowed`` (``(module, name)``) let through in mode ``warn``.
    A host read elsewhere fails the test with the port's frames that made
    it."""
    wrapped = []
    for module, name in allowed:
        inner = getattr(module, name)

        def through(*a, _inner=inner, **k):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return _inner(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        wrapped.append((module, name, inner))
        setattr(module, name, through)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        frames = [f"{f.filename.rsplit('/src/', 1)[-1]}:{f.lineno} {f.name}"
                  for f in traceback.extract_tb(e.__traceback__) if "repro_torch" in f.filename]
        pytest.fail("a host read inside the chunk, innermost last:\n  " + "\n  ".join(frames))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for module, name, inner in wrapped:
            setattr(module, name, inner)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,batch", [("matrix_free", None), ("auto", None),
                                            ("matrix_free", 8)])
def test_a_chunk_of_sweeps_reads_the_host_only_for_its_fits(cuda, strategy, batch):
    shape, rank = (30, 12, 20, 20), 10
    shape = shape[1:] if batch else shape
    lead = () if batch is None else (batch,)
    x = torch.randn(lead + shape, device=cuda)
    kw = {} if batch is None else {"batch": batch}
    plan = plan_sweep(Problem(shape, rank, **kw), strategy=strategy)
    init = [torch.randn(lead + (d, rank), device=cuda) for d in shape]
    run = lambda: cp_als(x, plan, n_iters=4, tol=0.0, init_factors=init, sweeps_per_sync=4)
    run()  # warm: plans, library handles, the kernel's first load
    st = _no_host_read(run, [(sw, "_host_fits")])
    assert st.it == 4


@pytest.mark.gpu
def test_a_service_dispatch_reads_the_host_once(cuda):
    from repro_torch.serve import CPService

    svc = CPService(batch_size=4, n_iters=6, tol=0.0, strategy="matrix_free", device=cuda)
    xs = [torch.randn(12, 20, 20, device=cuda) for _ in range(4)]

    def dispatch():
        for x in xs:
            svc.submit(x, 10)
        return svc.flush()

    dispatch()  # warm: the signature's plan
    # the dispatch's own read is the fits' ``tolist`` in its sync span
    real_tolist = torch.Tensor.tolist

    def tolist(t):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return real_tolist(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    reads = []
    torch.Tensor.tolist = lambda t: reads.append(t) or tolist(t)
    try:
        done = _no_host_read(dispatch, [])
    finally:
        torch.Tensor.tolist = real_tolist
    assert len(done) == 4
    assert len(reads) == 2  # the chunk's fits (``_host_fits``) and the dispatch's
