"""Parity of the port's core modules (tensor_ops, krp, mttkrp, dimtree,
cpals helpers, roofline) with the JAX reference, on the CPU.

Inputs are made once with numpy from a seed and handed to both packages;
float32 tolerance is ``rtol=2e-4, atol=2e-5`` (the bound of
``tests/test_batched.py::_check_mttkrp_batched``).  The last test reads the
port's sources and fails on any import of ``jax`` or ``repro``.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.analysis.roofline as jroof
import repro.core as jcore
import repro.core.dimtree as jdimtree
import repro.core.tensor_ops as jtensor_ops
import repro_torch.analysis.roofline as troof
import repro_torch.core as tcore
import repro_torch.core.dimtree as tdimtree
from repro_torch.core import cpals as tcpals
from repro.core import cpals as jcpals

TOL = dict(rtol=2e-4, atol=2e-5)
ROOT = Path(__file__).resolve().parents[1]


def _arrays(shape, rank, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    fs = [rng.standard_normal((d, rank)).astype(np.float32) for d in shape]
    return x, fs


def _both(x, fs):
    return (jnp.asarray(x), [jnp.asarray(u) for u in fs],
            torch.from_numpy(x), [torch.from_numpy(u) for u in fs])


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(j), t.detach().cpu().numpy(), **tol)


@pytest.mark.parametrize("shape", [(3, 4, 5), (4, 3, 5, 2), (2, 3, 2, 3, 2)])
def test_tensor_ops_match_reference(shape):
    x, fs = _arrays(shape, 3)
    jx, jf, tx, tf = _both(x, fs)
    for n in range(len(shape)):
        assert tcore.dims_split(shape, n) == jcore.dims_split(shape, n)
        view = tcore.as_lir(tx, n)
        assert view.data_ptr() == tx.data_ptr()  # a free view, never a copy
        _close(jcore.as_lir(jx, n), view)
        _close(jcore.matricize(jx, n), tcore.matricize(tx, n))
        _close(jcore.matricize_multi(jx, n), tcore.matricize_multi(tx, n))
        v = np.linspace(-1, 1, shape[n]).astype(np.float32)
        _close(jcore.ttv(jx, jnp.asarray(v), n), tcore.ttv(tx, torch.from_numpy(v), n))
        m = np.arange(shape[n] * 2, dtype=np.float32).reshape(shape[n], 2) / 7
        _close(jcore.ttm(jx, jnp.asarray(m), n), tcore.ttm(tx, torch.from_numpy(m), n))
    _close(jcore.tensor_norm(jx), tcore.tensor_norm(tx))
    _close(jcore.cp_full(None, jf), tcore.cp_full(None, tf))
    w = np.array([0.5, 2.0, -1.0], np.float32)
    _close(jcore.cp_full(jnp.asarray(w), jf), tcore.cp_full(torch.from_numpy(w), tf))
    idx = tuple(d - 1 for d in shape)
    assert tcore.linear_index(idx, shape) == jtensor_ops.linear_index(idx, shape)
    assert tcore.mode_letters(len(shape)) == jcore.mode_letters(len(shape))


def test_multi_ttv_and_batched_norm_match_reference():
    rng = np.random.default_rng(1)
    t = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    fs = [rng.standard_normal((d, 2)).astype(np.float32) for d in (3, 4)]
    _close(
        jcore.multi_ttv(jnp.asarray(t), [jnp.asarray(u) for u in fs]),
        tcore.multi_ttv(torch.from_numpy(t), [torch.from_numpy(u) for u in fs]),
    )
    _close(
        jcore.tensor_norm(jnp.asarray(t), batched=True),
        tcore.tensor_norm(torch.from_numpy(t), batched=True),
    )
    with pytest.raises(ValueError):
        tcore.mode_letters(13)


def test_tensor_norm_and_cp_als_take_float64():
    """The reference's norm casts any tensor to float32; the port's takes a
    float64 tensor too (it may not narrow inside the reduction), so
    cp_als runs in float64, with the float32 run's fits."""
    from repro_torch.plan import Problem, cp_als, plan_sweep

    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 5, 4, 3))
    for batched in (False, True):
        got = tcore.tensor_norm(torch.from_numpy(x), batched=batched)
        assert got.dtype == torch.float32
        _close(jcore.tensor_norm(jnp.asarray(x.astype(np.float32)), batched=batched), got)
    x32 = torch.from_numpy(x.astype(np.float32))
    init = [torch.from_numpy(rng.standard_normal((d, 3)).astype(np.float32)) for d in x.shape]
    plan = plan_sweep(Problem.from_tensor(x32, 3), "auto")
    fits = {}
    for dtype in (torch.float32, torch.float64):
        st = cp_als(x32.to(dtype), plan, n_iters=3, tol=0.0,
                    init_factors=[u.to(dtype) for u in init])
        assert all(u.dtype == dtype for u in st.factors)
        fits[dtype] = float(st.fit)
    assert abs(fits[torch.float32] - fits[torch.float64]) < 1e-4


def test_random_draws_live_where_asked():
    g = torch.Generator().manual_seed(3)
    x = tcore.random_tensor(g, (2, 3), device="cpu")
    fs = tcore.random_factors(g, (2, 3), 4, device="cpu")
    assert x.shape == (2, 3) and [tuple(u.shape) for u in fs] == [(2, 4), (3, 4)]
    assert x.device.type == "cpu"


def test_random_tensor_on_missing_card_raises():
    """The default device is the card; without one the draw raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is attached: nothing to refuse")
    with pytest.raises((RuntimeError, AssertionError)):
        tcore.random_tensor(torch.Generator(), (2, 2))


@pytest.mark.parametrize("dims", [(3,), (3, 4), (2, 3, 4), (3, 1, 2, 2)])
def test_krp_variants_match_reference(dims):
    _, fs = _arrays(dims, 3, seed=2)
    jf = [jnp.asarray(u) for u in fs]
    tf = [torch.from_numpy(u) for u in fs]
    ref = jcore.krp(jf)
    _close(ref, tcore.krp(tf))
    _close(ref, tcore.krp_naive(tf))
    _close(ref, tcore.krp_rowwise_scan(tf))
    total = int(np.prod(dims))
    start, length = total // 3, max(1, total // 2)
    _close(jcore.krp_row_block(jf, start, length), tcore.krp_row_block(tf, start, length))
    _close(jcore.krp_or_ones([], 3), tcore.krp_or_ones([], 3))


MTTKRP_SHAPES = [(4, 5, 6), (3, 4, 2, 5), (2, 3, 4, 2, 3)]
METHODS = ["einsum", "1step", "2step", "2step-left", "2step-right", "baseline", "auto",
           "fused", "matrix_free"]


@pytest.mark.parametrize("shape", MTTKRP_SHAPES)
@pytest.mark.parametrize("method", METHODS)
def test_mttkrp_methods_match_reference(shape, method):
    x, fs = _arrays(shape, 4, seed=3)
    jx, jf, tx, tf = _both(x, fs)
    for n in range(len(shape)):
        ref = jcore.mttkrp_einsum(jx, jf, n)
        _close(ref, tcore.mttkrp(tx, tf, n, method=method))


def test_mttkrp_1step_blocked_and_flops_match_reference():
    x, fs = _arrays((3, 4, 5), 2, seed=4)
    jx, jf, tx, tf = _both(x, fs)
    _close(jcore.mttkrp_1step(jx, jf, 1, blocked=True), tcore.mttkrp_1step(tx, tf, 1, blocked=True))
    for n in range(3):
        for kw in ({}, {"itemsize": 2}, {"dtype": "float64"}):
            assert tcore.mttkrp_flops((3, 4, 5), 7, n, **kw) == jcore.mttkrp_flops(
                (3, 4, 5), 7, n, **kw
            )
    with pytest.raises(ValueError):
        tcore.mttkrp(tx, tf, 0, method="nope")


@pytest.mark.parametrize("lo,hi", [(0, 2), (1, 3), (2, 4), (1, 2), (0, 1)])
def test_dimtree_partials_match_reference(lo, hi):
    x, fs = _arrays((3, 4, 2, 5), 3, seed=5)
    jx, jf, tx, tf = _both(x, fs)
    jt = jdimtree.partial_mttkrp_range(jx, jf, lo, hi)
    tt = tdimtree.partial_mttkrp_range(tx, tf, lo, hi)
    _close(jt, tt)
    if hi - lo > 1:  # contract the partial down to its first mode
        jsib = {m: jf[m] for m in range(lo + 1, hi)}
        tsib = {m: tf[m] for m in range(lo + 1, hi)}
        _close(
            jdimtree.contract_from_partial(jt, jsib, lo, lo + 1, lo),
            tdimtree.contract_from_partial(tt, tsib, lo, lo + 1, lo),
        )


def test_cpals_helpers_match_reference():
    x, fs = _arrays((3, 4, 5), 3, seed=6)
    jx, jf, tx, tf = _both(x, fs)
    jg, tg = jcpals.grams(jf), tcpals.grams(tf)
    for a, b in zip(jg, tg):
        _close(a, b)
    for n in range(3):
        _close(jcpals.hadamard_except(jg, n), tcpals.hadamard_except(tg, n))
    for it in (0, 3):
        ju, jn = jcpals.normalize_columns(jf[0] * 0.1, it)
        tu, tn = tcpals.normalize_columns(tf[0] * 0.1, it)
        _close(ju, tu)
        _close(jn, tn)
    w = np.array([1.5, 0.5, 1.0], np.float32)
    m_last = jcore.mttkrp_einsum(jx, jf, 2)
    _close(
        jcpals.fit_from_last_mttkrp(jg, jnp.asarray(w), m_last, jf[2], jcore.tensor_norm(jx)),
        tcpals.fit_from_last_mttkrp(
            tg, torch.from_numpy(w), torch.from_numpy(np.array(m_last)), tf[2],
            tcore.tensor_norm(tx),
        ),
    )


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_roofline_matches_reference_at_equal_constants(n):
    shape = (225, 59, 200, 200)
    for dtype in ("f32", "bf16", "float64"):
        ref = jroof.mttkrp_roofline(
            shape, 10, n, dtype=dtype, peak_flops=troof.PEAK_FLOPS, hbm_bw=troof.HBM_BW
        )
        assert troof.mttkrp_roofline(shape, 10, n, dtype=dtype) == ref
    assert troof.dtype_itemsize(torch.bfloat16) == 2
    assert troof.dtype_itemsize(torch.float32) == jroof.dtype_itemsize("float32") == 4
    with pytest.raises(ValueError):
        troof.dtype_itemsize("no-such-type")


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    """No module of the port, and not chip_smoke.py, imports jax or repro."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert len(_port_sources()) > 10
    assert not bad, bad


def test_core_exports_krp_or_ones_batched_as_the_reference_does():
    from repro_torch.core import krp_or_ones_batched

    assert "krp_or_ones_batched" in tcore.__all__
    rng = np.random.default_rng(4)
    mats = [rng.standard_normal((3, d, 2)).astype(np.float32) for d in (4, 3)]
    _close(jcore.krp_or_ones_batched([jnp.asarray(m) for m in mats], 3, 2),
           krp_or_ones_batched([torch.from_numpy(m) for m in mats], 3, 2))
    _close(jcore.krp_or_ones_batched([], 3, 2), krp_or_ones_batched([], 3, 2))
