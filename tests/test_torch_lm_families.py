"""Parity of the port's MoE, SSM, RG-LRU and enc-dec code with the JAX
reference, on the CPU.

Inputs and weights are made once with numpy from a seed and given to both
packages; reduced configs compute in fp32.  Tolerances: the building blocks
(scan, conv, SSM, RG-LRU, MoE, encoder and decoder passes) at the port's
fp32 bound ``rtol=2e-4, atol=2e-5``; whole-model logits and decode against
forward at the reference's own 2e-3 (``tests/test_models_smoke.py``).  The
scan's combine order is the reference's (the odd/even recursion of
``lax.associative_scan``), but XLA rounds its fused steps its own way, so
parity is at tolerance, not bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpoint.manager import _flatten
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import scan_utils as jscan
from repro.models import ssm as jssm
from repro.models.common import act_fn as jact_fn
from repro_torch.dist import collectives as tcoll
from repro_torch.interop import params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import scan_utils as tscan
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttrans

TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)


def _cfgs(arch, **changes):
    j = dataclasses.replace(jconfigs.get_config(arch).reduced(), **changes)
    t = dataclasses.replace(tconfigs.get_config(arch).reduced(), **changes)
    return j, t


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(tree):
    """A numpy tree (dicts, lists, arrays) as tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree))


def _rand(defs, rng):
    """Random numpy parameters for a tree of the reference's ParamDefs: near
    one for ``ones``, small noise for ``zeros`` (so biases are exercised),
    else the def's std."""
    if isinstance(defs, dict):
        return {k: _rand(v, rng) for k, v in defs.items()}
    if isinstance(defs, list):
        return [_rand(v, rng) for v in defs]
    d = defs
    z = rng.standard_normal(d.shape)
    if d.init == "ones":
        return (1 + 0.1 * z).astype(np.float32)
    if d.init == "zeros":
        return (0.1 * z).astype(np.float32)
    std = tcommon.ParamDef(d.shape, d.spec, d.init, d.scale).std()  # the shared std rule
    return (z * std).astype(np.float32)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(arch, seed=0, **changes):
    jcfg, tcfg = _cfgs(arch, **changes)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    params_from_numpy(tm, _flatten(jp))
    return jcfg, jm, jp, tm


# --------------------------------------------------------------------------
# scan_utils
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk,with_h0", [
    (13, 0, False),   # unchunked, odd length
    (16, 0, False),   # unchunked, a power of two
    (16, 4, False),   # chunked: 4 divides 16
    (12, 5, False),   # 5 does not divide 12: one block
    (8, 8, False),    # s <= chunk: one block
    (16, 4, True),    # chunked, seeded
    (7, 0, True),     # unchunked, seeded
    (1, 0, True),     # one step
])
def test_linear_scan_matches_the_reference(s, chunk, with_h0):
    rng = np.random.default_rng(s + chunk)
    a = rng.uniform(0.5, 1.0, (2, s, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, s, 3, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32) if with_h0 else None
    jh, jlast = jscan.linear_scan(a, b, h0, axis=1, chunk=chunk)
    th, tlast = tscan.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                  None if h0 is None else torch.from_numpy(h0),
                                  axis=1, chunk=chunk)
    np.testing.assert_allclose(_np(th), jh, **TOL)
    np.testing.assert_allclose(_np(tlast), jlast, **TOL)
    # the recurrence itself, step by step in float64
    h = np.zeros((2, 3, 4)) if h0 is None else h0.astype(np.float64)
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        np.testing.assert_allclose(_np(th)[:, i], h, rtol=1e-5, atol=1e-5)


def test_linear_scan_takes_another_axis_and_keeps_its_inputs():
    a = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 1, (3, 4, 10)).astype(np.float32))
    b = torch.from_numpy(_x((3, 4, 10), 1))
    a0, b0 = a.clone(), b.clone()
    th, tlast = tscan.linear_scan(a, b, axis=2, chunk=5)
    jh, jlast = jscan.linear_scan(a0.numpy(), b0.numpy(), axis=2, chunk=5)
    np.testing.assert_allclose(_np(th), jh, **TOL)
    np.testing.assert_allclose(_np(tlast), jlast, **TOL)
    assert torch.equal(a, a0) and torch.equal(b, b0)


@pytest.mark.parametrize("s,with_buf,with_bias", [
    (9, False, True), (9, True, True), (9, True, False), (2, True, True), (2, False, True),
    (1, True, True),
])
def test_causal_conv1d_matches_the_reference(s, with_buf, with_bias):
    """With and without a carried tail, and prompts shorter than K - 1."""
    x = _x((2, s, 6), s)
    w = _x((6, 4), 1, 0.3)
    bias = _x((6,), 2) if with_bias else None
    buf = _x((2, 3, 6), 3) if with_buf else None
    jy, jbuf = jscan.causal_conv1d(x, w, bias, buf=buf)
    ty, tbuf = tscan.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                   None if bias is None else torch.from_numpy(bias),
                                   buf=None if buf is None else torch.from_numpy(buf))
    np.testing.assert_allclose(_np(ty), jy, **TOL)
    np.testing.assert_array_equal(_np(tbuf), jbuf)
    assert tuple(tbuf.shape) == (2, 3, 6)


# --------------------------------------------------------------------------
# SSM (Mamba-1)
# --------------------------------------------------------------------------
def test_softplus_is_logaddexp_as_jax():
    x = np.concatenate([np.linspace(-30, 30, 601), [25.0, 40.0, 90.0]]).astype(np.float32)
    got = _np(tcommon.softplus(torch.from_numpy(x)))
    np.testing.assert_allclose(got, jax.nn.softplus(x), **TOL)
    np.testing.assert_allclose(got, np.logaddexp(x.astype(np.float64), 0.0), **TOL)


@pytest.mark.parametrize("s,seq_chunk", [(12, 0), (12, 4), (256, 0), (130, 0)])
def test_ssm_apply_and_decode_match_the_reference(s, seq_chunk):
    """S = 256 takes the default chunk of 128 (it divides S), S = 130 one
    block; ``seq_chunk=4`` chunks a short prompt.  The state carried out of
    the forward, then decoded from, is the reference's."""
    jcfg, tcfg = _cfgs("falcon-mamba-7b", seq_chunk=seq_chunk)
    p = _rand(jssm.ssm_defs(jcfg), np.random.default_rng(s))
    tp = _t(p)
    assert {k: v.shape for k, v in tssm.ssm_defs(tcfg).items()} == {
        k: v.shape for k, v in jssm.ssm_defs(jcfg).items()}
    x = _x((2, s, jcfg.d_model), 1)
    jy, jst = jssm.ssm_apply(p, jcfg, x, return_state=True)
    ty, tst = tssm.ssm_apply(tp, tcfg, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(_np(ty), jy, **TOL)
    np.testing.assert_allclose(_np(tst.h), jst.h, **TOL)
    np.testing.assert_allclose(_np(tst.conv), jst.conv, **TOL)
    assert isinstance(tst, tssm.SSMState)
    np.testing.assert_allclose(_np(tssm.ssm_apply(tp, tcfg, torch.from_numpy(x))), jy, **TOL)
    # a second segment from the carried state
    x2 = _x((2, 5, jcfg.d_model), 2)
    jy2 = jssm.ssm_apply(p, jcfg, x2, jst)
    ty2 = tssm.ssm_apply(tp, tcfg, torch.from_numpy(x2), tst)
    np.testing.assert_allclose(_np(ty2), jy2, **TOL)
    for i in range(3):
        xs = _x((2, 1, jcfg.d_model), 10 + i)
        jy, jst = jssm.ssm_decode(p, jcfg, xs, jst)
        ty, tst = tssm.ssm_decode(tp, tcfg, torch.from_numpy(xs), tst)
        np.testing.assert_allclose(_np(ty), jy, **TOL)
        np.testing.assert_allclose(_np(tst.h), jst.h, **TOL)
        np.testing.assert_allclose(_np(tst.conv), jst.conv, **TOL)


def test_ssm_bf16_casts_the_scanned_pair_as_the_reference():
    """In bf16 the decay and forced tensors are cast before the scan and the
    state is kept in bf16: outputs and state come back in bf16, near the
    reference's bf16 run."""
    jcfg, tcfg = _cfgs("falcon-mamba-7b", compute_dtype="bfloat16")
    p = _rand(jssm.ssm_defs(jcfg), np.random.default_rng(7))
    x = _x((2, 12, jcfg.d_model), 3)
    jy, jst = jssm.ssm_apply(p, jcfg, jnp.asarray(x, jnp.bfloat16), return_state=True)
    ty, tst = tssm.ssm_apply(_t(p), tcfg, torch.from_numpy(x).bfloat16(), return_state=True)
    assert ty.dtype == tst.h.dtype == tst.conv.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty.float()), np.asarray(jy, np.float32), rtol=5e-2, atol=5e-2)
    st = tssm.init_ssm_state(tcfg, 3, torch.bfloat16, "cpu")
    jstate = jssm.init_ssm_state(jcfg, 3, jnp.bfloat16)
    assert tuple(st.h.shape) == jstate.h.shape and tuple(st.conv.shape) == jstate.conv.shape


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------
def test_rglru_gelu_is_the_tanh_form():
    x = np.linspace(-5, 5, 201, dtype=np.float32)
    np.testing.assert_allclose(_np(tcommon.act_fn("gelu")(torch.from_numpy(x))),
                               jax.nn.gelu(x), **TOL)
    np.testing.assert_allclose(jax.nn.gelu(x), jact_fn("gelu")(x), **TOL)


@pytest.mark.parametrize("s,seq_chunk", [(12, 0), (12, 4), (9, 4)])
def test_rglru_apply_and_decode_match_the_reference(s, seq_chunk):
    jcfg, tcfg = _cfgs("recurrentgemma-2b", seq_chunk=seq_chunk)
    p = _rand(jrglru.rglru_defs(jcfg), np.random.default_rng(s))
    tp = _t(p)
    assert {k: v.shape for k, v in trglru.rglru_defs(tcfg).items()} == {
        k: v.shape for k, v in jrglru.rglru_defs(jcfg).items()}
    x = _x((2, s, jcfg.d_model), 4)
    xc = _x((2, s, jcfg.lru_width), 5)
    for jv, tv in zip(jrglru._lru_coeffs(p, jcfg, xc), trglru._lru_coeffs(tp, tcfg,
                                                                          torch.from_numpy(xc))):
        np.testing.assert_allclose(_np(tv), jv, **TOL)
    np.testing.assert_allclose(
        _np(trglru._block_diag(torch.from_numpy(xc), tp["gate_a_w"], tp["gate_a_b"], 4)),
        jrglru._block_diag(xc, p["gate_a_w"], p["gate_a_b"], 4), **TOL)
    jy, jst = jrglru.rglru_apply(p, jcfg, x, return_state=True)
    ty, tst = trglru.rglru_apply(tp, tcfg, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(_np(ty), jy, **TOL)
    np.testing.assert_allclose(_np(tst.h), jst.h, **TOL)
    np.testing.assert_allclose(_np(tst.conv), jst.conv, **TOL)
    assert isinstance(tst, trglru.LRUState)
    x2 = _x((2, 3, jcfg.d_model), 6)
    np.testing.assert_allclose(_np(trglru.rglru_apply(tp, tcfg, torch.from_numpy(x2), tst)),
                               jrglru.rglru_apply(p, jcfg, x2, jst), **TOL)
    for i in range(3):
        xs = _x((2, 1, jcfg.d_model), 20 + i)
        jy, jst = jrglru.rglru_decode(p, jcfg, xs, jst)
        ty, tst = trglru.rglru_decode(tp, tcfg, torch.from_numpy(xs), tst)
        np.testing.assert_allclose(_np(ty), jy, **TOL)
        np.testing.assert_allclose(_np(tst.h), jst.h, **TOL)
    st = trglru.init_lru_state(tcfg, 2, torch.float32, "cpu")
    jstate = jrglru.init_lru_state(jcfg, 2, jnp.float32)
    assert tuple(st.h.shape) == jstate.h.shape and tuple(st.conv.shape) == jstate.conv.shape


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def _moe_case(arch, t_tokens, seed):
    jcfg, tcfg = _cfgs(arch)
    p = _rand(jmoe.moe_defs(jcfg), np.random.default_rng(seed))
    x = _x((2, t_tokens // 2, jcfg.d_model), seed + 1)
    return jcfg, tcfg, p, x


def _reference_routing(p, cfg, x):
    """The reference's top-k indices and kept pairs (its ``_moe_local``'s
    first lines, on one device)."""
    import math

    xf = x.reshape(-1, x.shape[-1])
    t = xf.shape[0]
    e_pad = jmoe.padded_experts(cfg.n_experts)
    k = cfg.n_experts_per_tok
    cap = max(8, int(math.ceil(t * k / e_pad * cfg.capacity_factor)))
    logits = (xf @ p["router"]).astype(jnp.float32)
    logits = jnp.where((jnp.arange(e_pad) < cfg.n_experts)[None], logits, -jnp.inf)
    _, top_idx = jax.lax.top_k(logits, k)
    onehot = (top_idx.reshape(-1)[:, None] == jnp.arange(e_pad)[None]).astype(jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - 1, top_idx.reshape(-1)[:, None], 1)
    return np.asarray(top_idx), np.asarray(pos.reshape(t, k) < cap), cap


@pytest.mark.parametrize("arch,tokens", [
    ("qwen2-moe-a2.7b", 128),   # shared expert; 8 real of 16 padded: drops at capacity
    ("dbrx-132b", 128),         # no shared expert; drops
    ("qwen2-moe-a2.7b", 6),     # few tokens: capacity 8, nothing drops
])
def test_moe_local_matches_the_reference(arch, tokens, tmp_path):
    jcfg, tcfg, p, x = _moe_case(arch, tokens, 3)
    tp = _t(p)
    e_pad = jmoe.padded_experts(jcfg.n_experts)
    assert tmoe.padded_experts(tcfg.n_experts) == e_pad == 16
    jy, jaux = jmoe._moe_local(p, jcfg, jnp.asarray(x), e_loc=e_pad, my_first=jnp.int32(0),
                               act=jact_fn("silu"))
    ty, taux = tmoe._moe_local(tp, tcfg, torch.from_numpy(x), e_loc=e_pad, my_first=0,
                               act=tcommon.act_fn("silu"))
    np.testing.assert_allclose(_np(ty), jy, **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # the routing: indices (in the reference's order) and the pairs kept
    top_idx, kept, cap = _reference_routing(p, jcfg, x)
    r = tmoe.route(tp, tcfg, torch.from_numpy(x).reshape(-1, jcfg.d_model), e_loc=e_pad)
    np.testing.assert_array_equal(_np(r.top_idx), top_idx)
    np.testing.assert_array_equal(_np(r.keep), kept)
    assert r.cap == cap and int(r.top_idx.max()) < jcfg.n_experts  # pads never chosen
    dropped = tmoe.dropped_pairs(tp, tcfg, torch.from_numpy(x))
    assert dropped == int((~kept).sum())
    if tokens > 8:
        assert dropped > 0
    else:
        assert dropped == 0
    # moe_apply with no mesh, and on a mesh of one rank (a gloo world of one:
    # the expert-parallel path, its collectives run), is the local body
    ty2, taux2 = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert torch.equal(ty2, ty) and torch.equal(taux2, taux)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with tmesh.use_mesh(tmesh.make_host_mesh(1, 1, device="cpu")):
            calls = tcoll.TP.calls
            ty3, taux3 = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
            assert tcoll.TP.calls > calls
    finally:
        dist.destroy_process_group()
    assert torch.equal(ty3, ty) and torch.equal(taux3, taux)


class _Mesh:
    """Stands in for rank ``(0, 0)`` of a DeviceMesh of ``("data", "model")``."""

    mesh_dim_names = ("data", "model")

    def __init__(self, sizes):
        self._sizes = sizes

    def size(self, dim=None):
        return self._sizes[dim] if dim is not None else self._sizes[0] * self._sizes[1]

    def get_coordinate(self):
        return [0, 0]


def test_moe_apply_on_a_mesh_of_two_ranks_raises_the_sharded_lm():
    """Expert parallelism is ported (the 8-rank worlds of
    ``tests/test_torch_sharded_lm_moe.py`` run it); the one raise left on a
    mesh is the reference's: a model axis that does not divide the padded
    experts (16 here), before any collective."""
    jcfg, tcfg, p, x = _moe_case("qwen2-moe-a2.7b", 8, 4)
    assert tmoe.padded_experts(tcfg.n_experts) == 16
    with tmesh.use_mesh(_Mesh((1, 3))):
        with pytest.raises(ValueError, match="not divisible by tp=3"):
            tmoe.moe_apply(_t(p), tcfg, torch.from_numpy(x))


def test_moe_defs_match_the_reference():
    for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
        for full in (True, False):
            jcfg = jconfigs.get_config(arch)
            tcfg = tconfigs.get_config(arch)
            if not full:
                jcfg, tcfg = jcfg.reduced(), tcfg.reduced()

            def flat(defs):
                out = {}
                for k, v in defs.items():
                    if isinstance(v, dict):
                        out.update({f"{k}/{kk}": (vv.shape, vv.spec) for kk, vv in v.items()})
                    else:
                        out[k] = (v.shape, v.spec)
                return out

            assert flat(tmoe.moe_defs(tcfg)) == flat(jmoe.moe_defs(jcfg))
    assert tmoe.EXPERT_PAD_MULTIPLE == jmoe.EXPERT_PAD_MULTIPLE
    assert [tmoe.padded_experts(n) for n in (1, 16, 60, 17)] == [16, 16, 64, 32]


# --------------------------------------------------------------------------
# enc-dec (whisper)
# --------------------------------------------------------------------------
def test_encode_decode_train_and_decode_step_match_the_reference():
    jcfg, jm, jp, tm = _pair("whisper-base", seed=5)
    frames = _x((2, 10, jcfg.d_model), 6)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
    jenc = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp, frames)
    with torch.no_grad():
        tenc = tencdec.encode(tm.params, tm.cfg, torch.from_numpy(frames))
        np.testing.assert_allclose(_np(tenc), jenc, **TOL)
        jlog = jax.jit(lambda p, t, e: jencdec.decode_train(p, jcfg, t, e))(jp, toks, jenc)
        tlog = tencdec.decode_train(tm.params, tm.cfg, torch.from_numpy(toks), tenc)
        np.testing.assert_allclose(_np(tlog), jlog, **TOL)
        jc = jencdec.init_encdec_cache(jp, jcfg, jenc, 12, jnp.float32)
        tc = tencdec.init_encdec_cache(tm.params, tm.cfg, tenc, 12, torch.float32)
        for (tk, tv), (jk, jv) in zip(tc.cross_kv, jc.cross_kv):
            np.testing.assert_allclose(_np(tk), jk, **TOL)
            np.testing.assert_allclose(_np(tv), jv, **TOL)
        step = jax.jit(lambda p, t, c: jencdec.decode_step(p, jcfg, t, c))
        for i in range(7):
            jl, jc = step(jp, toks[:, i : i + 1], jc)
            tl, tc = tencdec.decode_step(tm.params, tm.cfg, torch.from_numpy(toks[:, i : i + 1]),
                                         tc)
            np.testing.assert_allclose(_np(tl), jl, **TOL)
            # teacher-forced decode equals the parallel decoder pass
            np.testing.assert_allclose(_np(tl[:, 0]), _np(tlog[:, i]), **MODEL_TOL)
        assert tc.length == 7 == int(jc.length)
        np.testing.assert_allclose(_np(tc.self_kv[0].k), jc.self_kv[0].k, **TOL)
    assert tencdec.MAX_POSITIONS == jencdec.MAX_POSITIONS
    with pytest.raises(AssertionError, match="prefill"):
        tm.init_cache(2, 8)


def test_encdec_prefill_decodes_only_the_first_prompt_token():
    """The reference's prefill for an enc-dec model encodes the frames and
    decodes ``tokens[:, :1]`` alone; the rest of the prompt changes nothing
    (a reference caveat, copied)."""
    jcfg, jm, jp, tm = _pair("whisper-base", seed=8)
    frames = _x((2, 6, jcfg.d_model), 9)
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (2, 6)).astype(np.int32)
    other = toks.copy()
    other[:, 1:] = (other[:, 1:] + 1) % jcfg.vocab
    jcache, jl = jax.jit(lambda p, b: jm.prefill(p, b, max_len=12))(
        jp, {"tokens": toks, "frames": frames})
    outs = []
    for tk in (toks, other):
        cache, tl = tm.prefill(tm.params, {"tokens": torch.from_numpy(tk),
                                           "frames": torch.from_numpy(frames)}, max_len=12)
        outs.append(tl)
        assert cache.length == 1 == int(jcache.length)
    np.testing.assert_allclose(_np(outs[0]), jl, **MODEL_TOL)
    assert torch.equal(outs[0], outs[1])
    with torch.no_grad():
        enc = tencdec.encode(tm.params, tm.cfg, torch.from_numpy(frames))
        c = tencdec.init_encdec_cache(tm.params, tm.cfg, enc, 12, torch.float32)
        one, _ = tencdec.decode_step(tm.params, tm.cfg, torch.from_numpy(toks[:, :1]), c)
    assert torch.equal(one, outs[0])


def test_encdec_loss_matches_the_reference():
    jcfg, jm, jp, tm = _pair("whisper-base", seed=11)
    batch = {"tokens": np.random.default_rng(12).integers(0, jcfg.vocab, (2, 9)).astype(np.int32),
             "frames": _x((2, 9, jcfg.d_model), 13)}
    jloss, jmet = jax.jit(jm.loss_fn)(jp, batch)
    with torch.no_grad():
        tloss, tmet = tm.loss_fn(tm.params, _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), **MODEL_TOL)
    assert set(tmet) == set(jmet)


# --------------------------------------------------------------------------
# decode against forward, within the port
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n", [
    ("falcon-mamba-7b", 10),
    ("recurrentgemma-2b", 40),   # local window 16: the ring wraps
    ("qwen2-moe-a2.7b", 6),
    ("dbrx-132b", 6),
])
def test_decode_matches_forward(arch, n):
    """Teacher-forced decode step by step matches the parallel forward (the
    reference's ``test_decode_matches_forward_dense`` for the recurrent and
    MoE families; a MoE forward that drops no pair at capacity)."""
    cfg = tconfigs.get_config(arch).reduced()
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (1, n)).astype(np.int32))
    with torch.no_grad():
        h, aux, _ = ttrans.forward(tm.params, cfg, toks)
        full = ttrans.lm_logits(tm.params, cfg, h)
        if cfg.n_experts:
            assert float(aux) > 0
            drops = []
            real = tmoe._moe_local

            def counting(p, cfg_, x, **kw):
                drops.append(tmoe.dropped_pairs(p, cfg_, x))
                return real(p, cfg_, x, **kw)

            tmoe._moe_local = counting
            try:
                ttrans.forward(tm.params, cfg, toks)
            finally:
                tmoe._moe_local = real
            assert drops == [0] * cfg.n_layers
        cache = tm.init_cache(batch=1, max_len=n)
        steps = []
        for i in range(n):
            lg, cache = tm.decode_step(tm.params, toks[:, i : i + 1], cache)
            steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1), full, **MODEL_TOL)
    assert cache.length == n
