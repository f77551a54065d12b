"""Parity of the port's LM model code with the JAX reference, on the CPU.

Inputs and weights are made once with numpy from a seed and given to both
packages; a whole model's reference parameters cross into the port through
``repro_torch.interop.params_from_numpy`` (the reference's checkpoint leaf
paths, a scanned stack as one array with a leading layer axis).  Reduced
configs compute in fp32.

Tolerances: the building blocks (norms, RoPE, M-RoPE, activations,
attention, FFN) at the port's fp32 bound ``rtol=2e-4, atol=2e-5``; whole-
model logits (forward, prefill, decode) and the loss at the reference's own
2e-3 (``tests/test_models_smoke.py``: decode against the forward pass), and
the SWA ring against the windowed forward at its 3e-3.  Every one of the
ten architectures is built; the MoE, SSM, RG-LRU and enc-dec blocks have
their own parity tests in ``tests/test_torch_lm_families.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpoint.manager import _flatten
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import transformer as jtrans
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttrans

TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
SWA_TOL = dict(rtol=3e-3, atol=3e-3)
BUILT = ["olmo-1b", "qwen3-8b", "h2o-danube-3-4b", "deepseek-coder-33b", "qwen2-vl-7b",
         "dbrx-132b", "qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b", "whisper-base"]


def _cfgs(arch, **changes):
    j = dataclasses.replace(jconfigs.get_config(arch).reduced(), **changes)
    t = dataclasses.replace(tconfigs.get_config(arch).reduced(), **changes)
    return j, t


def _pair(arch, seed=0, **changes):
    """Reference and port models of one reduced config, the reference's
    params (seeded) loaded into the port's."""
    jcfg, tcfg = _cfgs(arch, **changes)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    params_from_numpy(tm, _flatten(jp))
    return jcfg, jm, jp, tm


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------
def test_norms_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    np.testing.assert_allclose(_np(tcommon.rms_norm(tx, tw)), jcommon.rms_norm(x, w), **TOL)
    np.testing.assert_allclose(_np(tcommon.rms_norm(tx, None)), jcommon.rms_norm(x, None), **TOL)
    np.testing.assert_allclose(_np(tcommon.layer_norm(tx, tw, tb)),
                               jcommon.layer_norm(x, w, b), **TOL)
    np.testing.assert_allclose(_np(tcommon.layer_norm(tx, None, None)),
                               jcommon.layer_norm(x, None, None), **TOL)
    for kind, p in (("rmsnorm", {"w": w}), ("layernorm", {"w": w, "b": b}), ("layernorm_np", {})):
        assert set(tcommon.norm_defs(kind, 24)) == set(jcommon.norm_defs(kind, 24))
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        np.testing.assert_allclose(_np(tcommon.norm_apply(kind, tx, tp)),
                                   jcommon.norm_apply(kind, x, p), **TOL)
    # computed in fp32, cast back
    assert tcommon.rms_norm(tx.bfloat16(), tw).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tcommon.norm_defs("batchnorm", 4)


@pytest.mark.parametrize("hd", [16, 128, 15])
def test_rope_matches_the_reference(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    for theta in (1.0e4, 1.0e6):
        got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(_np(got), jcommon.apply_rope(x, pos, theta), **TOL)


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches_the_reference(sections, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 6, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 6, 3)).astype(np.int32)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, 1.0e6)
    np.testing.assert_allclose(_np(got), jcommon.apply_mrope(x, pos, sections, 1.0e6), **TOL)
    # text tokens (equal streams) reduce to plain RoPE
    same = np.repeat(pos[..., :1], 3, -1)
    np.testing.assert_allclose(
        _np(tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), sections, 1.0e6)),
        _np(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]), 1.0e6)),
        **TOL)


def test_rope_casts_each_half_to_the_input_dtype():
    x = torch.randn(1, 3, 2, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = tcommon.apply_rope(x, torch.arange(3)[None], 1.0e4)
    assert out.dtype == torch.bfloat16
    ref = jcommon.apply_rope(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             jnp.arange(3)[None], 1.0e4)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations_match_the_reference(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(_np(tcommon.act_fn(name)(torch.from_numpy(x))),
                               jcommon.act_fn(name)(x), **TOL)


def test_gelu_is_the_tanh_form_as_jax_default():
    x = torch.linspace(-4, 4, 101)
    got = tcommon.act_fn("gelu")(x)
    torch.testing.assert_close(got, torch.nn.functional.gelu(x, approximate="tanh"))
    assert float((got - torch.nn.functional.gelu(x)).abs().max()) > 1e-4  # not the erf form


def test_small_helpers_match_the_reference():
    for v in (256, 32000, 50304, 51865, 151936):
        assert tcommon.vocab_padded(v) == jcommon.vocab_padded(v)
    logits = np.random.default_rng(0).standard_normal((2, 3, 384)).astype(np.float32)
    np.testing.assert_array_equal(_np(tcommon.mask_vocab_pad(torch.from_numpy(logits), 300)),
                                  jcommon.mask_vocab_pad(logits, 300))
    lt = torch.from_numpy(logits)
    assert tcommon.mask_vocab_pad(lt, 384) is lt
    np.testing.assert_allclose(_np(tcommon.sinusoid_positions(10, 8, device="cpu")),
                               jcommon.sinusoid_positions(10, 8), **TOL)
    np.testing.assert_allclose(_np(tcommon.softcap(lt, 30.0)), jcommon.softcap(logits, 30.0),
                               **TOL)
    assert tcommon.softcap(lt, 0.0) is lt
    for hd in (16, 120, 128):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            want = float((1.0 / jnp.sqrt(hd).astype(jdt)).astype(jnp.float32))
            assert tcommon.attention_scale(hd, dt) == want


def test_param_def_init_rules():
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tcommon.ParamDef((3,), (None,), "ones").make(g, torch.float32, "cpu"),
                       torch.ones(3))
    assert torch.equal(tcommon.ParamDef((3,), (None,), "zeros").make(g, torch.float32, "cpu"),
                       torch.zeros(3))
    for init, std in (("fan_in", 1 / 32), ("small", 0.02), ("normal", 1.0)):
        x = tcommon.ParamDef((1024, 512), (None, None), init).make(g, torch.float32, "cpu")
        assert abs(float(x.std()) / std - 1) < 0.02
    meta = tcommon.ParamDef((4, 5), (None, None)).make(None, torch.float32, "meta")
    assert meta.is_meta and tuple(meta.shape) == (4, 5)
    # one generator seed, one draw
    a = tcommon.ParamDef((4, 5), (None, None)).make(torch.Generator().manual_seed(3),
                                                    torch.float32, "cpu")
    b = tcommon.ParamDef((4, 5), (None, None)).make(torch.Generator().manual_seed(3),
                                                    torch.float32, "cpu")
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _attn_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    defs = jattn.attn_defs(cfg)
    p = {}
    for k, d in defs.items():
        if d.init == "ones":
            p[k] = (1 + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        else:
            p[k] = (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
    assert set(tattn.attn_defs(cfg)) == set(defs)
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


def _positions(cfg, b, s):
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    if cfg.mrope_sections:
        pos = np.broadcast_to(pos[..., None], (b, s, 3))
    return np.ascontiguousarray(pos)


@pytest.mark.parametrize("case", [
    ("olmo-1b", {}, 0, 0, 12),                  # full causal, MHA
    ("qwen3-8b", {}, 0, 0, 12),                 # GQA groups (g=2), QK-norm
    ("h2o-danube-3-4b", {}, 16, 0, 48),         # windowed: chunks at the window, key span
    ("h2o-danube-3-4b", {}, 16, 0, 40),         # window with s % window != 0: one block
    ("olmo-1b", {}, 0, 4, 12),                  # explicit query chunks, full keys
    ("olmo-1b", {}, 6, 4, 12),                  # window 6 over chunks of 4
    ("qwen2-vl-7b", {}, 0, 0, 10),              # M-RoPE
])
def test_attn_sequence_matches_the_reference(case):
    arch, changes, window, q_chunk, s = case
    jcfg, tcfg = _cfgs(arch, **changes)
    p, tp = _attn_params(jcfg)
    x = np.random.default_rng(1).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    pos = _positions(jcfg, 2, s)
    for causal in (True, False):
        jy, (jk, jv) = jax.jit(lambda p_, x_, pos_: jattn.attn_sequence(
            p_, jcfg, x_, pos_, causal=causal, window=window, q_chunk=q_chunk, return_kv=True,
        ))(p, jnp.asarray(x), jnp.asarray(pos))
        ty, (tk, tv) = tattn.attn_sequence(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                           causal=causal, window=window, q_chunk=q_chunk,
                                           return_kv=True)
        np.testing.assert_allclose(_np(ty), jy, **TOL)
        np.testing.assert_allclose(_np(tk), jk, **TOL)
        np.testing.assert_allclose(_np(tv), jv, **TOL)


def test_attend_expands_kv_heads_when_the_groups_do_not_divide_tp(monkeypatch):
    """The grouped branch (``hk % tp == 0``, always at one device) and the
    expanded branch give the same attention; each matches the reference's
    branch under the same tp."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    mask = np.asarray(jattn._causal_mask(5, 7, 2, 0))
    tq, tk, tv, tm = (torch.from_numpy(np.array(a)) for a in (q, k, v, mask))
    grouped = tattn._attend(tq, tk, tv, tm)
    np.testing.assert_allclose(_np(grouped), jattn._attend(q, k, v, mask), **TOL)
    monkeypatch.setattr(tattn.meshlib, "tp_size", lambda mesh=None: 3)
    monkeypatch.setattr(jattn.meshlib, "tp_size", lambda mesh=None: 3)
    expanded = tattn._attend(tq, tk, tv, tm)
    np.testing.assert_allclose(_np(expanded), jattn._attend(q, k, v, mask), **TOL)
    np.testing.assert_allclose(_np(expanded), _np(grouped), **TOL)


@pytest.mark.parametrize("arch,max_len,steps", [
    ("olmo-1b", 16, 6),
    ("qwen3-8b", 16, 6),
    ("qwen2-vl-7b", 16, 6),
    ("h2o-danube-3-4b", 64, 40),   # ring of 16 slots, wrapped twice
])
def test_attn_decode_matches_the_reference(arch, max_len, steps):
    jcfg, tcfg = _cfgs(arch)
    p, tp = _attn_params(jcfg)
    jc = jattn.init_kv_cache(jcfg, 2, max_len, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, 2, max_len, torch.float32, "cpu")
    assert tuple(tc.k.shape) == tuple(jc.k.shape)
    xs = np.random.default_rng(3).standard_normal((steps, 2, 1, jcfg.d_model)).astype(np.float32)
    for t in range(steps):
        jy, jc = jattn.attn_decode(p, jcfg, jnp.asarray(xs[t]), jc, jnp.asarray(t, jnp.int32))
        ty, tc = tattn.attn_decode(tp, tcfg, torch.from_numpy(xs[t]), tc, t)
        np.testing.assert_allclose(_np(ty), jy, **TOL)
    np.testing.assert_allclose(_np(tc.k), jc.k, **TOL)
    np.testing.assert_allclose(_np(tc.v), jc.v, **TOL)


def test_cross_attention_matches_the_reference():
    jcfg, tcfg = _cfgs("olmo-1b")
    p, tp = _attn_params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    jkv = jattn.cross_attn_kv(p, jcfg, enc)
    tkv = tattn.cross_attn_kv(tp, tcfg, torch.from_numpy(enc))
    np.testing.assert_allclose(_np(tattn.cross_attn(tp, tcfg, torch.from_numpy(x), tkv)),
                               jattn.cross_attn(p, jcfg, x, jkv), **TOL)


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------
@pytest.mark.parametrize("act,cp_rank", [("swiglu", 0), ("geglu", 0), ("gelu", 0),
                                         ("swiglu", 8), ("geglu", 8)])
def test_ffn_matches_the_reference(act, cp_rank):
    jcfg, tcfg = _cfgs("olmo-1b", act=act, cp_rank=cp_rank)
    jdefs, tdefs = jffn.ffn_defs(jcfg), tffn.ffn_defs(tcfg)
    assert {k: (d.shape, d.spec, d.init) for k, d in tdefs.items()} == {
        k: (d.shape, d.spec, d.init) for k, d in jdefs.items()}
    rng = np.random.default_rng(5)
    p = {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
         for k, d in jdefs.items()}
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    got = tffn.ffn_apply({k: torch.from_numpy(v) for k, v in p.items()}, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), jffn.ffn_apply(p, jcfg, x), **TOL)


def test_cp_rank_ffn_takes_compress_ffn_output():
    """``compress_ffn`` of a dense FFN gives exactly the ``cp_rank``
    parameter names, and the factored FFN equals the dense FFN whose
    weights are the products ``A @ B``."""
    from repro_torch.core.cp_layers import compress_ffn

    _, dense_cfg = _cfgs("olmo-1b")
    _, cp_cfg = _cfgs("olmo-1b", cp_rank=8)
    g = torch.Generator().manual_seed(0)
    dense = {k: d.make(g, torch.float32, "cpu") for k, d in tffn.ffn_defs(dense_cfg).items()}
    factored = compress_ffn(dense, 8)
    assert set(factored) == set(tffn.ffn_defs(cp_cfg))
    products = {k: factored[f"{k}_a"] @ factored[f"{k}_b"] for k in ("gate", "up", "down")}
    x = torch.randn(2, 5, dense_cfg.d_model, generator=g)
    torch.testing.assert_close(tffn.ffn_apply(factored, cp_cfg, x),
                               tffn.ffn_apply(products, dense_cfg, x), rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------
def _batch(cfg, toks, seed=0):
    batch = {"tokens": toks}
    if cfg.mrope_sections:
        batch["positions"] = _positions(cfg, *toks.shape)
    if cfg.is_encdec:
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            toks.shape + (cfg.d_model,)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", BUILT)
def test_forward_and_loss_match_the_reference(arch):
    jcfg, jm, jp, tm = _pair(arch, seed=1)
    s = 40 if arch.startswith("h2o") else 12
    toks = _tokens(jcfg, (2, s))
    batch = _batch(jcfg, toks)
    if jcfg.is_encdec:  # the encoder over the frames, the decoder teacher-forced
        from repro.models import encdec as jencdec
        from repro_torch.models import encdec as tencdec

        want = jax.jit(lambda p, t, f: jencdec.decode_train(p, jcfg, t, jencdec.encode(p, jcfg, f)))(
            jp, jnp.asarray(toks), jnp.asarray(batch["frames"]))
        with torch.no_grad():
            enc = tencdec.encode(tm.params, tm.cfg, torch.from_numpy(batch["frames"]))
            got = tencdec.decode_train(tm.params, tm.cfg, torch.from_numpy(toks), enc)
    else:
        want, jaux = jax.jit(lambda p, t: (
            lambda h, aux: (jtrans.lm_logits(p, jcfg, h), aux))(*jtrans.forward(p, jcfg, t)[:2]))(
            jp, jnp.asarray(toks))
        with torch.no_grad():
            th, aux, cache = ttrans.forward(tm.params, tm.cfg, torch.from_numpy(toks))
            got = ttrans.lm_logits(tm.params, tm.cfg, th)
        assert cache is None
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)
        assert (float(aux) > 0) == bool(jcfg.n_experts)
    np.testing.assert_allclose(_np(got), want, **MODEL_TOL)
    jloss, jmet = jax.jit(jm.loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tloss, tmet = tm.loss_fn(tm.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), **MODEL_TOL)
    np.testing.assert_allclose(float(tmet["acc"]), float(jmet["acc"]), atol=1e-6)
    assert set(tmet) == set(jmet)


def _check_cache(tcache, jcache, scanned):
    """The port's decode cache (per-layer entries) holds the reference's
    arrays (a scanned stack's stacked on a leading layer axis)."""
    if hasattr(tcache, "self_kv"):  # enc-dec
        assert tcache.length == int(jcache.length)
        for t_kv, j_kv in zip(tcache.self_kv + tcache.cross_kv, jcache.self_kv + jcache.cross_kv):
            for t_a, j_a in zip(t_kv, j_kv):
                np.testing.assert_allclose(_np(t_a), j_a, **MODEL_TOL)
        return
    assert tcache.length == int(jcache.length)
    if scanned:
        for field in tcache.entries[0]._fields:
            np.testing.assert_allclose(np.stack([_np(getattr(e, field)) for e in tcache.entries]),
                                       getattr(jcache.entries, field), **MODEL_TOL)
        return
    for t_e, j_e in zip(tcache.entries, jcache.entries):
        assert type(t_e).__name__ == type(j_e).__name__ and t_e._fields == j_e._fields
        for t_a, j_a in zip(t_e, j_e):
            np.testing.assert_allclose(_np(t_a), j_a, **MODEL_TOL)


@pytest.mark.parametrize("arch", BUILT)
def test_prefill_and_decode_match_the_reference(arch):
    jcfg, jm, jp, tm = _pair(arch, seed=2)
    toks = _tokens(jcfg, (2, 14), seed=3)
    prompt = 8 if not arch.startswith("h2o") else 10
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg, toks[:, :prompt], seed=4).items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    jcache, jl = jax.jit(lambda p, b: jm.prefill(p, b, max_len=24))(jp, jb)
    tcache, tl = tm.prefill(tm.params, tb, max_len=24)
    assert tuple(tl.shape) == (2, 1, jcfg.vocab)
    assert tcache.length == (1 if jcfg.is_encdec else prompt)  # enc-dec: the first token only
    np.testing.assert_allclose(_np(tl), jl, **MODEL_TOL)
    # the cache the port fills is the reference's, layer by layer
    _check_cache(tcache, jcache, ttrans.is_scanned(tm.cfg))
    decode = jax.jit(jm.decode_step)
    for i in range(prompt, 14):
        jl, jcache = decode(jp, jnp.asarray(toks[:, i : i + 1]), jcache)
        tl, tcache = tm.decode_step(tm.params, torch.from_numpy(toks[:, i : i + 1]), tcache)
        np.testing.assert_allclose(_np(tl), jl, **MODEL_TOL)
    _check_cache(tcache, jcache, ttrans.is_scanned(tm.cfg))
    assert tcache.length == (14 - prompt + 1 if jcfg.is_encdec else 14)


def test_prefill_longer_than_the_window_rolls_the_ring():
    """A prompt past the window keeps its last W tokens, rolled so position
    p sits at slot p % W (the reference's ``_fill_cache``)."""
    jcfg, jm, jp, tm = _pair("h2o-danube-3-4b", seed=4)
    toks = _tokens(jcfg, (1, 37), seed=5)
    jcache, jl = jax.jit(lambda p, b: jm.prefill(p, b, max_len=64))(
        jp, {"tokens": jnp.asarray(toks[:, :35])})
    tcache, tl = tm.prefill(tm.params, {"tokens": torch.from_numpy(toks[:, :35])}, max_len=64)
    assert tuple(tcache.entries[0].k.shape[1:2]) == (16,)
    np.testing.assert_allclose(np.stack([_np(e.k) for e in tcache.entries]), jcache.entries.k,
                               **MODEL_TOL)
    decode = jax.jit(jm.decode_step)
    for i in (35, 36):
        jl, jcache = decode(jp, jnp.asarray(toks[:, i : i + 1]), jcache)
        tl, tcache = tm.decode_step(tm.params, torch.from_numpy(toks[:, i : i + 1]), tcache)
        np.testing.assert_allclose(_np(tl), jl, **MODEL_TOL)


def _teacher_forced(tm, toks, max_len):
    cache = tm.init_cache(batch=toks.shape[0], max_len=max_len)
    out = []
    for i in range(toks.shape[1]):
        logits, cache = tm.decode_step(tm.params, toks[:, i : i + 1], cache)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def test_decode_matches_forward_dense():
    """Teacher-forced decode step by step matches the parallel forward
    within the port (the reference's ``test_decode_matches_forward_dense``)."""
    cfg = tconfigs.get_config("olmo-1b").reduced()
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(cfg, (1, 10), seed=5))
    with torch.no_grad():
        full = ttrans.lm_logits(tm.params, cfg, ttrans.forward(tm.params, cfg, toks)[0])
    torch.testing.assert_close(_teacher_forced(tm, toks, 16), full, **MODEL_TOL)


def test_decode_matches_forward_swa():
    """The sliding-window ring agrees with windowed parallel attention over
    three windows of tokens (the ring wraps twice)."""
    cfg = tconfigs.get_config("h2o-danube-3-4b").reduced()
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    n = 3 * cfg.sliding_window
    toks = torch.from_numpy(_tokens(cfg, (1, n), seed=7))
    with torch.no_grad():
        full = ttrans.lm_logits(tm.params, cfg, ttrans.forward(tm.params, cfg, toks)[0])
    assert tm.init_cache(1, n).entries[0].k.shape[1] == cfg.sliding_window
    torch.testing.assert_close(_teacher_forced(tm, toks, n), full, **SWA_TOL)


def test_model_is_a_module_with_the_reference_leaves():
    cfg = tconfigs.get_config("qwen3-8b").reduced()
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(tm, torch.nn.Module)
    named = dict(tm.named_parameters())
    flat = params_to_numpy(tm)  # a stacked leaf is one array for all layers
    per_layer = [k for k in flat if k.startswith("layers/")]
    assert len(named) == len(flat) - len(per_layer) + len(per_layer) * cfg.n_layers
    assert flat["layers/attn/wq"].shape == (cfg.n_layers,) + tuple(named["layers.0.attn.wq"].shape)
    assert named["layers.0.attn.wq"] is tm.params["layers"][0]["attn"]["wq"]
    # one seed, one init; another seed, another
    again = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    other = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    a, b, c = params_to_numpy(tm), params_to_numpy(again), params_to_numpy(other)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["embed"], c["embed"])
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert torch.equal(fresh["embed"], tm.params["embed"])


def test_params_from_numpy_refuses_missing_or_misshapen_leaves():
    jcfg, jm, jp, tm = _pair("olmo-1b")
    flat = _flatten(jp)
    with pytest.raises(KeyError):
        params_from_numpy(tm, {k: v for k, v in flat.items() if k != "embed"})
    bad = dict(flat)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError):
        params_from_numpy(tm, bad)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_layer_plan_matches_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert ttrans.layer_types(tcfg) == jtrans.layer_types(jcfg)
    assert ttrans.is_scanned(tcfg) == jtrans.is_scanned(jcfg)
