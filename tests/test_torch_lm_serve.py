"""Parity of the port's LM serving engine with the JAX reference, on the CPU.

The reference's parameters cross into the port through
``params_from_numpy``; prompts are made with numpy from a seed.  Greedy
tokens are held against the reference's under the top-2 rule: step by step
the two agree while the reference's top-2 logit gap exceeds ``GAP`` (the
reference's own 2e-3 logit tolerance); at the first step where it does not,
either argmax is right and the comparison stops.  Sampling draws from
different generators in the two packages, so temperature output is held
to the reference test's own properties (shape, range) and to determinism
for one seed within the port.

The engine copies the reference's batching: prompts left-padded with token
0, the pads attended (no mask), positions counted from the first pad.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpoint.manager import _flatten
from repro.models import build_model as jbuild
from repro.serve.engine import GenerationConfig as JGen
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model
from repro_torch.serve import GenerationConfig, QueueFull, Request, ServeEngine, generate

GAP = 2e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def olmo():
    jcfg = jconfigs.get_config("olmo-1b").reduced()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tconfigs.get_config("olmo-1b").reduced(), device="cpu")
    params_from_numpy(tm, _flatten(jp))
    return jcfg, jm, jp, tm


def _reference_greedy(jm, jp, tokens, n):
    """The reference's greedy tokens and each step's top-2 logit gap (an
    enc-dec model given the engine's zero frames)."""
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, max_len=tokens.shape[1] + n + 1))
    decode = jax.jit(jm.decode_step)
    batch = {"tokens": jnp.asarray(tokens)}
    if jm.cfg.is_encdec:
        batch["frames"] = jnp.zeros(tokens.shape + (jm.cfg.d_model,), jnp.float32)
    cache, logits = prefill(jp, batch)
    toks, gaps = [], []
    for _ in range(n):
        last = np.asarray(logits[:, -1], np.float32)
        top2 = np.sort(last, -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        tok = last.argmax(-1).astype(np.int32)[:, None]
        toks.append(tok[:, 0])
        logits, cache = decode(jp, jnp.asarray(tok), cache)
    return np.stack(toks, 1), np.stack(gaps, 1)


def _agree_under_top2(got, want, gaps):
    """Row by row: equal up to the first step whose reference gap is under
    GAP (that step may differ, the rest may diverge)."""
    compared = 0
    for g, w, gap in zip(got, want, gaps):
        for t in range(len(w)):
            if gap[t] <= GAP:
                break
            assert g[t] == w[t], (g, w, gap)
            compared += 1
    return compared


def test_generate_greedy_matches_the_reference(olmo):
    jcfg, jm, jp, tm = olmo
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (3, 8)).astype(np.int32)
    want, gaps = _reference_greedy(jm, jp, tokens, 6)
    got = generate(tm, tm.params, {"tokens": torch.from_numpy(tokens)},
                   GenerationConfig(max_new_tokens=6))
    assert got.dtype == np.int32 and got.shape == (3, 6)
    assert _agree_under_top2(got, want, gaps) >= 6


def test_generate_greedy_deterministic(olmo):
    jcfg, _, _, tm = olmo
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8)).astype(np.int32))}
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0)
    a = generate(tm, tm.params, batch, gen)
    b = generate(tm, tm.params, batch, gen)
    assert a.shape == (2, 6)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and (a < jcfg.vocab).all()


def test_generate_temperature_valid_and_seeded(olmo):
    jcfg, _, _, tm = olmo
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(3).integers(0, jcfg.vocab, (2, 8)).astype(np.int32))}
    out = generate(tm, tm.params, batch, GenerationConfig(max_new_tokens=5, temperature=1.0))
    assert out.shape == (2, 5)
    assert (out >= 0).all() and (out < jcfg.vocab).all()
    again = generate(tm, tm.params, batch, GenerationConfig(max_new_tokens=5, temperature=1.0))
    np.testing.assert_array_equal(out, again)  # one seed, one draw


def test_generate_matches_decode_consistency(olmo):
    """Greedy generate continuation equals a manual prefill + decode argmax."""
    jcfg, _, _, tm = olmo
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, jcfg.vocab, (1, 8)).astype(np.int32))
    gen_out = generate(tm, tm.params, {"tokens": tokens}, GenerationConfig(max_new_tokens=4))
    cache, logits = tm.prefill(tm.params, {"tokens": tokens}, max_len=13)
    toks = []
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for _ in range(4):
        toks.append(int(tok[0, 0]))
        logits, cache = tm.decode_step(tm.params, tok, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(gen_out[0], np.asarray(toks))


def test_vlm_generate_matches_the_reference():
    """qwen2-vl (M-RoPE, text only): positions default to equal streams."""
    jcfg = jconfigs.get_config("qwen2-vl-7b").reduced()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = build_model(tconfigs.get_config("qwen2-vl-7b").reduced(), device="cpu")
    params_from_numpy(tm, _flatten(jp))
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
    want, gaps = _reference_greedy(jm, jp, tokens, 5)
    got = generate(tm, tm.params, {"tokens": torch.from_numpy(tokens)},
                   GenerationConfig(max_new_tokens=5))
    assert _agree_under_top2(got, want, gaps) >= 5


def test_engine_serves_queue(olmo):
    _, _, _, tm = olmo
    eng = ServeEngine(tm, tm.params, GenerationConfig(max_new_tokens=3), batch_size=2)
    rids = [eng.submit(np.full((5,), i + 1, np.int32)) for i in range(5)]
    results = eng.flush()
    assert sorted(results) == sorted(rids) == list(range(5))
    for r in results.values():
        assert r.shape == (3,)
    assert eng.flush() == {}


def test_engine_left_pads_with_attended_zeros(olmo):
    """A short prompt served beside a long one is the long batch's row: the
    prompt left-padded with token 0, the pads attended, positions from the
    first pad (the reference's semantics, copied)."""
    jcfg, _, _, tm = olmo
    rng = np.random.default_rng(6)
    short, long = rng.integers(1, jcfg.vocab, 4), rng.integers(1, jcfg.vocab, 9)
    eng = ServeEngine(tm, tm.params, GenerationConfig(max_new_tokens=4), batch_size=2)
    r_short, r_long = eng.submit(short), eng.submit(long)
    out = eng.flush()
    padded = np.zeros((2, 9), np.int32)
    padded[0, 5:] = short
    padded[1] = long
    want = generate(tm, tm.params, {"tokens": torch.from_numpy(padded)},
                    GenerationConfig(max_new_tokens=4))
    np.testing.assert_array_equal(out[r_short], want[0])
    np.testing.assert_array_equal(out[r_long], want[1])
    alone = generate(tm, tm.params, {"tokens": torch.from_numpy(short[None].astype(np.int32))},
                     GenerationConfig(max_new_tokens=4))
    assert alone.shape == (1, 4)  # served alone it has no pads: not held equal


def test_engine_matches_the_reference_engine(olmo):
    """The same prompts through both engines (batch 4, mixed lengths):
    every rid answered, tokens equal under the top-2 rule."""
    jcfg, jm, jp, tm = olmo
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, int(rng.integers(4, 10))) for _ in range(5)]
    jeng = JEngine(jm, jp, JGen(max_new_tokens=4), batch_size=4)
    teng = ServeEngine(tm, tm.params, GenerationConfig(max_new_tokens=4), batch_size=4)
    for p in prompts:
        assert jeng.submit(p) == teng.submit(p)
    jout, tout = jeng.flush(), teng.flush()
    assert sorted(tout) == sorted(jout) == list(range(5))
    for chunk in (range(0, 4), range(4, 5)):
        s = max(len(prompts[i]) for i in chunk)
        toks = np.zeros((4, s), np.int32)
        for row, i in enumerate(chunk):
            toks[row, s - len(prompts[i]):] = prompts[i]
        want, gaps = _reference_greedy(jm, jp, toks, 4)
        for row, i in enumerate(chunk):
            np.testing.assert_array_equal(want[row], jout[i])
            _agree_under_top2([tout[i]], [want[row]], [gaps[row]])


def test_engine_backpressure():
    from repro_torch.serve import engine

    assert engine.Request is Request
    cfg = tconfigs.get_config("olmo-1b").reduced()
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    eng = ServeEngine(tm, tm.params, GenerationConfig(max_new_tokens=1), max_pending=2)
    eng.submit([1, 2, 3])
    eng.submit([4, 5])
    with pytest.raises(QueueFull):
        eng.submit([6])
    assert len(eng.flush()) == 2


def test_serve_driver_refuses_a_sharded_mesh():
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="world size 1"):
        serve.main(["--arch", "olmo-1b", "--reduced", "--tp", "2", "--device", "cpu"])
    # every family shards over "model" now: the MoE's --tp 2 is refused only
    # because the mesh is not the world
    with pytest.raises(ValueError, match="world size 1"):
        serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--tp", "2", "--device", "cpu"])


def test_serve_driver_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
         "olmo-1b", "--reduced", "--requests", "2", "--new-tokens", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "served 2 requests / 8 tokens" in proc.stderr


FAMILIES = ["qwen2-moe-a2.7b", "dbrx-132b", "falcon-mamba-7b", "recurrentgemma-2b", "whisper-base"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_the_reference_engine_for_the_other_families(arch):
    """MoE, SSM, hybrid and enc-dec models through both engines (batch 4,
    mixed lengths; an enc-dec model gets zero frames): every rid answered,
    the reference engine's tokens its greedy loop's, the port's equal to
    them under the top-2 rule."""
    jcfg = jconfigs.get_config(arch).reduced()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(8))
    tm = build_model(tconfigs.get_config(arch).reduced(), device="cpu")
    params_from_numpy(tm, _flatten(jp))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, jcfg.vocab, int(rng.integers(4, 10))) for _ in range(5)]
    jeng = JEngine(jm, jp, JGen(max_new_tokens=4), batch_size=4)
    teng = ServeEngine(tm, tm.params, GenerationConfig(max_new_tokens=4), batch_size=4)
    for p in prompts:
        assert jeng.submit(p) == teng.submit(p)
    jout, tout = jeng.flush(), teng.flush()
    assert sorted(tout) == sorted(jout) == list(range(5))
    compared = 0
    for chunk in (range(0, 4), range(4, 5)):
        s = max(len(prompts[i]) for i in chunk)
        toks = np.zeros((4, s), np.int32)
        for row, i in enumerate(chunk):
            toks[row, s - len(prompts[i]):] = prompts[i]
        want, gaps = _reference_greedy(jm, jp, toks, 4)
        for row, i in enumerate(chunk):
            np.testing.assert_array_equal(want[row], jout[i])
            compared += _agree_under_top2([tout[i]], [want[row]], [gaps[row]])
    assert compared >= 10


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "whisper-base"])
def test_serve_driver_serves_the_other_families_on_the_cpu(arch):
    """``launch.serve --device cpu`` serves a reduced SSM and a reduced
    enc-dec model."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
         arch, "--reduced", "--requests", "3", "--new-tokens", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests / 12 tokens" in proc.stderr
