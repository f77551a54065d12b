"""Parity of the port's LM training path with the JAX reference, on the CPU.

The data pipeline (``repro_torch.data.pipeline``) must give the reference's
batches bitwise: batch ``i`` is a pure function of ``(seed, i)``, host
sharding included, and the loop's replay after a rollback depends on it.
``repro_torch.analysis.flops`` must count what the reference counts, for
every architecture, as plain integers.  The training step
(``train.train_step``) is held on reduced olmo-1b in fp32 compute, the
reference's parameters crossing through ``interop.params_from_numpy``:

* loss and metrics at the port's fp32 bound ``rtol=2e-4, atol=2e-5``;
* every gradient leaf within a norm-wise relative error of 2e-3, the
  reference's whole-model bound;
* ``adamw_update`` on gradients given to both as numpy at the fp32 bound;
* the updated parameters at the fp32 bound, except that an entry whose
  gradient is below ``SIGN_NOISE`` (1e-5) of its leaf's largest may move by
  up to 2 * lr more: on the first AdamW step ``m_hat / (sqrt(v_hat) +
  eps)`` is ``g / (|g| + eps)``, about ``sign(g)``, so a near-zero gradient
  whose sign or size differs between the packages moves its parameter by
  up to 2 * lr.  1e-6 suffices for one batch; the accumulated gradient is
  a mean of micro-batch gradients that cancel, and one entry at 3.3e-6 of
  its leaf's largest (2.5e-8, 2.5 eps) differs by 11% between the
  packages, moving its parameter by 2.8e-5;
* accumulation over 4 micro-batches against one batch (< 5e-3, the
  reference's own bound) and against the reference's accumulation.

The fault-tolerant loop is held port against port, with the reference's
own cases (``tests/test_train.py``): a run with an injected fault equals
the unfaulted run bitwise, the failure budget, a non-finite loss counting
as a failure, the straggler watchdog, ``jit_kwargs`` refused.  A
checkpoint of the reference's loop resumes in the port's.  The drivers run
with ``--device cpu``.
"""

import ast
import dataclasses
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.analysis import flops as jflops
from repro.checkpoint.manager import _flatten
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_step
from repro_torch import _tree
from repro_torch.analysis import flops as tflops
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as tpipe
from repro_torch.interop import optstate_from_numpy, optstate_to_numpy, params_from_numpy
from repro_torch.launch import serve as serve_driver
from repro_torch.launch import train as train_driver
from repro_torch.models import build_model
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tstep

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_REL = 2e-3
ACCUM_BOUND = 5e-3
SIGN_NOISE = 1e-5
LR = 1e-3
ARCHS = ["olmo-1b", "qwen3-8b", "h2o-danube-3-4b", "deepseek-coder-33b", "qwen2-vl-7b",
         "dbrx-132b", "qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b", "whisper-base"]
# batch x tokens of a family's step (default 4 x 16): the SSM's 256 runs its
# scan chunked (128 divides 256), and the chunked scan's backward with it
BATCH_SHAPES = {"falcon-mamba-7b": (2, 256)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's small CPU models run on one intra-op thread, restored
    after.  The suite runs files side by side, one worker process each, on
    one machine; there a multi-threaded torch op waits at its barrier for
    threads the other workers hold (the train files took 100-150 s each
    four side by side, against 3-75 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree):
    """A port tree as ``{leaf path: array}``."""
    return _tree.flatten(tree, _np, np.stack)


def _pair(arch="olmo-1b", seed=0, **changes):
    """Reduced reference and port models of one config, the reference's
    params (seeded) loaded into the port's."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), **changes)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    params_from_numpy(tm, _flatten(jp))
    return jm, jp, tm


def _batches(cfg, b=4, s=16, seed=0):
    """One batch as numpy, then as each package's arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _capture_grads(monkeypatch):
    """Record the gradients the port's step hands to ``adamw_update``."""
    seen = []
    real = tstep.adamw_update

    def recording(params, grads, state, cfg):
        seen.append(_flat(grads))
        return real(params, grads, state, cfg)

    monkeypatch.setattr(tstep, "adamw_update", recording)
    return seen


def _assert_update_close(got: dict, want: dict, grads: dict, lr: float):
    """Updated parameters at the fp32 bound; entries with a gradient below
    ``SIGN_NOISE`` of their leaf's largest may differ by a further 2 * lr
    (AdamW's first step moves them by about lr * sign(g))."""
    assert set(got) == set(want)
    for k in want:
        g = np.abs(np.asarray(grads[k]))
        allow = TOL["atol"] + TOL["rtol"] * np.abs(want[k]) + np.where(
            g < SIGN_NOISE * g.max(), 2 * lr, 0.0)
        bad = np.abs(got[k] - want[k]) > allow
        assert not bad.any(), (k, float(np.abs(got[k] - want[k]).max()))


def _assert_grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        rel = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert rel < GRAD_REL, (k, rel)


# --------------------------------------------------------------------------
# the data pipeline, bitwise
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed,index", [
    (97, 12, 8, 5, 11), (32, 32, 8, 0, 0), (50304, 16, 4, 3, 7), (211, 1, 2, 9, 123456),
])
def test_synthetic_batches_are_the_references_bitwise(vocab, seq, batch, seed, index):
    full = tpipe.SyntheticLM(tpipe.DataConfig(vocab, seq, batch, seed=seed)).batch(index)
    want = jpipe.SyntheticLM(jpipe.DataConfig(vocab, seq, batch, seed=seed)).batch(index)
    assert set(full) == {"tokens"} and full["tokens"].dtype == np.int32
    np.testing.assert_array_equal(full["tokens"], want["tokens"])
    for hosts in (2, 4):
        if batch % hosts:
            continue
        parts = []
        for h in range(hosts):
            c = tpipe.DataConfig(vocab, seq, batch, seed=seed, host_id=h, host_count=hosts)
            part = tpipe.SyntheticLM(c).batch(index)["tokens"]
            np.testing.assert_array_equal(part, jpipe.SyntheticLM(
                jpipe.DataConfig(vocab, seq, batch, seed=seed, host_id=h, host_count=hosts)
            ).batch(index)["tokens"])
            parts.append(part)
        np.testing.assert_array_equal(np.concatenate(parts), full["tokens"])


def _corpus(tmp_path, dtype, n=4096, vocab=300):
    path = tmp_path / f"corpus_{np.dtype(dtype).name}.bin"
    np.random.default_rng(0).integers(0, vocab, size=n).astype(dtype).tofile(path)
    return str(path)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_memmap_batches_are_the_references_bitwise(tmp_path, dtype):
    path = _corpus(tmp_path, dtype)
    for vocab, seq, batch, seed, index in ((211, 32, 4, 1, 0), (4096, 16, 8, 3, 2), (64, 7, 2, 7, 5)):
        got = tpipe.MemmapCorpus(path, tpipe.DataConfig(vocab, seq, batch, seed=seed),
                                 dtype=dtype).batch(index)["tokens"]
        want = jpipe.MemmapCorpus(path, jpipe.DataConfig(vocab, seq, batch, seed=seed),
                                  dtype=dtype).batch(index)["tokens"]
        assert got.dtype == np.int32 and got.shape == (batch, seq + 1)
        np.testing.assert_array_equal(got, want)
        parts = [tpipe.MemmapCorpus(path, tpipe.DataConfig(vocab, seq, batch, seed=seed,
                                                           host_id=h, host_count=2),
                                    dtype=dtype).batch(index)["tokens"] for h in range(2)]
        np.testing.assert_array_equal(np.concatenate(parts), got)


def test_memmap_corpus_too_short_raises_as_the_reference(tmp_path):
    path = _corpus(tmp_path, np.uint16, n=8)
    for pipe in (tpipe, jpipe):
        with pytest.raises(ValueError):
            pipe.MemmapCorpus(path, pipe.DataConfig(vocab=211, seq_len=32, global_batch=1))


def test_prefetcher_yields_the_references_batches_in_order(tmp_path):
    cfg = dict(vocab=97, seq_len=8, global_batch=2, seed=4)
    want = jpipe.SyntheticLM(jpipe.DataConfig(**cfg))
    sources = (tpipe.SyntheticLM(tpipe.DataConfig(**cfg)),
               tpipe.MemmapCorpus(_corpus(tmp_path, np.uint16), tpipe.DataConfig(**cfg)))
    for source in sources:
        pf = tpipe.Prefetcher(source, start=3, depth=2)
        try:
            got = [next(pf) for _ in range(4)]
        finally:
            pf.close()
        assert not pf._thread.is_alive()
        assert [i for i, _ in got] == [3, 4, 5, 6]
        ref = want if isinstance(source, tpipe.SyntheticLM) else jpipe.MemmapCorpus(
            source.data.filename, jpipe.DataConfig(**cfg))
        for i, b in got:
            np.testing.assert_array_equal(b["tokens"], ref.batch(i)["tokens"])


# --------------------------------------------------------------------------
# analysis/flops: the reference's counts for every architecture
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_counts_equal_the_reference(arch):
    for reduce in (False, True):
        t = tconfigs.get_config(arch)
        j = jconfigs.get_config(arch)
        if reduce:
            t, j = t.reduced(), j.reduced()
        n = tflops.param_count(t)
        assert type(n) is int and n == jflops.param_count(j)
        assert tflops.active_param_count(t) == jflops.active_param_count(j)
        if t.n_experts:
            assert tflops.active_param_count(t) < n
        for name, shape in tconfigs.LM_SHAPES.items():
            assert tflops.model_flops(t, shape) == jflops.model_flops(j, jconfigs.LM_SHAPES[name])
            for chips in (1, 256):
                assert tflops.hbm_estimate(t, shape, chips) == jflops.hbm_estimate(
                    j, jconfigs.LM_SHAPES[name], chips)
        for training in (True, False):
            assert tflops.bytes_per_param(t, training) == jflops.bytes_per_param(j, training)
        if reduce:  # the count is what build_model allocates
            m = build_model(t, device="meta")
            assert n == sum(p.numel() for p in m.parameters())


def test_olmo_1b_train_flops_of_the_smoke_step():
    """6 * N * D for olmo-1b's 1,176,764,416 parameters at 8 x 2048 tokens."""
    cfg = tconfigs.get_config("olmo-1b")
    assert tflops.param_count(cfg) == 1_176_764_416
    shape = tconfigs.ShapeConfig("smoke", 2048, 8, "train")
    assert tflops.model_flops(cfg, shape) == 6.0 * 1_176_764_416 * 8 * 2048


# --------------------------------------------------------------------------
# public signatures against the reference (ast)
# --------------------------------------------------------------------------
# the invariants' keyword-only additions; ``fsdp`` is make_train_step's
# FSDP/ZeRO-3 placement (the reference places parameters by spec instead)
ALLOWED_EXTRA = {"device", "generator", "argv", "fsdp"}


def _public(path: Path) -> dict:
    """``{name: (positional args, keyword-only args)}`` of the public
    functions and public classes' methods of a module, and each class's
    annotated fields."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = ([a.arg for a in node.args.args],
                              [a.arg for a in node.args.kwonlyargs])
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = [s.target.id for s in node.body if isinstance(s, ast.AnnAssign)]
            for f in node.body:
                if isinstance(f, ast.FunctionDef) and (f.name == "__init__" or
                                                       not f.name.startswith("_")):
                    out[f"{node.name}.{f.name}"] = ([a.arg for a in f.args.args],
                                                    [a.arg for a in f.args.kwonlyargs])
    return out


@pytest.mark.parametrize("module", ["train/train_step.py", "train/loop.py",
                                    "data/pipeline.py", "launch/train.py", "analysis/flops.py"])
def test_public_signatures_are_the_references(module):
    ref = _public(ROOT / "src" / "repro" / module)
    port = _public(ROOT / "src" / "repro_torch" / module)
    assert set(port) == set(ref), module
    for name, want in ref.items():
        got = port[name]
        if isinstance(want, list):  # a class's fields
            assert got == want, name
            continue
        pos, kw = got
        extra_pos = pos[len(want[0]):]
        assert pos[: len(want[0])] == want[0], name
        assert kw[: len(want[1])] == want[1], name
        assert set(extra_pos + kw[len(want[1]):]) <= ALLOWED_EXTRA, name


# --------------------------------------------------------------------------
# the step on reduced olmo-1b, fp32 compute
# --------------------------------------------------------------------------
def test_train_step_matches_the_reference(monkeypatch):
    jm, jp, tm = _pair()
    jb, tb = _batches(tm.cfg)
    opt = dict(lr=LR, warmup_steps=0)
    jp2, js2, jmet = jax.jit(jmake_step(jm, jopt.OptConfig(**opt)))(
        jp, jopt.init_opt_state(jp), jb)
    seen = _capture_grads(monkeypatch)
    params0 = {k: v.copy() for k, v in _flat(tm.params).items()}
    tp2, ts2, tmet = tstep.make_train_step(tm, topt.OptConfig(**opt))(
        tm.params, topt.init_opt_state(tm.params), tb)
    assert set(tmet) == set(jmet) == {"ce", "acc", "aux", "lr", "grad_norm", "loss"}
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]), **TOL, err_msg=k)
    # gradients leaf by leaf, as the step hands them to the optimizer
    jg = _flatten(jax.grad(lambda p: jm.loss_fn(p, jb)[0])(jp))
    _assert_grads_close(seen[0], jg)
    _assert_update_close(_flat(tp2), _flatten(jp2), jg, LR)
    jst, tst = optstate_to_numpy(js2), optstate_to_numpy(ts2)
    assert tst["step"] == jst["step"] == 1
    for part in ("m", "v"):
        for k in jst[part]:
            np.testing.assert_allclose(tst[part][k], jst[part][k], **TOL, err_msg=k)
    # functional: the model's parameters are untouched, the new leaves require grad
    assert all(np.array_equal(v, params0[k]) for k, v in _flat(tm.params).items())
    assert all(p.requires_grad and p.grad is None for p in _tree.leaves(tp2))
    assert all(p.grad is None for p in tm.parameters())


def test_adamw_update_on_shared_gradients_matches_the_reference():
    """Gradients, moments and step given to both packages as numpy."""
    jm, jp, tm = _pair(seed=3)
    rng = np.random.default_rng(7)
    jg = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), jp)
    m = jax.tree.map(lambda p: jnp.asarray(0.01 * rng.standard_normal(p.shape), jnp.float32), jp)
    v = jax.tree.map(lambda p: jnp.asarray(1e-4 * rng.random(p.shape), jnp.float32), jp)
    for state in (jopt.init_opt_state(jp), jopt.OptState(jnp.asarray(5, jnp.int32), m, v)):
        for cfg in (dict(lr=3e-4, warmup_steps=0), dict(lr=1e-2, warmup_steps=10, clip_norm=1e9)):
            jp2, js2, jstats = jopt.adamw_update(jp, jg, state, jopt.OptConfig(**cfg))
            tstate = optstate_from_numpy(tm, optstate_to_numpy(state))
            tgrads = _tree.rebuild(tm.params, lambda k: _flatten(jg)[k],
                                   lambda a, p, k: torch.from_numpy(np.array(a)))
            tp2, ts2, tstats = topt.adamw_update(tm.params, tgrads, tstate, topt.OptConfig(**cfg))
            for k in ("lr", "grad_norm"):
                np.testing.assert_allclose(_np(tstats[k]), np.asarray(jstats[k]), **TOL)
            want, got = _flatten(jp2), _flat(tp2)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
            jst, tst = optstate_to_numpy(js2), optstate_to_numpy(ts2)
            assert tst["step"] == jst["step"]
            for part in ("m", "v"):
                for k in jst[part]:
                    np.testing.assert_allclose(tst[part][k], jst[part][k], **TOL, err_msg=k)


def test_optstate_crosses_both_ways():
    jm, jp, tm = _pair()
    rng = np.random.default_rng(1)
    state = jopt.OptState(jnp.asarray(3, jnp.int32),
                          jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape), jnp.float32), jp),
                          jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape), jnp.float32), jp))
    fields = optstate_to_numpy(state)
    port = optstate_from_numpy(tm, fields)
    assert int(port.step) == 3 and port.step.dtype == torch.int32
    back = optstate_to_numpy(port)
    for part in ("m", "v"):
        assert set(back[part]) == set(fields[part]) == set(_flatten(jp))
        for k in fields[part]:
            np.testing.assert_array_equal(back[part][k], fields[part][k])
    bad = dict(fields, m={**fields["m"], "embed": np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError):
        optstate_from_numpy(tm, bad)


def test_grad_accumulation_matches_one_batch_and_the_reference():
    jm, jp, tm = _pair(seed=1)
    jb, tb = _batches(tm.cfg, b=8, seed=2)
    opt = dict(lr=LR, warmup_steps=0, total_steps=10, clip_norm=1e9)
    outs = {}
    for accum in (1, 4):
        outs[accum] = tstep.make_train_step(tm, topt.OptConfig(**opt), accum_steps=accum)(
            tm.params, topt.init_opt_state(tm.params), tb)
    d = max(float(np.abs(a - b).max()) for a, b in
            zip(_flat(outs[1][0]).values(), _flat(outs[4][0]).values()))
    assert d < ACCUM_BOUND  # same data, same update direction
    assert set(outs[4][2]) == {"ce", "lr", "grad_norm", "loss"}
    jp4, _, jmet4 = jax.jit(jmake_step(jm, jopt.OptConfig(**opt), accum_steps=4))(
        jp, jopt.init_opt_state(jp), jb)
    for k in jmet4:
        np.testing.assert_allclose(_np(outs[4][2][k]), np.asarray(jmet4[k]), **TOL, err_msg=k)
    jg = _flatten(jax.grad(lambda p: jm.loss_fn(p, jb)[0])(jp))  # = the accumulated mean
    _assert_update_close(_flat(outs[4][0]), _flatten(jp4), jg, LR)


def test_bf16_step_moves_every_leaf_and_lowers_the_loss():
    """bf16 compute over fp32 parameters, port against itself: finite loss
    and gradient norm, every leaf moved, the loss lower after a few steps."""
    cfg = dataclasses.replace(tconfigs.get_config("olmo-1b").reduced(), compute_dtype="bfloat16")
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    data = tpipe.SyntheticLM(tpipe.DataConfig(vocab=32, seq_len=32, global_batch=8, seed=0))
    step = tstep.make_train_step(tm, topt.OptConfig(lr=3e-3, warmup_steps=0))
    p, s = tm.params, topt.init_opt_state(tm.params)
    losses = []
    for i in range(8):
        p2, s, met = step(p, s, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
        assert np.isfinite(float(met["loss"])) and np.isfinite(float(met["grad_norm"]))
        if i == 0:
            assert all(not torch.equal(a, b) for a, b in zip(_tree.leaves(p), _tree.leaves(p2)))
        p = p2
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0]


# --------------------------------------------------------------------------
# the fault-tolerant loop, port against port
# --------------------------------------------------------------------------
def _loop(tmp, total=12, ckpt_every=5, hook=None, **kw):
    tm = build_model(tconfigs.get_config("olmo-1b").reduced(), device="cpu")
    data = tpipe.SyntheticLM(tpipe.DataConfig(tm.cfg.vocab, 16, 4, seed=0))
    loop_cfg = tloop.LoopConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=str(tmp),
                                **kw)
    return tloop.train_loop(tm, data, topt.OptConfig(lr=1e-3, warmup_steps=0,
                                                     total_steps=total),
                            loop_cfg, fault_hook=hook)


def _restored(tmp, step):
    tm = build_model(tconfigs.get_config("olmo-1b").reduced(), device="cpu")
    (p, s), manifest = CheckpointManager(str(tmp)).restore(
        (tm.params, topt.init_opt_state(tm.params)), step)
    assert manifest["step"] == step
    return _tree.leaves((p, s))


def test_fault_tolerant_loop_recovers(tmp_path):
    armed = [True]

    def fault_hook(step):
        if step == 7 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected node failure")

    res = _loop(tmp_path, hook=fault_hook, max_failures=2)
    assert res.step == 12 and res.failures == 1
    steps = [m["step"] for m in res.metrics_history]  # 6 and 7 replayed from step 5
    assert steps.count(6) == 2 and steps.count(7) == 2 and steps[-1] == 12


def test_fault_budget_exhausted(tmp_path):
    def always_fail(step):
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent"):
        _loop(tmp_path, total=4, ckpt_every=2, hook=always_fail, max_failures=2)


def test_non_finite_loss_is_a_failure(tmp_path, monkeypatch):
    """A NaN loss raises FloatingPointError inside the step and rolls back."""
    real = tstep.make_train_step
    calls = [0]

    def poisoned(model, opt_cfg, **kw):
        step = real(model, opt_cfg, **kw)

        def run(p, s, batch):
            calls[0] += 1
            p2, s2, met = step(p, s, batch)
            if calls[0] == 3:
                met = dict(met, loss=torch.tensor(float("nan")))
            return p2, s2, met

        return run

    monkeypatch.setattr(tloop, "make_train_step", poisoned)
    res = _loop(tmp_path, total=4, ckpt_every=2)
    assert res.step == 4 and res.failures == 1
    assert [m["step"] for m in res.metrics_history] == [1, 2, 3, 4]


def test_straggler_watchdog(tmp_path):
    """The hook makes step 6 sleep 4x the median interval between its calls
    so far; each interval holds a whole step, so step 6 takes over 3x the
    median step on a loaded machine too, and is flagged."""
    calls = []

    def slow_step(step):
        calls.append(time.perf_counter())
        if step == 6:
            time.sleep(4 * float(np.median(np.diff(calls))))

    res = _loop(tmp_path, total=8, ckpt_every=50, hook=slow_step, straggler_factor=3.0)
    assert 6 in res.straggler_steps


def test_faulted_run_is_bitwise_the_unfaulted_run(tmp_path):
    armed = [True]

    def fault_at_5(step):
        if step == 5 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected")

    clean = _loop(tmp_path / "clean", total=8, ckpt_every=3)
    faulted = _loop(tmp_path / "faulted", total=8, ckpt_every=3, hook=fault_at_5)
    assert clean.failures == 0 and faulted.failures == 1
    # steps 4 and 5 replayed from the step-3 checkpoint, with the same losses
    assert [m["step"] for m in faulted.metrics_history] == [1, 2, 3, 4, 5, 4, 5, 6, 7, 8]
    by_step = {m["step"]: m["loss"] for m in clean.metrics_history}
    assert [m["loss"] for m in faulted.metrics_history] == [by_step[m["step"]]
                                                          for m in faulted.metrics_history]
    for a, b in zip(_restored(tmp_path / "clean", 8), _restored(tmp_path / "faulted", 8)):
        assert torch.equal(a, b)


def test_loop_refuses_jit_kwargs(tmp_path):
    tm = build_model(tconfigs.get_config("olmo-1b").reduced(), device="cpu")
    data = tpipe.SyntheticLM(tpipe.DataConfig(tm.cfg.vocab, 8, 2))
    for kw in ({"donate_argnums": (0, 1)}, {"static_argnums": ()}):
        with pytest.raises(ValueError, match="jit_kwargs"):
            tloop.train_loop(tm, data, topt.OptConfig(), tloop.LoopConfig(
                total_steps=1, ckpt_dir=str(tmp_path / "no")), jit_kwargs=kw)
    assert not (tmp_path / "no").exists()
    for kw in (None, {}):
        res = tloop.train_loop(tm, data, topt.OptConfig(), tloop.LoopConfig(
            total_steps=1, ckpt_dir=str(tmp_path / str(kw))), jit_kwargs=kw)
        assert res.step == 1


def test_fresh_state_is_init_from_seed_0(tmp_path):
    """Without ``params`` the loop starts from ``model.init`` of a generator
    seeded 0, and checkpoints it at step 0."""
    tm = build_model(tconfigs.get_config("olmo-1b").reduced(), device="cpu")
    data = tpipe.SyntheticLM(tpipe.DataConfig(tm.cfg.vocab, 8, 2))
    tloop.train_loop(tm, data, topt.OptConfig(), tloop.LoopConfig(
        total_steps=1, ckpt_every=5, ckpt_dir=str(tmp_path), keep=3))
    want = tm.init(torch.Generator().manual_seed(0))
    got = _restored(tmp_path, 0)
    for a, b in zip(_tree.leaves(want), got):
        assert torch.equal(a, b)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's loop runs 4 steps; the port's loop restores its
    step-4 checkpoint and runs steps 5-6, whose losses match the reference's
    own 6-step run (the reference's step donates its params: each run gets
    a copy)."""
    jm, jp, tm = _pair()
    data_cfg = dict(vocab=tm.cfg.vocab, seq_len=16, global_batch=4, seed=0)
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=6)
    jref = jloop.train_loop(jm, jpipe.SyntheticLM(jpipe.DataConfig(**data_cfg)),
                            jopt.OptConfig(**opt),
                            jloop.LoopConfig(total_steps=6, ckpt_every=50,
                                             ckpt_dir=str(tmp_path / "ref6")),
                            params=jax.tree.map(jnp.copy, jp))
    jloop.train_loop(jm, jpipe.SyntheticLM(jpipe.DataConfig(**data_cfg)), jopt.OptConfig(**opt),
                     jloop.LoopConfig(total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / "x")),
                     params=jax.tree.map(jnp.copy, jp))
    res = tloop.train_loop(tm, tpipe.SyntheticLM(tpipe.DataConfig(**data_cfg)),
                           topt.OptConfig(**opt),
                           tloop.LoopConfig(total_steps=6, ckpt_every=2,
                                            ckpt_dir=str(tmp_path / "x")), params=tm.params)
    assert [m["step"] for m in res.metrics_history] == [5, 6] and res.step == 6
    want = [m["loss"] for m in jref.metrics_history[4:]]
    np.testing.assert_allclose([m["loss"] for m in res.metrics_history], want, **TOL)


# --------------------------------------------------------------------------
# the drivers
# --------------------------------------------------------------------------
def test_train_driver_then_serve_restores_its_checkpoint(tmp_path, caplog):
    ckpt = str(tmp_path / "ckpt")
    with caplog.at_level(logging.INFO):
        res = train_driver.main(["--arch", "olmo-1b", "--reduced", "--steps", "4", "--batch", "2",
                                 "--seq", "32", "--ckpt-every", "2", "--ckpt-dir", ckpt,
                                 "--device", "cpu"])
        assert res.step == 4 and res.failures == 0
        assert "done: step=4 final_loss=" in caplog.text
        assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004"]
        out = serve_driver.main(["--arch", "olmo-1b", "--reduced", "--requests", "2",
                                 "--new-tokens", "4", "--ckpt-dir", ckpt, "--device", "cpu"])
    assert "restored step 4" in caplog.text and len(out) == 2


def test_train_driver_reads_a_memmap_corpus_and_accumulates(tmp_path, caplog):
    path = _corpus(tmp_path, np.uint16, vocab=2048)
    with caplog.at_level(logging.INFO):
        res = train_driver.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps", "2",
                                 "--batch", "4", "--accum", "2", "--seq", "16", "--corpus", path,
                                 "--ckpt-dir", str(tmp_path / "c"), "--device", "cpu"])
    assert res.step == 2 and "done: step=2" in caplog.text


def test_train_driver_refuses_the_sharded_lm(tmp_path):
    for flags in (["--dp", "2"], ["--tp", "2"]):  # no process group: a world of one
        with pytest.raises(ValueError, match="world size 1"):
            train_driver.main(["--arch", "olmo-1b", "--reduced", "--steps", "1", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path), *flags])
    # every family shards over "model" now: the SSM's --tp 2 is refused only
    # because the mesh is not the world
    with pytest.raises(ValueError, match="world size 1"):
        train_driver.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps", "1", "--device",
                           "cpu", "--ckpt-dir", str(tmp_path), "--tp", "2"])


def test_train_driver_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--reduced",
         "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-every", "3", "--ckpt-dir",
         str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "done: step=3" in proc.stdout + proc.stderr
    assert any(p.startswith("step_") for p in os.listdir(tmp_path))
