"""One training step of every architecture against the JAX reference, and
remat, on the CPU.

Each of the ten reduced architectures (fp32 compute), and olmo-1b with a
``cp_rank`` FFN, takes one ``make_train_step`` step in both packages from
the reference's parameters (crossing through ``interop.params_from_numpy``)
and one batch made in numpy: loss and metrics (``ce``, ``acc``, the MoE
``aux``, ``lr``, ``grad_norm``) at the port's fp32 bound ``rtol=2e-4,
atol=2e-5``, every gradient leaf the step hands to the optimizer within a
norm-wise relative error of 2e-3 (the reference's whole-model bound), and
the updated parameters at the fp32 bound with the first AdamW step's
allowance for near-zero gradients (``tests/test_torch_train.py``).  The
batch is 4 x 16 tokens, except the SSM's 2 x 256, whose scan then runs
chunked (128 divides 256), as ``ssm_apply`` chunks it.  The MoE layer's
backward through dropped pairs is held against the reference's too.

Remat (``torch.utils.checkpoint`` around each layer while autograd
records, the reference's ``jax.checkpoint``) changes memory, not values: a
step with ``cfg.remat`` is bitwise the step without it, port against port,
for every architecture and for bf16 compute, with one non-reentrant
checkpointed call a layer; serving never reaches it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpoint.manager import _flatten
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_step
from repro_torch import _tree
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tstep
from test_torch_train import (
    ARCHS,
    BATCH_SHAPES,
    LR,
    TOL,
    _assert_grads_close,
    _assert_update_close,
    _batches,
    _capture_grads,
    _flat,
    _np,
    _pair,
    one_torch_thread,  # noqa: F401 -- the module's autouse fixture
)

CASES = [(a, {}) for a in ARCHS] + [("olmo-1b", {"cp_rank": 8})]


@pytest.mark.parametrize("arch,changes", CASES, ids=[a + ("-cp" if c else "") for a, c in CASES])
def test_train_step_matches_the_reference(arch, changes, monkeypatch):
    jm, jp, tm = _pair(arch, **changes)
    b, s = BATCH_SHAPES.get(arch, (4, 16))
    jb, tb = _batches(tm.cfg, b=b, s=s, seed=1)
    opt = dict(lr=LR, warmup_steps=0)
    step = jmake_step(jm, jopt.OptConfig(**opt))

    @jax.jit
    def reference(p, batch):  # one compile: the gradients and the step
        grads = jax.grad(lambda q: jm.loss_fn(q, batch)[0])(p)
        return grads, step(p, jopt.init_opt_state(p), batch)

    jg, (jp2, _, jmet) = reference(jp, jb)
    jg = _flatten(jg)
    seen = _capture_grads(monkeypatch)
    tp2, ts2, tmet = tstep.make_train_step(tm, topt.OptConfig(**opt))(
        tm.params, topt.init_opt_state(tm.params), tb)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(_np(tmet[k]), np.asarray(jmet[k]), **TOL, err_msg=k)
    _assert_grads_close(seen[0], jg)
    _assert_update_close(_flat(tp2), _flatten(jp2), jg, LR)
    assert int(ts2.step) == 1


def test_moe_backward_through_dropped_pairs_matches_the_reference():
    """At a capacity factor that drops pairs, the gradients of the MoE layer
    (input, router, experts, shared expert) are the reference's: the drop
    row, which every dropped pair writes and which is sliced off, carries
    no gradient."""
    jcfg = dataclasses.replace(jconfigs.get_config("qwen2-moe-a2.7b").reduced(),
                               capacity_factor=0.25)
    tcfg = dataclasses.replace(tconfigs.get_config("qwen2-moe-a2.7b").reduced(),
                               capacity_factor=0.25)
    rng = np.random.default_rng(3)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))["layers"]
    jp = jax.tree.map(lambda a: a[0], jp)["moe"]
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), jp)
    tx = torch.from_numpy(x).requires_grad_()
    assert tmoe.dropped_pairs(tp, tcfg, tx) > 0

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jcfg, xx)
        return (y * w).sum() + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    y, aux = tmoe.moe_apply(tp, tcfg, tx)
    leaves = _tree.leaves(tp) + [tx]
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, leaves)
    want = _flatten(jgp)
    got = {k: g.numpy() for k, g in zip(_tree.flatten(tp, lambda a: 0, len), grads)}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TOL)


REMAT_CASES = [(a, "float32") for a in ARCHS] + [("olmo-1b", "bfloat16"),
                                                 ("qwen2-moe-a2.7b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", REMAT_CASES)
def test_remat_is_bitwise_no_remat(arch, dtype, monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(kwargs.get("use_reentrant"))
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), remat=remat,
                                  compute_dtype=dtype)
        tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        b, s = BATCH_SHAPES.get(arch, (4, 16))
        _, tb = _batches(cfg, b=b, s=s, seed=2)
        out[remat] = tstep.make_train_step(tm, topt.OptConfig(lr=LR, warmup_steps=0))(
            tm.params, topt.init_opt_state(tm.params), tb)
    layers = tm.cfg.enc_layers + tm.cfg.dec_layers if tm.cfg.is_encdec else tm.cfg.n_layers
    assert calls == [False] * layers  # one checkpointed call a layer, non-reentrant
    for a, b in zip(_tree.leaves(out[True]), _tree.leaves(out[False])):
        assert torch.equal(a, b)
    assert out[True][2].keys() == out[False][2].keys()
    for k in out[True][2]:
        assert torch.equal(out[True][2][k], out[False][2][k]), k


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-base"])
def test_serving_never_checkpoints(arch, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("activation checkpointing while serving")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    cfg = tconfigs.get_config(arch).reduced()
    assert cfg.remat
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    _, tb = _batches(cfg, b=2, s=6)
    cache, logits = tm.prefill(tm.params, tb, max_len=10)
    tm.decode_step(tm.params, tb["tokens"][:, :1], cache)
    with torch.no_grad():
        tm.loss_fn(tm.params, tb)
