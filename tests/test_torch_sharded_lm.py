"""The port's sharded LM training path in 8-rank gloo worlds, on the CPU.

Each multi-rank case is one subprocess, ``python tests/test_torch_sharded_lm.py
<case> <dir>``: it spawns 8 gloo ranks (``init_method="file://<dir>/store"``,
one torch thread each) and rank 0 writes ``<dir>/out.npz``.  The inputs are
made with numpy from a seed in this process (the reference's initial
parameters, the port's, a reference checkpoint) and cross through
``repro_torch.interop``.  The reference's oracles run beside the cases in
their own subprocess (case ``reference``: ``JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8``):

* ``compressed_dp``: the reference's ``case_compressed_dp_trainer``
  (``tests/dist_worker.py``): reduced olmo-1b, SyntheticLM vocab 32, seq 16,
  batch 8, lr 3e-3 with no warm-up, 8 steps of ``make_compressed_dp_step``
  on an (8, 1) mesh, exact and compressed.  The exact run holds the
  reference's exact run step by step: loss at ``rtol=2e-4, atol=2e-5``,
  the parameters after step 1 at the training bounds of
  ``tests/test_torch_train.py`` (an entry whose gradient is below
  ``SIGN_NOISE`` of its leaf's largest may move a further 2 * lr: AdamW's
  first step is about ``lr * sign(g)``).  The compressed run holds the
  reference's compressed run at the same bounds: both quantize each
  reference leaf (a scanned stack's layers as one payload) with one
  scale, so they round the same gradients the same way (the losses
  differed by 4.8e-6 at most in 8 steps, here); and its last loss is
  within 0.3 of the exact run's, the reference's own criterion.
* ``train``: ``launch.train --dp 8``, ``--dp 4 --tp 2`` and ``--dp 2 --tp 4``
  (3 steps of 8 x 16 tokens, checkpoints at steps 0 and 3) on reduced
  olmo-1b and its ``cp_rank`` 64 variant: per-step losses against the port's
  single-rank ``launch.train`` and the reference's ``train_loop`` at (1, 1)
  from the same initial parameters, the checkpointed (assembled) parameters
  at the training bounds, the data groups' blocks row for row the
  reference's global batch, a repeated run bitwise.
* ``elastic``: the reference's ``case_elastic_restore`` ((4, 2) save, (2, 4)
  restore, bitwise), a tensor-parallel train state saved on (2, 4) and
  restored onto (4, 2) and (1, 1) bitwise, and a checkpoint the reference
  wrote restored onto a (2, 4) mesh bitwise.

By hand, one case (the inputs must be in ``<dir>`` first, as the fixture
writes them):

    PYTHONPATH=src python tests/test_torch_sharded_lm.py <case> <dir>
"""

import ast
import dataclasses
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TOL = dict(rtol=2e-4, atol=2e-5)
SIGN_NOISE = 1e-5
CASE_TIMEOUT = 240  # seconds a case subprocess may take
DP_STEPS, DP_LR, DP_VOCAB = 8, 3e-3, 32
COMPRESSED_GAP = 0.3  # the reference's criterion (tests/dist_worker.py)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 3, 8, 16, 3e-4
TRAIN_MESHES = ((8, 1), (4, 2), (2, 4))
VARIANTS = {"olmo": {}, "cp64": {"cp_rank": 64}}
ELASTIC_SPECS = {"w": ("data", "model"), "b": ("model",)}


# ---------------------------------------------------------- the rank side
def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree) -> dict:
    from repro_torch import _tree

    return _tree.flatten(tree, _np, np.stack)


def _prefixed(prefix: str, arrays: dict) -> dict:
    return {prefix + k: v for k, v in arrays.items()}


def _same_everywhere(arrays: dict) -> bool:
    """Every rank holds the same bytes for every array of ``arrays``."""
    import torch.distributed as dist

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, h.hexdigest())
    return len(set(digests)) == 1


def _all_true(flag: bool) -> bool:
    import torch.distributed as dist

    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(flag))
    return all(flags)


def _case_compressed_dp(root: str, out: dict) -> None:
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives as coll
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt

    model = build_model(get_config("olmo-1b").reduced(), device="cpu")
    params_from_numpy(model, dict(np.load(f"{root}/params.npz")))
    mesh = make_host_mesh(WORLD, 1, device="cpu")
    data = SyntheticLM(DataConfig(vocab=DP_VOCAB, seq_len=16, global_batch=8))
    opt_cfg = opt.OptConfig(lr=DP_LR, warmup_steps=0, total_steps=100)
    real_update, seen = opt.adamw_update, []

    def recording(params, grads, state, cfg, **kw):
        seen.append(_flat(grads))
        return real_update(params, grads, state, cfg, **kw)

    opt.adamw_update = recording
    row = dist.get_rank()  # the mesh's row-major index of this rank
    n_leaves = len(_flat(model.params))  # the reference's leaves: a stack is one
    for label, compress in (("exact", False), ("compressed", True)):
        step = coll.make_compressed_dp_step(model, opt_cfg, mesh, compress=compress)
        p = _tree.tree_map(lambda x: x.detach().clone(), model.params)
        s = opt.init_opt_state(p)
        err = coll.init_error_state(p, mesh)
        coll.INT8_GATHERS.calls = coll.INT8_GATHERS.bytes = 0
        seen.clear()
        losses = []
        for i in range(DP_STEPS):
            batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            p, s, err, met = step(p, s, err, batch)
            losses.append(float(met["loss"]))
            if i == 0:
                out.update(_prefixed(f"{label}/p1/", _flat(p)))
                out.update(_prefixed(f"{label}/g1/", seen[0]))
                if compress:
                    out["compressed/residuals_nonzero"] = _all_true(
                        all(bool(e[row].abs().max() > 0) for e in _tree.leaves(err)))
                    out["compressed/other_rows_zero"] = _all_true(all(
                        bool(torch.cat([e[:row], e[row + 1:]]).abs().max() == 0)
                        for e in _tree.leaves(err)))
        out[f"{label}/loss"] = np.array(losses)
        out.update(_prefixed(f"{label}/p{DP_STEPS}/", _flat(p)))
        out[f"{label}/int8_gathers"] = coll.INT8_GATHERS.calls
        out[f"{label}/int8_bytes"] = coll.INT8_GATHERS.bytes
        out[f"{label}/same_everywhere"] = _same_everywhere(_flat(p))
    out["n_leaves"] = n_leaves
    opt.adamw_update = real_update


def _case_train(root: str, out: dict) -> None:
    import torch.distributed as dist

    import repro_torch.configs as tconfigs
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_driver

    real_get, real_batch = tconfigs.get_config, pipeline.SyntheticLM.batch
    seen = []

    def batch(self, index):
        b = real_batch(self, index)
        seen.append((self.cfg.host_id, self.cfg.host_count, index, b["tokens"]))
        return b

    pipeline.SyntheticLM.batch = batch
    runs = [(name, mesh) for name in VARIANTS for mesh in TRAIN_MESHES] + [("olmo", (2, 4))]
    for n, (name, (dp, tp)) in enumerate(runs):
        tag = f"{name}/{dp}x{tp}" + ("/again" if n == len(runs) - 1 else "")
        tconfigs.get_config = lambda arch, c=VARIANTS[name]: dataclasses.replace(real_get(arch),
                                                                                 **c)
        seen.clear()
        res = train_driver.main([
            "--arch", "olmo-1b", "--reduced", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every", str(TRAIN_STEPS),
            "--ckpt-dir", f"{root}/{tag.replace('/', '_')}", "--device", "cpu",
            "--dp", str(dp), "--tp", str(tp)])
        losses = np.array([m["loss"] for m in res.metrics_history])
        out[f"{tag}/loss"] = losses
        out[f"{tag}/same_everywhere"] = _same_everywhere({"loss": losses})
        blocks = [None] * dist.get_world_size()
        dist.all_gather_object(blocks, [(h, c, i, t) for h, c, i, t in seen])
        rank_coord = [(r // tp) for r in range(WORLD)]  # the data coordinate of each rank
        ok = True
        for r, recs in enumerate(blocks):
            for h, c, i, t in recs:
                ok = ok and h == rank_coord[r] and c == dp
                key = f"{tag}/block/{i}/{h}"
                if key in out:
                    ok = ok and np.array_equal(out[key], t)  # one data group, one block
                out[key] = t
        out[f"{tag}/blocks_ok"] = ok
    tconfigs.get_config = real_get
    pipeline.SyntheticLM.batch = real_batch


def _case_elastic(root: str, out: dict) -> None:
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, OptState, init_opt_state
    from repro_torch.train.train_step import make_train_step

    # the reference's case_elastic_restore: (4, 2) save, (2, 4) restore
    mesh_a = meshlib.make_host_mesh(4, 2, device="cpu")
    mesh_b = meshlib.make_host_mesh(2, 4, device="cpu")
    full = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(8.0)}
    blocks = meshlib.shard_tree(full, ELASTIC_SPECS, mesh_a)
    mgr = CheckpointManager(f"{root}/elastic")
    mgr.save(3, blocks, mesh=mesh_a, specs=ELASTIC_SPECS)
    template = {k: torch.zeros_like(v) for k, v in full.items()}
    got, _ = mgr.restore(template, mesh=mesh_b, specs=ELASTIC_SPECS)
    want = meshlib.shard_tree(full, ELASTIC_SPECS, mesh_b)
    out["elastic/case"] = _all_true(all(torch.equal(got[k], want[k]) for k in full))

    # a tensor-parallel train state: one step on (2, 4), saved, restored onto (4, 2)
    model = build_model(get_config("olmo-1b").reduced(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    data = SyntheticLM(DataConfig(vocab=256, seq_len=16, global_batch=2, host_id=0,
                                  host_count=1))
    state = {}
    for name, mesh in (("b", mesh_b), ("a", mesh_a)):
        specs = model.partition_specs(mesh, drop_fsdp=True)
        state[name] = (specs, (specs, OptState((), specs, specs)))
    specs_b, where_b = state["b"]
    p = meshlib.shard_tree(model.params, specs_b, mesh_b)
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    with meshlib.use_mesh(mesh_b):
        p, s, _ = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=0))(
            p, init_opt_state(p), batch)
    mgr = CheckpointManager(f"{root}/tp_state")
    mgr.save(1, (p, s), mesh=mesh_b, specs=where_b)
    whole = meshlib.assemble_tree((p, s), where_b, mesh_b)
    full_template = (model.params, init_opt_state(model.params))
    specs_a, where_a = state["a"]
    (pa, sa), _ = mgr.restore(full_template, mesh=mesh_a, specs=where_a)
    want = meshlib.shard_tree(whole, where_a, mesh_a)
    from repro_torch import _tree

    out["tp_state/onto_4x2"] = _all_true(all(
        torch.equal(x, y) for x, y in zip(_tree.leaves((pa, sa)), _tree.leaves(want))))
    (pb, sb), _ = mgr.restore(full_template, mesh=mesh_b, specs=where_b)
    out["tp_state/onto_2x4"] = _all_true(all(
        torch.equal(x, y) for x, y in zip(_tree.leaves((pb, sb)), _tree.leaves((p, s)))))
    out.update(_prefixed("tp_state/whole/", _flat(whole)))

    # a checkpoint the reference wrote, restored onto (2, 4)
    ref = CheckpointManager(f"{root}/reference_ckpt")
    (rp, rs), _ = ref.restore(full_template, mesh=mesh_b, specs=where_b)
    with np.load(f"{root}/reference_ckpt/step_{ref.latest_step():08d}/arrays.npz") as arrays:
        files = {k: torch.from_numpy(np.asarray(arrays[k])) for k in arrays.files}
    restored = _tree.flatten((rp, rs), lambda t: t, torch.stack)
    ok = set(restored) == set(files)
    for key, t in restored.items():
        spec = _spec_for(key, specs_b)
        ok = ok and torch.equal(t, meshlib.NamedSharding(mesh_b, spec).cut(files[key]))
    out["reference_ckpt/onto_2x4"] = _all_true(ok)
    dist.barrier()


def _spec_for(key: str, pspecs) -> tuple:
    """The spec of a ``(params, opt_state)`` checkpoint key: a moment's is
    its parameter's, with the stacked layer axis of a scanned stack first."""
    from repro_torch.checkpoint.manager import _spec_at

    parts = key.split("/")
    if parts[0] == "1":  # the optimizer state: step, m/..., v/...
        if parts[1] == "step":
            return ()
        parts = parts[2:]
    else:
        parts = parts[1:]
    spec = tuple(_spec_at(pspecs, "/".join(parts)))
    return ((None,) + spec) if parts[0] == "layers" else spec


CASES = {"compressed_dp": _case_compressed_dp, "train": _case_train, "elastic": _case_elastic}


def _rank_main(rank: int, case: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        CASES[case](root, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------- the reference side
def _reference(root: str) -> None:
    """The reference's oracles on 8 host devices: the compressed
    data-parallel trainer, exact and compressed, and ``train_loop`` at
    (1, 1) on each variant from the port's initial parameters."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.checkpoint.manager import _flatten
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.dist.collectives import init_error_state, make_compressed_dp_step
    from repro.launch import mesh as meshlib
    from repro.models import build_model
    from repro.train.loop import LoopConfig, train_loop
    from repro.train.optimizer import OptConfig, init_opt_state

    assert jax.device_count() == WORLD, jax.device_count()
    out = {}
    cfg = jconfigs.get_config("olmo-1b").reduced()
    model = build_model(cfg)
    params = _unflatten_like(model.init(jax.random.PRNGKey(0)),
                             dict(np.load(f"{root}/params.npz")))
    mesh = jax.make_mesh((WORLD, 1), ("data", "model"))
    data = SyntheticLM(DataConfig(vocab=DP_VOCAB, seq_len=16, global_batch=8))
    opt_cfg = OptConfig(lr=DP_LR, warmup_steps=0, total_steps=100)
    with meshlib.use_mesh(mesh):
        for label, compress in (("exact", False), ("compressed", True)):
            step = jax.jit(make_compressed_dp_step(model, opt_cfg, mesh, compress=compress))
            p = jax.tree.map(jnp.copy, params)
            s = init_opt_state(p)
            err = init_error_state(p)
            losses = []
            for i in range(DP_STEPS):
                batch = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
                p, s, err, met = step(p, s, err, batch)
                losses.append(float(met["loss"]))
                if i == 0:
                    out.update(_prefixed(f"{label}/p1/", {k: np.asarray(v) for k, v in
                                                          _flatten(p).items()}))
            out[f"{label}/loss"] = np.array(losses)
            out.update(_prefixed(f"{label}/p{DP_STEPS}/", {k: np.asarray(v) for k, v in
                                                           _flatten(p).items()}))
    for name, changes in VARIANTS.items():
        vcfg = dataclasses.replace(jconfigs.get_config("olmo-1b").reduced(), **changes)
        vcfg = dataclasses.replace(vcfg, vocab=min(vcfg.vocab, 2048))
        vmodel = build_model(vcfg)
        init = _unflatten_like(vmodel.init(jax.random.PRNGKey(0)),
                               dict(np.load(f"{root}/init_{name}.npz")))
        dc = DataConfig(vocab=vcfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        with meshlib.use_mesh(meshlib.make_host_mesh(1, 1)):
            res = train_loop(vmodel, SyntheticLM(dc),
                             OptConfig(lr=TRAIN_LR, total_steps=max(TRAIN_STEPS, 100)),
                             LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                                        ckpt_dir=f"{root}/train_{name}"),
                             params=jax.tree.map(jnp.copy, init))
        out[f"train/{name}/loss"] = np.array([m["loss"] for m in res.metrics_history])
    np.savez(f"{root}/out.npz", **out)


def _unflatten_like(template, flat: dict):
    """A reference params tree of ``template``'s structure from
    ``{leaf path: array}``."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten

    keys = list(_flatten(template))
    leaves, tdef = jax.tree.flatten(template)
    assert len(keys) == len(leaves)
    return tdef.unflatten([jnp.asarray(flat[k]) for k in keys])


# -------------------------------------------------------- the pytest side
def _port_init(name: str) -> dict:
    """The port's initial parameters of ``launch.train``'s reduced olmo-1b
    variant ``name`` (the loop's ``model.init`` from a generator seeded 0)."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), **VARIANTS[name])
    cfg = dataclasses.replace(cfg, vocab=min(cfg.vocab, 2048))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return _tree.flatten(model.init(torch.Generator().manual_seed(0)), _np, np.stack)


def _inputs(case: str, root: Path) -> None:
    """Write the numpy inputs of ``case`` into ``root``."""
    if case in ("compressed_dp", "reference"):
        import jax

        import repro.configs as jconfigs
        from repro.checkpoint.manager import _flatten
        from repro.models import build_model as jbuild

        jm = jbuild(jconfigs.get_config("olmo-1b").reduced())
        flat = {k: np.asarray(v) for k, v in _flatten(jm.init(jax.random.PRNGKey(0))).items()}
        np.savez(root / "params.npz", **flat)
    if case == "reference":
        for name in VARIANTS:
            np.savez(root / f"init_{name}.npz", **_port_init(name))
    if case == "elastic":  # a checkpoint of the reference's (params, opt_state)
        import jax

        import repro.configs as jconfigs
        from repro.checkpoint.manager import CheckpointManager as JManager
        from repro.models import build_model as jbuild
        from repro.train.optimizer import init_opt_state

        jm = jbuild(jconfigs.get_config("olmo-1b").reduced())
        jp = jm.init(jax.random.PRNGKey(3))
        js = init_opt_state(jp)
        js = js._replace(m=jax.tree.map(lambda x: x + 0.5, js.m))
        JManager(str(root / "reference_ckpt")).save(2, (jp, js))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(case)``: the case's results.  The first call starts the
    reference's process and runs the 8-rank cases beside it, one after the
    other; a failure is kept and raised to every test of the case."""
    done, jobs = {}, {}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def start_reference():
        if "reference" in jobs:
            return
        root = tmp_path_factory.mktemp("reference")
        _inputs("reference", root)
        ref_env = {**env, "JAX_PLATFORMS": "cpu",
                   "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
        jobs["reference"] = (root, subprocess.Popen(
            [sys.executable, __file__, "reference", str(root)], cwd=ROOT, env=ref_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, process_group=0))

    def finish(case, root, proc):
        try:
            _, err = proc.communicate(timeout=CASE_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)  # the case and the ranks it spawned
            proc.communicate()
            return AssertionError(f"case {case} ran over {CASE_TIMEOUT} s")
        if proc.returncode != 0:
            return AssertionError(f"case {case} failed:\n{err[-4000:]}")
        return root, dict(np.load(root / "out.npz"))

    def get(case):
        start_reference()
        if case == "reference" and case not in done:
            done[case] = finish(case, *jobs["reference"])
        for c in CASES if case not in done else ():
            if c not in done:
                root = tmp_path_factory.mktemp(c)
                _inputs(c, root)
                proc = subprocess.Popen([sys.executable, __file__, c, str(root)], cwd=ROOT,
                                        env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True,
                                        process_group=0)
                done[c] = finish(c, root, proc)
        if isinstance(done[case], Exception):
            raise done[case]
        return done[case]

    yield get
    for _, proc in jobs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()


def _under(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _assert_update_close(got: dict, want: dict, grads: list, lrs: list):
    """Parameters at the fp32 bound; an entry whose gradient was below
    ``SIGN_NOISE`` of its leaf's largest at a step may differ by a further
    2 * lr of that step (AdamW's first step is about ``lr * sign(g)``)."""
    assert set(got) == set(want)
    for k in want:
        allow = TOL["atol"] + TOL["rtol"] * np.abs(want[k])
        for g, lr in zip(grads, lrs):
            a = np.abs(np.asarray(g[k]))
            allow = allow + np.where(a < SIGN_NOISE * a.max(), 2 * lr, 0.0)
        diff = np.abs(np.asarray(got[k], np.float64) - want[k])
        assert not (diff > allow).any(), (k, float(diff.max()))


# ---- the compressed data-parallel step
def test_exact_dp_step_matches_the_reference_step_by_step(run):
    _, port = run("compressed_dp")
    _, ref = run("reference")
    np.testing.assert_allclose(port["exact/loss"], ref["exact/loss"], **TOL)
    _assert_update_close(_under(port, "exact/p1/"), _under(ref, "exact/p1/"),
                         [_under(port, "exact/g1/")], [DP_LR])


def test_compressed_dp_step_matches_the_references_compressed_run(run):
    _, port = run("compressed_dp")
    _, ref = run("reference")
    np.testing.assert_allclose(port["compressed/loss"], ref["compressed/loss"], **TOL)
    _assert_update_close(_under(port, "compressed/p1/"), _under(ref, "compressed/p1/"),
                         [_under(port, "compressed/g1/")], [DP_LR])


def test_compressed_dp_tracks_the_exact_run(run):
    """The reference's own criterion: finite, and the compressed run's last
    loss within 0.3 of the exact run's."""
    _, port = run("compressed_dp")
    lc, le = port["compressed/loss"][-1], port["exact/loss"][-1]
    assert np.isfinite(port["compressed/loss"]).all() and np.isfinite(port["exact/loss"]).all()
    assert abs(lc - le) < COMPRESSED_GAP, (lc, le)
    assert port["compressed/loss"][-1] < port["compressed/loss"][0]


def test_compressed_dp_gathers_int8_once_a_leaf_a_step(run):
    _, port = run("compressed_dp")
    n = int(port["n_leaves"])
    assert int(port["compressed/int8_gathers"]) == n * DP_STEPS
    assert int(port["exact/int8_gathers"]) == 0
    params = sum(v.size for k, v in _under(port, "exact/p1/").items())
    # a leaf's payload is its int8 elements and a 4-byte scale
    assert int(port["compressed/int8_bytes"]) == DP_STEPS * (params + 4 * n)
    assert bool(port["compressed/residuals_nonzero"])
    assert bool(port["compressed/other_rows_zero"])  # a rank writes its own row only


@pytest.mark.parametrize("label", ["exact", "compressed"])
def test_dp_state_is_the_same_on_every_rank(run, label):
    _, port = run("compressed_dp")
    assert bool(port[f"{label}/same_everywhere"])


# ---- launch.train across meshes
@pytest.fixture(scope="module")
def single_rank(tmp_path_factory):
    """The port's single-rank ``launch.train`` of each variant: its losses,
    its last checkpoint and each step's gradients."""
    import repro_torch.configs as tconfigs
    from repro_torch import _tree
    from repro_torch.launch import train as train_driver
    from repro_torch.train import train_step as tstep

    real_get, real_update = tconfigs.get_config, tstep.adamw_update
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, changes in VARIANTS.items():
            grads, lrs = [], []

            def recording(params, g, state, cfg):
                grads.append(_tree.flatten(g, _np, np.stack))
                new = real_update(params, g, state, cfg)
                lrs.append(float(new[2]["lr"]))
                return new

            tconfigs.get_config = lambda arch, c=changes: dataclasses.replace(real_get(arch), **c)
            tstep.adamw_update = recording
            ckpt = tmp_path_factory.mktemp(f"single_{name}")
            res = train_driver.main([
                "--arch", "olmo-1b", "--reduced", "--steps", str(TRAIN_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-every", str(TRAIN_STEPS),
                "--ckpt-dir", str(ckpt), "--device", "cpu"])
            out[name] = (np.array([m["loss"] for m in res.metrics_history]), _params_at(ckpt),
                         grads, lrs)
    finally:
        tconfigs.get_config, tstep.adamw_update = real_get, real_update
        torch.set_num_threads(threads)
    return out


def _params_at(ckpt: Path, step: int = TRAIN_STEPS) -> dict:
    """The parameters (``0/...`` keys) of a ``(params, opt_state)`` checkpoint."""
    with np.load(Path(ckpt) / f"step_{step:08d}" / "arrays.npz") as arrays:
        return {k[2:]: np.asarray(arrays[k]) for k in arrays.files if k.startswith("0/")}


@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_train_losses_match_one_rank_and_the_reference(run, single_rank, name, mesh):
    _, port = run("train")
    _, ref = run("reference")
    tag = f"{name}/{mesh[0]}x{mesh[1]}"
    np.testing.assert_allclose(port[f"{tag}/loss"], single_rank[name][0], **TOL)
    np.testing.assert_allclose(port[f"{tag}/loss"], ref[f"train/{name}/loss"], **TOL)
    assert bool(port[f"{tag}/same_everywhere"])


@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_train_parameters_match_one_rank(run, single_rank, name, mesh):
    root, _ = run("train")
    got = _params_at(root / f"{name}_{mesh[0]}x{mesh[1]}")
    _, want, grads, lrs = single_rank[name]
    _assert_update_close(got, want, grads, lrs)


@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_data_groups_read_the_references_global_batch(run, mesh):
    """Each data group's block is its rows of the reference's global batch,
    and the ranks of one group read the same block."""
    from repro.data.pipeline import DataConfig, SyntheticLM

    _, port = run("train")
    dp = mesh[0]
    tag = f"olmo/{mesh[0]}x{mesh[1]}"
    assert bool(port[f"{tag}/blocks_ok"])
    data = SyntheticLM(DataConfig(vocab=256, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    for i in range(TRAIN_STEPS):
        union = np.concatenate([port[f"{tag}/block/{i}/{h}"] for h in range(dp)])
        assert np.array_equal(union, data.batch(i)["tokens"]), i


def test_sharded_train_run_repeats_bitwise(run):
    root, _ = run("train")
    a, b = _params_at(root / "olmo_2x4"), _params_at(root / "olmo_2x4_again")
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


# ---- elastic restore
def test_elastic_restore_case_of_the_reference(run):
    _, port = run("elastic")
    assert bool(port["elastic/case"])


@pytest.mark.parametrize("onto", ["2x4", "4x2"])
def test_tp_train_state_restores_onto_other_meshes(run, onto):
    _, port = run("elastic")
    assert bool(port[f"tp_state/onto_{onto}"])


def test_tp_train_state_restores_onto_one_rank(run, tmp_path):
    """The (2, 4) save restored onto a (1, 1) mesh of a world of one is the
    assembled state, bitwise."""
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptState, init_opt_state

    root, port = run("elastic")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = meshlib.make_host_mesh(1, 1, device="cpu")
        model = build_model(get_config("olmo-1b").reduced(), device="cpu")
        specs = model.partition_specs(mesh, drop_fsdp=True)
        template = (model.params, init_opt_state(model.params))
        state, manifest = CheckpointManager(str(root / "tp_state")).restore(
            template, mesh=mesh, specs=(specs, OptState((), specs, specs)))
    finally:
        dist.destroy_process_group()
    got = _tree.flatten(state, _np, np.stack)
    want = _under(port, "tp_state/whole/")
    assert manifest["step"] == 1 and set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_reference_checkpoint_restores_onto_a_port_mesh(run):
    _, port = run("elastic")
    assert bool(port["reference_ckpt/onto_2x4"])


# ---- in process
def _public(path: Path, names) -> dict:
    """``{name: (positional args, keyword-only args)}`` of the module-level
    functions ``names`` of a module."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            out[node.name] = ([a.arg for a in node.args.args],
                              [a.arg for a in node.args.kwonlyargs])
    return out


@pytest.mark.parametrize("module,names", [
    ("dist/collectives.py", ("make_compressed_dp_step",)),
    ("launch/mesh.py", ("manual_mode", "in_manual_mode", "named_sharding")),
])
def test_public_signatures_are_the_references(module, names):
    ref = _public(ROOT / "src" / "repro" / module, names)
    port = _public(ROOT / "src" / "repro_torch" / module, names)
    assert set(ref) == set(names) and port == ref


class _Mesh:
    """Stands in for rank ``coord`` of a ``("data", "model")`` DeviceMesh."""

    mesh_dim_names = ("data", "model")

    def __init__(self, sizes, coord=(0, 0)):
        self._sizes, self._coord = sizes, list(coord)

    def size(self, dim=None):
        return self._sizes[dim] if dim is not None else self._sizes[0] * self._sizes[1]

    def get_coordinate(self):
        return self._coord


def test_manual_mode_runs_the_single_device_path():
    from repro_torch.launch import mesh as tmesh

    mesh = _Mesh((2, 4))
    assert not tmesh.in_manual_mode() and tmesh.active_mesh() is None
    with tmesh.use_mesh(mesh):
        assert tmesh.active_mesh() is mesh and tmesh.tp_active() == 4
        with tmesh.manual_mode():
            assert tmesh.in_manual_mode() and tmesh.active_mesh() is None
            assert tmesh.tp_active() == 1 and tmesh.tp_size() == 4
        assert not tmesh.in_manual_mode()


def test_named_sharding_cuts_and_sizes_blocks():
    from repro_torch.launch import mesh as tmesh

    x = torch.arange(48.0).reshape(8, 6)
    s = tmesh.named_sharding(("fsdp", "tp"), _Mesh((2, 3), (1, 2)))
    assert s.spec == ("data", "model") and s.block_shape((8, 6)) == (4, 2)
    assert torch.equal(s.cut(x), x[4:, 4:])
    both = tmesh.NamedSharding(_Mesh((2, 3), (1, 2)), (("data", "model"), None))
    assert torch.equal(both.cut(torch.arange(12.0)[:, None]), torch.arange(12.0)[10:, None])
    with pytest.raises(ValueError, match="does not divide"):
        s.block_shape((8, 5))
    with pytest.raises(AssertionError, match="no mesh"):
        tmesh.named_sharding(("tp",))


ALL_ARCHS = ["olmo-1b", "qwen3-8b", "h2o-danube-3-4b", "deepseek-coder-33b", "qwen2-vl-7b",
             "qwen2-moe-a2.7b", "dbrx-132b", "falcon-mamba-7b", "recurrentgemma-2b",
             "whisper-base"]


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_published_attention_ffn_configs_cut_over_the_model_axis(arch, tp):
    """Every parameter of the ten architectures at full size has a block on
    a model axis of 2, 4 and 8 (the serving layout); the SSM's ``in_proj``
    (``x | z``) is cut part by part, and its blocks assemble it back."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import build_model

    model = build_model(get_config(arch), device="meta")
    mesh = _Mesh((1, tp))
    specs = _tree.specs_of(model.param_defs, model.partition_specs(mesh, drop_fsdp=True))
    parts = 0
    for d, spec in zip(_tree.leaves(model.param_defs), specs):
        block = tmesh.NamedSharding.of(mesh, spec).block_shape(d.shape)
        assert np.prod(block) * (tp if "model" in spec else 1) == np.prod(d.shape)
        parts += getattr(spec, "parts", 1) > 1
    assert (parts > 0) == (get_config(arch).family == "ssm")  # in_proj, a layer each


@pytest.mark.parametrize("tp", [2, 4])
def test_parts_cut_gives_each_rank_its_block_of_each_part(tp):
    """``in_proj`` (d, 2 d_inner) = ``x | z``: rank r's block is ``[x block r
    | z block r]``, and the blocks, concatenated rank-major as a gather
    gives them, reorder to the whole bitwise."""
    from repro_torch.launch import mesh as tmesh

    d, di = 3, 4 * tp
    w = torch.arange(d * 2 * di, dtype=torch.float32).reshape(d, 2 * di)
    spec = tmesh.PartsSpec((None, "model"), 2)
    assert spec == (None, "model")  # the reference's spec, as a tuple
    blocks = []
    for r in range(tp):
        got = tmesh.NamedSharding.of(_Mesh((1, tp), (0, r)), spec).cut(w)
        n = di // tp
        assert torch.equal(got, torch.cat([w[:, r * n:(r + 1) * n],
                                           w[:, di + r * n:di + (r + 1) * n]], 1))
        blocks.append(got)
    gathered = torch.cat(blocks, 1)
    whole = gathered.reshape(d, tp, 2, -1).transpose(1, 2).reshape(d, -1)
    assert torch.equal(whole, w)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b",
                                  "whisper-base"])
def test_families_without_tensor_parallelism_raise_the_sharded_lm(arch, tmp_path):
    """Every family now shards over ``"model"``, so the drivers refuse
    ``--tp 2`` only where the mesh is not the world (a process of one), and
    ``driver_mesh`` takes the family's ``--dp 1 --tp 1`` on a gloo world of
    one, on which the family's loss runs its collectives and equals the
    local loss bitwise."""
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver
    from repro_torch.models import build_model

    with pytest.raises(ValueError, match="must equal the world size"):
        train_driver.main(["--arch", arch, "--reduced", "--steps", "1", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path), "--tp", "2"])
    with pytest.raises(ValueError, match="must equal the world size"):
        serve_driver.main(["--arch", arch, "--reduced", "--device", "cpu", "--tp", "2"])
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            np.random.default_rng(1).standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = model.loss_fn(model.params, batch)[0]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh, dev = tmesh.driver_mesh(1, 1, "cpu")
        specs = model.partition_specs(mesh, drop_fsdp=True)
        blocks = tmesh.shard_tree(_tree.tree_map(torch.Tensor.detach, model.params), specs, mesh)
        coll.TP.calls = 0
        with tmesh.use_mesh(mesh), torch.no_grad():
            got = model.loss_fn(blocks, batch)[0]
        assert coll.TP.calls > 0 and dev == torch.device("cpu")
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)


def test_drivers_refuse_a_mesh_that_is_not_the_world(tmp_path):
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver

    for flags in (["--dp", "2", "--tp", "2"], ["--dp", "8"]):
        with pytest.raises(ValueError, match="must equal the world size"):
            train_driver.main(["--arch", "olmo-1b", "--reduced", "--steps", "1", "--device",
                               "cpu", "--ckpt-dir", str(tmp_path), *flags])
        with pytest.raises(ValueError, match="must equal the world size"):
            serve_driver.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", *flags])


def test_port_modules_of_this_slice_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.launch.mesh, repro_torch.dist.collectives, "
            "repro_torch.train.train_step, repro_torch.train.loop, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.serve.engine, repro_torch.interop, "
            "repro_torch.models.moe, repro_torch.models.ssm, repro_torch.models.rglru, "
            "repro_torch.models.attention, repro_torch.models.encdec, "
            "repro_torch.models.transformer, repro_torch.models.model, "
            "repro_torch.checkpoint.manager, repro_torch.train.optimizer")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    if case_ == "reference":
        _reference(root_)
    else:
        torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
