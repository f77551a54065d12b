"""The port's sharded SSM, RG-LRU hybrid and enc-dec families, and the
query-row attention layout, in 8-rank gloo worlds on the CPU.

Each multi-rank case is one subprocess, ``python tests/test_torch_sharded_lm_scan.py
<family> <dir>``: 8 gloo ranks (``init_method="file://<dir>/store"``, one
torch thread each), rank 0 writing ``<dir>/out.npz``; one world a family,
its meshes, steps and drivers one after the other.  The inputs are numpy
from a seed, written here: the reference's parameters
(``repro.checkpoint.manager._flatten``), the tokens (and frames), crossing
into each rank's blocks through ``repro_torch.interop.params_from_numpy(...,
mesh=)``.  The oracle is the reference's unsharded model in this process
(its sharded runs equal it to fp32 rounding at every mesh of these
families).

Reduced falcon-mamba (``in_proj`` cut part by part, ``x_proj``'s summed
backward) and recurrentgemma (RG-LRU channels; at (1, 8) 8-channel rank
blocks straddle its 16-channel gate blocks, and its 4 heads take the
query-row layout, the local window of 16 over 32 tokens running the rows
against key spans) here; whisper-base (4 heads, 2 kv heads: (4, 2)
grouped, (2, 4) expanded, (1, 8) query rows; cross attention on the
gathered encoder states) in ``tests/test_torch_sharded_lm_encdec.py``,
which runs these tests on it (``NAMES``).  8 rows of 32 tokens (the
encoder 16 frames):

* the forward's logits, gathered over ``"model"`` and the data groups, at
  ``(4, 2)``, ``(2, 4)`` and ``(1, 8)`` against the reference's at
  ``rtol=2e-4, atol=2e-5``;
* one train step at ``(2, 4)`` and ``(1, 8)``, and at ``(1, 8)`` on 30
  tokens, which do not divide over the ranks (the stream stays whole, the
  attention runs whole on gathered weights): loss at that bound, the
  assembled gradients within a norm-wise 2e-3 of the reference's and the
  parameters at the training bounds of ``tests/test_torch_train.py`` (an
  entry whose gradient is below ``SIGN_NOISE`` of its leaf's largest may
  move a further 2 * lr: AdamW's first step is about ``lr * sign(g)``); the
  ``(2, 4)`` step repeated is bitwise itself;
* ``launch.train --dp 2 --tp 4`` against the single-rank driver (losses; the
  SSM and hybrid: the driver, as the reference's, feeds tokens only, so it
  does not train the enc-dec model) and ``launch.serve --dp 2 --tp 4``
  against the single-rank engine (the greedy
  tokens up to and including the first step whose top-2 logit gap on the
  single rank is within ``GAP_BOUND``);
* elastic restore: the ``(2, 4)`` train state saved and restored onto
  ``(4, 2)`` bitwise (and onto one rank here, bitwise); a checkpoint the
  reference wrote of falcon-mamba restored onto ``(2, 4)`` gives the
  reference's loss, and its ``in_proj`` assembles bitwise.

By hand, one case (the inputs must be in ``<dir>`` first, as the fixture
writes them with ``_inputs``):

    PYTHONPATH=src python tests/test_torch_sharded_lm_scan.py ssm <dir>
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_REL = 2e-3  # the reference's whole-model gradient bound (tests/test_torch_train.py)
SIGN_NOISE = 1e-5
GAP_BOUND = 1e-4
CASE_TIMEOUT = 300
FORWARD_MESHES = ((4, 2), (2, 4), (1, 8))
BATCH, SEQ, FRAMES = 8, 32, 16
# 30 tokens do not divide over 8 ranks: the residual stream stays whole (the
# layers enter by tp_copy and leave by tp_sum, the attention runs whole on
# gathered weights), while whisper's 16 frames still shard its encoder
WHOLE_SEQ = 30
TRAIN_RUNS = (((2, 4), SEQ), ((1, 8), SEQ), ((1, 8), WHOLE_SEQ))
LR = 1e-3
FAMILIES = {"ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b", "encdec": "whisper-base"}
# this file's families; tests/test_torch_sharded_lm_encdec.py runs these
# tests on "encdec" (one 8-rank world a family: a file each keeps both near
# 100 s of test time in the suite's run)
NAMES = ("ssm", "hybrid")
DRIVER_STEPS, DRIVER_BATCH, DRIVER_SEQ = 2, 8, 16
# launch.train feeds no frames to an enc-dec model, so the train driver's
# test is left out of whisper-base's file
TRAIN_DRIVER_FAMILIES = ("ssm", "hybrid")
SERVE_ARGS = ("--reduced", "--requests", "8", "--new-tokens", "8", "--batch-size", "4")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree) -> dict:
    from repro_torch import _tree

    return _tree.flatten(tree, _np, np.stack)


def _tag(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _run_tag(run_) -> str:
    mesh, seq = run_
    return _tag(mesh) + ("" if seq == SEQ else f"/s{seq}")


# ---------------------------------------------------------- the rank side
def _gather_objects(obj) -> list:
    import torch.distributed as dist

    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs


def _same_everywhere(arrays: dict) -> bool:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return len(set(_gather_objects(h.hexdigest()))) == 1


def _block(batch: dict, mesh) -> dict:
    """This rank's data-parallel rows of ``batch`` (numpy) as tensors."""
    from repro_torch.launch import mesh as meshlib

    groups, g = meshlib.dp_coord(mesh)
    n = batch["tokens"].shape[0] // groups
    return {k: torch.from_numpy(np.ascontiguousarray(v[g * n:(g + 1) * n]))
            for k, v in batch.items()}


def _logits(model, params, block) -> torch.Tensor:
    from repro_torch.models import encdec, transformer

    cfg = model.cfg
    if cfg.is_encdec:
        return encdec.decode_train(params, cfg, block["tokens"][:, :-1],
                                   encdec.encode(params, cfg, block["frames"]))
    h, _, _ = transformer.forward(params, cfg, block["tokens"][:, :-1])
    return transformer.lm_logits(params, cfg, h)


def _train_step(model, params, block, mesh, out, tag):
    """One ``make_train_step`` on ``mesh``: loss, the assembled gradients
    and parameters into ``out``; returns the new (params, opt_state)."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    specs = model.partition_specs(mesh, drop_fsdp=True)
    real, seen = tstep.adamw_update, []

    def recording(params, grads, state, cfg, **kw):
        seen.append(_flat(meshlib.assemble_tree(grads, specs, mesh)))
        return real(params, grads, state, cfg, **kw)

    tstep.adamw_update = recording
    try:
        with meshlib.use_mesh(mesh):
            p, s, met = tstep.make_train_step(model, OptConfig(lr=LR, warmup_steps=0))(
                params, init_opt_state(params), block)
    finally:
        tstep.adamw_update = real
    whole = _flat(meshlib.assemble_tree(p, specs, mesh))
    out[f"{tag}/loss"] = float(met["loss"])
    out.update({f"{tag}/g/{k}": v for k, v in seen[0].items()})
    out.update({f"{tag}/p/{k}": v for k, v in whole.items()})
    out[f"{tag}/same_everywhere"] = _same_everywhere(whole)
    return p, s


def _case_family(name: str, root: str, out: dict) -> None:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptState, init_opt_state

    arch = FAMILIES[name]
    model = build_model(get_config(arch).reduced(), device="cpu")
    flat = dict(np.load(f"{root}/params.npz"))
    batch = dict(np.load(f"{root}/batch.npz"))
    for shape in FORWARD_MESHES:
        mesh = meshlib.make_host_mesh(*shape, device="cpu")
        params = params_from_numpy(model, flat, mesh=mesh)
        block = _block(batch, mesh)
        coll.TP.calls = 0
        with meshlib.use_mesh(mesh), torch.no_grad():
            logits = coll.gather_cat(_logits(model, params, block), ("model",), mesh, dim=-1)
        out[f"{_tag(shape)}/tp_calls"] = coll.TP.calls
        whole = _np(coll.gather_cat(logits, ("data",), mesh, dim=0))
        out[f"{_tag(shape)}/logits"] = whole
        out[f"{_tag(shape)}/logits_same_everywhere"] = _same_everywhere({"l": whole})
        for run_ in TRAIN_RUNS:
            if run_[0] != shape:
                continue
            cut = {**block, "tokens": block["tokens"][:, :run_[1] + 1]}
            p, s = _train_step(model, params, cut, mesh, out, _run_tag(run_))
            if shape == (2, 4):
                again = {}
                _train_step(model, params, block, mesh, again, "again")
                out["again/bitwise"] = all(
                    np.array_equal(again[f"again/p/{k[len('2x4/p/'):]}"], v)
                    for k, v in out.items() if k.startswith("2x4/p/"))
                state_2x4 = (p, s)
    # elastic restore: the (2, 4) state saved, restored onto (4, 2)
    mesh_b = meshlib.make_host_mesh(2, 4, device="cpu")
    mesh_a = meshlib.make_host_mesh(4, 2, device="cpu")

    def where(mesh):
        specs = model.partition_specs(mesh, drop_fsdp=True)
        return specs, (specs, OptState((), specs, specs))

    specs_b, where_b = where(mesh_b)
    mgr = CheckpointManager(f"{root}/tp_state")
    mgr.save(1, state_2x4, mesh=mesh_b, specs=where_b)
    whole_state = meshlib.assemble_tree(state_2x4, where_b, mesh_b)
    _, where_a = where(mesh_a)
    template = (model.params, init_opt_state(model.params))
    got, _ = mgr.restore(template, mesh=mesh_a, specs=where_a)
    want = meshlib.shard_tree(whole_state, where_a, mesh_a)
    from repro_torch import _tree

    out["elastic/onto_4x2"] = all(_gather_objects(all(
        torch.equal(x, y) for x, y in zip(_tree.leaves(got), _tree.leaves(want)))))
    out.update({f"elastic/whole/{k}": v for k, v in _flat(whole_state).items()})
    if name == "ssm":  # a checkpoint the reference wrote, restored onto (2, 4)
        ref = CheckpointManager(f"{root}/reference_ckpt")
        (rp, _), _ = ref.restore(template, mesh=mesh_b, specs=where_b)
        with meshlib.use_mesh(mesh_b), torch.no_grad():
            loss = model.loss_fn(rp, _block(batch, mesh_b))[0]
            out["reference_ckpt/loss"] = float(coll.ordered_mean(loss, ("data",), mesh_b))
        key = "layers/mixer/in_proj"
        with np.load(f"{root}/reference_ckpt/step_{ref.latest_step():08d}/arrays.npz") as a:
            file_in_proj = np.asarray(a[f"0/{key}"])
        assembled = _flat(meshlib.assemble_tree(rp, specs_b, mesh_b))[key]
        out["reference_ckpt/in_proj_bitwise"] = np.array_equal(assembled, file_in_proj)
    # the drivers on a (2, 4) mesh (launch.train feeds tokens only, so it
    # trains the decoder-only families, as the reference's does)
    if not model.cfg.is_encdec:
        res = train_driver.main([
            "--arch", arch, "--reduced", "--steps", str(DRIVER_STEPS), "--batch",
            str(DRIVER_BATCH), "--seq", str(DRIVER_SEQ), "--ckpt-every", str(DRIVER_STEPS),
            "--ckpt-dir", f"{root}/driver", "--device", "cpu", "--dp", "2", "--tp", "4"])
        out["driver/loss"] = np.array([m["loss"] for m in res.metrics_history])
    served = serve_driver.main(["--arch", arch, *SERVE_ARGS, "--device", "cpu", "--dp", "2",
                                "--tp", "4"])
    tokens = np.stack([served[k] for k in sorted(served)])
    out["serve/tokens"] = tokens
    out["serve/same_everywhere"] = _same_everywhere({"t": tokens})


def _rank_main(rank: int, case: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        _case_family(case, root, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- the pytest side
def _reference_model(arch: str):
    import repro.configs as jconfigs
    from repro.models import build_model as jbuild

    return jbuild(jconfigs.get_config(arch).reduced())


def _unflatten(template, flat: dict):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten

    _, tdef = jax.tree.flatten(template)
    return tdef.unflatten([jnp.asarray(flat[k]) for k in _flatten(template)])


def _inputs(name: str, root: Path) -> None:
    """The reference's parameters (``PRNGKey`` of the family's index), the
    batch (numpy seeds), and for the SSM a checkpoint of the reference's
    ``(params, opt_state)``."""
    import jax
    from repro.checkpoint.manager import _flatten

    i = list(FAMILIES).index(name)
    jm = _reference_model(FAMILIES[name])
    np.savez(root / "params.npz",
             **{k: np.asarray(v) for k, v in _flatten(jm.init(jax.random.PRNGKey(i))).items()})
    cfg = jm.cfg
    rng = np.random.default_rng(10 + i)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((BATCH, FRAMES, cfg.d_model)).astype(np.float32)
    np.savez(root / "batch.npz", **batch)
    if name == "ssm":
        from repro.checkpoint.manager import CheckpointManager as JManager
        from repro.train.optimizer import init_opt_state

        jp = jm.init(jax.random.PRNGKey(3))
        JManager(str(root / "reference_ckpt")).save(2, (jp, init_opt_state(jp)))


def pytest_generate_tests(metafunc):
    """Every test taking ``name`` runs on the module's ``NAMES``."""
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", metafunc.module.NAMES)


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    """``run(name)``: ``(dir, results)`` of the family's case, for the
    requesting module's ``NAMES``.  The first call writes every case's
    inputs and starts the cases one after the other on a thread, so the
    reference's oracles here run beside them; a failure is kept and raised
    to every test of the case."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    roots = {}
    for name in request.module.NAMES:
        roots[name] = tmp_path_factory.mktemp(name)
        _inputs(name, roots[name])
    done, procs = {}, []
    events = {name: threading.Event() for name in roots}

    def work():
        for name, root in roots.items():
            proc = subprocess.Popen([sys.executable, __file__, name, str(root)], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, process_group=0)
            procs.append(proc)
            try:
                _, err = proc.communicate(timeout=CASE_TIMEOUT)
                if proc.returncode != 0:
                    done[name] = AssertionError(f"case {name} failed:\n{err[-4000:]}")
                else:
                    done[name] = (root, dict(np.load(root / "out.npz")))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)  # the case and the ranks it spawned
                proc.communicate()
                done[name] = AssertionError(f"case {name} ran over {CASE_TIMEOUT} s")
            events[name].set()

    thread = threading.Thread(target=work, daemon=True)
    thread.start()

    def get(name):
        events[name].wait()
        if isinstance(done[name], Exception):
            raise done[name]
        return done[name]

    get.roots = roots
    yield get
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    thread.join(timeout=10)


@pytest.fixture(scope="module")
def reference(run):
    """The reference's unsharded logits, gradients, one-step parameters and
    loss of each family's inputs (jitted)."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten
    from repro.models import encdec as jencdec
    from repro.models import transformer as jtransformer
    from repro.train.optimizer import OptConfig, adamw_update, init_opt_state

    out = {}
    for name, root in run.roots.items():
        arch = FAMILIES[name]
        jm = _reference_model(arch)
        cfg = jm.cfg
        params = _unflatten(jm.init(jax.random.PRNGKey(0)), dict(np.load(root / "params.npz")))
        batch = {k: jnp.asarray(v) for k, v in np.load(root / "batch.npz").items()}

        def logits_of(p, b):
            if cfg.is_encdec:
                return jencdec.decode_train(p, cfg, b["tokens"][:, :-1],
                                            jencdec.encode(p, cfg, b["frames"]))
            h, _, _ = jtransformer.forward(p, cfg, b["tokens"][:, :-1])
            return jtransformer.lm_logits(p, cfg, h)

        logits = np.asarray(jax.jit(logits_of)(params, batch), np.float32)
        # the reference's train step is its loss's gradient, then adamw_update
        loss_grad = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b)[0]))
        update = jax.jit(lambda p, g: adamw_update(p, g, init_opt_state(p),
                                                   OptConfig(lr=LR, warmup_steps=0))[0])
        out[name] = dict(logits=logits)
        for seq in sorted({seq for _, seq in TRAIN_RUNS}):
            loss, grads = loss_grad(params, {**batch, "tokens": batch["tokens"][:, :seq + 1]})
            out[name][seq] = dict(
                grads={k: np.asarray(v) for k, v in _flatten(grads).items()},
                loss=float(loss),
                params={k: np.asarray(v) for k, v in _flatten(update(params, grads)).items()})
        if name == "ssm":
            ck = root / "reference_ckpt"
            with np.load(next(ck.glob("step_*")) / "arrays.npz") as a:
                ref_p = _unflatten(jm.init(jax.random.PRNGKey(0)),
                                   {k[2:]: a[k] for k in a.files if k.startswith("0/")})
            out["ckpt_loss"] = float(jax.jit(lambda p, b: jm.loss_fn(p, b)[0])(ref_p, batch))
    return out


def _under(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


# ---- the forward
@pytest.mark.parametrize("mesh", FORWARD_MESHES, ids=_tag)
def test_sharded_logits_match_the_references_unsharded_forward(run, reference, name, mesh):
    _, port = run(name)
    got = port[f"{_tag(mesh)}/logits"]
    want = reference[name]["logits"]
    v = _reference_model(FAMILIES[name]).cfg.vocab
    np.testing.assert_allclose(got[..., :v], want[..., :v], **TOL)
    assert (got[..., v:] == -1e9).all()  # the vocab pad, masked in its block
    assert bool(port[f"{_tag(mesh)}/logits_same_everywhere"])
    assert int(port[f"{_tag(mesh)}/tp_calls"]) > 0


# ---- one train step
@pytest.mark.parametrize("run_", TRAIN_RUNS, ids=_run_tag)
def test_sharded_train_step_matches_the_reference(run, reference, name, run_):
    _, port = run(name)
    ref = reference[name][run_[1]]
    tag = _run_tag(run_)
    np.testing.assert_allclose(port[f"{tag}/loss"], ref["loss"], **TOL)
    grads = _under(port, f"{tag}/g/")
    assert set(grads) == set(ref["grads"])
    for k, want in ref["grads"].items():
        rel = np.linalg.norm(grads[k] - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < GRAD_REL, (k, rel)
    got = _under(port, f"{tag}/p/")
    assert set(got) == set(ref["params"])
    for k, want in ref["params"].items():
        g = np.abs(grads[k])
        allow = TOL["atol"] + TOL["rtol"] * np.abs(want) + np.where(
            g < SIGN_NOISE * g.max(), 2 * LR, 0.0)
        diff = np.abs(np.asarray(got[k], np.float64) - want)
        assert not (diff > allow).any(), (k, float(diff.max()))
    assert bool(port[f"{tag}/same_everywhere"])


def test_sharded_train_step_repeats_bitwise(run, name):
    _, port = run(name)
    assert bool(port["again/bitwise"])


# ---- the drivers
@pytest.fixture(scope="module")
def one_rank(run):
    """The single-rank drivers of each family: ``launch.train``'s losses,
    and ``launch.serve``'s tokens with each step's top-2 logit gaps."""
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver
    from repro_torch.serve import engine

    real, gaps = engine._select, []

    def select(logits, gen, generator):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).numpy())
        return real(logits, gen, generator)

    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    engine._select = select
    try:
        for name in run.roots:
            arch, losses = FAMILIES[name], None
            if name in TRAIN_DRIVER_FAMILIES:
                res = train_driver.main([
                    "--arch", arch, "--reduced", "--steps", str(DRIVER_STEPS), "--batch",
                    str(DRIVER_BATCH), "--seq", str(DRIVER_SEQ), "--ckpt-every",
                    str(DRIVER_STEPS), "--ckpt-dir", str(run.roots[name] / "one_rank"),
                    "--device", "cpu"])
                losses = np.array([m["loss"] for m in res.metrics_history])
            gaps.clear()
            served = serve_driver.main(["--arch", arch, *SERVE_ARGS, "--device", "cpu"])
            per_batch = [np.stack(gaps[i:i + 9], 1) for i in range(0, len(gaps), 9)]
            out[name] = (losses, np.stack([served[k] for k in sorted(served)]),
                         np.concatenate(per_batch))
    finally:
        engine._select = real
        torch.set_num_threads(threads)
    return out


def test_train_driver_on_a_2x4_mesh_matches_one_rank(run, one_rank, name):
    _, port = run(name)
    np.testing.assert_allclose(port["driver/loss"], one_rank[name][0], **TOL)


def test_serve_driver_on_a_2x4_mesh_gives_the_single_rank_greedy_tokens(run, one_rank, name):
    _, port = run(name)
    got = port["serve/tokens"]
    _, want, gaps = one_rank[name]
    assert got.shape == want.shape and bool(port["serve/same_everywhere"])
    compared = 0
    for row in range(want.shape[0]):
        for t in range(want.shape[1]):
            assert got[row, t] == want[row, t] or gaps[row, t] <= GAP_BOUND, (row, t)
            compared += 1
            if gaps[row, t] <= GAP_BOUND:
                break  # past a near tie the continuations may part
    assert compared >= want.size // 2


# ---- checkpoints
def test_train_state_restores_from_2x4_onto_4x2(run, name):
    _, port = run(name)
    assert bool(port["elastic/onto_4x2"])


def test_train_state_restores_from_2x4_onto_one_rank(run, name, tmp_path):
    """The (2, 4) save restored onto a (1, 1) mesh of a world of one is the
    assembled state, bitwise."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptState, init_opt_state

    root, port = run(name)
    model = build_model(get_config(FAMILIES[name]).reduced(), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = meshlib.make_host_mesh(1, 1, device="cpu")
        specs = model.partition_specs(mesh, drop_fsdp=True)
        state, manifest = CheckpointManager(str(root / "tp_state")).restore(
            (model.params, init_opt_state(model.params)), mesh=mesh,
            specs=(specs, OptState((), specs, specs)))
    finally:
        dist.destroy_process_group()
    got = _flat(state)
    want = _under(port, "elastic/whole/")
    assert manifest["step"] == 1 and set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_reference_ssm_checkpoint_on_a_2x4_mesh_gives_the_references_loss(run, reference):
    _, port = run("ssm")
    np.testing.assert_allclose(port["reference_ckpt/loss"], reference["ckpt_loss"], **TOL)
    assert bool(port["reference_ckpt/in_proj_bitwise"])


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
