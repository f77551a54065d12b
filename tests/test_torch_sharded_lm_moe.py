"""The port's MoE expert parallelism in 8-rank gloo worlds on the CPU.

One subprocess, ``python tests/test_torch_sharded_lm_moe.py moe <dir>``: 8
gloo ranks (``init_method="file://<dir>/store"``, one torch thread each),
rank 0 writing ``<dir>/out.npz``.  The inputs are numpy from a seed, written
here: the reference's parameters (``repro.checkpoint.manager._flatten``) and
the tokens, crossing into each rank's blocks through
``repro_torch.interop.params_from_numpy(..., mesh=)``.

The MoE's capacity counts the tokens of a data-parallel block, so its loss
depends on the data-parallel size: the reference's sharded loss at ``(dp,
tp)`` is the mean over the ``dp`` row blocks of its unsharded loss on each
block, and expert parallelism changes no value.  The oracle is therefore
the reference's unsharded model in this process, run block by block and
averaged (loss, gradients; the parameters then take the reference's AdamW
step with the averaged gradients).

Reduced qwen2-moe (8 experts padded to 16, top 2, a shared expert behind
its gate; 4 heads), 8 rows of 32 tokens, at ``(4, 2)``, ``(2, 4)`` and
``(1, 8)`` (2 experts a rank at the last):

* the forward's logits, gathered, against the reference's of each block at
  ``rtol=2e-4, atol=2e-5``; each rank routes its whole data block (the
  gathered sequence), its top-k indices the reference's of those tokens;
* one train step: loss at that bound, the assembled gradients within a
  norm-wise 2e-3 of the reference's, the router's and ``shared_gate``'s
  gradient the same whole one on every rank, the parameters at the
  training bounds of ``tests/test_torch_train.py``; the ``(2, 4)`` step
  repeated is bitwise itself; dbrx (no shared expert) at ``(2, 4)`` the
  same way;
* ``launch.train --dp 2 --tp 4`` against a single-rank run of its two data
  groups (the mean of the blocks' gradients, then the loop's AdamW), and
  ``launch.serve --dp 2 --tp 4`` against the single-rank engine serving each
  data group's rows of a batch (the greedy tokens up to and including the
  first step whose top-2 logit gap there is within ``GAP_BOUND``);
* the ``(2, 4)`` train state saved and restored onto ``(4, 2)`` and, here,
  onto one rank, bitwise.

By hand (the inputs must be in ``<dir>`` first, as the fixture writes them
with ``_inputs``):

    PYTHONPATH=src python tests/test_torch_sharded_lm_moe.py moe <dir>
"""

import dataclasses
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
GRAD_REL = 2e-3
SIGN_NOISE = 1e-5
GAP_BOUND = 1e-4
CASE_TIMEOUT = 300
MESHES = ((4, 2), (2, 4), (1, 8))
BATCH, SEQ = 8, 32
LR = 1e-3
ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b")
RUNS = [("qwen2-moe-a2.7b", m) for m in MESHES] + [("dbrx-132b", (2, 4))]
DRIVER_STEPS, DRIVER_BATCH, DRIVER_SEQ, DRIVER_LR = 2, 8, 16, 3e-4
SERVE_ARGS = ("--reduced", "--requests", "8", "--new-tokens", "8", "--batch-size", "4")
SERVE_BATCH, NEW_TOKENS = 4, 8


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree) -> dict:
    from repro_torch import _tree

    return _tree.flatten(tree, _np, np.stack)


def _tag(arch, mesh) -> str:
    return f"{arch}/{mesh[0]}x{mesh[1]}"


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


def _case_moe(root: str, out: dict) -> None:
    from repro_torch import _tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver
    from repro_torch.models import build_model, transformer
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import OptConfig, OptState, init_opt_state

    real_update, real_route = tstep.adamw_update, moe_mod.route
    grads_seen, routes = [], []

    def recording(params, grads, state, cfg, **kw):
        grads_seen.append(grads)
        return real_update(params, grads, state, cfg, **kw)

    def routing(p, cfg, xf, **kw):
        r = real_route(p, cfg, xf, **kw)
        routes.append((_np(xf).copy(), _np(r.top_idx).copy()))
        return r

    tstep.adamw_update, moe_mod.route = recording, routing
    for arch, shape in RUNS:
        tag = _tag(arch, shape)
        model = build_model(get_config(arch).reduced(), device="cpu")
        flat = dict(np.load(f"{root}/params_{arch}.npz"))
        tokens = np.load(f"{root}/tokens.npz")[arch]
        mesh = meshlib.make_host_mesh(*shape, device="cpu")
        specs = model.partition_specs(mesh, drop_fsdp=True)
        params = params_from_numpy(model, flat, mesh=mesh)
        groups, g = meshlib.dp_coord(mesh)
        n = BATCH // groups
        block = {"tokens": torch.from_numpy(tokens[g * n:(g + 1) * n])}
        routes.clear()
        coll.TP.calls = 0
        with meshlib.use_mesh(mesh), torch.no_grad():
            h, _, _ = transformer.forward(params, model.cfg, block["tokens"][:, :-1])
            logits = coll.gather_cat(transformer.lm_logits(params, model.cfg, h), ("model",),
                                     mesh, dim=-1)
        out[f"{tag}/tp_calls"] = coll.TP.calls
        out[f"{tag}/logits"] = _np(coll.gather_cat(logits, ("data",), mesh, dim=0))
        for r, recs in enumerate(_gather_objects(routes)):
            for layer, (xf, idx) in enumerate(recs):
                out[f"{tag}/route/{r}/{layer}/x"], out[f"{tag}/route/{r}/{layer}/idx"] = xf, idx
        step = tstep.make_train_step(model, OptConfig(lr=LR, warmup_steps=0))
        states = []
        for again in ((False, True) if shape == (2, 4) else (False,)):
            grads_seen.clear()
            with meshlib.use_mesh(mesh):
                p, s, met = step(params, init_opt_state(params), block)
            whole = _flat(meshlib.assemble_tree(p, specs, mesh))
            if again:
                out[f"{tag}/again_bitwise"] = all(
                    np.array_equal(whole[k], out[f"{tag}/p/{k}"]) for k in whole)
                continue
            out[f"{tag}/loss"] = float(met["loss"])
            out.update({f"{tag}/p/{k}": v for k, v in whole.items()})
            grads = grads_seen[0]
            out.update({f"{tag}/g/{k}": v for k, v in
                        _flat(meshlib.assemble_tree(grads, specs, mesh)).items()})
            norm = topt.global_norm(grads, specs=specs, mesh=mesh)  # "expert" is "model"
            out[f"{tag}/global_norm"] = float(norm)
            out[f"{tag}/global_norm_whole"] = float(
                topt.global_norm(meshlib.assemble_tree(grads, specs, mesh)))
            replicated = {k: v for k, v in _flat(grads).items()
                          if k.endswith(("/router", "/shared_gate"))}
            out[f"{tag}/replicated_grads_same_everywhere"] = _same_everywhere(replicated)
            out[f"{tag}/params_same_everywhere"] = _same_everywhere(whole)
            states.append((p, s))
        if arch == "qwen2-moe-a2.7b" and shape == (2, 4):  # the (2, 4) state onto (4, 2)
            mesh_a = meshlib.make_host_mesh(4, 2, device="cpu")

            def where(m):
                sp = model.partition_specs(m, drop_fsdp=True)
                return sp, OptState((), sp, sp)

            mgr = CheckpointManager(f"{root}/tp_state")
            mgr.save(1, states[0], mesh=mesh, specs=where(mesh))
            whole_state = meshlib.assemble_tree(states[0], where(mesh), mesh)
            got, _ = mgr.restore((model.params, init_opt_state(model.params)), mesh=mesh_a,
                                 specs=where(mesh_a))
            want = meshlib.shard_tree(whole_state, where(mesh_a), mesh_a)
            out["elastic/onto_4x2"] = all(_gather_objects(all(
                torch.equal(x, y) for x, y in zip(_tree.leaves(got), _tree.leaves(want)))))
            out.update({f"elastic/whole/{k}": v for k, v in _flat(whole_state).items()})
    tstep.adamw_update, moe_mod.route = real_update, real_route
    res = train_driver.main([
        "--arch", "qwen2-moe-a2.7b", "--reduced", "--steps", str(DRIVER_STEPS), "--batch",
        str(DRIVER_BATCH), "--seq", str(DRIVER_SEQ), "--ckpt-every", str(DRIVER_STEPS),
        "--ckpt-dir", f"{root}/driver", "--device", "cpu", "--dp", "2", "--tp", "4"])
    out["driver/loss"] = np.array([m["loss"] for m in res.metrics_history])
    served = serve_driver.main(["--arch", "qwen2-moe-a2.7b", *SERVE_ARGS, "--device", "cpu",
                                "--dp", "2", "--tp", "4"])
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
        _case_moe(root, out)
        if rank == 0:
            np.savez(f"{root}/out.npz", **out)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------- the pytest side
def _reference_model(arch: str):
    import repro.configs as jconfigs
    from repro.models import build_model as jbuild

    return jbuild(jconfigs.get_config(arch).reduced())


def _inputs(root: Path) -> None:
    import jax
    from repro.checkpoint.manager import _flatten

    tokens = {}
    for i, arch in enumerate(ARCHS):
        jm = _reference_model(arch)
        flat = _flatten(jm.init(jax.random.PRNGKey(i)))
        np.savez(root / f"params_{arch}.npz", **{k: np.asarray(v) for k, v in flat.items()})
        tokens[arch] = np.random.default_rng(1 + i).integers(
            0, jm.cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    np.savez(root / "tokens.npz", **tokens)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``(dir, results)`` of the 8-rank case, started here and awaited on
    first use, so the reference's oracles run beside it."""
    root = tmp_path_factory.mktemp("moe")
    _inputs(root)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, __file__, "moe", str(root)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            process_group=0)
    done = {}

    def get():
        if "result" not in done:
            try:
                _, err = proc.communicate(timeout=CASE_TIMEOUT)
                if proc.returncode != 0:
                    done["result"] = AssertionError(f"case moe failed:\n{err[-4000:]}")
                else:
                    done["result"] = (root, dict(np.load(root / "out.npz")))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)  # the case and the ranks it spawned
                proc.communicate()
                done["result"] = AssertionError(f"case moe ran over {CASE_TIMEOUT} s")
        if isinstance(done["result"], Exception):
            raise done["result"]
        return done["result"]

    get.root = root
    yield get
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.communicate()


@pytest.fixture(scope="module")
def reference(run):
    """For each run: the reference's unsharded logits of each data block,
    and the mean over the blocks of its loss and gradients, then its AdamW
    step with those (jitted)."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten
    from repro.models import transformer as jtransformer
    from repro.train.optimizer import OptConfig, adamw_update, init_opt_state

    out = {}
    for arch in ARCHS:
        jm = _reference_model(arch)
        cfg = jm.cfg
        template = jm.init(jax.random.PRNGKey(0))
        flat = dict(np.load(run.root / f"params_{arch}.npz"))
        _, tdef = jax.tree.flatten(template)
        params = tdef.unflatten([jnp.asarray(flat[k]) for k in _flatten(template)])
        tokens = np.load(run.root / "tokens.npz")[arch]

        @jax.jit
        def block_of(p, t):
            h, _, _ = jtransformer.forward(p, cfg, t[:, :-1])
            logits = jtransformer.lm_logits(p, cfg, h)
            loss, grads = jax.value_and_grad(lambda q: jm.loss_fn(q, {"tokens": t})[0])(p)
            return logits, loss, grads

        update = jax.jit(lambda p, g: adamw_update(p, g, init_opt_state(p),
                                                   OptConfig(lr=LR, warmup_steps=0))[0])
        for a, shape in RUNS:
            if a != arch:
                continue
            dp = shape[0]
            n = BATCH // dp
            logits, losses, grads = [], [], None
            for d in range(dp):
                lg, loss, g = block_of(params, jnp.asarray(tokens[d * n:(d + 1) * n]))
                logits.append(np.asarray(lg, np.float32))
                losses.append(float(loss))
                grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
            grads = jax.tree.map(lambda x: x / dp, grads)
            out[_tag(arch, shape)] = dict(
                logits=np.concatenate(logits), loss=float(np.mean(losses)),
                grads={k: np.asarray(v) for k, v in _flatten(grads).items()},
                params={k: np.asarray(v) for k, v in _flatten(update(params, grads)).items()},
                router=np.asarray(params["layers"]["moe"]["router"]))
    return out


def _under(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _ids(run_):
    return _tag(*run_)


@pytest.mark.parametrize("case", RUNS, ids=_ids)
def test_expert_parallel_logits_match_the_references_blocks(run, reference, case):
    _, port = run()
    tag = _tag(*case)
    got, want = port[f"{tag}/logits"], reference[tag]["logits"]
    v = _reference_model(case[0]).cfg.vocab
    np.testing.assert_allclose(got[..., :v], want[..., :v], **TOL)
    assert (got[..., v:] == -1e9).all()
    assert int(port[f"{tag}/tp_calls"]) > 0


@pytest.mark.parametrize("case", RUNS, ids=_ids)
def test_each_rank_routes_its_whole_data_block_as_the_reference(run, reference, case):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe

    _, port = run()
    arch, (dp, tp) = case
    tag = _tag(*case)
    cfg = _reference_model(arch).cfg
    routers = reference[tag]["router"]
    e_pad = jmoe.padded_experts(cfg.n_experts)
    for r in range(WORLD):
        for layer in range(cfg.n_layers):
            xf = jnp.asarray(port[f"{tag}/route/{r}/{layer}/x"])
            assert xf.shape[0] == BATCH // dp * SEQ  # the whole block, on every model rank
            logits = (xf @ jnp.asarray(routers[layer])).astype(jnp.float32)
            logits = jnp.where((jnp.arange(e_pad) < cfg.n_experts)[None], logits, -jnp.inf)
            _, top_idx = jax.lax.top_k(logits, cfg.n_experts_per_tok)
            np.testing.assert_array_equal(port[f"{tag}/route/{r}/{layer}/idx"],
                                          np.asarray(top_idx))


@pytest.mark.parametrize("case", RUNS, ids=_ids)
def test_expert_parallel_train_step_matches_the_references_block_mean(run, reference, case):
    _, port = run()
    tag = _tag(*case)
    ref = reference[tag]
    np.testing.assert_allclose(port[f"{tag}/loss"], ref["loss"], **TOL)
    grads = _under(port, f"{tag}/g/")
    assert set(grads) == set(ref["grads"])
    for k, want in ref["grads"].items():
        rel = np.linalg.norm(grads[k] - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < GRAD_REL, (k, rel)
    got = _under(port, f"{tag}/p/")
    for k, want in ref["params"].items():
        g = np.abs(grads[k])
        allow = TOL["atol"] + TOL["rtol"] * np.abs(want) + np.where(
            g < SIGN_NOISE * g.max(), 2 * LR, 0.0)
        diff = np.abs(np.asarray(got[k], np.float64) - want)
        assert not (diff > allow).any(), (k, float(diff.max()))
    assert bool(port[f"{tag}/params_same_everywhere"])


@pytest.mark.parametrize("case", RUNS, ids=_ids)
def test_router_and_shared_gate_gradients_are_whole_on_every_rank(run, case):
    _, port = run()
    assert bool(port[f"{_tag(*case)}/replicated_grads_same_everywhere"])


@pytest.mark.parametrize("case", RUNS, ids=_ids)
def test_sharded_global_norm_counts_each_expert_block_once(run, case):
    """The clipping norm of the step's gradient blocks (the experts'
    ``"expert"`` axis resolves to ``"model"``: their squares are summed over
    it, the replicated leaves' counted once) is the assembled tree's."""
    from repro_torch.launch import mesh as tmesh

    _, port = run()
    tag = _tag(*case)
    np.testing.assert_allclose(port[f"{tag}/global_norm"], port[f"{tag}/global_norm_whole"],
                               rtol=1e-6)
    assert tmesh.resolve_logical(("expert", "fsdp", None), _DpMesh()) == ("model", "data", None)


class _DpMesh:
    mesh_dim_names = ("data", "model")


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_train_step_repeats_bitwise(run, arch):
    _, port = run()
    assert bool(port[f"{_tag(arch, (2, 4))}/again_bitwise"])


def test_moe_train_state_restores_from_2x4_onto_4x2(run):
    _, port = run()
    assert bool(port["elastic/onto_4x2"])


def test_moe_train_state_restores_from_2x4_onto_one_rank(run, tmp_path):
    """The (2, 4) save restored onto a (1, 1) mesh of a world of one is the
    assembled state, bitwise (every expert back in one leaf)."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptState, init_opt_state

    root, port = run()
    model = build_model(get_config("qwen2-moe-a2.7b").reduced(), device="cpu")
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


# ---- the drivers
def _cfg():
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    return dataclasses.replace(cfg, vocab=min(cfg.vocab, 2048))


def _one_torch_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _two_groups_train() -> np.ndarray:
    """``launch.train --dp 2``'s losses on one rank: each step the mean of
    the two data groups' losses and gradients, then the loop's AdamW."""
    from repro_torch._tree import leaves, unflatten_like
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import _grads_of

    cfg = _cfg()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0))
    state = opt.init_opt_state(params)
    opt_cfg = opt.OptConfig(lr=DRIVER_LR, total_steps=max(DRIVER_STEPS, 100))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=DRIVER_SEQ,
                                  global_batch=DRIVER_BATCH))
    losses = []
    for i in range(DRIVER_STEPS):
        tokens = torch.from_numpy(data.batch(i)["tokens"])
        half = DRIVER_BATCH // 2
        parts = [_grads_of(model, params, {"tokens": tokens[g * half:(g + 1) * half]})
                 for g in range(2)]
        grads = [(a + b) / 2 for a, b in zip(leaves(parts[0][2]), leaves(parts[1][2]))]
        params, state, _ = opt.adamw_update(params, unflatten_like(params, grads), state, opt_cfg)
        losses.append(float((parts[0][0] + parts[1][0]) / 2))
    return np.array(losses)


def test_train_driver_on_a_2x4_mesh_matches_its_data_groups_on_one_rank(run):
    _, port = run()
    np.testing.assert_allclose(port["driver/loss"], _one_torch_thread(_two_groups_train), **TOL)


def _two_groups_served():
    """``launch.serve --dp 2``'s tokens on one rank: each batch of
    ``SERVE_BATCH`` prompts padded as the engine pads it, each data group's
    rows generated apart; with each step's top-2 logit gaps."""
    from repro_torch.models import build_model
    from repro_torch.serve import engine

    cfg = _cfg()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 16))) for _ in range(8)]
    real, gaps = engine._select, []

    def select(logits, gen, generator):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).numpy())
        return real(logits, gen, generator)

    engine._select = select
    tokens, all_gaps = [], []
    try:
        for b0 in range(0, len(prompts), SERVE_BATCH):
            chunk = prompts[b0:b0 + SERVE_BATCH]
            s = max(len(p) for p in chunk)
            toks = np.zeros((SERVE_BATCH, s), np.int32)
            for i, p in enumerate(chunk):
                toks[i, s - len(p):] = p
            for g in range(2):
                gaps.clear()
                rows = toks[g * 2:(g + 1) * 2]
                tokens.append(engine.generate(model, model.params,
                                              {"tokens": torch.from_numpy(rows)},
                                              engine.GenerationConfig(max_new_tokens=NEW_TOKENS)))
                all_gaps.append(np.stack(gaps[:NEW_TOKENS], 1))
    finally:
        engine._select = real
    return np.concatenate(tokens), np.concatenate(all_gaps)


def test_serve_driver_on_a_2x4_mesh_gives_its_data_groups_greedy_tokens(run):
    _, port = run()
    got = port["serve/tokens"]
    want, gaps = _one_torch_thread(_two_groups_served)
    assert got.shape == want.shape and bool(port["serve/same_everywhere"])
    compared = 0
    for row in range(want.shape[0]):
        for t in range(want.shape[1]):
            assert got[row, t] == want[row, t] or gaps[row, t] <= GAP_BOUND, (row, t)
            compared += 1
            if gaps[row, t] <= GAP_BOUND:
                break  # past a near tie the continuations may part
    assert compared >= want.size // 2


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
