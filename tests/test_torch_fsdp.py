"""FSDP/ZeRO-3 placement in 8-rank gloo worlds.

One subprocess, ``python tests/test_torch_fsdp.py fsdp <dir>``, spawns 8
gloo ranks (``init_method="file://<dir>/store"``, one torch thread each)
and rank 0 writes ``<dir>/out.npz``.  The reference's initial parameters
and tokens are made here (numpy from a seed, jax) and cross through
``repro_torch.interop``; the reference's oracles run in this process,
jitted, while the ranks run.

* FSDP: ``make_train_step(fsdp=True)`` on the blocks of
  ``Model.partition_specs(mesh)`` at (4, 2) and (8, 1) ``("data",
  "model")`` and (2, 2, 2) ``("pod", "data", "model")``, for reduced
  olmo-1b, qwen2-moe-a2.7b (``("expert", "fsdp", None)`` leaves) and
  falcon-mamba-7b (``in_proj``'s parts cut beside ``"fsdp"``): one step at
  ``accum_steps`` 1 and 2 beside the ``drop_fsdp`` step on the same mesh.
  At ``accum_steps=1`` parameters and AdamW state are bitwise the
  ``drop_fsdp`` step's cut to the FSDP blocks; both accumulations hold the
  reference's step at the training bounds (``tests/test_torch_sharded_lm.py``).
  The reference's oracle is its gradient averaged over the data ranks'
  micro-batches (the MoE's capacity counts a block's tokens), then its
  AdamW update.  ``dist.collectives.FSDP`` counts the gathers and the bytes
  of gathered leaves alive at once.
* The remat recompute on another thread (as a CUDA backward runs it)
  keeps the ambient mesh.

The split-K decode is ``tests/test_torch_split_decode.py``.

By hand (inputs first, as the fixture writes them): ``PYTHONPATH=src python
tests/test_torch_fsdp.py fsdp <dir>``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
CASE_TIMEOUT = 300
TOL = dict(rtol=2e-4, atol=2e-5)
SIGN_NOISE = 1e-5
LR = 1e-3
BATCH, SEQ = 16, 16
FSDP_ARCHS = ("olmo-1b", "qwen2-moe-a2.7b", "falcon-mamba-7b")
MESHES = {"4x2": ((4, 2), ("data", "model")), "8x1": ((8, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ACCUMS = (1, 2)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree) -> dict:
    from repro_torch import _tree

    return _tree.flatten(tree, _np, np.stack)


# ---------------------------------------------------------- the rank side
def _gather_objects(obj) -> list:
    import torch.distributed as dist

    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs


def _all(flag: bool) -> bool:
    return all(_gather_objects(bool(flag)))


def _layer_bytes(model, mesh) -> tuple[list, int, int, int]:
    """The bytes each layer's FSDP leaves take gathered (their
    ``drop_fsdp`` blocks, fp32) and the head's; the number of FSDP leaves
    in the layers and in the head."""
    from repro_torch import _tree
    from repro_torch.launch import mesh as meshlib

    full, drop = model.partition_specs(mesh), model.partition_specs(mesh, drop_fsdp=True)
    dp = meshlib.dp_spec_entry(mesh)

    def size(defs, fs, ds):
        n = k = 0
        for d, f, s in zip(_tree.leaves(defs), _tree.specs_of(defs, fs), _tree.specs_of(defs, ds)):
            if dp in tuple(f):
                n += 4 * int(np.prod(meshlib.NamedSharding.of(mesh, s).block_shape(d.shape)))
                k += 1
        return n, k

    per = [size(d, f, s) for d, f, s in zip(model.param_defs["layers"], full["layers"],
                                             drop["layers"])]
    head, n_head = size({"h": model.param_defs["head"]}, {"h": full["head"]},
                        {"h": drop["head"]}) if "head" in model.param_defs else (0, 0)
    return [b for b, _ in per], head, sum(k for _, k in per), n_head


def _case_fsdp(root: str, out: dict) -> None:
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    real_update = tstep.adamw_update
    seen = []

    def recording(params, grads, state, cfg, **kw):
        seen.append(grads)
        return real_update(params, grads, state, cfg, **kw)

    tstep.adamw_update = recording
    tokens = dict(np.load(f"{root}/tokens.npz"))
    opt = OptConfig(lr=LR, warmup_steps=0)
    for arch in FSDP_ARCHS:
        model = build_model(get_config(arch).reduced(), device="cpu")
        params_from_numpy(model, dict(np.load(f"{root}/params_{arch}.npz")))
        for name, (shape, axes) in MESHES.items():
            mesh = meshlib._mesh(shape, axes, "cpu")
            n, i = meshlib.dp_coord(mesh)
            batch = {"tokens": torch.from_numpy(tokens[arch][i * BATCH // n:(i + 1) * BATCH // n])}
            full = model.partition_specs(mesh)
            drop = model.partition_specs(mesh, drop_fsdp=True)
            layers, head, n_layer_leaves, n_head_leaves = _layer_bytes(model, mesh)
            for accum in ACCUMS:
                tag = f"{arch}/{name}/{accum}"
                pd = meshlib.shard_tree(model.params, drop, mesh)
                pf = meshlib.shard_tree(model.params, full, mesh)
                with meshlib.use_mesh(mesh):
                    a, sa, ma = tstep.make_train_step(model, opt, accum_steps=accum)(
                        pd, init_opt_state(pd), batch)
                    coll.FSDP.calls = coll.FSDP.peak = coll.FSDP.live = 0
                    b, sb, mb = tstep.make_train_step(model, opt, accum_steps=accum, fsdp=True)(
                        pf, init_opt_state(pf), batch)
                    calls, peak = coll.FSDP.calls, coll.FSDP.peak
                grads = seen[-1]

                def cut(x, f, s):
                    return meshlib.NamedSharding.of(mesh, f).cut(
                        meshlib.NamedSharding.of(mesh, s).assemble(x.detach()))

                same = {}
                for part, ta, tb in (("params", a, b), ("m", sa.m, sb.m), ("v", sa.v, sb.v)):
                    same[part] = all([  # every rank assembles every leaf
                        torch.equal(cut(xa, f, s), xb.detach()) for xa, xb, f, s in zip(
                            _tree.leaves(ta), _tree.leaves(tb), _tree.specs_of(ta, full),
                            _tree.specs_of(ta, drop))])
                for part, ok in same.items():
                    out[f"{tag}/bitwise_{part}"] = _all(ok)
                out[f"{tag}/bitwise_grad_norm"] = _all(bool(
                    torch.equal(ma["grad_norm"], mb["grad_norm"])))
                whole = meshlib.assemble_tree(b, full, mesh)
                whole_g = meshlib.assemble_tree(grads, full, mesh)
                whole_drop = meshlib.assemble_tree(a, drop, mesh)
                for k, v in _flat(whole).items():
                    out[f"{tag}/p/{k}"] = v
                for k, v in _flat(whole_g).items():
                    out[f"{tag}/g/{k}"] = v
                for k, v in _flat(whole_drop).items():
                    out[f"{tag}/drop/{k}"] = v
                out[f"{tag}/loss"] = _np(mb["loss"])
                out[f"{tag}/fsdp_calls"] = np.array(calls)
                out[f"{tag}/fsdp_peak"] = np.array(peak)
                out[f"{tag}/layer_bytes"] = np.array(layers)
                out[f"{tag}/head_bytes"] = np.array(head)
                out[f"{tag}/fsdp_leaves"] = np.array([n_layer_leaves, n_head_leaves])
    tstep.adamw_update = real_update


def _rank_main(rank: int, case: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    try:
        out = {}
        _case_fsdp(root, out)
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
    """The reference's initial parameters of each architecture and the
    tokens, written for the ranks."""
    import jax
    from repro.checkpoint.manager import _flatten

    rng = np.random.default_rng(0)
    tokens = {}
    for i, arch in enumerate(FSDP_ARCHS):
        jm = _reference_model(arch)
        np.savez(root / f"params_{arch}.npz",
                 **{k: np.asarray(v) for k, v in _flatten(jm.init(jax.random.PRNGKey(i))).items()})
        tokens[arch] = rng.integers(0, jm.cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    np.savez(root / "tokens.npz", **tokens)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``get()`` -> the 8-rank case's results; started here, awaited on
    first use, so the reference's oracles run beside it."""
    root = tmp_path_factory.mktemp("fsdp")
    _inputs(root)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, __file__, "fsdp", str(root)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            process_group=0)
    done = {}

    def get():
        if "result" not in done:
            try:
                _, err = proc.communicate(timeout=CASE_TIMEOUT)
                if proc.returncode != 0:
                    done["result"] = AssertionError(f"case fsdp failed:\n{err[-4000:]}")
                else:
                    done["result"] = dict(np.load(root / "out.npz"))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)  # the case and the ranks it spawned
                proc.communicate()
                done["result"] = AssertionError(f"case fsdp ran over {CASE_TIMEOUT} s")
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
    """The reference's step for each (arch, data size, accumulation): its
    gradient averaged over the data ranks' micro-batches, then AdamW."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten
    from repro.train.optimizer import OptConfig, adamw_update, init_opt_state

    out = {}
    tokens = dict(np.load(run.root / "tokens.npz"))
    for arch in FSDP_ARCHS:
        jm = _reference_model(arch)
        template = jm.init(jax.random.PRNGKey(0))
        flat = dict(np.load(run.root / f"params_{arch}.npz"))
        _, tdef = jax.tree.flatten(template)
        params = tdef.unflatten([jnp.asarray(flat[k]) for k in _flatten(template)])
        grad = jax.jit(jax.value_and_grad(lambda p, t: jm.loss_fn(p, {"tokens": t})[0]))
        update = jax.jit(lambda p, g: adamw_update(p, g, init_opt_state(p),
                                                   OptConfig(lr=LR, warmup_steps=0))[0])
        for name, (shape, _) in MESHES.items():
            dp = int(np.prod(shape[:-1]))
            for accum in ACCUMS:
                rows = BATCH // dp // accum
                total, losses = None, []
                for j in range(BATCH // rows):
                    loss, g = grad(params, jnp.asarray(tokens[arch][j * rows:(j + 1) * rows]))
                    losses.append(float(loss))
                    total = g if total is None else jax.tree.map(jnp.add, total, g)
                g = jax.tree.map(lambda x: x / (BATCH // rows), total)
                out[f"{arch}/{name}/{accum}"] = dict(
                    loss=float(np.mean(losses)),
                    params={k: np.asarray(v) for k, v in _flatten(update(params, g)).items()})
    return out


def _under(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


FSDP_RUNS = [(a, m, acc) for a in FSDP_ARCHS for m in MESHES for acc in ACCUMS]


def _id(case) -> str:
    return "/".join(map(str, case))


@pytest.mark.parametrize("arch", FSDP_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("part", ["params", "m", "v", "grad_norm"])
def test_fsdp_step_is_bitwise_the_drop_fsdp_step(run, arch, mesh, part):
    """Parameters, AdamW state and the global norm at ``accum_steps=1``:
    the FSDP blocks equal the ``drop_fsdp`` step's cut to them, bit for bit."""
    assert bool(run()[f"{arch}/{mesh}/1/bitwise_{part}"])


@pytest.mark.parametrize("arch", FSDP_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_step_with_accumulation_holds_the_drop_fsdp_step(run, arch, mesh):
    """``accum_steps=2`` adds the micro-batches' reduce-scattered gradients
    where the ``drop_fsdp`` step adds whole ones, then reduces: the same
    sums in another order, at the fp32 bound."""
    port = run()
    tag = f"{arch}/{mesh}/2"
    got, want = _under(port, f"{tag}/p/"), _under(port, f"{tag}/drop/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("case", FSDP_RUNS, ids=_id)
def test_fsdp_step_holds_the_references_step(run, reference, case):
    port = run()
    tag = _id(case)
    ref = reference[tag]
    np.testing.assert_allclose(port[f"{tag}/loss"], ref["loss"], **TOL)
    got, grads = _under(port, f"{tag}/p/"), _under(port, f"{tag}/g/")
    assert set(got) == set(ref["params"])
    for k, want in ref["params"].items():
        g = np.abs(grads[k])
        allow = TOL["atol"] + TOL["rtol"] * np.abs(want) + np.where(
            g < SIGN_NOISE * g.max(), 2 * LR, 0.0)
        diff = np.abs(np.asarray(got[k], np.float64) - want)
        assert not (diff > allow).any(), (k, float(diff.max()))


@pytest.mark.parametrize("case", FSDP_RUNS, ids=_id)
def test_fsdp_gathers_about_one_layer_at_a_time(run, case):
    """Under remat the gathered leaves alive at once are at most one
    layer's and the head's, never the whole tree.  A micro-batch gathers a
    layer's leaf in the forward and again in the recompute, and
    reduce-scatters it in the backward; the head, outside remat, once
    each way."""
    port = run()
    tag = _id(case)
    layers, head = port[f"{tag}/layer_bytes"], int(port[f"{tag}/head_bytes"])
    peak = int(port[f"{tag}/fsdp_peak"])
    assert 0 < peak <= int(layers.max()) + head
    assert peak < int(layers.sum()) + head
    n_layer, n_head = port[f"{tag}/fsdp_leaves"]
    assert int(port[f"{tag}/fsdp_calls"]) == case[2] * (3 * n_layer + 2 * n_head)


def test_fsdp_needs_a_mesh():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    model = build_model(get_config("olmo-1b").reduced(), device="cpu")
    step = make_train_step(model, OptConfig(), fsdp=True)
    with pytest.raises(ValueError, match="runs on a mesh"):
        step(model.params, init_opt_state(model.params),
             {"tokens": torch.zeros((2, 9), dtype=torch.int32)})


def test_fsdp_block_is_cast_before_its_gather():
    """The mixed-precision entry cast of an FSDP leaf only records its
    dtype; the gather casts the block, so the whole bf16 tensor is the cast
    of the whole fp32 one."""
    from repro_torch.dist.collectives import FsdpBlock

    b = FsdpBlock(torch.ones(2, 3), 0, mesh=None)
    c = b.to(torch.bfloat16)
    assert c.t is b.t and c.dtype == torch.bfloat16 and c.dim == 0 and b.dtype == torch.float32
    assert c.is_floating_point()


def test_remat_recompute_keeps_the_mesh_on_another_thread(tmp_path):
    """The autograd engine runs a CUDA tensor's backward, and so a remat's
    recompute, on a thread of its own, where the ambient mesh (a context
    variable) is unset.  Here the backward runs on another thread: the
    recompute still takes the mesh's path (its collectives counted as on
    the forward's thread) and the gradients are bitwise the same."""
    import threading

    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model

    model = build_model(get_config("olmo-1b").reduced(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, 256, (2, 17), generator=torch.Generator().manual_seed(1))}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = meshlib.make_host_mesh(1, 1, device="cpu")
        runs = {}
        for where in ("same", "other"):
            leaves = [p.detach().requires_grad_() for p in _tree.leaves(model.params)]
            out = {}

            def backward():
                out["g"] = torch.autograd.grad(loss, leaves)

            with meshlib.use_mesh(mesh):  # as the train step runs forward and backward
                loss, _ = model.loss_fn(_tree.unflatten_like(model.params, leaves), batch)
                coll.TP.calls = 0
                if where == "same":
                    backward()
                else:
                    t = threading.Thread(target=backward)
                    t.start()
                    t.join()
            runs[where] = (coll.TP.calls, out["g"])
    finally:
        dist.destroy_process_group()
    assert runs["other"][0] == runs["same"][0] > 0
    assert all(torch.equal(a, b) for a, b in zip(runs["other"][1], runs["same"][1]))


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
