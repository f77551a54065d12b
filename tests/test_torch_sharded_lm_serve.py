"""The port's sharded LM forward and serving paths, and data parallelism on
the other families, in 8-rank gloo worlds on the CPU.

Each multi-rank case is one subprocess, ``python
tests/test_torch_sharded_lm_serve.py <case> <dir>``: 8 gloo ranks
(``init_method="file://<dir>/store"``, one torch thread each), rank 0
writing ``<dir>/out.npz``.  The inputs are numpy from a seed, written here:
the reference's parameters (``repro.checkpoint.manager._flatten``) and the
tokens, crossing into each rank's blocks through
``repro_torch.interop.params_from_numpy(..., mesh=)``.

* ``tp_forward``: reduced olmo-1b and qwen3-8b (GQA, QK-norm, untied head)
  on the ``("data", "model")`` meshes (4, 2), (2, 4) and (1, 8): the logits
  gathered over ``"model"`` against the reference's unsharded ``forward``
  (fp32 at ``rtol=2e-4, atol=2e-5``, bf16 compute at 2e-3).  Reduced olmo
  has 4 heads and 2 kv heads, so (4, 2) takes the sharded-kv (grouped)
  path, (2, 4) the replicated-kv (expand) path, (1, 8) the query-row layout
  of heads that do not divide ``tp`` (each rank's queries its own sequence
  block).
* ``serve``: ``launch.serve --dp 2 --tp 4`` (and ``--dp 1 --tp 8`` on
  qwen3-8b) against the single-rank engine: the same greedy tokens up to
  and including the first step whose top-2 logit gap on the single rank is
  within ``GAP_BOUND`` (past it the two may choose apart).
* ``families``: one data-parallel step at (8, 1) of reduced qwen2-moe,
  falcon-mamba, recurrentgemma and whisper-base against the reference's
  step on an (8, 1) host mesh (the oracle runs in its own subprocess with 8
  host devices): loss at the fp32 bound, the updated parameters at the
  training bounds of ``tests/test_torch_train.py``, and each rank's MoE
  routing indices equal to the reference's routing of the same block (the
  capacity is per data-parallel block, as in the reference's sharded run).

By hand, one case (the inputs must be in ``<dir>`` first):

    PYTHONPATH=src python tests/test_torch_sharded_lm_serve.py <case> <dir>
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
BF16_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_SPREAD = 2.0  # times the port's single-device bf16 distance from the reference
SIGN_NOISE = 1e-5
CASE_TIMEOUT = 240
TP_MESHES = ((4, 2), (2, 4), (1, 8))
TP_ARCHS = ("olmo-1b", "qwen3-8b")
DTYPES = ("float32", "bfloat16")
SERVE_RUNS = {"olmo-1b": (2, 4), "qwen3-8b": (1, 8)}
SERVE_ARGS = ("--reduced", "--requests", "8", "--new-tokens", "8", "--batch-size", "4")
GAP_BOUND = 1e-4  # 5x the fp32 atol the sharded logits hold against one rank's
FAMILIES = ("qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b", "whisper-base")
FAMILY_LR = 1e-3
FAMILY_BATCH, FAMILY_SEQ = 8, 16


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat(tree) -> dict:
    from repro_torch import _tree

    return _tree.flatten(tree, _np, np.stack)


def _cfg(arch: str, dtype: str = "float32"):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype)


def _tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, 8, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------- the rank side
def _gather_objects(obj) -> list:
    import torch.distributed as dist

    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs


def _case_tp_forward(root: str, out: dict) -> None:
    from repro_torch.dist.collectives import gather_cat
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model, transformer

    for arch in TP_ARCHS:
        flat = dict(np.load(f"{root}/params_{arch}.npz"))
        tokens = torch.from_numpy(np.load(f"{root}/tokens.npz")[arch])
        for dtype in DTYPES:
            model = build_model(_cfg(arch, dtype), device="cpu")
            for shape in TP_MESHES:
                mesh = meshlib.make_host_mesh(*shape, device="cpu")
                blocks = params_from_numpy(model, flat, mesh=mesh)
                with meshlib.use_mesh(mesh), torch.no_grad():
                    h, _, _ = transformer.forward(blocks, model.cfg, tokens)
                    logits = transformer.lm_logits(blocks, model.cfg, h)
                    whole = gather_cat(logits, ("model",), mesh, dim=-1).float().numpy()
                tag = f"{arch}/{dtype}/{shape[0]}x{shape[1]}"
                out[f"{tag}/logits"] = whole
                digests = _gather_objects(whole.tobytes())
                out[f"{tag}/same_everywhere"] = len(set(digests)) == 1


def _case_serve(root: str, out: dict) -> None:
    from repro_torch.launch import serve as serve_driver

    for arch, (dp, tp) in SERVE_RUNS.items():
        res = serve_driver.main(["--arch", arch, *SERVE_ARGS, "--device", "cpu",
                                 "--dp", str(dp), "--tp", str(tp)])
        arr = np.stack([res[k] for k in sorted(res)])
        out[f"{arch}/tokens"] = arr
        out[f"{arch}/same_everywhere"] = len(set(_gather_objects(arr.tobytes()))) == 1


def _case_families(root: str, out: dict) -> None:
    import torch.distributed as dist

    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import train_step as tstep
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    mesh = meshlib.make_host_mesh(WORLD, 1, device="cpu")
    real_update, real_route = tstep.adamw_update, moe_mod.route
    seen, routes = [], []

    def recording(params, grads, state, cfg, **kw):
        seen.append(_flat(grads))
        return real_update(params, grads, state, cfg, **kw)

    def routing(p, cfg, xf, **kw):
        r = real_route(p, cfg, xf, **kw)
        routes.append((xf.detach().numpy().copy(), r.top_idx.numpy().copy()))
        return r

    tstep.adamw_update, moe_mod.route = recording, routing
    rank = dist.get_rank()
    for arch in FAMILIES:
        cfg = _cfg(arch)
        model = build_model(cfg, device="cpu")
        params = params_from_numpy(model, dict(np.load(f"{root}/params_{arch}.npz")), mesh=mesh)
        data = np.load(f"{root}/batch_{arch}.npz")
        n = FAMILY_BATCH // WORLD
        batch = {k: torch.from_numpy(data[k][rank * n:(rank + 1) * n]) for k in data.files}
        seen.clear()
        routes.clear()
        with meshlib.use_mesh(mesh):
            p, _, met = tstep.make_train_step(model, OptConfig(lr=FAMILY_LR, warmup_steps=0))(
                params, init_opt_state(params), batch)
        out[f"{arch}/loss"] = float(met["loss"])
        out.update({f"{arch}/p/{k}": v for k, v in _flat(p).items()})
        out.update({f"{arch}/g/{k}": v for k, v in seen[0].items()})
        for r, recs in enumerate(_gather_objects(routes[:cfg.n_layers])):
            for layer, (xf, idx) in enumerate(recs):
                out[f"{arch}/route/{r}/{layer}/x"], out[f"{arch}/route/{r}/{layer}/idx"] = xf, idx
    tstep.adamw_update, moe_mod.route = real_update, real_route


CASES = {"tp_forward": _case_tp_forward, "serve": _case_serve, "families": _case_families}


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
    """One train step of each family on an (8, 1) host mesh: the batch
    sharded over ``"data"``, the parameters replicated."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.checkpoint.manager import _flatten
    from repro.launch import mesh as meshlib
    from repro.models import build_model
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import make_train_step

    assert jax.device_count() == WORLD, jax.device_count()
    mesh = meshlib.make_host_mesh(WORLD, 1)  # auto axes: the model's constraints apply
    out = {}
    for arch in FAMILIES:
        model = build_model(jconfigs.get_config(arch).reduced())
        template = model.init(jax.random.PRNGKey(0))
        flat = dict(np.load(f"{root}/params_{arch}.npz"))
        leaves, tdef = jax.tree.flatten(template)
        params = tdef.unflatten([jnp.asarray(flat[k]) for k in _flatten(template)])
        data = np.load(f"{root}/batch_{arch}.npz")
        with meshlib.use_mesh(mesh):  # the model's constraints shard the batch over "data"
            batch = {k: jnp.asarray(data[k]) for k in data.files}
            step = jax.jit(make_train_step(model, OptConfig(lr=FAMILY_LR, warmup_steps=0)))
            p, _, met = step(params, init_opt_state(params), batch)
        out[f"{arch}/loss"] = float(met["loss"])
        out.update({f"{arch}/p/{k}": np.asarray(v) for k, v in _flatten(p).items()})
    np.savez(f"{root}/out.npz", **out)


# -------------------------------------------------------- the pytest side
def _reference_params(arch: str, seed: int = 0) -> dict:
    import jax

    import repro.configs as jconfigs
    from repro.checkpoint.manager import _flatten
    from repro.models import build_model as jbuild

    jm = jbuild(jconfigs.get_config(arch).reduced())
    return {k: np.asarray(v) for k, v in _flatten(jm.init(jax.random.PRNGKey(seed))).items()}


def _inputs(case: str, root: Path) -> None:
    if case == "tp_forward":
        toks = {}
        for i, arch in enumerate(TP_ARCHS):
            np.savez(root / f"params_{arch}.npz", **_reference_params(arch, i))
            toks[arch] = _tokens(_cfg(arch).vocab, 2, 16, i)
        np.savez(root / "tokens.npz", **toks)
    if case in ("families", "reference"):
        for i, arch in enumerate(FAMILIES):
            cfg = _cfg(arch)
            np.savez(root / f"params_{arch}.npz", **_reference_params(arch, i))
            batch = {"tokens": _tokens(cfg.vocab, FAMILY_BATCH, FAMILY_SEQ + 1, 10 + i)}
            if cfg.is_encdec:
                batch["frames"] = _frames(cfg, FAMILY_BATCH, 20 + i)
            np.savez(root / f"batch_{arch}.npz", **batch)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``run(case)``: ``(dir, results)`` of the case.  The first call starts
    the reference's process and runs the 8-rank cases beside it, one after
    the other; a failure is kept and raised to every test of the case."""
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


# ---- the tensor-parallel forward
@pytest.fixture(scope="module")
def reference_logits(run):
    """The reference's unsharded logits of the ``tp_forward`` inputs, and
    the port's single-device ones."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.checkpoint.manager import _flatten
    from repro.models import build_model as jbuild
    from repro.models import transformer as jtransformer
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import build_model, transformer

    root, _ = run("tp_forward")
    out = {}
    for arch in TP_ARCHS:
        flat = dict(np.load(root / f"params_{arch}.npz"))
        tokens = np.load(root / "tokens.npz")[arch]
        for dtype in DTYPES:
            cfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), compute_dtype=dtype)
            template = jbuild(cfg).init(jax.random.PRNGKey(0))
            _, tdef = jax.tree.flatten(template)
            params = tdef.unflatten([jnp.asarray(flat[k]) for k in _flatten(template)])
            h, _, _ = jtransformer.forward(params, cfg, jnp.asarray(tokens))
            want = np.asarray(jtransformer.lm_logits(params, cfg, h), np.float32)
            model = build_model(_cfg(arch, dtype), device="cpu")
            params_from_numpy(model, flat)
            with torch.no_grad():
                th, _, _ = transformer.forward(model.params, model.cfg, torch.from_numpy(tokens))
                local = transformer.lm_logits(model.params, model.cfg, th).float().numpy()
            out[(arch, dtype)] = (want, local)
    return out


@pytest.mark.parametrize("mesh", TP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_logits_match_the_references_unsharded_forward(run, reference_logits, arch, dtype,
                                                          mesh):
    """fp32 at the fp32 bound.  bf16 compute: the port's own single-device
    forward is already one or more bf16 roundings from the reference's,
    beyond 2e-3 on both models, so the sharded logits are held within
    ``BF16_TOL`` plus ``BF16_SPREAD`` times that single-device spread,
    entry by entry."""
    _, port = run("tp_forward")
    tag = f"{arch}/{dtype}/{mesh[0]}x{mesh[1]}"
    got = port[f"{tag}/logits"]
    want, local = reference_logits[(arch, dtype)]
    v = _cfg(arch).vocab
    if dtype == "float32":
        np.testing.assert_allclose(got[..., :v], want[..., :v], **TOL)
    else:
        spread = np.abs(local[..., :v] - want[..., :v]).max()
        allow = BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(want[..., :v]) + BF16_SPREAD * spread
        diff = np.abs(got[..., :v] - want[..., :v])
        assert (diff <= allow).all(), (float(diff.max()), float(spread))
    assert (got[..., v:] == -1e9).all()  # the vocab pad, masked in its block
    assert bool(port[f"{tag}/same_everywhere"])


# ---- serving
@pytest.fixture(scope="module")
def one_rank_served():
    """The single-rank engine's tokens and each step's top-2 logit gaps."""
    from repro_torch.launch import serve as serve_driver
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
        for arch in SERVE_RUNS:
            gaps.clear()
            res = serve_driver.main(["--arch", arch, *SERVE_ARGS, "--device", "cpu"])
            # the flush serves batches of 4 rows, each 1 + 8 selections
            per_batch = [np.stack(gaps[i:i + 9], 1) for i in range(0, len(gaps), 9)]
            out[arch] = (np.stack([res[k] for k in sorted(res)]), np.concatenate(per_batch))
    finally:
        engine._select = real
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("arch", list(SERVE_RUNS))
def test_sharded_serve_gives_the_single_rank_greedy_tokens(run, one_rank_served, arch):
    _, port = run("serve")
    got = port[f"{arch}/tokens"]
    want, gaps = one_rank_served[arch]
    assert got.shape == want.shape and bool(port[f"{arch}/same_everywhere"])
    compared = 0
    for row in range(want.shape[0]):
        for t in range(want.shape[1]):
            assert got[row, t] == want[row, t] or gaps[row, t] <= GAP_BOUND, (row, t)
            compared += 1
            if gaps[row, t] <= GAP_BOUND:
                break  # past a near tie the continuations may part
    assert compared >= want.size // 2


# ---- data parallelism on the other families
def _assert_update_close(got: dict, want: dict, grads: dict, lr: float):
    assert set(got) == set(want)
    for k in want:
        g = np.abs(np.asarray(grads[k]))
        allow = TOL["atol"] + TOL["rtol"] * np.abs(want[k]) + np.where(
            g < SIGN_NOISE * g.max(), 2 * lr, 0.0)
        diff = np.abs(np.asarray(got[k], np.float64) - want[k])
        assert not (diff > allow).any(), (k, float(diff.max()))


def _under(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_step_of_each_family_matches_the_references_sharded_step(run, arch):
    _, port = run("families")
    _, ref = run("reference")
    np.testing.assert_allclose(port[f"{arch}/loss"], ref[f"{arch}/loss"], **TOL)
    _assert_update_close(_under(port, f"{arch}/p/"), _under(ref, f"{arch}/p/"),
                         _under(port, f"{arch}/g/"), FAMILY_LR)


def test_moe_routing_per_block_is_the_references(run):
    """Each rank routes its own block (capacity per block); its top-k
    indices are the reference's routing of the same tokens."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.models import moe as jmoe

    root, port = run("families")
    arch = "qwen2-moe-a2.7b"
    cfg = jconfigs.get_config(arch).reduced()
    flat = dict(np.load(root / f"params_{arch}.npz"))
    routers = flat["layers/moe/router"]
    e_pad = jmoe.padded_experts(cfg.n_experts)
    for r in range(WORLD):
        for layer in range(cfg.n_layers):
            xf = jnp.asarray(port[f"{arch}/route/{r}/{layer}/x"])
            t = xf.shape[0]
            assert t == FAMILY_BATCH // WORLD * FAMILY_SEQ  # this rank's block only
            logits = (xf @ jnp.asarray(routers[layer])).astype(jnp.float32)
            logits = jnp.where((jnp.arange(e_pad) < cfg.n_experts)[None], logits, -jnp.inf)
            _, top_idx = jax.lax.top_k(logits, cfg.n_experts_per_tok)
            np.testing.assert_array_equal(port[f"{arch}/route/{r}/{layer}/idx"],
                                          np.asarray(top_idx))


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    if case_ == "reference":
        _reference(root_)
    else:
        torch.multiprocessing.spawn(_rank_main, args=(case_, root_), nprocs=WORLD)
