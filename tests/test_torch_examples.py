"""The port's examples (``examples/repro_torch/``) against the reference's
(``examples/``), on the CPU.

Both packages' examples are loaded by path with ``importlib`` and are not
edited.  The same numpy inputs go to the reference's functions and to the
port's, and the results hold at the port's fp32 bound ``rtol=2e-4,
atol=2e-5`` where the two compute the same thing:

- ``fmri_cpals.run`` with the same numpy ``init_factors`` (the
  reference's ``run`` through ``repro.core.cp_als`` with that init), for
  ``auto`` and ``baseline``, on a 4-way tensor and its linearized 3-way
  form; ``synth_fmri``'s regions symmetric before the noise;
- quickstart's fused MTTKRP against the reference's ``ops.fused_mttkrp``
  in interpret mode, and the whole quickstart on the CPU; the fused and
  matrix-free entries on a strided tensor (``cp_full``'s output);
- ``distributed_cpals`` in 8 gloo ranks (one subprocess, ``file://``
  store) against the reference's ``dist_cp_als`` on 8 host devices (its own
  subprocess) from the same numpy tensor and init;
- ``serve_lm``'s greedy tokens against the reference example's own engine
  run at temperature 0, with its weights carried by
  ``interop.params_from_numpy``;
- ``train_lm``'s config and parameter count against the reference
  example's (``_defs_count``), and a short run whose checkpoint restores in
  the reference's ``CheckpointManager``.

By hand, one multi-process case (inputs first, as the fixture writes them):

    PYTHONPATH=src python tests/test_torch_examples.py distributed <dir>

This file imports no jax at module level: ``torch.multiprocessing.spawn``
re-imports it in each rank.
"""

import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
WORLD = 8
CASE_TIMEOUT = 120  # seconds a case subprocess may take
DIST_SHAPE, DIST_RANK = (64, 48, 40), 6  # examples/distributed_cpals.py's problem
FMRI_SMALL = dict(t=12, subjects=5, regions=8, rank=3)
FMRI_ITERS = 15  # the reference example's default


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name: str):
    """The port's example ``name``, loaded by path."""
    return _load(f"examples/repro_torch/{name}.py", f"port_example_{name}")


def reference(name: str):
    """The reference's example ``name``, loaded by path (imports jax)."""
    return _load(f"examples/{name}.py", f"reference_example_{name}")


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **TOL)


# ------------------------------------------------------------- fmri_cpals
@pytest.fixture(scope="module")
def fmri():
    """The port's small synthetic tensor (numpy) and the loaded examples."""
    ex = port("fmri_cpals")
    x4 = ex.synth_fmri(**FMRI_SMALL, seed=0, device="cpu").numpy()
    return ex, reference("fmri_cpals"), x4


def test_synth_fmri_regions_are_symmetric_before_the_noise(fmri):
    ex, _, x4 = fmri
    clean = ex.synth_fmri(**FMRI_SMALL, seed=0, device="cpu", noise=0)
    assert tuple(clean.shape) == (12, 5, 8, 8) and clean.dtype == torch.float32
    torch.testing.assert_close(clean, clean.transpose(-1, -2), rtol=1e-6, atol=0)
    assert float(clean.abs().max()) == 1.0
    assert not np.allclose(x4, np.swapaxes(x4, -1, -2))  # the noise is not symmetric


def test_linearize_matches_the_reference_triangle(fmri):
    import jax.numpy as jnp

    ex, _, x4 = fmri
    iu = jnp.triu_indices(x4.shape[-1])  # the reference example's own indices
    want = x4[:, :, np.asarray(iu[0]), np.asarray(iu[1])]
    got = ex.linearize(torch.from_numpy(x4))
    assert tuple(got.shape) == (12, 5, 36)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["auto", "baseline"])
@pytest.mark.parametrize("order", [4, 3])
def test_fmri_run_matches_the_reference(fmri, monkeypatch, order, method):
    import jax.numpy as jnp

    from repro.core import cp_als as ref_cp_als

    ex, ref, x4 = fmri
    x = x4 if order == 4 else ex.linearize(torch.from_numpy(x4)).numpy()
    rank = FMRI_SMALL["rank"]
    rng = np.random.default_rng(order)
    init = [_normal(rng, (d, rank)) for d in x.shape]
    st, per_iter = ex.run(torch.from_numpy(x), rank, "port", method, FMRI_ITERS,
                          init_factors=[torch.from_numpy(u) for u in init])
    # the reference example's run, its cp_als given the same init
    monkeypatch.setattr(ref, "cp_als", functools.partial(
        ref_cp_als, init_factors=[jnp.asarray(u) for u in init]))
    jst, _ = ref.run(jnp.asarray(x), rank, "reference", method, FMRI_ITERS)
    assert per_iter > 0 and st.it == jst.it
    _close(float(st.fit), float(jst.fit), "fit")
    _close(st.weights, jst.weights, "weights")
    for k, (u, ju) in enumerate(zip(st.factors, jst.factors)):
        _close(u, ju, f"factor {k}")


def test_fmri_main_runs_on_the_cpu(fmri, capsys):
    ex, _, _ = fmri
    out = ex.main(["--device", "cpu", "--time", "12", "--subjects", "5", "--regions", "8",
                   "--rank", "3"])
    text = capsys.readouterr().out
    assert "4D speedup over baseline" in text and "3D speedup over baseline" in text
    for st, t_auto, stb, t_base in out.values():
        assert np.isfinite(float(st.fit)) and t_auto > 0 and t_base > 0
        assert abs(float(st.fit) - float(stb.fit)) < 1e-3  # the same init, two method mixes


# ------------------------------------------------------------- quickstart
def test_quickstart_main_on_the_cpu():
    ex = port("quickstart")
    state, err, launches = ex.main(["--device", "cpu"])
    assert float(state.fit) > ex.FIT_BOUND and err < ex.ERR_BOUND
    assert launches == 0  # a CPU tensor takes the plain version


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_quickstart_fused_mttkrp_matches_the_reference_kernel(n):
    import jax.numpy as jnp

    from repro.kernels import ops as ref_ops

    rng = np.random.default_rng(10 + n)
    x = _normal(rng, (12, 10, 8, 6))
    fs = [_normal(rng, (d, 4)) for d in x.shape]
    got, err = port("quickstart").fused_check(torch.from_numpy(x),
                                             [torch.from_numpy(u) for u in fs], n)
    want = ref_ops.fused_mttkrp(jnp.asarray(x), [jnp.asarray(u) for u in fs], n,
                                interpret=True)
    _close(got, want)
    assert err < 1e-4


def _strided_entries():
    from repro_torch.core import mttkrp
    from repro_torch.kernels import ops

    def batched(fn):
        return lambda x, fs, n: fn(torch.stack([x, 2 * x]), [torch.stack([u, u]) for u in fs], n)

    return {
        "fused_mttkrp": ops.fused_mttkrp,
        "fused_mttkrp_batched": batched(ops.fused_mttkrp_batched),
        "matrix_free_mttkrp": ops.matrix_free_mttkrp,
        "matrix_free_mttkrp_batched": batched(ops.matrix_free_mttkrp_batched),
        "mttkrp_fused": functools.partial(mttkrp, method="fused"),
        "mttkrp_2step_kernel": ops.mttkrp_2step_kernel,
        "mttkrp_1step": functools.partial(mttkrp, method="1step"),
        "mttkrp_2step": functools.partial(mttkrp, method="2step"),
    }


@pytest.mark.parametrize("entry", sorted(_strided_entries()))
def test_kernel_entries_take_a_strided_tensor(entry):
    """The quickstart's tensor is ``cp_full``'s output plus noise.  The
    ``einsum`` inside ``cp_full`` returns a strided tensor, which the
    entries' free views refuse; ``cp_full`` makes it row-major, as the
    reference's array is, so every MTTKRP entry takes it with no copy of
    its own and gives the oracle's values."""
    from repro_torch.core import cp_full, mttkrp_einsum, random_factors

    fn = _strided_entries()[entry]
    gen = torch.Generator().manual_seed(3)
    fs = random_factors(gen, (6, 5, 4, 3), 2, device="cpu")
    x = cp_full(None, fs) + 0.1 * torch.randn((6, 5, 4, 3), generator=gen)
    assert x.is_contiguous()
    dense = np.einsum("ic,jc,kc,lc->ijkl", *[u.numpy() for u in fs])
    _close(cp_full(None, fs), dense)
    for n in range(4):
        got = fn(x, fs, n)
        want = mttkrp_einsum(x, fs, n)
        torch.testing.assert_close(got[0] if got.ndim == 3 else got, want, **TOL)


@pytest.mark.parametrize("method", ["auto", "baseline", "1step", "2step", "fused",
                                    "matrix_free", "dimtree"])
def test_cp_als_copies_a_strided_tensor_once(method):
    """A permuted view reaches the CP-ALS driver, which copies it once into
    the row-major layout: the run is bitwise the run on the copy."""
    from repro_torch.core import CPConfig, cp_als, random_factors

    gen = torch.Generator().manual_seed(4)
    x = torch.randn((5, 6, 4, 3), generator=gen).permute(1, 0, 2, 3)
    assert not x.is_contiguous()
    init = random_factors(gen, tuple(x.shape), 2, device="cpu")
    cfg = CPConfig(rank=2, n_iters=3, method=method)
    got, want = cp_als(x, cfg, init_factors=init), cp_als(x.contiguous(), cfg, init_factors=init)
    assert torch.equal(got.fit, want.fit)
    assert all(torch.equal(u, v) for u, v in zip(got.factors, want.factors))


# ------------------------------------------------------ distributed_cpals
def _dist_inputs() -> dict:
    """The example's planted (64, 48, 40) rank-6 tensor and an init, from a seed."""
    rng = np.random.default_rng(0)
    planted = [_normal(rng, (d, DIST_RANK)) for d in DIST_SHAPE]
    x = np.einsum("ic,jc,kc->ijk", *planted).astype(np.float32)
    return {"x": x, **{f"f{k}": _normal(rng, (d, DIST_RANK)) for k, d in enumerate(DIST_SHAPE)}}


def _rank_main(rank: int, root: str) -> None:
    """One of 8 gloo ranks: the port's example on the 2 x 4 mesh."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                            world_size=WORLD)
    try:
        data = np.load(f"{root}/inputs.npz")
        fit, local = port("distributed_cpals").main(
            ["--device", "cpu"], x=torch.from_numpy(data["x"]),
            init_factors=[torch.from_numpy(data[f"f{k}"]) for k in range(3)])
        if rank == 0:
            np.savez(f"{root}/out.npz", fit=fit, local=local)
    finally:
        dist.destroy_process_group()


def _reference_main(root: str) -> None:
    """The reference's ``dist_cp_als`` on 8 host devices, as its example
    calls it.  The example's own ``jax.make_mesh`` mesh has explicit axes
    under jax 0.9.0, on which the reference's sweep raises, so the oracle
    runs on the reference's ``make_host_mesh(2, 4)``."""
    import jax.numpy as jnp

    from repro.dist.dist_mttkrp import dist_cp_als
    from repro.launch.mesh import make_host_mesh

    data = np.load(f"{root}/inputs.npz")
    _, _, fit = dist_cp_als(jnp.asarray(data["x"]), rank=DIST_RANK,
                            mode_axes={0: "data", 1: "model"}, mesh=make_host_mesh(2, 4),
                            n_iters=60, init_factors=[jnp.asarray(data[f"f{k}"])
                                                      for k in range(3)])
    np.savez(f"{root}/reference.npz", fit=float(fit))


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """Both processes, started together; a failed or overdue one is killed
    with its process group (the case and the ranks it spawned)."""
    root = tmp_path_factory.mktemp("distributed")
    np.savez(root / "inputs.npz", **_dist_inputs())
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {
        case: subprocess.Popen([sys.executable, __file__, case, str(root)], cwd=ROOT,
                               env=dict(env, **extra), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, process_group=0)
        for case, extra in (
            ("distributed", {}),
            ("reference", {"JAX_PLATFORMS": "cpu",
                           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}))
    }
    errors = {}
    for case, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=CASE_TIMEOUT)
        except subprocess.TimeoutExpired:
            out, err = "", f"ran over {CASE_TIMEOUT} s"
        if proc.returncode != 0:
            try:
                os.killpg(proc.pid, 9)
            except ProcessLookupError:
                pass
            proc.communicate()
            errors[case] = err[-4000:]
        procs[case] = out
    if errors:
        raise AssertionError(f"cases failed: {errors}")
    return dict(np.load(root / "out.npz")), dict(np.load(root / "reference.npz")), procs


def test_distributed_cpals_matches_the_reference_dist_cp_als(dist_runs):
    port_out, ref_out, logs = dist_runs
    assert "planner picked executor: overlapping" in logs["distributed"]
    assert "OK: distributed result matches" in logs["distributed"]
    _close(float(port_out["fit"]), float(ref_out["fit"]), "dist fit")
    assert abs(float(port_out["fit"]) - float(port_out["local"])) < 1e-2


# ---------------------------------------------------------------- serve_lm
def test_serve_lm_greedy_matches_the_reference_engine(monkeypatch):
    from repro.checkpoint.manager import _flatten

    ref = reference("serve_lm")
    captured = {}

    class Recording(ref.ServeEngine):
        def flush(self):
            out = super().flush()
            captured.update(results=out, params=self.params)
            return out

    monkeypatch.setattr(ref, "ServeEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", "--temperature", "0"])
    ref.main()
    want = captured["results"]
    weights = {k: np.asarray(v) for k, v in _flatten(captured["params"]).items()}
    got = port("serve_lm").main(["--device", "cpu", "--temperature", "0"], weights=weights)
    assert sorted(got) == sorted(want) and len(got) == 6
    for rid in want:
        assert np.array_equal(got[rid], np.asarray(want[rid])), rid


# ---------------------------------------------------------------- train_lm
def _reference_train_model(monkeypatch, argv):
    """The model the reference example builds for ``argv`` (its
    ``train_loop`` replaced by a recorder: nothing is trained)."""
    ref = reference("train_lm")
    captured = {}

    def record(model, data, opt_cfg, loop_cfg):
        captured["model"] = model
        return types.SimpleNamespace(metrics_history=[{"loss": 0.0}], step=0, failures=0)

    monkeypatch.setattr(ref, "train_loop", record)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    ref.main()
    return captured["model"]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_train_lm_config_and_param_count_match_the_reference(monkeypatch, arch):
    from repro.analysis.flops import _defs_count

    from repro_torch.analysis.flops import param_count

    jm = _reference_train_model(monkeypatch, ["--arch", arch])
    cfg = port("train_lm").make_config(arch)  # the example's defaults
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jm.cfg)
    assert param_count(cfg) == _defs_count(jm.param_defs)


def test_train_lm_checkpoint_restores_in_the_reference(monkeypatch, tmp_path):
    import jax

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.checkpoint.manager import _flatten
    from repro.train.optimizer import init_opt_state as jinit_opt

    from repro_torch import _tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_opt_state

    argv = ["--arch", "olmo-1b", "--steps", "2", "--batch", "2", "--seq", "16",
            "--width", "64", "--layers", "2", "--vocab", "256",
            "--ckpt-dir", str(tmp_path)]
    ex = port("train_lm")
    result = ex.main(["--device", "cpu", *argv])
    assert result.step == 2 and np.isfinite(result.metrics_history[-1]["loss"])
    jm = _reference_train_model(monkeypatch, argv[:-2])
    jp = jm.init(jax.random.PRNGKey(0))
    (rp, _), manifest = JManager(str(tmp_path)).restore((jp, jinit_opt(jp)))
    assert manifest["step"] == 2
    tm = build_model(ex.make_config("olmo-1b", 64, 2, 256), device="cpu")
    (tp, _), _ = CheckpointManager(str(tmp_path)).restore((tm.params, init_opt_state(tm.params)))
    want = _tree.flatten(tp, lambda t: t.numpy(), np.stack)
    got = {k: np.asarray(v) for k, v in _flatten(rp).items()}
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


if __name__ == "__main__":
    case_, root_ = sys.argv[1], sys.argv[2]
    if case_ == "reference":
        _reference_main(root_)
    else:
        torch.multiprocessing.spawn(_rank_main, args=(root_,), nprocs=WORLD)
