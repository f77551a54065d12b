"""The port's checkpoint manager against the reference's, on the CPU.

Counterparts of the reference's seven ``tests/test_checkpoint.py`` cases,
then interchange: both packages write ``step_<n>/arrays.npz`` +
``manifest.json`` under the same leaf paths, so a reference checkpoint of a
reduced olmo-1b ``(params, init_opt_state(params))`` restores in the port
bitwise and the reverse, with equal manifests (keys, shapes, dtypes), and
the port's serving driver restores a checkpoint the reference wrote.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten as jflatten
from repro.models import build_model as jbuild
from repro.train.optimizer import init_opt_state as jinit_opt
from repro_torch import _tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptState, init_opt_state


def _tree_of(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "layers": [
            {"w": torch.randn(8, 4, generator=g), "b": torch.zeros(4)},
            {"w": torch.randn(4, 8, generator=g), "b": torch.ones(8)},
        ],
        "step_scalar": torch.tensor(3, dtype=torch.int32),
    }


def _zeros_like(tree):
    return _tree.tree_map(torch.zeros_like, tree)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree_of()
    mgr.save(10, tree)
    restored, manifest = mgr.restore(_zeros_like(tree))
    assert manifest["step"] == 10
    for a, b in zip(_tree.leaves(tree), _tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree_of()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree_of(1)
    mgr.save_async(7, tree)
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore(_zeros_like(tree))
    assert torch.equal(restored["layers"][0]["w"], tree["layers"][0]["w"])


def test_tmp_dirs_are_not_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(1)})


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(3, 3)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros(2, 2)})


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo process group in this process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield tmesh.make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_elastic_restore_new_mesh(tmp_path, world_of_one):
    """Save, then restore re-placed onto a (1, 1) DeviceMesh: each leaf on
    the mesh's device, its spec checked against the mesh's axes; onto a
    mesh of two ranks each rank cuts its block."""
    mesh = world_of_one
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = {"w": torch.arange(16.0).reshape(8, 2), "b": torch.ones(8)}
    mgr.save(5, tree)
    specs = {"w": ("data", None), "b": ()}
    restored, _ = mgr.restore(_zeros_like(tree), mesh=mesh, specs=specs)
    assert torch.equal(restored["w"], tree["w"])
    assert restored["w"].device.type == mesh.device_type
    with pytest.raises(ValueError, match="not an axis"):
        mgr.restore(_zeros_like(tree), mesh=mesh, specs={"w": ("pod", None), "b": ()})
    with pytest.raises(ValueError, match="more entries"):
        mgr.restore(_zeros_like(tree), mesh=mesh, specs={"w": ("data", None, None), "b": ()})

    class Wider:  # rank 1 of a (1, 2) mesh, as a DeviceMesh reports it
        device_type, mesh_dim_names = "cpu", ("data", "model")

        def size(self, dim=None):
            return 2 if dim is None else (1, 2)[dim]

        def get_coordinate(self):
            return [0, 1]

    blocks, _ = mgr.restore(_zeros_like(tree), mesh=Wider(),
                            specs={"w": (None, "model"), "b": ("model",)})
    assert torch.equal(blocks["w"], tree["w"][:, 1:]) and torch.equal(blocks["b"], tree["b"][4:])


def test_manifest_contents(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.arange(10, dtype=torch.float32).reshape(2, 5).bfloat16()
    path = mgr.save(3, {"x": x}, extra={"arch": "t"})
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["arch"] == "t"
    assert m["shapes"]["x"] == [2, 5]
    assert m["dtypes"]["x"] == "bfloat16"
    restored, _ = mgr.restore({"x": torch.zeros(2, 5, dtype=torch.bfloat16)})
    assert restored["x"].dtype == torch.bfloat16 and torch.equal(restored["x"], x)


def test_bfloat16_leaves_interchange_with_the_reference(tmp_path):
    """The reference stores a bf16 leaf as its raw 2-byte words (``<V2``);
    the port writes the same bytes and reads either package's."""
    vals = np.arange(-6, 4, dtype=np.float32).reshape(2, 5) / 3
    JManager(str(tmp_path / "j")).save(1, {"x": jnp.asarray(vals, jnp.bfloat16)})
    CheckpointManager(str(tmp_path / "t")).save(1, {"x": torch.from_numpy(vals).bfloat16()})
    jz = np.load(tmp_path / "j" / "step_00000001" / "arrays.npz")["x"]
    tz = np.load(tmp_path / "t" / "step_00000001" / "arrays.npz")["x"]
    assert jz.dtype == tz.dtype and jz.tobytes() == tz.tobytes()
    restored, _ = CheckpointManager(str(tmp_path / "j")).restore(
        {"x": torch.zeros(2, 5, dtype=torch.bfloat16)})
    assert torch.equal(restored["x"], torch.from_numpy(vals).bfloat16())


# --------------------------------------------------------------------------
# interchange of a model checkpoint
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def olmo():
    jcfg = jconfigs.get_config("olmo-1b").reduced()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tm = build_model(tconfigs.get_config("olmo-1b").reduced(), device="cpu")
    params_from_numpy(tm, jflatten(jp))
    return jp, tm


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return m["keys"], m["shapes"], m["dtypes"]


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path, olmo):
    jp, tm = olmo
    jstate = jinit_opt(jp)
    jstate = jstate._replace(step=jnp.asarray(12, jnp.int32),
                             m=jax.tree.map(lambda p: p * 0.5, jp))
    JManager(str(tmp_path)).save(12, (jp, jstate), extra={"arch": "olmo-1b"})
    fresh = build_model(tm.cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    (params, opt), manifest = CheckpointManager(str(tmp_path)).restore(
        (fresh.params, init_opt_state(fresh.params)))
    assert manifest["step"] == 12 and manifest["arch"] == "olmo-1b"
    assert isinstance(opt, OptState) and int(opt.step) == 12 and opt.step.dtype == torch.int32
    want = jflatten(jp)
    got = _tree.flatten(params, lambda t: t.numpy(), np.stack)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    m = _tree.flatten(opt.m, lambda t: t.numpy(), np.stack)
    assert all(np.array_equal(m[k], want[k] * 0.5) for k in want)


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path, olmo):
    jp, tm = olmo
    CheckpointManager(str(tmp_path / "t")).save(4, (tm.params, init_opt_state(tm.params)))
    JManager(str(tmp_path / "j")).save(4, (jp, jinit_opt(jp)))
    assert _manifest(tmp_path / "t" / "step_00000004") == _manifest(
        tmp_path / "j" / "step_00000004")
    template = jax.tree.map(jnp.zeros_like, (jp, jinit_opt(jp)))
    (params, opt), manifest = JManager(str(tmp_path / "t")).restore(template)
    assert manifest["step"] == 4
    want = params_to_numpy(tm)
    got = jflatten(params)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert int(opt.step) == 0


def test_serve_driver_restores_a_reference_checkpoint(tmp_path):
    """The reference writes a checkpoint of the driver's model (reduced
    olmo-1b, vocab capped at 2048); the port's driver restores it and
    serves what a port engine serves from the same parameters."""
    from repro_torch.launch import serve
    from repro_torch.serve import GenerationConfig, ServeEngine

    jcfg = jconfigs.get_config("olmo-1b").reduced()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(3))
    JManager(str(tmp_path)).save(6, (jp, jinit_opt(jp)))
    got = serve.main(["--arch", "olmo-1b", "--reduced", "--requests", "3", "--new-tokens", "4",
                      "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    tm = build_model(tconfigs.get_config("olmo-1b").reduced(), device="cpu")
    params_from_numpy(tm, jflatten(jp))
    eng = ServeEngine(tm, tm.params, GenerationConfig(max_new_tokens=4), batch_size=4)
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, jcfg.vocab, size=int(rng.integers(4, 16))))
    want = eng.flush()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_stacked_layers_save_as_one_array(tmp_path, olmo):
    """A scanned stack's layers are one array a leaf, with a leading layer
    axis, and restore into the port's per-layer tensors."""
    _, tm = olmo
    path = CheckpointManager(str(tmp_path)).save(1, tm.params)
    keys, shapes, dtypes = _manifest(path)
    assert "layers/attn/wq" in keys and not any(k.startswith("layers/0") for k in keys)
    assert shapes["layers/attn/wq"] == [tm.cfg.n_layers] + list(
        tm.params["layers"][0]["attn"]["wq"].shape)
    assert set(dtypes.values()) == {"float32"}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-base"])
def test_moe_and_encdec_checkpoints_interchange_bitwise(tmp_path, arch):
    """A MoE model (a scanned stack with expert and shared-expert leaves) and
    an enc-dec model (``enc_layers/0/...`` lists): the reference's checkpoint
    restores in the port bitwise, the port's in the reference, with equal
    manifests."""
    jcfg = jconfigs.get_config(arch).reduced()
    jp = jbuild(jcfg).init(jax.random.PRNGKey(13))
    JManager(str(tmp_path / "j")).save(3, (jp, jinit_opt(jp)), extra={"arch": arch})
    tm = build_model(tconfigs.get_config(arch).reduced(), device="cpu",
                     generator=torch.Generator().manual_seed(14))
    (params, opt), manifest = CheckpointManager(str(tmp_path / "j")).restore(
        (tm.params, init_opt_state(tm.params)))
    assert manifest["step"] == 3 and manifest["arch"] == arch
    want = jflatten(jp)
    got = _tree.flatten(params, lambda t: t.numpy(), np.stack)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    if jcfg.is_encdec:
        assert "enc_layers/0/attn/wq" in want and "dec_layers/1/cross_attn/wk" in want
    else:
        assert "layers/moe/w_gate" in want and "layers/moe/shared/gate" in want
    # the other way: the port writes a fresh model, the reference restores it
    fresh = build_model(tm.cfg, device="cpu", generator=torch.Generator().manual_seed(15))
    CheckpointManager(str(tmp_path / "t")).save(5, (fresh.params, init_opt_state(fresh.params)))
    JManager(str(tmp_path / "j5")).save(5, (jp, jinit_opt(jp)))
    assert _manifest(tmp_path / "t" / "step_00000005") == _manifest(tmp_path / "j5" / "step_00000005")
    template = jax.tree.map(jnp.zeros_like, (jp, jinit_opt(jp)))
    (jparams, _), _ = JManager(str(tmp_path / "t")).restore(template)
    back, mine = jflatten(jparams), params_to_numpy(fresh)
    assert sorted(back) == sorted(mine)
    assert all(np.array_equal(back[k], mine[k]) for k in mine)
