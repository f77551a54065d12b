"""Parity of the port's LM configs, mesh plumbing and parameter shapes with
the JAX reference, on the CPU.

The configs are copies: every field of all ten architectures, full and
``reduced()``, equals the reference's; so do ``LM_SHAPES`` and the cell
skip rule.  The port builds every family: each full config's parameter
shapes (on the ``meta`` device, no storage; dbrx-132b's 132 B included)
equal the reference's ``jax.eval_shape(model.init, key)`` leaf for leaf,
under the reference's checkpoint leaf paths, and so do the counts.
"""

import dataclasses

import jax
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpoint.manager import _path_str
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild
from repro_torch import _tree
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model
from repro_torch.models.common import count_params

BUILT = ["olmo-1b", "qwen3-8b", "h2o-danube-3-4b", "deepseek-coder-33b", "qwen2-vl-7b",
         "dbrx-132b", "qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b", "whisper-base"]


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_and_reduced_equal_the_reference_field_for_field(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for prop in ("hd", "is_encdec", "attention_free", "subquadratic"):
        assert getattr(t, prop) == getattr(j, prop)
        assert getattr(t.reduced(), prop) == getattr(j.reduced(), prop)


def test_registry_equals_the_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(tconfigs.ARCHS) == 10
    assert all(cfg.source for cfg in tconfigs.ARCHS.values())
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
    with pytest.raises(KeyError):
        tconfigs.get_shape("no-such-shape")
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.LM_SHAPES.items()
    }
    for name in jconfigs.LM_SHAPES:
        assert dataclasses.asdict(tconfigs.get_shape(name)) == dataclasses.asdict(
            jconfigs.get_shape(name))


@pytest.mark.parametrize("shape", sorted(jconfigs.LM_SHAPES))
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_cell_is_applicable_equals_the_reference(arch, shape):
    assert tconfigs.cell_is_applicable(
        tconfigs.get_config(arch), tconfigs.get_shape(shape)
    ) == jconfigs.cell_is_applicable(jconfigs.get_config(arch), jconfigs.get_shape(shape))


def _reference_shapes(arch) -> dict:
    model = jbuild(jconfigs.get_config(arch))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_path_str(p) for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


@pytest.mark.parametrize("arch", BUILT)
def test_full_config_param_shapes_on_meta_equal_the_reference(arch):
    model = build_model(tconfigs.get_config(arch), device="meta")
    assert model.device.type == "meta"
    shapes = _tree.flatten(
        model.params, lambda p: (tuple(p.shape), str(p.dtype).removeprefix("torch.")),
        lambda xs: ((len(xs),) + xs[0][0], xs[0][1]),
    )
    assert shapes == _reference_shapes(arch)
    n = sum(int(torch.Size(s).numel()) for s, _ in shapes.values())
    assert count_params(model.params) == n


def test_olmo_1b_has_the_reference_count():
    """The card's full-width model: 1,176,764,416 parameters, 4.71 GB in fp32
    (``repro.analysis.flops.param_count`` of the reference gives the same)."""
    from repro.analysis.flops import param_count

    model = build_model(tconfigs.get_config("olmo-1b"), device="meta")
    assert count_params(model.params) == 1_176_764_416
    assert param_count(jconfigs.get_config("olmo-1b")) == 1_176_764_416


@pytest.mark.parametrize("arch,count", [
    ("falcon-mamba-7b", 7_272_665_088),
    ("recurrentgemma-2b", 3_337_597_440),
    ("qwen2-moe-a2.7b", 15_146_305_536),  # 64 experts a layer: the 4 pads included
    ("whisper-base", 114_065_408),
])
def test_full_config_param_counts_equal_the_reference_defs(arch, count):
    """The full models the card serves (phase 15): the port's count on
    ``meta`` is the sum of the reference's ``ParamDef`` shapes."""
    import numpy as np
    from repro.models.common import ParamDef as JDef

    defs = jbuild(jconfigs.get_config(arch)).param_defs
    n = sum(int(np.prod(d.shape)) for d in jax.tree.leaves(defs, is_leaf=lambda x: isinstance(x, JDef)))
    assert n == count
    assert count_params(build_model(tconfigs.get_config(arch), device="meta").params) == count


class _Mesh:
    """Stands in for a DeviceMesh: its axis names and sizes, no ranks."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = tuple(names), tuple(sizes)

    def size(self, dim=None):
        return self._sizes[dim] if dim is not None else int(torch.tensor(self._sizes).prod())


@pytest.mark.parametrize("arch", BUILT)
def test_logical_and_partition_specs_equal_the_reference(arch):
    cfg = jconfigs.get_config(arch).reduced()
    jmodel = jbuild(cfg)
    model = build_model(tconfigs.get_config(arch).reduced(), device="meta")

    def reference(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, tuple))
        return {"/".join(_path_str(p) for p in path): tuple(s) for path, s in flat[0]}

    # a scanned stack's spec gains a leading None for the layer axis
    def specs(tree):
        return _tree.flatten(tree, tuple, lambda ss: (None,) + tuple(ss[0]),
                             is_leaf=lambda x: isinstance(x, tuple))

    assert specs(model.logical_specs()) == reference(jmodel.logical_specs())
    jm = jmesh.make_host_mesh(1, 1)
    for drop in (False, True):
        got = specs(model.partition_specs(_Mesh(("data", "model"), (1, 1)), drop_fsdp=drop))
        assert got == reference(jmodel.partition_specs(jm, drop_fsdp=drop))


def test_mesh_plumbing_matches_the_reference():
    """No ambient mesh: constraints are the identity and tp is 1; the
    logical axes resolve as the reference's (checked on a stand-in mesh
    with the reference's axis names)."""
    x = torch.ones(2, 3)
    assert tmesh.current_mesh() is None
    assert tmesh.constraint(x, "dp", None) is x
    assert tmesh.tp_size() == 1 == jmesh.tp_size()

    flat, pods = _Mesh(("data", "model"), (2, 4)), _Mesh(("pod", "data", "model"), (2, 2, 2))
    assert tmesh.dp_axes(flat) == ("data",) and tmesh.dp_axes(pods) == ("pod", "data")
    assert tmesh.dp_spec_entry(flat) == "data"
    assert tmesh.dp_spec_entry(pods) == ("pod", "data")
    assert tmesh.resolve_logical(("fsdp", "tp", None), flat) == ("data", "model", None)
    assert tmesh.resolve_logical(("dp", "expert"), pods) == (("pod", "data"), "model")
    assert tmesh.resolve_logical(None, flat) == ()
    with pytest.raises(ValueError):
        tmesh.resolve_logical(("nope",), flat)
    assert tmesh.tp_size(flat) == 4
    with tmesh.use_mesh(flat):
        assert tmesh.current_mesh() is flat
        assert tmesh.constraint(x, "dp", None) is x  # a rank's block stays as it is
        with pytest.raises(ValueError):
            tmesh.constraint(x, "nope")
    with tmesh.use_mesh(_Mesh(("data", "model"), (1, 1))):
        assert tmesh.constraint(x, "dp", None) is x
    assert tmesh.current_mesh() is None
