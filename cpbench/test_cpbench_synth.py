"""CPU tests: a configuration's data comes from the synthesis it names
(``synth/<name>.py``, found by name), in its dtype; the fMRI study's bits
are those of the direct call; and a synthesis of another order, added as a
file alone, runs a whole cell to ``correct``."""

from __future__ import annotations

import sys

import pytest
import torch

from cpbench import run, spec
from cpbench.reference import synth

BENCH = spec.benchmark()
ANALYST = spec.workload("fmri4d.matrix_free")  # a committed cell's traffic and limits
CPU = torch.device("cpu")

# A planted rank-``planted_rank`` cube of any order with 5% noise: what a
# later configuration of another order would add as its own file.
CUBE = '''
import torch

TINY_SHAPE = {shape}


def make(gen, config, device):
    dtype = getattr(torch, config["dtype"])
    r = int(config["planted_rank"])
    fs = [torch.randn((d, r), generator=gen, device=device, dtype=dtype)
          for d in config["shape"]]
    x = fs[0]
    for u in fs[1:]:
        x = x[..., None, :] * u
    x = x.sum(-1)
    x /= x.abs().max()
    return x + float(config["noise"]) * torch.randn(x.shape, generator=gen, device=device,
                                                    dtype=dtype)
'''


def _tiny_config(name):
    config = dict(spec.config(name))
    config.update(shape=list(spec.synth(config).TINY_SHAPE), planted_rank=3, rank=3)
    return config


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
@pytest.mark.parametrize("name", ["fmri4d", "fmri_fleet"])
def test_make_data_gives_the_bits_of_the_direct_call(name, seed):
    config = _tiny_config(name)
    got = run.make_data(torch, config, seed, CPU)
    gen = torch.Generator(device=CPU).manual_seed(synth.derived_seed(seed, 0))
    want = synth.fmri_tensor(gen, config["shape"], 3, float(config["noise"]), CPU)
    if "subject_mode" in config:
        want = synth.subjects(want, int(config["subject_mode"]))
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)


def test_the_fmri_study_keeps_its_order_on_the_cpu():
    assert spec.synth({}).TINY_SHAPE == (12, 7, 8, 8)
    assert spec.synth(spec.config("fmri4d")) is spec.synth({"synth": "fmri"})


def test_data_is_made_in_the_stated_dtype():
    config = _tiny_config("fmri4d")
    config["dtype"] = "float64"
    x = run.make_data(torch, config, 7, CPU)
    assert x.dtype == torch.float64 and tuple(x.shape) == (12, 7, 8, 8)
    assert float(x.abs().max()) == pytest.approx(1.0, abs=0.3)


def test_an_unknown_synthesis_raises_with_the_file_it_looked_for():
    config = _tiny_config("fmri4d")
    config["synth"] = "no_such_synthesis"
    with pytest.raises(FileNotFoundError, match="cpbench/synth/no_such_synthesis.py"):
        run.make_data(torch, config, 1, CPU)


@pytest.mark.parametrize("dtype,tf32", [("bfloat16", False), ("float16", False),
                                        ("float64", True)])
def test_a_dtype_with_no_control_raises(dtype, tf32):
    config = _tiny_config("fmri4d")
    config.update(dtype=dtype, tf32=tf32)
    with pytest.raises(ValueError, match="cpbench/configs/fmri4d.json"):
        run.make_data(torch, config, 1, CPU)


@pytest.fixture
def scratch_root(tmp_path, monkeypatch):
    """A benchmark root whose ``synth/`` is a new directory and whose traffic
    drivers and metric readers are the committed ones."""
    here = tmp_path / "cpbench"
    (here / "synth").mkdir(parents=True)
    for kind in ("traffic", "metrics"):
        (here / kind).symlink_to(spec.HERE / kind)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "HERE", here)
    yield here
    for name in list(sys.modules):
        if name.startswith("cpbench.synth.cube"):
            del sys.modules[name]


@pytest.mark.parametrize("strategy", ["auto", "matrix_free"])
@pytest.mark.parametrize("shape", [(9, 8, 7), (4, 3, 4, 3, 4, 3)])
def test_a_synthesis_of_another_order_runs_a_cell_to_correct(scratch_root, shape, strategy):
    name = f"cube{len(shape)}"
    (scratch_root / "synth" / f"{name}.py").write_text(CUBE.format(shape=shape))
    config = {"name": name, "synth": name, "shape": [1], "dtype": "float32", "tf32": False,
              "rank": 10, "planted_rank": 10, "noise": 0.05}
    config.update(shape=list(spec.synth(config).TINY_SHAPE), planted_rank=3, rank=3)
    cell = dict(ANALYST, config=name, strategy=strategy, init_pool=16)
    r = run.execute(f"{name}.{strategy}", cell, config, 2**31 + 3, 0.2, False, CPU, BENCH)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    x = run.make_data(torch, config, 1, CPU)
    assert tuple(x.shape) == shape
