"""CPU tests: the benchmark loads neither JAX nor the JAX package ``repro``
(top-level names compared whole), and its reference nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from cpbench import spec

REFERENCE_MAY_IMPORT = {"__future__", "math", "typing", "torch"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_names_are_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.plan": 1, "reprox": 1, "repro.core": 1,
            "jax": 1, "jaxlib.xla": 1, "flax": 1, "jax_like": 1}
    assert spec.loaded_forbidden(mods) == ["flax", "jax", "jaxlib.xla", "repro.core"]


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in sorted(spec.HERE.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & spec.FORBIDDEN, path
        if path.parent.name == "reference":
            assert tops <= REFERENCE_MAY_IMPORT, (path, tops)
        if path.parent.name == "synth":  # the data is the yardstick's, not the port's
            assert tops <= REFERENCE_MAY_IMPORT | {"cpbench"}, (path, tops)


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_port():
    got = _fresh(
        "import json, sys\n"
        "from cpbench.reference import als, synth\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    assert not set(got) & (spec.FORBIDDEN | {"repro_torch"})


def test_a_whole_run_loads_no_jax():
    got = _fresh(
        "import json, sys, torch\n"
        "sys.path.insert(0, 'src')\n"
        "from cpbench import check, control, run, spec\n"
        "bench = spec.benchmark()\n"
        "for name in [w['name'] for w in bench['workloads']]:\n"
        "    cell = dict(spec.workload(name)); config = dict(spec.config(cell['config']))\n"
        "    config.update(shape=[10, 5, 6, 6], planted_rank=2, rank=2)\n"
        "    cell.update(init_pool=4, batch=2, clients=4)\n"
        "    run.execute(name, cell, config, 5, 0.05, True, torch.device('cpu'), bench)\n"
        "for m in bench['per_layer']: spec.metric(m['name'])\n"
        "print(json.dumps({'bad': spec.loaded_forbidden(), 'port': 'repro_torch' in sys.modules}))\n"
    )
    assert got == {"bad": [], "port": True}
