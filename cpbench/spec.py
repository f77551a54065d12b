"""Finding a cell's pieces by name: configurations, workloads, traffic
drivers, per-layer metric readers and ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")

# Top-level module names the benchmark may never load: JAX and the JAX
# package that the port was made from (whole names: ``repro_torch`` is not
# ``repro``).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.fullmatch(name) or ".." in name:
        raise ValueError(f"not a name: {name!r}")
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} ({path.relative_to(ROOT)})")
    return path


def config(name: str) -> dict:
    """``configs/<name>.json``."""
    return json.loads(_path("configs", name, ".json").read_text())


def workload(name: str) -> dict:
    """``workloads/<name>.json``."""
    return json.loads(_path("workloads", name, ".json").read_text())


def _module(kind: str, name: str):
    path = _path(kind, name, ".py")
    mod_name = f"cpbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[mod_name] = mod
    return mod


def driver(name: str):
    """The ``Driver`` class of ``traffic/<name>.py``."""
    return _module("traffic", name).Driver


def metric(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics_of(bench: dict, cell: str, section: str) -> list[dict]:
    """The entries of ``bench[section]`` that ``cell`` reports: those that
    list it under ``workloads``, and those with no such list."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def loaded_forbidden(modules=None) -> list[str]:
    """Names in ``modules`` (``sys.modules``) whose top-level name is one of
    :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN)
