"""Hardware-measured autotuning, read side: the tuning cache and its keys.

Port of the part of ``repro.plan.autotune`` that ``plan_sweep`` reads:
:func:`backend_name`, :func:`problem_key`, :func:`node_key`,
:class:`Measurements`, :class:`TuningCache`, :func:`default_tuning_cache`
and :func:`lookup_measurements`.  Planning only ever reads the cache; the
measuring side (``tune()`` and the tile tuners) comes with the autotuning
slice of the port.

Keys start with :func:`backend_name`, which names the CUDA device
(``cuda:NVIDIA H100 80GB HBM3``), so entries of the port never mix with the
JAX package's (``cpu``/``gpu``/``tpu``) even in one shared cache file.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping

import torch

from .problem import Problem
from .schedule import ContractionNode

# Environment variable naming the on-disk cache file of the process-default
# cache (see default_tuning_cache); unset/empty means in-memory only.
CACHE_ENV = "REPRO_TUNING_CACHE"


def backend_name() -> str:
    """The device measurements are valid for: ``cuda:<card name>`` when a
    card is attached, ``cpu`` otherwise."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cpu"


def problem_key(
    problem: Problem, *, backend: str | None = None, n_devices: int | None = None
) -> str:
    """Cache key of one (hardware, problem) pair: the problem's
    :meth:`~repro_torch.plan.problem.Problem.signature` with the live
    backend filled in."""
    backend = backend_name() if backend is None else str(backend)
    return problem.signature(backend=backend, n_devices=n_devices)


def node_key(
    node: ContractionNode, algorithm: str, executor: str, collective: str = "flat"
) -> str:
    """Measurement key of one schedule node's contraction (executor kind,
    algorithm, kept range, parent range, source), shared by every candidate
    tree the node appears in."""
    src = "root" if node.from_root else "partial"
    key = (
        f"{executor}|{algorithm}|{src}|keep={node.lo}:{node.hi}"
        f"|parent={node.parent_lo}:{node.parent_hi}"
    )
    if collective != "flat":
        key += f"|coll={collective}"
    return key


@dataclass(frozen=True)
class Measurements:
    """One problem's resolved tuning entry, as the planner consumes it:
    ``node_s`` maps :func:`node_key` strings to measured median seconds,
    ``tiles`` maps kernel name to its tuned tile config."""

    node_s: Mapping[str, float] = field(default_factory=dict)
    tiles: Mapping[str, Mapping[str, int]] = field(default_factory=dict)

    def node_time(
        self, node: ContractionNode, algorithm: str, executor: str, collective: str = "flat"
    ) -> float | None:
        """Measured seconds for one node contraction, ``None`` if unmeasured."""
        return self.node_s.get(node_key(node, algorithm, executor, collective))

    def kernel_tiles(self, kernel: str) -> dict[str, int] | None:
        """Tuned tile config for one kernel name, ``None`` if untuned."""
        t = self.tiles.get(kernel)
        return {k: int(v) for k, v in t.items()} if t else None


class TuningCache:
    """Persistent ``{problem_key: entry}`` store with in-memory memoization.

    Entries are plain JSON dicts.  ``path=None`` lives in memory only; with
    a path, construction loads whatever the file holds (an empty file is an
    empty store) and every :meth:`put` rewrites it.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path else None
        self._entries: dict[str, dict] = {}
        if self.path is not None and self.path.exists():
            text = self.path.read_text()
            self._entries = json.loads(text) if text.strip() else {}

    def get(self, key: str) -> dict | None:
        """The entry stored under ``key``, or ``None``."""
        return self._entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        """Store ``entry`` under ``key`` and persist to disk when backed."""
        self._entries[key] = entry
        self.save()

    def save(self) -> None:
        """Write the full store to ``self.path`` (no-op when memory-only)."""
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self._entries, indent=1))

    def keys(self) -> list[str]:
        """All problem keys currently held."""
        return list(self._entries)


_default_cache: TuningCache | None = None


def default_tuning_cache() -> TuningCache:
    """The process-default cache ``plan_sweep`` reads: backed by the file
    named in ``$REPRO_TUNING_CACHE`` when set, in-memory otherwise."""
    global _default_cache
    if _default_cache is None:
        _default_cache = TuningCache(os.environ.get(CACHE_ENV) or None)
    return _default_cache


def lookup_measurements(
    problem: Problem, cache: TuningCache | None = None
) -> Measurements | None:
    """Resolve ``problem``'s tuning entry into planner-ready Measurements;
    ``None`` when it was never tuned on this backend (the planner then uses
    the analytic model alone)."""
    cache = cache or default_tuning_cache()
    entry = cache.get(problem_key(problem))
    if not entry:
        return None
    node_s = {r["key"]: float(r["measured_s"]) for r in entry.get("nodes", [])}
    tiles = {
        k: {
            kk: int(vv)
            for kk, vv in v.items()
            if kk in ("block_i", "block_b", "block_r", "block_batch")
        }
        for k, v in entry.get("tiles", {}).items()
        if v
    }
    return Measurements(node_s=node_s, tiles=tiles)
