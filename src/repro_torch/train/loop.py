"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler watchdog, deterministic resume.

Port of ``repro.train.loop``.  Recovery model (maps to a real fleet):
  * every ``ckpt_every`` steps the full (params, opt_state, step) is saved
    asynchronously (atomic rename; keep-k); ``save_async`` copies the tree
    to host memory at the call, and the step never overwrites a tensor it
    was given, so a pending write reads the state of its own step;
  * any exception inside a step rolls back to the latest complete
    checkpoint and replays from there -- the data pipeline is
    index-deterministic so replayed batches are identical; ``max_failures``
    bounds the retry budget;
  * a wall-time watchdog flags steps slower than ``straggler_factor`` x the
    running median of the last 20 (once five steps have run); it is
    recorded in the result (and tested by injecting a slow step).

What the rollback covers: Python exceptions raised in the step -- an
injected fault, a non-finite loss (``FloatingPointError``),
``torch.cuda.OutOfMemoryError``.  It does not cover a sticky CUDA error (an
illegal address, a device-side assert): that leaves the CUDA context
unusable, every later call fails, and only a new process recovers; the
checkpoints on disk are what that process resumes from.

On an ambient mesh (``repro_torch.launch.mesh.use_mesh``) every rank runs
the loop, and all step together: the state is this rank's blocks of
``Model.partition_specs(mesh, drop_fsdp=True)`` (the fresh state or
``params`` cut here, a restore cut by the same specs onto the same mesh),
each batch this rank's data block (the data source cuts it), the metrics
the step's ordered means, so every rank sees the same loss and takes the
same branch; a checkpoint is assembled whole, and rank 0 alone writes it.
A fault must be raised on every rank (a non-finite loss is, since the loss
is the same everywhere); a rank failing alone leaves the others waiting in
a collective.

Each batch is host numpy from the data source, moved here to the model's
device.  The reference compiles the step with ``jax.jit`` (``jit_kwargs``
pass through to it); the port runs it eagerly and refuses any
``jit_kwargs``.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed

from repro_torch import _tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import mesh as meshlib
from repro_torch.models import Model

from .optimizer import OptConfig, OptState, init_opt_state
from .train_step import make_train_step

log = logging.getLogger("repro_torch.train")


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 2
    max_failures: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    accum_steps: int = 1


@dataclass
class LoopResult:
    step: int
    metrics_history: list[dict] = field(default_factory=list)
    failures: int = 0
    straggler_steps: list[int] = field(default_factory=list)


def train_loop(
    model: Model,
    data_source: Any,
    opt_cfg: OptConfig,
    loop_cfg: LoopConfig,
    *,
    params: Any = None,
    fault_hook: Callable[[int], None] | None = None,
    jit_kwargs: dict | None = None,
) -> LoopResult:
    """Run training with checkpoint/restart semantics.

    ``fault_hook(step)`` (tests) may raise to simulate a failure or sleep to
    simulate a straggler; it runs inside the protected region.
    ``jit_kwargs`` must be ``None`` or empty: the port does not compile the
    step.
    """
    if jit_kwargs:
        raise ValueError(f"jit_kwargs {sorted(jit_kwargs)}: the port runs the step eagerly "
                         "and compiles nothing")
    mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
    step_fn = make_train_step(model, opt_cfg, accum_steps=loop_cfg.accum_steps)
    mesh = meshlib.active_mesh()
    where = {}
    if mesh is not None:
        pspecs = model.partition_specs(mesh, drop_fsdp=True)
        where = {"mesh": mesh, "specs": (pspecs, OptState((), pspecs, pspecs))}

    def fresh_state():
        p = params if params is not None else model.init(_seed0(model))
        if mesh is not None:
            p = _blocks(model, p, pspecs, mesh)
        return p, init_opt_state(p)

    def restore(step):
        (p, s), _ = mgr.restore(_state_template(model, params), step, **where)
        return p, s

    result = LoopResult(step=0)
    latest = mgr.latest_step()
    if mesh is not None:  # every rank has looked before rank 0 may write step 0
        torch.distributed.barrier()
    if latest is not None:
        p, opt_state = restore(latest)
        step = latest
        log.info("restored checkpoint at step %d", step)
    else:
        p, opt_state = fresh_state()
        step = 0
        # Step-0 checkpoint: guarantees a restore point exists even if the
        # first failure precedes the first periodic save.
        mgr.save(0, (p, opt_state), **where)

    durations: list[float] = []
    while step < loop_cfg.total_steps:
        try:
            t0 = time.perf_counter()
            if fault_hook is not None:
                fault_hook(step)
            batch = data_source.batch(step)
            batch = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
            p, opt_state, metrics = step_fn(p, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
            # straggler watchdog
            if len(durations) >= 5:
                med = float(np.median(durations[-20:]))
                if dt > loop_cfg.straggler_factor * med:
                    result.straggler_steps.append(step)
                    log.warning("straggler step %d: %.3fs (median %.3fs)", step, dt, med)
            durations.append(dt)
            step += 1
            result.metrics_history.append(
                {"step": step, "loss": loss, "seconds": dt}
            )
            if step % loop_cfg.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            if step % loop_cfg.ckpt_every == 0 or step == loop_cfg.total_steps:
                mgr.wait()
                mgr.save_async(step, (p, opt_state), **where)
        except Exception as e:  # noqa: BLE001 -- recovery boundary
            result.failures += 1
            log.warning("step %d failed (%s); failures=%d", step, e, result.failures)
            if result.failures > loop_cfg.max_failures:
                raise
            mgr.wait()
            p = opt_state = None  # drop the failed state before the template is built
            latest = mgr.latest_step()
            if latest is None:
                p, opt_state = fresh_state()
                step = 0
            else:
                p, opt_state = restore(latest)
                step = latest
            log.info("recovered to step %d", step)

    mgr.wait()
    result.step = step
    return result


def _seed0(model: Model) -> torch.Generator:
    """The reference's ``PRNGKey(0)``: a generator seeded 0 on the model's device."""
    return torch.Generator(device=model.device).manual_seed(0)


def _blocks(model: Model, params: Any, specs: Any, mesh) -> Any:
    """``params`` as this rank's blocks: a whole leaf (the definition's
    shape) is cut, a leaf already a block is kept."""
    defs = _tree.leaves(model.param_defs)
    out = [meshlib.NamedSharding.of(mesh, s).cut(x) if tuple(x.shape) == tuple(d.shape)
           else x for x, d, s in zip(_tree.leaves(params), defs, _tree.specs_of(params, specs))]
    return _tree.unflatten_like(params, out)


def _state_template(model: Model, params: Any):
    p = params if params is not None else model.init(_seed0(model))
    return (p, init_opt_state(p))
