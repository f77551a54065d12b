"""The train step: mixed precision, grad accumulation, sharded steps.

Port of ``repro.train.train_step``.  The step is functional, as the
reference's pure function is: it takes a params tree and an optimizer state
and returns new ones, and overwrites no tensor it was given (the
reference's ``donate_argnums`` has no counterpart), so a checkpoint
snapshot or a caller's tree stays valid.  Gradients come from
``torch.autograd.grad`` over the params tree's leaves (detached copies that
require grad, so a model's ``nn.Parameter``s are read, never written); the
leaves it returns require grad again.  Gradient accumulation slices every
entry of the batch along dim 0 into ``accum_steps`` equal micro-batches
(the batch must divide) and averages gradients and loss in fp32, as the
reference's ``lax.scan`` does.

On an ambient mesh (``repro_torch.launch.mesh.use_mesh``, outside manual
mode) the step is one rank's part of the sharded step: ``params`` and the
optimizer state are this rank's blocks of ``Model.partition_specs(mesh,
drop_fsdp=True)`` (tensor parallelism over ``"model"``, replicated over
the data axes) and ``batch`` is this rank's data-parallel block (the data
pipeline cuts it by the rank's ``"data"`` coordinate; the ranks of one
data group read the same block).  The model code runs the tensor-parallel
collectives; the step then sums the gradients over the data axes in rank
order and divides by their count, takes the ordered means of loss and
metrics, and clips by the global norm of the sharded tree.

With ``fsdp=True`` (FSDP/ZeRO-3, on a mesh) ``params`` and the optimizer
state are this rank's blocks of ``Model.partition_specs(mesh)``, with the
``"fsdp"`` dims cut over the data axes too.  The step hands the model a
leaf with such a cut as a :class:`~repro_torch.dist.collectives.FsdpBlock`,
which the model code gathers where it uses it (at the top of a layer's
function, so one layer's gathered weights are alive at a time under
remat); the gather's backward reduce-scatters the gradient over the data
axes in the order the ordered mean sums them, so the step divides those
leaves by the data size where it takes the ordered mean of the others.
With ``accum_steps == 1`` the step is bit for bit the ``drop_fsdp`` step on
the same mesh, cut to the blocks (the global norm sums each leaf's squares
by its FSDP blocks in both layouts, ``optimizer.global_norm``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch._tree import leaves, specs_of, tree_map, unflatten_like
from repro_torch.launch import mesh as meshlib
from repro_torch.models import Model

from .optimizer import OptConfig, OptState, adamw_update

Tensor = torch.Tensor


def _grads_of(model: Model, params: Any, batch: dict,
              held: Callable[[list], Any] | None = None) -> tuple[Tensor, dict, Any]:
    """``(loss, metrics, grads)`` of ``model.loss_fn`` at ``params``;
    ``held`` maps the tracked leaves to the tree the model takes (FSDP
    blocks)."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(tracked if held is None else held(leaves(tracked)), batch)
        grads = torch.autograd.grad(loss, leaves(tracked))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten_like(params, list(grads))


def _check_blocks(model: Model, params: Any, specs: Any, mesh) -> None:
    """Each leaf of ``params`` must be this rank's block of its spec."""
    defs = leaves(model.param_defs)
    for p, d, s in zip(leaves(params), defs, specs_of(params, specs)):
        want = meshlib.NamedSharding.of(mesh, s).block_shape(d.shape)
        if tuple(p.shape) != want:
            raise ValueError(f"a parameter of shape {tuple(p.shape)} on the mesh: its block of "
                             f"{tuple(d.shape)} under {tuple(s)} is {want}; cut the parameters "
                             "with repro_torch.launch.mesh.shard_tree")


def _fsdp_dims(specs: Any, params: Any, mesh) -> list:
    """Each leaf's FSDP dim (its spec's data-axes entry), ``None`` where
    its spec has none."""
    dp = meshlib.dp_spec_entry(mesh)
    return [tuple(s).index(dp) if dp in tuple(s) else None for s in specs_of(params, specs)]


def make_train_step(
    model: Model, opt_cfg: OptConfig, *, accum_steps: int = 1, fsdp: bool = False
) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).
    ``fsdp`` takes FSDP blocks on a mesh (see the module docstring)."""

    def step(params: Any, opt_state: OptState, batch: dict):
        mesh = meshlib.active_mesh()
        held, dims = None, None
        if mesh is not None:
            full = model.partition_specs(mesh)
            specs = full if fsdp else model.partition_specs(mesh, drop_fsdp=True)
            _check_blocks(model, params, specs, mesh)
            if fsdp:
                from repro_torch.dist.collectives import FsdpBlock

                dims = _fsdp_dims(specs, params, mesh)

                def held(tracked):
                    return unflatten_like(params, [
                        t if d is None else FsdpBlock(t, d, mesh) for t, d in zip(tracked, dims)])
        elif fsdp:
            raise ValueError("make_train_step(fsdp=True) runs on a mesh (launch.mesh.use_mesh)")
        if accum_steps == 1:
            loss, metrics, grads = _grads_of(model, params, batch, held)
        else:
            def micro(i):
                return {k: x.narrow(0, i * (x.shape[0] // accum_steps), x.shape[0] // accum_steps)
                        for k, x in batch.items()}

            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            for i in range(accum_steps):
                loss_i, _, g_i = _grads_of(model, params, micro(i), held)
                for a, g in zip(leaves(grads), leaves(g_i)):  # the step's own sums
                    a.add_(g.float() / accum_steps)
                loss = loss + loss_i / accum_steps
                del g_i  # freed before the next micro-batch's backward
            metrics = {"ce": loss}
        if mesh is None:
            params, opt_state, opt_stats = adamw_update(params, grads, opt_state, opt_cfg)
        else:
            from repro_torch.dist.collectives import ordered_mean

            dp = meshlib.dp_axes(mesh)
            n_dp = meshlib.dp_coord(mesh)[0]
            flat = leaves(grads)
            del grads
            for i, g in enumerate(flat):  # a leaf at a time: each freed once averaged
                # an FSDP leaf's gradient arrives summed over the data axes
                flat[i] = g / n_dp if dims is not None and dims[i] is not None \
                    else ordered_mean(g, dp, mesh)
            del g
            grads = unflatten_like(params, flat)
            loss = ordered_mean(loss, dp, mesh)
            metrics = {k: ordered_mean(v, dp, mesh) for k, v in metrics.items()}
            params, opt_state, opt_stats = adamw_update(params, grads, opt_state, opt_cfg,
                                                        specs=specs, mesh=mesh, fsdp_specs=full)
        params = tree_map(lambda p: p.requires_grad_(), params)
        metrics = dict(metrics)
        metrics.update(opt_stats)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step
