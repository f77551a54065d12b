"""train_step builder: mixed precision, grad accumulation.

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
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch._tree import leaves, tree_map, unflatten_like
from repro_torch.models import Model

from .optimizer import OptConfig, OptState, adamw_update

Tensor = torch.Tensor


def make_train_step(
    model: Model, opt_cfg: OptConfig, *, accum_steps: int = 1
) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def grads_of(params: Any, batch: dict) -> tuple[Tensor, dict, Any]:
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(tracked, batch)
            grads = torch.autograd.grad(loss, leaves(tracked))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten_like(params, list(grads))

    def step(params: Any, opt_state: OptState, batch: dict):
        if accum_steps == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def micro(i):
                return {k: x.narrow(0, i * (x.shape[0] // accum_steps), x.shape[0] // accum_steps)
                        for k, x in batch.items()}

            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            for i in range(accum_steps):
                loss_i, _, g_i = grads_of(params, micro(i))
                for a, g in zip(leaves(grads), leaves(g_i)):  # the step's own sums
                    a.add_(g.float() / accum_steps)
                loss = loss + loss_i / accum_steps
                del g_i  # freed before the next micro-batch's backward
            metrics = {"ce": loss}
        params, opt_state, opt_stats = adamw_update(params, grads, opt_state, opt_cfg)
        params = tree_map(lambda p: p.requires_grad_(), params)
        metrics = dict(metrics)
        metrics.update(opt_stats)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step
