"""AdamW with warmup+cosine schedule, global-norm clipping.

Port of ``repro.train.optimizer`` (hand-rolled, as the reference's).
Optimizer state is a tree of fp32 ``(m, v)`` mirroring the params, on each
parameter's device; its checkpoint keys are the reference's (``step``,
``m/...``, ``v/...``).  Serving restores a checkpoint into the template
``(params, init_opt_state(params))``.

On a mesh the tree holds this rank's blocks: :func:`global_norm` (and so
the clipping of :func:`adamw_update`) takes the parameters' resolved
``specs`` and the ``mesh`` and sums a sharded leaf's squares over the
axes it is sharded on, in rank order (the data axes first), counting a
replicated leaf once.  With ``fsdp_specs`` (the leaves' specs with their
FSDP cut over the data axes) a leaf's squares are summed block by block of
that cut and the blocks added as the data axes add them, whether the leaf
is held whole over the data axes (a ``drop_fsdp`` block, its blocks summed
here) or as its FSDP block (summed over the data axes): both layouts give
the same norm, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch._tree import leaves, specs_of, tree_map, unflatten_like
from repro_torch.launch import mesh as meshlib

Tensor = torch.Tensor


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: Tensor
    m: Any
    v: Any


def init_opt_state(params: Any) -> OptState:
    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    device = leaves(params)[0].device if leaves(params) else "cpu"
    return OptState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())


def schedule(cfg: OptConfig, step: Tensor) -> Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _axes_of(spec) -> tuple[str, ...]:
    return tuple(a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e))


def _squares(g: Tensor, spec, fspec, mesh) -> Tensor:
    """The sum of ``g``'s squares; for a leaf held whole over the data axes
    whose ``fspec`` cuts it over them, the sum of each block's, added as
    :func:`~repro_torch.dist.collectives.ordered_psum` adds the data ranks'
    (over ``"pod"`` first, then ``"data"``)."""
    dp = meshlib.dp_spec_entry(mesh)
    sizes = [int(mesh.size(mesh.mesh_dim_names.index(a))) for a in meshlib.dp_axes(mesh)]
    n = math.prod(sizes)
    if fspec is None or dp not in tuple(fspec) or dp in tuple(spec) or n == 1 \
            or g.shape[tuple(fspec).index(dp)] % n:
        return torch.sum(torch.square(g.float()))
    from repro_torch.dist.collectives import _add_in_order

    dim = tuple(fspec).index(dp)
    sq = [torch.sum(torch.square(c.contiguous().float())) for c in g.chunk(n, dim)]
    # block i = row-major over the data axes; sum the most significant axis first
    for k in range(len(sizes)):
        inner = math.prod(sizes[k + 1:])
        sq = [_add_in_order(sq[j::inner]) for j in range(inner)]
    return sq[0]


def global_norm(tree: Any, *, specs: Any = None, mesh=None, fsdp_specs: Any = None) -> Tensor:
    """The 2-norm of every leaf together.  With ``specs`` and ``mesh`` the
    leaves are this rank's blocks: the squares of the leaves sharded on the
    same mesh axes go through one ordered sum over those axes, the data
    axes first (the same bits on every rank), then all squares are added in
    leaf order.  ``fsdp_specs`` makes a leaf's squares a sum over its FSDP
    blocks in either layout (see the module docstring)."""
    if mesh is None or specs is None:
        return torch.sqrt(torch.sum(torch.stack(
            [torch.sum(torch.square(g.float())) for g in leaves(tree)])))
    from repro_torch.dist.collectives import ordered_psum

    spec_list = specs_of(tree, specs)
    fspec_list = specs_of(tree, fsdp_specs) if fsdp_specs is not None else [None] * len(spec_list)
    sq = [_squares(g, s, f, mesh) for g, s, f in zip(leaves(tree), spec_list, fspec_list)]
    dp_axes = meshlib.dp_axes(mesh)
    groups: dict[tuple, list[int]] = {}
    for i, s in enumerate(spec_list):
        axes = _axes_of(s)
        axes = tuple(a for a in dp_axes if a in axes) + tuple(a for a in axes if a not in dp_axes)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        total = ordered_psum(torch.stack([sq[i] for i in idx]), axes, mesh)
        for j, i in enumerate(idx):
            sq[i] = total[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Any, max_norm: float, *, specs: Any = None,
                        mesh=None, fsdp_specs: Any = None) -> tuple[Any, Tensor]:
    norm = global_norm(grads, specs=specs, mesh=mesh, fsdp_specs=fsdp_specs)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(
    params: Any, grads: Any, state: OptState, cfg: OptConfig, *, specs: Any = None, mesh=None,
    fsdp_specs: Any = None,
) -> tuple[Any, OptState, dict]:
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, specs=specs, mesh=mesh,
                                       fsdp_specs=fsdp_specs)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    new_p = unflatten_like(params, [o[0] for o in outs])
    new_m = unflatten_like(state.m, [o[1] for o in outs])
    new_v = unflatten_like(state.v, [o[2] for o in outs])
    return new_p, OptState(step, new_m, new_v), {"lr": lr, "grad_norm": gnorm}
