"""The deterministic collectives of the port's distributed MTTKRP.

The reference completes every sharded contraction with ``jax.lax.psum``,
whose summation order the backend picks.  The port's reductions are the
ordered gather-sum below instead: every rank of a reduce group all-gathers
the partials and adds them in group-rank order, so all ranks hold the same
bits and a sharded run is repeatable.  No atomics, and no ``all_reduce``.
The partials a CP-ALS sweep reduces are small (factor blocks, Gram
matrices, column norms, a tree's partial tensor), so the gather costs
little beside the contraction it completes.

:data:`GATHERS` counts collectives as a kernel counts launches
(``GATHERS.calls``): one a ``torch.distributed.all_gather``, wherever the
port makes one.  The reference's compressed and hierarchical collectives
come with distribution slices 3 and 4 of the port.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class _Count:
    """A call counter, set to 0 by whoever reads it."""

    def __init__(self) -> None:
        self.calls = 0


GATHERS = _Count()


def _gather(t: Tensor, group) -> list[Tensor]:
    """This rank's ``t`` from every rank of ``group``, in group-rank order:
    THE one ``all_gather`` of the port (counted in :data:`GATHERS`)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    GATHERS.calls += 1
    return parts


def gather_sum(t: Tensor, group) -> Tensor:
    """``sum`` of ``t`` over the ranks of ``group``, added in group-rank
    order; every rank gets the same bits.  The sum keeps ``t``'s layout (a
    contraction may return a transposed view, and what consumes it may
    take another path on another layout), so a group of one returns its
    own partial, bitwise and stride for stride."""
    parts = _gather(t, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    if out.stride() != t.stride():
        out = torch.empty_like(t).copy_(out)
    return out


def ordered_psum(t: Tensor, axes: Sequence[str], mesh) -> Tensor:
    """The port's ``psum(t, axes)`` on a DeviceMesh: :func:`gather_sum`
    over each named mesh dimension's process group in turn, in the order
    given (one gather an axis).  Deterministic: the same order on every
    rank, so every rank of the reduced axes holds the same bits."""
    for axis in axes:
        t = gather_sum(t, mesh.get_group(axis))
    return t


def gather_cat(t: Tensor, axes: Sequence[str], mesh, dim: int = 0) -> Tensor:
    """Blocks of ``t`` laid along ``dim`` over the mesh dimensions
    ``axes`` (the first the most significant, as a batch sharded over
    several axes is cut), concatenated into the whole on every rank."""
    for axis in reversed(tuple(axes)):
        t = torch.cat(_gather(t, mesh.get_group(axis)), dim=dim)
    return t
