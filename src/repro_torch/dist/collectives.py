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
port makes one.  :func:`ordered_psum_async` issues the first axis's gather
with ``async_op=True`` and sums after ``wait()`` (the overlapping
executor's pipeline), bitwise the synchronous sum.

:func:`compressed_psum` is the reference's int8 error-feedback all-reduce
(EF-SGD: Seide et al.'s 1-bit SGD generalized to int8, Karimireddy et
al.'s error feedback): each rank quantizes ``x + err`` with a private
scale, the int8 payloads and their scales are all-gathered (one uint8
buffer a rank, the scale's four bytes first) and every rank dequantizes
and adds them in group-rank order, carrying its own quantization error
into the next round.  :data:`INT8_GATHERS` counts those gathers and the
payload bytes they send.  :func:`init_error_state` makes zero residuals.
The compressed data-parallel train step of the reference comes with the
port's LM substrate; the hierarchical collectives come with distribution
slice 4.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor

_EPS = 1e-12  # guards the all-zero-tensor scale


class _Count:
    """A call counter, set to 0 by whoever reads it."""

    def __init__(self) -> None:
        self.calls = 0
        self.bytes = 0


GATHERS = _Count()
# gathers of int8 payloads made by compressed_psum; ``bytes`` is what this
# rank sent (its payload and scale, once an axis)
INT8_GATHERS = _Count()


def _gather(t: Tensor, group, *, async_op: bool = False):
    """This rank's ``t`` from every rank of ``group``, in group-rank order:
    THE one ``all_gather`` of the port (counted in :data:`GATHERS`).
    ``async_op`` returns ``(parts, work)``: the parts hold the result only
    after ``work.wait()``."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    work = dist.all_gather(parts, t, group=group, async_op=async_op)
    GATHERS.calls += 1
    return (parts, work) if async_op else parts


def _sum_parts(parts: Sequence[Tensor], t: Tensor) -> Tensor:
    """The gathered partials added in group-rank order, in ``t``'s layout."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    if out.stride() != t.stride():
        out = torch.empty_like(t).copy_(out)
    return out


def gather_sum(t: Tensor, group) -> Tensor:
    """``sum`` of ``t`` over the ranks of ``group``, added in group-rank
    order; every rank gets the same bits.  The sum keeps ``t``'s layout (a
    contraction may return a transposed view, and what consumes it may
    take another path on another layout), so a group of one returns its
    own partial, bitwise and stride for stride."""
    return _sum_parts(_gather(t, group), t)


def ordered_psum(t: Tensor, axes: Sequence[str], mesh) -> Tensor:
    """The port's ``psum(t, axes)`` on a DeviceMesh: :func:`gather_sum`
    over each named mesh dimension's process group in turn, in the order
    given (one gather an axis).  Deterministic: the same order on every
    rank, so every rank of the reduced axes holds the same bits."""
    for axis in axes:
        t = gather_sum(t, mesh.get_group(axis))
    return t


class PendingSum:
    """An :func:`ordered_psum` whose first gather is in flight.  Holds the
    partial (the gather reads it until it completes) and the gather's
    buffers; :meth:`wait` completes the first axis, adds in group-rank
    order and reduces over the remaining axes synchronously."""

    def __init__(self, t: Tensor, axes: Sequence[str], mesh):
        self.t, self.axes, self.mesh = t, tuple(axes), mesh
        self.src = t.contiguous()  # alive until the gather has read it
        self.parts, self.work = _gather(self.src, mesh.get_group(self.axes[0]), async_op=True)

    def wait(self) -> Tensor:
        """The reduced tensor, bitwise :func:`ordered_psum`'s.  On NCCL
        ``work.wait()`` makes the current stream wait for the gather's, so
        the sum runs after it without blocking the host."""
        self.work.wait()
        out = _sum_parts(self.parts, self.t)
        self.parts = self.work = self.src = None
        return ordered_psum(out, self.axes[1:], self.mesh)


def ordered_psum_async(t: Tensor, axes: Sequence[str], mesh) -> PendingSum:
    """Issue :func:`ordered_psum` of ``t`` over ``axes`` (at least one) with
    its first gather asynchronous (``async_op=True``); ``.wait()`` gives
    the sum.  Work queued between the call and ``wait()`` (the next slab's
    contraction) runs beside the gather."""
    return PendingSum(t, axes, mesh)


def gather_cat(t: Tensor, axes: Sequence[str], mesh, dim: int = 0) -> Tensor:
    """Blocks of ``t`` laid along ``dim`` over the mesh dimensions
    ``axes`` (the first the most significant, as a batch sharded over
    several axes is cut), concatenated into the whole on every rank."""
    for axis in reversed(tuple(axes)):
        t = torch.cat(_gather(t, mesh.get_group(axis)), dim=dim)
    return t


def compressed_psum(x: Tensor, axis_name, err: Tensor, mesh) -> tuple[Tensor, Tensor]:
    """int8-quantized ``psum`` of ``x`` over the mesh axes ``axis_name``
    (one name or a sequence) with error feedback.

    ``err`` is this rank's carried residual (zeros at first, ``x``'s
    shape).  Returns ``(sum, new_err)``: the dequantized sum, the same bits
    on every rank of the axes, and this rank's new residual, at most half
    a quantization step (``max|x + err| / 254``) an element.

    Each rank computes ``val = x + err`` and ``scale = max(max|val| / 127,
    1e-12)``, rounds ``val / scale`` half to even into int8 (as
    ``jnp.round`` does) and keeps ``val - q * scale``.  The payload and
    scale travel as one uint8 buffer through the port's counted gather, one
    gather an axis (the last axis first, so the payloads line up row-major
    over the axes, the first the most significant); every rank then adds
    ``q_r * scale_r`` in that order.  The wire carries one byte an element
    and four a sender, a quarter of an fp32 gather.
    """
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    val = x.float() + err
    scale = torch.clamp(val.abs().max() / 127.0, min=_EPS)
    q = torch.round(val / scale).to(torch.int8)  # |val| / scale <= 127 by the scale
    new_err = val - q.float() * scale
    pack = torch.cat([scale.reshape(1).view(torch.uint8), q.reshape(-1).view(torch.uint8)])
    for axis in reversed(axes):
        INT8_GATHERS.calls += 1
        INT8_GATHERS.bytes += pack.numel()
        pack = torch.stack(_gather(pack, mesh.get_group(axis)))
    rows = pack.reshape(-1, 4 + q.numel())
    total = None
    for row in rows:
        # the scale's bytes are copied out: a float view needs a 4-aligned offset
        term = row[4:].view(torch.int8).float().reshape(x.shape) * row[:4].clone().view(
            torch.float32
        )
        total = term if total is None else total + term
    return total.to(x.dtype), new_err


def init_error_state(params: Any, mesh=None, *, n_shards: int | None = None) -> Any:
    """Zero error-feedback residuals: one fp32 copy of each tensor of
    ``params`` (a dict or a list of tensors) a device, as the reference's
    ``(n, *param.shape)`` leaves.  ``n`` is ``n_shards`` when given, else
    the size of ``mesh``; the port has no global device count to fall back
    on, so one of them is needed."""
    if n_shards is not None:
        n = int(n_shards)
    elif mesh is not None:
        n = math.prod(int(s) for s in mesh.shape)
    else:
        raise ValueError("init_error_state needs mesh or n_shards")

    def zeros(p: Tensor) -> Tensor:
        return torch.zeros((n,) + tuple(p.shape), dtype=torch.float32, device=p.device)

    if isinstance(params, dict):
        return {k: zeros(v) for k, v in params.items()}
    return [zeros(p) for p in params]
