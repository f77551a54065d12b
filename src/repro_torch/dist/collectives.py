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

The two-level collectives of a node mesh: :func:`reduce_scatter` within
one axis (``all_to_all_single`` of the ``k`` row chunks, the received
chunks added in group-rank order: the priced ``B (k - 1) / k`` bytes, and
bitwise repeatable where ``torch.distributed.reduce_scatter`` promises no
summation order), :func:`all_gather` back (the counted gather,
concatenated), and :func:`hierarchical_psum` built of them around the
ordered psum across nodes.  :data:`SCATTERS` counts the reduce-scatters
and the bytes this rank sends in them.

The sharded LM's collectives, autograd-aware (``torch.autograd.Function``s
in Megatron's pairs, over the mesh's ``"model"`` axis, each run even on an
axis of one rank; :data:`TP` counts them, forward and backward):

* :func:`tp_copy`: into a tensor-parallel region, forward the identity,
  backward the ordered sum of the ranks' partial gradients;
* :func:`tp_sum`: out of it, forward the ordered sum, backward the identity;
* :func:`sp_gather`: a sequence-sharded activation gathered whole, backward
  the ordered reduce-scatter; :func:`sp_scatter` the reverse;
* :func:`rep_gather` / :func:`rep_split`: into and out of a region every
  rank computes whole (replicated), backward a rank's own slice / the
  gather of the slices.

FSDP/ZeRO-3 parameter placement (:data:`FSDP` counts it, as :data:`TP`):
a leaf held as this rank's block along its ``"fsdp"`` dim is an
:class:`FsdpBlock`, and :func:`fsdp_gather` rebuilds its ``drop_fsdp``
block where the model code uses it (:func:`fsdp_tree`, at the top of a
layer's function): forward the blocks gathered over the data axes and
concatenated in rank order, backward the ordered reduce-scatter, an
all-to-all of chunks an axis, summed in rank order.

:data:`RECORD`, when a dry-run sets it, takes every collective this rank
issues under XLA's kind names (``all-reduce`` for an ordered sum,
``all-gather``, ``reduce-scatter``): its operand bytes, as the
reference's HLO parser counts them, and the bytes this rank receives.

:func:`make_compressed_dp_step` is the reference's data-parallel train step
with the int8 error-feedback gradient exchange (or the exact ordered mean).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import dp_axes

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
# reduce-scatters (one all_to_all_single each); ``bytes`` is what this rank
# sent to the other ranks of the group, ``B (k - 1) / k`` a call
SCATTERS = _Count()
# the sharded LM's autograd collectives, one a forward or backward call
TP = _Count()


class _FsdpCount(_Count):
    """:data:`TP`'s count for :func:`fsdp_gather`, with the bytes of the
    gathered leaves alive at once (``live``) and their most (``peak``)."""

    def __init__(self) -> None:
        super().__init__()
        self.live = 0
        self.peak = 0


# fsdp_gather's forward and backward calls (bytes: the gathered leaves)
FSDP = _FsdpCount()


class Recorder:
    """Collectives by kind while a dry-run traces a step: ``bytes`` and
    ``counts`` over groups of more than one rank (operand bytes, the
    reference's measure), ``received`` the bytes this rank receives in
    them, ``issued`` the operand bytes of every call, groups of one
    included, and ``calls`` each call's ``(kind, operand bytes, ranks)``."""

    def __init__(self) -> None:
        from repro_torch.analysis.roofline import _COLL_KINDS  # the HLO parser's kinds

        self.bytes = {k: 0 for k in _COLL_KINDS}
        self.counts = {k: 0 for k in _COLL_KINDS}
        self.received = 0
        self.issued = 0
        self.calls: list[tuple[str, int, int]] = []

    def add(self, kind: str, operand: int, received: int, n: int) -> None:
        self.issued += operand
        self.calls.append((kind, operand, n))
        if n > 1:
            self.bytes[kind] += operand
            self.counts[kind] += 1
            self.received += received


RECORD: Recorder | None = None


def _gather(t: Tensor, group, *, async_op: bool = False, kind: str = "all-gather"):
    """This rank's ``t`` from every rank of ``group``, in group-rank order:
    THE one ``all_gather`` of the port (counted in :data:`GATHERS`;
    ``kind`` is what it stands for in :data:`RECORD`).  ``async_op``
    returns ``(parts, work)``: the parts hold the result only after
    ``work.wait()``."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    work = dist.all_gather(parts, t, group=group, async_op=async_op)
    GATHERS.calls += 1
    if RECORD is not None:
        b = t.numel() * t.element_size()
        RECORD.add(kind, b, (n - 1) * b, n)
    return (parts, work) if async_op else parts


def _sum_parts(parts: Sequence[Tensor], t: Tensor) -> Tensor:
    """The gathered partials added in group-rank order, in ``t``'s layout."""
    return _keep_layout(_add_in_order(parts), t)


def _add_in_order(parts: Sequence[Tensor]) -> Tensor:
    """``parts[0] + parts[1] + ...``, left to right: the one summation
    order of the port's reductions."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gather_sum(t: Tensor, group) -> Tensor:
    """``sum`` of ``t`` over the ranks of ``group``, added in group-rank
    order; every rank gets the same bits.  The sum keeps ``t``'s layout (a
    contraction may return a transposed view, and what consumes it may
    take another path on another layout), so a group of one returns its
    own partial, bitwise and stride for stride."""
    return _sum_parts(_gather(t, group, kind="all-reduce"), t)


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
        self.parts, self.work = _gather(self.src, mesh.get_group(self.axes[0]), async_op=True,
                                        kind="all-reduce")

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


def _keep_layout(out: Tensor, t: Tensor) -> Tensor:
    """``out`` in ``t``'s layout (strides), as :func:`gather_sum` keeps it."""
    if out.stride() != t.stride():
        out = torch.empty_like(t).copy_(out)
    return out


def _scatter_issue(x: Tensor, axis: str, mesh, scatter_axis: int, async_op: bool):
    """Send chunk ``j`` of ``x`` along ``scatter_axis`` to group rank ``j``
    of ``axis`` (one ``all_to_all_single``, counted in :data:`SCATTERS`);
    returns ``(received, work, sent)``: ``received[j]`` is rank ``j``'s
    chunk of this rank's index (after ``work.wait()`` when asynchronous),
    and ``sent`` the buffer the collective reads until then."""
    group = mesh.get_group(axis)
    k = dist.get_world_size(group)
    if x.shape[scatter_axis] % k:
        raise ValueError(
            f"reduce_scatter: dim {scatter_axis} of extent {x.shape[scatter_axis]} "
            f"does not divide over axis {axis!r} of size {k}"
        )
    src = x.movedim(scatter_axis, 0).contiguous()
    recv = torch.empty_like(src)
    work = dist.all_to_all_single(recv, src, group=group, async_op=async_op)
    SCATTERS.calls += 1
    SCATTERS.bytes += src.numel() * src.element_size() * (k - 1) // k
    if RECORD is not None:
        b = src.numel() * src.element_size()
        RECORD.add("reduce-scatter", b, b * (k - 1) // k, k)
    return recv.reshape((k, src.shape[0] // k) + tuple(src.shape[1:])), work, src


def _scatter_sum(received: Tensor, scatter_axis: int) -> Tensor:
    """The received chunks added in group-rank order, the scattered dim
    moved back to ``scatter_axis``."""
    return _add_in_order(received).movedim(0, scatter_axis)


def reduce_scatter(x: Tensor, axis_name: str, mesh, *, scatter_axis: int = 0) -> Tensor:
    """Tiled reduce-scatter of ``x`` over the mesh axis ``axis_name``: each
    of its ``k`` ranks gets the sum over the group of its ``1/k`` slice of
    ``x`` along ``scatter_axis`` (rank ``j`` the ``j``-th slice), the first
    half of a ring all-reduce, ``B (k - 1) / k`` bytes sent a rank.
    ``x.shape[scatter_axis]`` must divide by ``k``.  One
    ``all_to_all_single`` carries the chunks; the received ones are added
    in group-rank order, so a second call is bitwise the first (a group of
    one returns ``x``'s values)."""
    received, _, _ = _scatter_issue(x, axis_name, mesh, scatter_axis, False)
    return _scatter_sum(received, scatter_axis)


def all_gather(x: Tensor, axis_name: str, mesh, *, gather_axis: int = 0) -> Tensor:
    """Tiled all-gather of ``x`` over the mesh axis ``axis_name``: the
    ranks' blocks concatenated along ``gather_axis`` in group-rank order on
    every rank, the second half of a ring all-reduce, undoing
    :func:`reduce_scatter`'s split (one counted gather)."""
    return gather_cat(x, (axis_name,), mesh, dim=gather_axis)


def _levels(x: Tensor, axes, mesh, node_axis, scatter_axis):
    """``(axes, inter axes)`` of a two-level sum, or ``(axes, None)`` when
    it falls back to the flat ordered psum."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if node_axis is None or node_axis not in axes:
        return axes, None
    inter = tuple(a for a in axes if a != node_axis)
    k = dist.get_world_size(mesh.get_group(node_axis))
    if not inter or k <= 1 or x.shape[scatter_axis] % k:
        return axes, None
    return axes, inter


def hierarchical_psum(x: Tensor, axes, mesh, node_axis: str | None = None,
                      *, scatter_axis: int = 0) -> Tensor:
    """Two-level ``psum`` of ``x`` over the mesh ``axes``: fast links
    within a node, only a ``1/k`` shard across the slow node boundary.

    ``node_axis`` names the mesh axis of the ``k`` devices *within* one
    node; the other ``axes`` cross nodes.  :func:`reduce_scatter` within
    ``node_axis`` along ``scatter_axis``, the ordered psum of the shard
    across the node-crossing axes, then :func:`all_gather` back: each rank
    sends ``2 B (k - 1) / k`` bytes within the node and ``2 (B / k) (m - 1)
    / m`` across nodes, where the flat sum sends ``2 B`` across them.  The
    same sum as :func:`ordered_psum` grouped otherwise, so equal to it at
    fp32 tolerance, the same bits on every rank and bitwise repeatable.
    Falls back to the flat :func:`ordered_psum` whenever the decomposition
    cannot apply: ``node_axis`` is ``None`` or not among ``axes``, it is
    the only reduced axis, its size is 1, or ``x.shape[scatter_axis]`` does
    not divide by it.  The result keeps ``x``'s layout."""
    axes, inter = _levels(x, axes, mesh, node_axis, scatter_axis)
    if inter is None:
        return ordered_psum(x, axes, mesh)
    return PendingHierarchicalSum(x, node_axis, inter, mesh, scatter_axis).wait()


class PendingHierarchicalSum:
    """A two-level sum whose reduce-scatter is in flight (over
    ``node_axis``; ``inter`` are the node-crossing axes): :meth:`wait`
    adds the received chunks in group-rank order, reduces the shard across
    nodes and gathers it back, in ``t``'s layout."""

    def __init__(self, t: Tensor, node_axis: str, inter, mesh, scatter_axis: int):
        self.t, self.node_axis, self.inter, self.mesh = t, node_axis, inter, mesh
        self.scatter_axis = scatter_axis
        self.received, self.work, self.src = _scatter_issue(
            t, node_axis, mesh, scatter_axis, True
        )

    def wait(self) -> Tensor:
        self.work.wait()
        shard = ordered_psum(_scatter_sum(self.received, self.scatter_axis), self.inter,
                             self.mesh)
        out = all_gather(shard, self.node_axis, self.mesh, gather_axis=self.scatter_axis)
        self.received = self.work = self.src = None
        return _keep_layout(out, self.t)


def hierarchical_psum_async(t: Tensor, axes, mesh, node_axis: str | None = None,
                            *, scatter_axis: int = 0):
    """Issue :func:`hierarchical_psum` with its reduce-scatter asynchronous
    (``async_op=True``); ``.wait()`` gives the sum.  Where the sum falls
    back to the flat one, :func:`ordered_psum_async`."""
    axes, inter = _levels(t, axes, mesh, node_axis, scatter_axis)
    if inter is None:
        return ordered_psum_async(t, axes, mesh)
    return PendingHierarchicalSum(t, node_axis, inter, mesh, scatter_axis)


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
    ``params`` (a tree of tensors: dicts, lists, a model's params) a
    device, as the reference's ``(n, *param.shape)`` leaves.  ``n`` is
    ``n_shards`` when given, else the size of ``mesh``; the port has no
    global device count to fall back on, so one of them is needed."""
    if n_shards is not None:
        n = int(n_shards)
    elif mesh is not None:
        n = math.prod(int(s) for s in mesh.shape)
    else:
        raise ValueError("init_error_state needs mesh or n_shards")

    def zeros(p: Tensor) -> Tensor:
        return torch.zeros((n,) + tuple(p.shape), dtype=torch.float32, device=p.device)

    from repro_torch._tree import tree_map

    return tree_map(zeros, params)



# --------------------------------------------------------------------------
# The sharded LM's autograd collectives (the "model" axis of a mesh)
# --------------------------------------------------------------------------
AXIS = "model"


def _model_index(mesh) -> tuple[int, int]:
    k = mesh.mesh_dim_names.index(AXIS)
    return int(mesh.size(k)), int(mesh.get_coordinate()[k])


def _count(t: Tensor) -> None:
    TP.calls += 1
    TP.bytes += t.numel() * t.element_size()


def _sum(t: Tensor, mesh) -> Tensor:
    _count(t)
    return gather_sum(t.contiguous(), mesh.get_group(AXIS))


def _cat(t: Tensor, mesh, dim: int) -> Tensor:
    _count(t)
    return all_gather(t.contiguous(), AXIS, mesh, gather_axis=dim)


def _scatter(t: Tensor, mesh, dim: int) -> Tensor:
    _count(t)
    return reduce_scatter(t, AXIS, mesh, scatter_axis=dim).contiguous()


def _own(t: Tensor, mesh, dim: int) -> Tensor:
    n, i = _model_index(mesh)
    step = t.shape[dim] // n
    return t.narrow(dim, i * step, step).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, replicated):
        ctx.mesh, ctx.dim, ctx.replicated = mesh, dim, replicated
        return _cat(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _own(g, ctx.mesh, ctx.dim), None, None, None
        return _scatter(g, ctx.mesh, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, replicated):
        ctx.mesh, ctx.dim = mesh, dim
        return _own(x, mesh, dim) if replicated else _scatter(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _cat(g, ctx.mesh, ctx.dim), None, None, None


def tp_copy(x: Tensor, mesh) -> Tensor:
    """Into a tensor-parallel region: ``x`` as it is; its gradient, partial
    on each ``"model"`` rank, summed over them in rank order."""
    return _Copy.apply(x, mesh)


def tp_sum(x: Tensor, mesh) -> Tensor:
    """Out of a tensor-parallel region: the ranks' partials summed in rank
    order over ``"model"``; the gradient passes as it is."""
    return _Sum.apply(x, mesh)


def sp_gather(x: Tensor, mesh, *, dim: int = 1) -> Tensor:
    """The ``"model"`` ranks' blocks of ``x`` along ``dim`` (the sequence)
    concatenated whole; the whole tensor's partial gradients reduce-scattered
    back to the blocks, summed in rank order.  A leaf sharded along ``dim``
    gathers the same way where each rank's use of it is partial."""
    return _Gather.apply(x, mesh, dim, False)


def sp_scatter(x: Tensor, mesh, *, dim: int = 1) -> Tensor:
    """The ranks' partial ``x`` summed in rank order and cut along ``dim``
    (this rank's block of the sequence); the blocks' gradients gathered
    whole."""
    return _Scatter.apply(x, mesh, dim, False)


def rep_gather(x: Tensor, mesh, *, dim: int) -> Tensor:
    """Blocks of ``x`` along ``dim`` gathered whole for a region every
    ``"model"`` rank computes whole; the (equal) whole gradient cut back to
    this rank's block."""
    return _Gather.apply(x, mesh, dim, True)


def rep_split(x: Tensor, mesh, *, dim: int) -> Tensor:
    """This rank's block along ``dim`` of a tensor every ``"model"`` rank
    holds whole; the blocks' gradients gathered whole."""
    return _Scatter.apply(x, mesh, dim, True)


class FsdpBlock:
    """A parameter leaf held as this rank's FSDP block: ``t`` is block
    ``i`` along ``dim`` over the data axes of ``mesh`` of the leaf's
    ``drop_fsdp`` block (``i`` row-major over the rank's data coordinates,
    as ``NamedSharding`` cuts it).  ``dtype`` is the dtype the model code
    uses it in: :meth:`to` sets it (the mixed-precision entry cast), and
    :func:`fsdp_gather` casts the block before it gathers."""

    __slots__ = ("t", "dim", "mesh", "dtype")

    def __init__(self, t: Tensor, dim: int, mesh, dtype: torch.dtype | None = None):
        self.t, self.dim, self.mesh = t, dim, mesh
        self.dtype = t.dtype if dtype is None else dtype

    def to(self, dtype: torch.dtype) -> "FsdpBlock":
        return FsdpBlock(self.t, self.dim, self.mesh, dtype)

    def is_floating_point(self) -> bool:
        return self.t.is_floating_point()


def _note_live(out: Tensor) -> None:
    import weakref

    b = out.numel() * out.element_size()
    FSDP.live += b
    FSDP.peak = max(FSDP.peak, FSDP.live)

    def release(n=b):
        FSDP.live -= n

    weakref.finalize(out.untyped_storage(), release)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, dtype):
        ctx.mesh, ctx.dim, ctx.in_dtype = mesh, dim, x.dtype
        y = x.to(dtype)
        FSDP.calls += 1
        FSDP.bytes += y.numel() * y.element_size()
        out = gather_cat(y.contiguous(), dp_axes(mesh), ctx.mesh, dim=dim)
        _note_live(out)
        return out

    @staticmethod
    def backward(ctx, g):
        FSDP.calls += 1
        g = g.to(ctx.in_dtype)
        FSDP.bytes += g.numel() * g.element_size()
        for axis in dp_axes(ctx.mesh):  # the order ordered_psum sums the axes in
            g = reduce_scatter(g, axis, ctx.mesh, scatter_axis=ctx.dim)
        return g.contiguous(), None, None, None


def fsdp_gather(block: FsdpBlock) -> Tensor:
    """The ``drop_fsdp`` block of an :class:`FsdpBlock`, in its ``dtype``:
    the data ranks' blocks (cast first) concatenated along ``dim`` in rank
    order (the first data axis the most significant).  Backward: the whole
    gradient, cast to the block's dtype, reduce-scattered over the data
    axes in the order :func:`ordered_psum` sums them (``"pod"``, then
    ``"data"``), each an all-to-all of chunks summed in rank order; so this
    rank's block of it is, bit for bit, its slice of the ordered sum of the
    whole gradients.  The caller divides by the data size, as
    :func:`ordered_mean` does."""
    return _FsdpGather.apply(block.t, block.mesh, block.dim, block.dtype)


def fsdp_tree(tree):
    """``tree`` with every :class:`FsdpBlock` leaf gathered
    (:func:`fsdp_gather`) and every other leaf as it is: called at the top
    of the function that a layer's remat wraps, so about one layer's
    gathered leaves are alive at a time and the recompute gathers again."""
    from repro_torch._tree import tree_map

    return tree_map(lambda x: fsdp_gather(x) if isinstance(x, FsdpBlock) else x, tree)


def ordered_mean(t: Tensor, axes: Sequence[str], mesh) -> Tensor:
    """The mean of ``t`` over the ranks of the mesh ``axes``: the ordered
    sum divided by their count."""
    n = math.prod(int(mesh.size(mesh.mesh_dim_names.index(a))) for a in axes)
    return ordered_psum(t, axes, mesh) / n


# --------------------------------------------------------------------------
# The compressed data-parallel train step
# --------------------------------------------------------------------------
def make_compressed_dp_step(model, opt_cfg, mesh, *, compress: bool = True):
    """Data-parallel train step with int8 + error-feedback gradient exchange.

    Returns ``step(params, opt_state, err, batch) -> (params, opt_state,
    new_err, metrics)``.  ``params`` are whole on every rank (the
    reference's ``P()``); ``batch`` is the global batch, of which each rank
    takes its data-parallel block of rows (row-major over the data axes).
    The gradients of ``model.loss_fn`` on the block are taken under
    :func:`~repro_torch.launch.mesh.manual_mode` (the model's single-device
    path), then, with ``compress``, each leaf goes through
    :func:`compressed_psum` over the data axes with this rank's residual and
    is divided by the data-parallel size; without it, the ordered mean.
    Loss and metrics are ordered means; then ``adamw_update``.  A scanned
    stack's layers are one leaf of the reference's, so their gradients are
    stacked into one quantized payload with one scale, as there.

    ``err`` is :func:`init_error_state`'s: ``(n, *shape)`` leaves with ``n``
    the mesh size (checked, as the reference checks).  The reference shards
    the leading dim so a device holds its own row; here every rank holds
    the whole array and the step reads and writes only this rank's row
    (row-major over all mesh axes), returning the others as given.
    ``compress=False`` swaps the quantized exchange for the exact mean (the
    residuals returned as given), the baseline in tests.
    """
    from repro_torch import _tree
    from repro_torch.launch import mesh as meshlib
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import _grads_of

    dp = meshlib.dp_axes(mesh)
    dp_size = math.prod(int(mesh.size(mesh.mesh_dim_names.index(a))) for a in dp)
    mesh_size = math.prod(int(s) for s in mesh.shape)

    def step(params: Any, opt_state, err: Any, batch: dict):
        for e in _tree.leaves(err):
            if e.shape[0] != mesh_size:
                raise ValueError(
                    f"error-state leading dim {e.shape[0]} != mesh size "
                    f"{mesh_size}; build it with init_error_state(params, mesh)"
                )
        row = 0
        for k, c in enumerate(mesh.get_coordinate()):
            row = row * int(mesh.size(k)) + int(c)
        _, d = meshlib.dp_coord(mesh)
        block = {}
        for key, x in batch.items():
            if x.shape[0] % dp_size:
                raise ValueError(f"batch[{key!r}] of {x.shape[0]} rows does not divide over "
                                 f"{dp_size} data-parallel ranks")
            n = x.shape[0] // dp_size
            block[key] = x.narrow(0, d * n, n)
        with meshlib.use_mesh(mesh), meshlib.manual_mode():
            loss, metrics, grads = _grads_of(model, params, block)
        if compress:
            # one quantization scale a reference leaf: a scanned stack's
            # layers are one leaf there, so they are stacked here, a leaf at
            # a time (each layer's gradient freed once stacked)
            def layers(tree):  # path -> [leaf], or a Stacked of the layers' leaves
                return _tree.flatten(tree, lambda x: [x],
                                     lambda xs: _tree.Stacked(y for ys in xs for y in ys))

            per_g, per_e = layers(grads), layers(err)
            del grads
            synced, new_e = {}, {}
            for key in list(per_g):
                gs, es = per_g.pop(key), per_e[key]
                stacked = isinstance(es, _tree.Stacked)
                g = torch.stack(gs) if stacked else gs[0]
                del gs
                e_row = torch.stack([e[row] for e in es]) if stacked else es[0][row]
                total, new_row = compressed_psum(g, dp, e_row, mesh)
                del g, e_row
                total = total / dp_size
                synced[key] = list(total.unbind(0)) if stacked else total
                del total
                outs = []
                for e, r in zip(es, new_row.unbind(0) if stacked else [new_row]):
                    out = e.clone()
                    out[row] = r
                    outs.append(out)
                new_e[key] = outs if stacked else outs[0]

            def fetch(table):
                return lambda key: table[key]

            grads = _tree.rebuild(err, fetch(synced), lambda x, leaf, key: x)
            new_err = _tree.rebuild(err, fetch(new_e), lambda x, leaf, key: x)
        else:
            grads = _tree.tree_map(lambda g: ordered_mean(g, dp, mesh), grads)
            new_err = err
        loss = ordered_mean(loss, dp, mesh)
        metrics = {k: ordered_mean(v, dp, mesh) for k, v in metrics.items()}
        params, opt_state, opt_stats = opt.adamw_update(params, grads, opt_state, opt_cfg)
        params = _tree.tree_map(lambda p: p.requires_grad_(), params)
        metrics.update(opt_stats)
        metrics["loss"] = loss
        return params, opt_state, new_err, metrics

    return step
