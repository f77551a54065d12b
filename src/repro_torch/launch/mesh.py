"""Device meshes and the LM's logical-axis plumbing.

Port of ``repro.launch.mesh``: the mesh constructors the tensor algorithms
use, and the ambient mesh and logical axes the LM's model code names.  A
mesh is a ``torch.distributed`` DeviceMesh with named
dimensions over the ranks of the default process group, which the
caller starts (``torch.distributed.init_process_group``, given its
address, world size and rank); each named dimension has its process group
(``mesh.get_group(name)``), over which the port's reductions run.

The device type follows the tensors: ``"cuda"`` (one card a rank, NCCL)
unless the caller asks for ``"cpu"`` (gloo).

The sharded LM runs SPMD over local blocks: on a mesh, each parameter leaf
of a rank is a plain tensor, this rank's block of the full leaf
(:class:`NamedSharding` cuts and assembles it), and the model code puts the
collectives where the reference's :func:`constraint` calls make GSPMD put
them (``repro_torch.dist.collectives``: ``tp_copy``, ``tp_sum``,
``sp_gather``, ``sp_scatter``).  :func:`constraint` itself is the identity
on the local block.  Inside :func:`manual_mode` the model code runs its
single-device path on whole parameters, as the reference's code inside
``shard_map`` does (the compressed data-parallel step).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import _tree

# Model code names logical axes; they resolve against the ambient mesh:
#   "fsdp", "dp"    -> the data axes (("pod", "data") or ("data",))
#   "tp", "expert"  -> "model"
#   None            -> replicated

_MESH: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None
)
_MANUAL: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_manual", default=False
)


@contextlib.contextmanager
def manual_mode():
    """Mark a region as per-rank code on whole parameters (the reference's
    code inside ``shard_map``): constraints are no-ops and the model code
    takes its single-device path, with no collective."""
    token = _MANUAL.set(True)
    try:
        yield
    finally:
        _MANUAL.reset(token)


def in_manual_mode() -> bool:
    return _MANUAL.get()


def _mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device: str) -> DeviceMesh:
    return init_device_mesh(device, tuple(int(s) for s in shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """The production mesh over the ranks of the default process group:
    ``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")`` with ``multi_pod``.  A larger world takes its first
    256 or 512 ranks.  The shapes are the reference's, so a cell is the
    same program; on H100 nodes of eight NVLink-joined GPUs a model axis of
    16 spans two nodes, so its collectives cross the slower inter-node
    links.  The dry-run (:mod:`repro_torch.launch.dryrun`) builds it in a
    fake world of 512 ranks."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == n:
        return _mesh(shape, axes, device)
    if world > n:
        return DeviceMesh(device, torch.arange(n).reshape(shape), mesh_dim_names=axes)
    raise RuntimeError(
        f"need {n} devices for mesh {shape}, have {world} -- start a world of "
        f"{n} ranks (repro_torch.launch.dryrun starts a fake one)"
    )


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda") -> DeviceMesh:
    """``(data, model)`` mesh over the ranks of the default process group,
    the two-axis mesh the reference's cases build."""
    return _mesh((data, model), ("data", "model"), device)


def make_node_mesh(
    nodes: int,
    devices_per_node: int,
    *,
    axis_names: tuple[str, str] = ("node", "device"),
    device: str = "cuda",
) -> DeviceMesh:
    """Two-level ``(nodes, devices_per_node)`` mesh.

    Axis ``axis_names[0]`` (default ``"node"``) spans the nodes,
    ``axis_names[1]`` (default ``"device"``) the devices within one node:
    consecutive ranks share a node, as a launcher numbers them.  Pair it
    with ``Problem(intra_axes=(axis_names[1],))``: the planner then prices
    each reduction's two levels apart and may pick the hierarchical
    collective, which reduce-scatters over ``axis_names[1]``.
    """
    return _mesh((nodes, devices_per_node), tuple(axis_names), device)


@contextlib.contextmanager
def host_world(device: str | torch.device = "cuda"):
    """A default process group for the block: the caller's when one is
    started, else one from a launcher's environment (``RANK`` set, as
    ``torchrun`` sets it), else a world of one over a file store in a
    temporary directory (no TCP port).  NCCL for a CUDA ``device``, gloo
    otherwise; a group started here is destroyed on exit.  The examples
    build their ``make_host_mesh`` on it, where the reference's single
    process sees its devices without one."""
    import os
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=0,
                                    world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the ambient mesh of the model code inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> DeviceMesh | None:
    return _MESH.get()


def carry(fn):
    """``fn`` run under the ambient mesh and manual mode in force now, on
    whichever thread calls it.  The autograd engine runs a CUDA tensor's
    backward pass, and so a remat's recompute, on a thread of its own,
    where this thread's context variables are unset: without this the
    recompute would take the single-device path."""
    mesh, manual = current_mesh(), in_manual_mode()

    def run(*args, **kwargs):
        t_mesh, t_manual = _MESH.set(mesh), _MANUAL.set(manual)
        try:
            return fn(*args, **kwargs)
        finally:
            _MANUAL.reset(t_manual)
            _MESH.reset(t_mesh)

    return run


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def dp_spec_entry(mesh: DeviceMesh):
    """The data-parallel axes as one spec entry: a tuple when the batch dim
    is sharded over several mesh axes, the bare name otherwise."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def resolve_logical(logical: Sequence[Any] | None, mesh: DeviceMesh) -> tuple:
    """Map a tuple of logical axis names to mesh axis names, one entry a dim
    (the reference's ``PartitionSpec`` entries, as a plain tuple)."""
    if logical is None:
        return ()
    out: list[Any] = []
    for ax in logical:
        if ax is None:
            out.append(None)
        elif ax in ("fsdp", "dp"):
            out.append(dp_spec_entry(mesh))
        elif ax in ("tp", "expert"):
            out.append("model")
        else:
            raise ValueError(f"unknown logical axis {ax!r}")
    return tuple(out)


class PartsSpec(tuple):
    """A resolved spec (equal to the plain tuple of its entries) of a leaf
    whose last dim is ``parts`` equal parts laid end to end: a sharding cuts
    each part into its blocks, and a rank's block of that dim is its block
    of each part, in part order."""

    def __new__(cls, entries, parts: int):
        spec = super().__new__(cls, entries)
        spec.parts = int(parts)
        return spec


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on ``mesh``: ``spec`` one entry a dim (a mesh axis
    name, a tuple of names with the first the most significant, or
    ``None``), as :func:`resolve_logical` gives it.  A sharded dim must
    divide by the product of its axes' sizes; block ``i`` of it (``i``
    row-major over this rank's coordinates on those axes) is this rank's.
    With ``parts > 1`` the last dim is that many equal parts laid end to
    end, each cut into its blocks: a rank's block of it is its block of
    every part, concatenated in part order."""

    mesh: Any
    spec: tuple
    parts: int = 1

    @classmethod
    def of(cls, mesh, spec) -> "NamedSharding":
        """The sharding of a resolved ``spec`` (a tuple, a
        :class:`PartsSpec` or ``None``) on ``mesh``."""
        return cls(mesh, tuple(spec or ()), getattr(spec, "parts", 1))

    def _axes(self, d: int) -> tuple[str, ...]:
        entry = self.spec[d] if d < len(self.spec) else None
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def _split(self, d: int) -> tuple[int, int]:
        """``(number of blocks, this rank's block)`` along dim ``d``."""
        axes = self._axes(d)
        if not axes:
            return 1, 0
        names = tuple(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate()
        n, i = 1, 0
        for a in axes:
            k = names.index(a)
            size = int(self.mesh.size(k))
            n, i = n * size, i * size + int(coord[k])
        return n, i

    def block_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of a rank's block of a leaf of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the leaf's {len(shape)} dims")
        out = []
        for d, extent in enumerate(shape):
            n, _ = self._split(d)
            k = self.parts if d == len(shape) - 1 else 1
            if extent % (n * k):
                raise ValueError(f"dim {d} of extent {extent} does not divide over "
                                 f"{self._axes(d)} ({n} blocks{f' of {k} parts' if k > 1 else ''})")
            out.append(extent // n)
        return tuple(out)

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor ``x`` (its own storage)."""
        self.block_shape(x.shape)
        out = x
        for d in range(x.ndim):
            n, i = self._split(d)
            if n > 1 and d == x.ndim - 1 and self.parts > 1:
                step = x.shape[d] // (n * self.parts)
                out = torch.cat([part.narrow(d, i * step, step)
                                 for part in out.chunk(self.parts, d)], d)
            elif n > 1:
                step = x.shape[d] // n
                out = out.narrow(d, i * step, step)
        return out.clone(memory_format=torch.contiguous_format) if out is not x else x

    def assemble(self, x: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block ``x`` (one counted
        gather an axis of each sharded dim; every rank gets the same
        bits)."""
        from repro_torch.dist.collectives import gather_cat  # the port's collectives

        for d in range(x.ndim):
            axes = self._axes(d)
            n = math.prod(int(self.mesh.size(self.mesh.mesh_dim_names.index(a))) for a in axes)
            if axes and n > 1:
                x = gather_cat(x, axes, self.mesh, dim=d)
                if d == x.ndim - 1 and self.parts > 1:  # rank-major blocks -> part-major
                    lead = x.shape[:-1]
                    x = x.reshape(*lead, n, self.parts, -1).transpose(-3, -2).reshape(*lead, -1)
        return x


def named_sharding(logical: Sequence[Any] | None, mesh: DeviceMesh | None = None
                   ) -> NamedSharding:
    """The logical spec resolved on ``mesh`` (default: the ambient one) as a
    :class:`NamedSharding`, which cuts a full tensor to this rank's block
    and assembles the blocks back."""
    mesh = mesh or current_mesh()
    assert mesh is not None, "no mesh in context"
    return NamedSharding(mesh, resolve_logical(logical, mesh))


def shard_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """Every leaf of the full ``tree`` cut to this rank's block by its spec
    in ``specs`` (a tree of resolved specs, as ``Model.partition_specs``
    gives it)."""
    return _tree.map_with_specs(lambda x, s: NamedSharding.of(mesh, s).cut(x), tree, specs)


def assemble_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """Every leaf of the blocks ``tree`` assembled to its full tensor, in
    the order of :func:`repro_torch._tree.leaves` on every rank."""
    return _tree.map_with_specs(lambda x, s: NamedSharding.of(mesh, s).assemble(x),
                                tree, specs)


def constraint(x, *logical: Any):
    """The reference's sharding constraint.  The port's tensors are local
    blocks and its layout changes are explicit collectives in the model
    code, so this is the identity on every mesh; the logical axes are
    checked against the ambient mesh."""
    mesh = current_mesh()
    if mesh is not None and not in_manual_mode():
        resolve_logical(logical, mesh)
    return x


def tp_size(mesh: DeviceMesh | None = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index("model")))


def active_mesh() -> DeviceMesh | None:
    """The ambient mesh when the model code runs on local blocks (not in
    :func:`manual_mode`), else ``None``: the single-device path."""
    mesh = current_mesh()
    return None if mesh is None or in_manual_mode() else mesh


def model_coord(mesh: DeviceMesh | None = None) -> tuple[int, int]:
    """``(size, this rank's index)`` of the ``"model"`` axis of ``mesh``
    (default: the active one); ``(1, 0)`` without one."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1, 0
    k = mesh.mesh_dim_names.index("model")
    return int(mesh.size(k)), int(mesh.get_coordinate()[k])


def dp_coord(mesh: DeviceMesh) -> tuple[int, int]:
    """``(size, this rank's index)`` of the data-parallel axes of ``mesh``,
    the index row-major over them (the first the most significant)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    n, i = 1, 0
    for a in dp_axes(mesh):
        k = names.index(a)
        size = int(mesh.size(k))
        n, i = n * size, i * size + int(coord[k])
    return n, i


def tp_active() -> int:
    """The model-axis size the model code shards over: the active mesh's,
    1 without one or in manual mode."""
    return model_coord()[0]


def driver_mesh(dp: int, tp: int, device: str, *,
                distributed: bool = False) -> tuple[DeviceMesh | None, torch.device]:
    """The mesh and device of a driver's ``--dp``/``--tp``/``--device``:
    ``(None, device)`` without a process group (``distributed`` starts one
    from a launcher's environment), else ``make_host_mesh(dp, tp)`` over the
    world, ``dp * tp`` equal to its size, a CUDA rank on the card
    ``LOCAL_RANK``.  Every family shards over ``"model"``."""
    import os

    import torch.distributed as dist

    if distributed and not dist.is_initialized():  # pragma: no cover -- a launcher's env
        dist.init_process_group()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp != world:
        raise ValueError(f"--dp {dp} x --tp {tp} must equal the world size {world} "
                         "(start the ranks with a launcher and --distributed)")
    dev = torch.device(device)
    if not dist.is_initialized():
        return None, dev
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return make_host_mesh(dp, tp, device=dev.type), dev

