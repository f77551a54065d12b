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
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Sequence

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Model code names logical axes; they resolve against the ambient mesh:
#   "fsdp", "dp"    -> the data axes (("pod", "data") or ("data",))
#   "tp", "expert"  -> "model"
#   None            -> replicated
SHARDED_LM = ("the sharded LM is not ported yet (ROADMAP.md queue 1: the sharded LM); "
              "run the LM on one device")

_MESH: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None
)


def _mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device: str) -> DeviceMesh:
    return init_device_mesh(device, tuple(int(s) for s in shape), mesh_dim_names=tuple(axis_names))


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
def use_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the ambient mesh of the model code inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> DeviceMesh | None:
    return _MESH.get()


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


def constraint(x, *logical: Any):
    """The reference's sharding constraint: the identity with no ambient
    mesh or a mesh of one rank; a larger mesh raises (the sharded LM)."""
    mesh = current_mesh()
    if mesh is None or mesh.size() == 1:
        return x
    raise NotImplementedError(SHARDED_LM)


def tp_size(mesh: DeviceMesh | None = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index("model")))
