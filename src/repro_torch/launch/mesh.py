"""Device meshes for the port's distributed CP-ALS.

Port of the mesh constructors of ``repro.launch.mesh`` that the tensor
algorithms use (the LM's logical-axis plumbing comes with the LM
substrate).  A mesh is a ``torch.distributed`` DeviceMesh with named
dimensions over the ranks of the default process group, which the
caller starts (``torch.distributed.init_process_group``, given its
address, world size and rank); each named dimension has its process group
(``mesh.get_group(name)``), over which the port's reductions run.

The device type follows the tensors: ``"cuda"`` (one card a rank, NCCL)
unless the caller asks for ``"cpu"`` (gloo).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


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
