"""``Problem``: the immutable descriptor every planner/executor call keys on.

Port of ``repro.plan.problem``: the same fields, validation and
:meth:`Problem.signature` layout, so one problem gives the same signature
string in both packages.  ``dtype`` may be a ``torch.dtype``.

A Problem captures everything the analytic cost model needs -- tensor shape,
CP rank, element dtype, and (for sharded problems) the mode -> mesh-axis
mapping plus the mesh axis sizes.  It deliberately does NOT hold the tensor
or the mesh object itself: planning is pure arithmetic on static metadata,
so plans can be built for hardware that isn't attached (capacity planning,
dry-runs) and inside ``jit`` traces (shapes are static under tracing).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from repro_torch.analysis.roofline import dtype_itemsize


def _axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh (whose ``shape`` is a tuple of
    sizes, in the order of ``mesh_dim_names``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class Problem:
    """Descriptor of one CP-ALS / MTTKRP problem.

    ``mode_axes`` maps tensor modes to mesh axis names (the block
    distribution of ``repro.dist``); ``axis_sizes`` maps each mesh axis name
    to its device count.  Both empty means a single-device problem.

    ``batch`` stacks B same-shaped tensors along a leading axis (default 1:
    a single tensor, and every array keeps its classic unbatched rank).
    ``batch_axes`` names the mesh axes the batch is sharded over -- the
    third mesh-axis role next to mode axes: batch entries never contract
    against each other, so a pure batch-parallel placement moves zero
    reduce traffic while a mode-parallel placement pays psum volume x B.

    ``intra_axes`` declares a *two-level* mesh topology: the named axes span
    the devices within one node (fast ICI), every other mesh axis crosses
    nodes (slow DCN).  Empty (the default) means a flat single-level network
    -- all collective traffic is priced at ICI bandwidth and nothing about
    planning changes.  Non-empty, the cost model prices intra- and
    inter-node wire volume separately, the planner enumerates alternative
    mode -> axis mappings against the Ballard-Knight-Rouse communication
    lower bound, and executors may complete psums hierarchically
    (:func:`repro.dist.collectives.hierarchical_psum`).

    ``pp_tol`` opts into pairwise-perturbation sweeps (Ma & Solomonik,
    arXiv 2010.12056): while every factor's relative drift since the last
    exact sweep stays below it, MTTKRPs are approximated from cached
    pairwise intermediates plus first-order corrections.  The default 0.0
    disables the approximation entirely -- the sweep engine then runs the
    classic exact path with *bitwise identical* iterates by construction.
    """

    shape: tuple[int, ...]
    rank: int
    dtype: Any = "float32"
    mode_axes: Mapping[int, str] = field(default_factory=dict)
    axis_sizes: Mapping[str, int] = field(default_factory=dict)
    batch: int = 1
    batch_axes: tuple[str, ...] = ()
    pp_tol: float = 0.0
    intra_axes: tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "rank", int(self.rank))
        object.__setattr__(
            self, "mode_axes", {int(m): str(a) for m, a in dict(self.mode_axes).items()}
        )
        object.__setattr__(
            self, "axis_sizes", {str(a): int(s) for a, s in dict(self.axis_sizes).items()}
        )
        object.__setattr__(self, "batch", int(self.batch))
        object.__setattr__(
            self, "batch_axes", tuple(str(a) for a in self.batch_axes)
        )
        object.__setattr__(self, "pp_tol", float(self.pp_tol))
        object.__setattr__(
            self, "intra_axes", tuple(str(a) for a in self.intra_axes)
        )
        self._validate()

    def __hash__(self):
        # the generated frozen-dataclass hash would include the dict fields
        # (unhashable); hash the canonical projections instead so plans can
        # be cached/memoized keyed on the Problem
        return hash(
            (
                self.shape,
                self.rank,
                self.dtype_str,
                tuple(sorted(self.mode_axes.items())),
                tuple(sorted(self.axis_sizes.items())),
                self.batch,
                self.batch_axes,
                self.pp_tol,
                self.intra_axes,
            )
        )

    def _validate(self) -> None:
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if not self.pp_tol >= 0.0:  # also rejects NaN
            raise ValueError(f"pp_tol must be >= 0, got {self.pp_tol}")
        self.itemsize  # fail at construction on an unresolvable dtype
        mode_axis_names = set(self.mode_axes.values())
        for axis in self.batch_axes:
            if axis not in self.axis_sizes:
                raise ValueError(
                    f"no size known for batch mesh axis {axis!r} "
                    f"(axes: {sorted(self.axis_sizes)})"
                )
            if axis in mode_axis_names:
                raise ValueError(
                    f"mesh axis {axis!r} cannot shard both a mode and the batch"
                )
        if len(set(self.batch_axes)) != len(self.batch_axes):
            raise ValueError(f"duplicate batch axes in {self.batch_axes}")
        if len(set(self.intra_axes)) != len(self.intra_axes):
            raise ValueError(f"duplicate intra axes in {self.intra_axes}")
        for axis in self.intra_axes:
            if axis not in self.axis_sizes:
                raise ValueError(
                    f"no size known for intra-node mesh axis {axis!r} "
                    f"(axes: {sorted(self.axis_sizes)})"
                )
        if self.batch % self.batch_shards:
            raise ValueError(
                f"batch {self.batch} not divisible by the "
                f"{self.batch_shards} devices of batch axes {self.batch_axes}"
            )
        seen: dict[str, int] = {}
        for mode, axis in self.mode_axes.items():
            if not 0 <= mode < self.ndim:
                raise ValueError(
                    f"mode {mode} out of range for order-{self.ndim} tensor"
                )
            if axis not in self.axis_sizes:
                raise ValueError(
                    f"no size known for mesh axis {axis!r} "
                    f"(axes: {sorted(self.axis_sizes)})"
                )
            if axis in seen:
                raise ValueError(
                    f"mesh axis {axis!r} mapped to modes {seen[axis]} and {mode}"
                )
            seen[axis] = mode
            if self.shape[mode] % self.axis_sizes[axis]:
                raise ValueError(
                    f"mode {mode} dim {self.shape[mode]} not divisible by "
                    f"axis {axis!r} size {self.axis_sizes[axis]}"
                )

    @classmethod
    def from_tensor(
        cls, x, rank: int, mode_axes=None, mesh=None, *, batch=1, batch_axes=(),
        pp_tol: float = 0.0, intra_axes=(),
    ) -> "Problem":
        """Build a Problem from an array (or tracer / ShapeDtypeStruct).

        Pass ``mode_axes`` + ``mesh`` (a ``torch.distributed`` DeviceMesh
        with named dimensions) for a block-distributed problem; the mesh
        contributes only its axis sizes (the object stays with the
        executor).  With ``batch=B > 1`` the array's leading axis is the
        batch (``x.shape[0] == B``) and the tensor shape is ``x.shape[1:]``;
        ``batch_axes`` optionally shards that axis over mesh axes.
        ``pp_tol > 0`` opts into pairwise-perturbation sweeps and
        ``intra_axes`` declares the mesh axes spanning one node of a
        two-level topology (see the class docstring).
        """
        batch = int(batch)
        shape = tuple(x.shape)
        if batch > 1:
            if not shape or shape[0] != batch:
                raise ValueError(
                    f"leading axis {shape[:1]} does not match batch={batch}"
                )
            shape = shape[1:]
        return cls(
            shape=shape,
            rank=rank,
            dtype=x.dtype,
            mode_axes=mode_axes or {},
            axis_sizes=_axis_sizes(mesh) if mesh is not None else {},
            batch=batch,
            batch_axes=tuple(batch_axes),
            pp_tol=pp_tol,
            intra_axes=tuple(intra_axes),
        )

    # ------------------------------------------------------------- derived
    @property
    def ndim(self) -> int:
        """Tensor order (number of modes)."""
        return len(self.shape)

    @property
    def itemsize(self) -> float:
        """Bytes per element of ``dtype``.

        ``dtype_itemsize`` also accepts HLO-style ('bf16') and numpy-name
        ('bfloat16') strings, matching ``analysis.roofline.mttkrp_roofline``.
        """
        return float(dtype_itemsize(self.dtype))

    @property
    def dtype_str(self) -> str:
        """Canonical dtype name for describe()/JSON output: ``torch.float32``
        and ``np.float32`` both give ``"float32"``."""
        if isinstance(self.dtype, torch.dtype):
            return str(self.dtype).removeprefix("torch.")
        try:
            return str(np.dtype(self.dtype))
        except TypeError:
            return str(self.dtype)  # HLO-style names np.dtype can't resolve

    @property
    def sharded(self) -> bool:
        """True when any mode or the batch is mapped to a mesh axis."""
        return bool(self.mode_axes) or bool(self.batch_axes)

    @property
    def batched(self) -> bool:
        """True when the problem stacks more than one tensor (batch > 1)."""
        return self.batch > 1

    @property
    def batch_shards(self) -> int:
        """Device count the batch axis is split over (1 when unsharded)."""
        p = 1
        for axis in self.batch_axes:
            p *= self.axis_sizes[axis]
        return p

    @property
    def local_batch(self) -> int:
        """Per-device batch extent under the ``batch_axes`` distribution."""
        return self.batch // self.batch_shards

    @property
    def intra_shards(self) -> int:
        """Devices per node (product of ``intra_axes`` sizes; 1 when flat)."""
        p = 1
        for axis in self.intra_axes:
            p *= self.axis_sizes[axis]
        return p

    @property
    def n_nodes(self) -> int:
        """Node count of a two-level mesh: the product of every non-intra
        mesh axis size (1 when the topology is flat or single-node)."""
        if not self.intra_axes:
            return 1
        p = 1
        for axis, size in self.axis_sizes.items():
            if axis not in self.intra_axes:
                p *= size
        return p

    @property
    def node_axis(self) -> str | None:
        """The intra-node mesh axis executors reduce-scatter over --
        the first of ``intra_axes``, ``None`` for flat topologies."""
        return self.intra_axes[0] if self.intra_axes else None

    def signature(
        self, *, backend: str = "any", n_devices: int | None = None
    ) -> str:
        """THE canonical signature string of this problem.

        ``backend|shape|rank|dtype|devices`` (plus ``|b{B}`` for batched
        problems and ``|pp{tol}`` when pairwise perturbation is enabled;
        defaults keep the historical 5-field layout, so old on-disk keys
        keep resolving) -- the one key construction shared by the tuning
        cache
        (:func:`repro.plan.autotune.problem_key`, which fills in the live
        jax backend) and the serving engine's batch buckets
        (:class:`repro.serve.cp_service.CPService`): two problems with equal
        signatures are interchangeable in one compiled batched dispatch and
        comparable under one set of hardware measurements.

        ``n_devices`` defaults to the product of the problem's mesh axis
        sizes (1 when unsharded) -- NOT the runtime device count, so plans
        for detached hardware key consistently.
        """
        if n_devices is None:
            n_devices = (
                math.prod(self.axis_sizes.values()) if self.axis_sizes else 1
            )
        shape = "x".join(str(d) for d in self.shape)
        key = f"{backend}|{shape}|r{self.rank}|{self.dtype_str}|d{int(n_devices)}"
        if self.batch > 1:
            key += f"|b{self.batch}"
        if self.pp_tol > 0.0:
            key += f"|pp{self.pp_tol:g}"
        if self.intra_axes:
            # two-level topologies measure/bucket separately from flat ones
            # on the same device count (the collectives differ); flat
            # problems keep the historical layout so old keys resolve
            key += f"|node{self.intra_shards}"
        return key

    def mode_shards(self, n: int) -> int:
        """Device count along the axis of mode ``n`` (1 when unmapped)."""
        axis = self.mode_axes.get(n)
        return self.axis_sizes[axis] if axis is not None else 1

    @property
    def local_shape(self) -> tuple[int, ...]:
        """Per-device block dims under the ``mode_axes`` distribution."""
        return tuple(d // self.mode_shards(m) for m, d in enumerate(self.shape))

    def reduce_participants(self, keep_modes: Iterable[int]) -> int:
        """Devices participating in the psum that completes a contraction
        keeping only ``keep_modes`` -- the product of the axis sizes of every
        mapped mode that is contracted away."""
        keep = set(keep_modes)
        p = 1
        for mode in self.mode_axes:
            if mode not in keep:
                p *= self.mode_shards(mode)
        return p

    def reduce_axes_for(self, n: int) -> tuple[str, ...]:
        """Mesh axes the mode-``n`` MTTKRP psums over, in mode order.

        These are the axes of every mapped mode other than ``n`` -- the
        contracted modes whose partial sums the collective completes.  Empty
        when mode ``n`` is the only mapped mode (the output rows ride its own
        axis; no collective is needed) or the problem is unsharded.  Matches
        the axis order :func:`repro.dist.dist_mttkrp.dist_mttkrp` reduces
        over, so cost terms and executors agree on the participant set.
        """
        return tuple(
            self.mode_axes[m] for m in sorted(self.mode_axes) if m != n
        )

    def external_mode(self, n: int) -> bool:
        """External modes (first/last) are where 2-step degenerates to 1-step."""
        return n in (0, self.ndim - 1)
