"""Fused bilinear MTTKRP: the KRP tile is formed on chip, never in HBM.

Port of ``repro.kernels.fused_mttkrp.fused_mttkrp_bilinear`` and
``fused_mttkrp_bilinear_batched``.  Computes

    pos=0:  M[i,c] = sum_{a,b} T[i,a,b] * A[a,c] * B[b,c]
    pos=1:  M[i,c] = sum_{a,b} T[a,i,b] * A[a,c] * B[b,c]
    pos=2:  M[i,c] = sum_{a,b} T[a,b,i] * A[a,c] * B[b,c]

where ``T`` is a free 3-D view of the tensor and ``A``/``B`` are the two
partial KRPs :func:`repro_torch.kernels.ops.fused_mttkrp` builds; the
batched form computes the same per slab ``s`` of a stack, ``M[s,i,c]`` from
``T[s]``, ``A[s]``, ``B[s]``.  That is the order-3 matrix-free fold of the
view at mode ``pos``, with ``A`` in the one outer slot and ``B`` in the
contracted one (:data:`FOLD_MODES`), so on the card the wrappers launch the
port's one Hopper MTTKRP body (``csrc/mttkrp_cluster.cuh``) through the
entries of ``csrc/fused_mttkrp.cu``, with the matrix-free kernels' launch
geometry of the view (:func:`launch_geometry`); the design notes are in
those files.  On the CPU they take the ``*_plain`` versions.

Operands are float32, bfloat16, float16 or float64, all of one dtype.  The
kernel reads them at their own width and sums in fp32; it and the plain
versions (the einsum on the operands cast to float32) return float32, as
the reference's kernel declares a float32 output whatever it reads.  The
reference forms each KRP tile and each step's product in the operands'
dtype, so in 16 bits it is less precise than the fp32 fold here.
"""

from __future__ import annotations

import ctypes

import torch

from . import matrix_free as mf
from ._build import CudaKernel
from ._tiling import (
    BLOCKS_PER_SM,
    check_rank,
    check_slabs,
    kernel_suffix,
    reference_tiles,
    use_kernel,
)

Tensor = torch.Tensor

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "fused_mttkrp.cu",
    "fused_mttkrp_bilinear_f32",
    [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _c64, _c64, _c64, _int, _int, _int, _c64, _int, _ptr],
    mf.TYPED_SOURCES,
)
BATCHED_KERNEL = CudaKernel(
    "fused_mttkrp.cu",
    "fused_mttkrp_bilinear_batched_f32",
    [_ptr, _ptr, _ptr, _ptr, _int, _int, _c64, _c64, _c64, _int, _int, _c64, _int, _ptr],
    mf.TYPED_SOURCES,
)

# The order-3 fold of the view at each pos: (target mode, A's mode, B's
# mode).  B's is the mode the fold contracts first, the highest one other
# than pos (matrix_free.contracted_mode(3, pos)); A's is the outer mode.
FOLD_MODES = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}

_SPECS = {0: "iab,ac,bc->ic", 1: "aib,ac,bc->ic", 2: "abi,ac,bc->ic"}
_BATCHED_SPECS = {0: "siab,sac,sbc->sic", 1: "saib,sac,sbc->sic", 2: "sabi,sac,sbc->sic"}


def _f32(*ts: Tensor) -> list[Tensor]:
    return [t.to(torch.float32) for t in ts]


def fused_mttkrp_bilinear_plain(t: Tensor, a: Tensor, b: Tensor, *, pos: int) -> Tensor:
    """The plain PyTorch version: the bilinear einsum on the operands cast
    to float32 (float32 out)."""
    return torch.einsum(_SPECS[pos], *_f32(t, a, b))


def fused_mttkrp_bilinear_batched_plain(
    t: Tensor, a: Tensor, b: Tensor, *, pos: int
) -> Tensor:
    """The plain PyTorch version of the batched kernel: the bilinear einsum
    with a leading slab axis on every operand, cast to float32."""
    return torch.einsum(_BATCHED_SPECS[pos], *_f32(t, a, b))


def _dims(t: Tensor, a: Tensor, b: Tensor, pos: int, lead: int) -> int:
    """Validate the bilinear operands (``lead`` slab axes in front of each);
    return the output row count."""
    if t.ndim != 3 + lead:
        raise ValueError("t must be a 3-D view" + (" with a leading slab axis" if lead else ""))
    if pos not in _SPECS:
        raise ValueError(f"pos must be 0, 1 or 2, got {pos}")
    if a.ndim != 2 + lead or b.ndim != 2 + lead or a.shape[-1] != b.shape[-1]:
        want = "(S, dim, C)" if lead else "(dim, C)"
        raise ValueError(f"A {tuple(a.shape)} and B {tuple(b.shape)} must be {want}")
    if lead and not t.shape[0] == a.shape[0] == b.shape[0]:
        raise ValueError(f"slab mismatch: t {tuple(t.shape)}, A {tuple(a.shape)}, B {tuple(b.shape)}")
    shape = list(t.shape[lead:])
    dim_i = shape.pop(pos)
    if shape != [a.shape[-2], b.shape[-2]]:
        raise ValueError(
            f"t shape {tuple(t.shape)} inconsistent with A/B {tuple(a.shape)}/{tuple(b.shape)}"
        )
    return dim_i


def launch_geometry(
    view: tuple[int, int, int], pos: int, rank: int, slabs: int | None = None,
    blocks_per_sm: int = BLOCKS_PER_SM, itemsize: int = 4,
) -> mf.ClusterLaunch:
    """The launch of the fold of a 3-D ``view`` at mode ``pos`` and
    ``rank``, from the shape and the operands' ``itemsize`` alone (cached):
    the matrix-free kernels'
    :func:`~repro_torch.kernels.matrix_free.unbatched_launch_shape` for one
    view (``slabs`` None), :func:`~repro_torch.kernels.matrix_free.launch_shape`
    for a stack of ``slabs``.  ``blocks_per_sm`` caps the CTAs an SM is
    counted to hold, as there."""
    if slabs is None:
        return mf.unbatched_launch_shape(view, pos, rank, blocks_per_sm, itemsize)
    return mf.launch_shape(view, pos, rank, slabs, blocks_per_sm, itemsize)


def _launch(t: Tensor, a: Tensor, b: Tensor, pos: int, dim_i: int, slabs: int | None,
            blocks_per_sm: int) -> Tensor:
    """Check the operands and launch the unbatched entry (``slabs`` None;
    with more than one group also its pass over the workspace) or the
    batched one.  Returns a float32 ``(I, C)`` or ``(S, I, C)``."""
    c = a.shape[-1]
    suffix = kernel_suffix(("t", t), ("A", a), ("B", b))
    check_rank(c)
    view = tuple(int(d) for d in t.shape[-3:])
    itemsize = t.element_size()
    t_ptr = t.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(t.device.index)
    if slabs is None:
        g = launch_geometry(view, pos, c, None, blocks_per_sm, itemsize)
        out = t.new_empty((dim_i, c), dtype=torch.float32)
        ws_shape = mf.workspace_shape(g, dim_i, c)
        ws = None if ws_shape is None else t.new_empty(ws_shape, dtype=torch.float32)
        KERNEL.launch(
            t_ptr, a.data_ptr(), b.data_ptr(), None if ws is None else ws.data_ptr(),
            out.data_ptr(), pos, *view, c, g.groups, g.splits, g.q_chunk,
            int(g.vec and t_ptr % 16 == 0),  # a contiguous view may start off a 16-byte line
            stream, suffix=suffix,
        )
        return out
    check_slabs(slabs)
    g = launch_geometry(view, pos, c, slabs, blocks_per_sm, itemsize)
    out = t.new_empty((slabs, dim_i, c), dtype=torch.float32)
    BATCHED_KERNEL.launch(
        t_ptr, a.data_ptr(), b.data_ptr(), out.data_ptr(), pos, slabs, *view, c, g.splits,
        g.q_chunk, int(g.vec and t_ptr % 16 == 0), stream, suffix=suffix,
    )
    return out


def fused_mttkrp_bilinear(
    t: Tensor,
    a: Tensor,
    b: Tensor,
    *,
    pos: int,
    block_i: int | None = None,
    block_b: int | None = None,
    interpret: bool = False,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """``M[i,c] = sum_{a,b} T * A[a,c] * B[b,c]`` with T's i-axis at ``pos``.

    CUDA tensors launch the kernel (contiguous operands of one dtype of
    ``KERNEL_DTYPES`` at any rank >= 1, a rank above 64 in column blocks of
    the one launch; else it raises): one launch of the fold's body, plus a
    pass that
    adds the groups' partials in a fixed order where the launch has more
    than one group.  CPU tensors take the plain version.  Both return
    float32.  Any extent is accepted: the kernel masks ragged tiles, so
    nothing is padded.
    ``blocks_per_sm`` caps the CTAs an SM is counted to hold when
    :func:`launch_geometry` sizes the launch (at or above the kernel's
    residency, 2 at rank <= 32, it changes nothing); the plain version
    ignores it.  ``block_i``, ``block_b`` and ``interpret`` are the
    reference's keywords, taken for its signature: the CUDA tiles are fixed
    at compile time, so the tile sizes change nothing, and ``interpret``
    never decides the device (a CUDA tensor launches the kernel even with
    ``interpret=True``).
    """
    reference_tiles(block_i=block_i, block_b=block_b)
    dim_i = _dims(t, a, b, pos, 0)
    if not use_kernel(t, a, b):
        return fused_mttkrp_bilinear_plain(t, a, b, pos=pos)
    return _launch(t, a, b, pos, dim_i, None, blocks_per_sm)


def fused_mttkrp_bilinear_batched(
    t: Tensor,
    a: Tensor,
    b: Tensor,
    *,
    pos: int,
    block_i: int | None = None,
    block_b: int | None = None,
    block_batch: int | None = None,
    interpret: bool = False,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> Tensor:
    """Batched bilinear MTTKRP ``M[s,i,c] = sum_{a,b} T[s,...] A[s,a,c] B[s,b,c]``.

    ``t`` is ``(S, *3-D view)`` with the i-axis of each slab's view at
    ``pos``; ``a``/``b`` are the per-slab partial KRPs ``(S, dim, C)``.
    CUDA tensors make one launch of the kernel, one slab per grid z
    (contiguous operands of one dtype of ``KERNEL_DTYPES`` at any rank >= 1,
    1..65535 slabs, else it raises): no workspace, the split summed on chip.
    CPU tensors take the plain version.  Both return float32.  Nothing is
    padded: not the slabs, not any extent.
    ``blocks_per_sm``, ``block_i``, ``block_b`` and ``interpret`` as in
    :func:`fused_mttkrp_bilinear`; ``block_batch``, the reference's slab
    tile, changes nothing either (every slab is its own z block).
    """
    reference_tiles(block_i=block_i, block_b=block_b, block_batch=block_batch)
    dim_i = _dims(t, a, b, pos, 1)
    if not use_kernel(t, a, b):
        return fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos)
    return _launch(t, a, b, pos, dim_i, int(t.shape[0]), blocks_per_sm)
