"""Fused bilinear MTTKRP: the KRP tile is formed on chip, never in HBM.

Port of ``repro.kernels.fused_mttkrp.fused_mttkrp_bilinear`` and
``fused_mttkrp_bilinear_batched``.  Computes

    pos=0:  M[i,c] = sum_{a,b} T[i,a,b] * A[a,c] * B[b,c]
    pos=1:  M[i,c] = sum_{a,b} T[a,i,b] * A[a,c] * B[b,c]
    pos=2:  M[i,c] = sum_{a,b} T[a,b,i] * A[a,c] * B[b,c]

where ``T`` is a free 3-D view of the tensor and ``A``/``B`` are the two
partial KRPs :func:`repro_torch.kernels.ops.fused_mttkrp` builds; the
batched form computes the same per slab ``s`` of a stack, ``M[s,i,c]`` from
``T[s]``, ``A[s]``, ``B[s]``.  On the card the wrappers launch the CUDA
kernel of ``csrc/fused_mttkrp.cu``: each thread block forms the tile
``A[a, :] * B[b-tile, :]`` in shared memory and contracts the streamed
tensor tile against it; the design notes are in that file.  On the CPU
they take the ``*_plain`` versions.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from ._tiling import (
    BLOCKS_PER_SM,
    check_kernel_operand,
    check_rank,
    check_slabs,
    reference_tiles,
    split_reduction,
    use_kernel,
)

Tensor = torch.Tensor

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "fused_mttkrp.cu",
    "fused_mttkrp_bilinear_f32",
    [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _c64, _c64, _c64, _int, _c64, _int, _ptr],
)
BATCHED_KERNEL = CudaKernel(
    "fused_mttkrp.cu",
    "fused_mttkrp_bilinear_batched_f32",
    [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _c64, _c64, _c64, _int, _c64, _int, _ptr],
)

_SPECS = {0: "iab,ac,bc->ic", 1: "aib,ac,bc->ic", 2: "abi,ac,bc->ic"}
_BATCHED_SPECS = {0: "siab,sac,sbc->sic", 1: "saib,sac,sbc->sic", 2: "sabi,sac,sbc->sic"}


def fused_mttkrp_bilinear_plain(t: Tensor, a: Tensor, b: Tensor, *, pos: int) -> Tensor:
    """The plain PyTorch version: the bilinear einsum."""
    return torch.einsum(_SPECS[pos], t, a, b)


def fused_mttkrp_bilinear_batched_plain(
    t: Tensor, a: Tensor, b: Tensor, *, pos: int
) -> Tensor:
    """The plain PyTorch version of the batched kernel: the bilinear einsum
    with a leading slab axis on every operand."""
    return torch.einsum(_BATCHED_SPECS[pos], t, a, b)


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


def launch_split(
    dim_i: int, dim_a: int, device, slabs: int | None = None, *,
    blocks_per_sm: int = BLOCKS_PER_SM,
) -> tuple[int, int]:
    """``(a per split, splits)`` of a launch with ``dim_i`` output rows and
    ``dim_a`` rows of ``A`` (the split reduction), per slab when batched."""
    return split_reduction(dim_i, dim_a, device, slabs or 1, blocks_per_sm=blocks_per_sm)


def _launch(kernel: CudaKernel, t: Tensor, a: Tensor, b: Tensor, pos: int, dim_i: int,
            slabs: int | None, blocks_per_sm: int) -> Tensor:
    """Check the operands and launch ``kernel``; ``slabs`` is ``None`` for
    the unbatched entry point.  Returns ``(I, C)`` or ``(S, I, C)``."""
    c = a.shape[-1]
    check_kernel_operand("t", t)
    check_kernel_operand("A", a)
    check_kernel_operand("B", b)
    check_rank(c)
    lead = () if slabs is None else (slabs,)
    if slabs is not None:
        check_slabs(slabs)
    a_per_split, splits = launch_split(
        dim_i, a.shape[-2], t.device, slabs, blocks_per_sm=blocks_per_sm
    )
    ws = torch.empty(lead + (splits, dim_i, c), dtype=torch.float32, device=t.device)
    out = torch.empty(lead + (dim_i, c), dtype=torch.float32, device=t.device)
    d0, d1, d2 = (int(d) for d in t.shape[-3:])
    kernel.launch(
        t.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(), out.data_ptr(),
        pos, *lead, d0, d1, d2, c, a_per_split, splits,
        torch.cuda.current_stream(t.device).cuda_stream,
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

    CUDA tensors launch the kernel (contiguous float32 operands, rank up to
    64, else it raises); CPU tensors take the plain version.  Any extent is
    accepted: the kernel masks ragged tiles, so nothing is padded.
    ``blocks_per_sm`` sizes the split of the ``a`` reduction
    (:func:`~repro_torch.kernels._tiling.split_reduction`); the plain
    version ignores it.  ``block_i``, ``block_b`` and ``interpret`` are the
    reference's keywords, taken for its signature: the CUDA tiles are fixed
    at compile time, so the tile sizes change nothing, and ``interpret``
    never decides the device (a CUDA tensor launches the kernel even with
    ``interpret=True``).
    """
    reference_tiles(block_i=block_i, block_b=block_b)
    dim_i = _dims(t, a, b, pos, 0)
    if not use_kernel(t, a, b):
        return fused_mttkrp_bilinear_plain(t, a, b, pos=pos)
    return _launch(KERNEL, t, a, b, pos, dim_i, None, blocks_per_sm)


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
    CUDA tensors launch the kernel, one slab per block along the grid's z
    axis (contiguous float32 operands, rank up to 64, 1..65535 slabs, else
    it raises); CPU tensors take the plain version.  Nothing is padded: not
    the slabs, not any extent.  ``blocks_per_sm``, ``block_i``, ``block_b``
    and ``interpret`` as in :func:`fused_mttkrp_bilinear`; ``block_batch``,
    the reference's slab tile, changes nothing either (every slab is its
    own z block).
    """
    reference_tiles(block_i=block_i, block_b=block_b, block_batch=block_batch)
    dim_i = _dims(t, a, b, pos, 1)
    if not use_kernel(t, a, b):
        return fused_mttkrp_bilinear_batched_plain(t, a, b, pos=pos)
    return _launch(BATCHED_KERNEL, t, a, b, pos, dim_i, int(t.shape[0]), blocks_per_sm)
