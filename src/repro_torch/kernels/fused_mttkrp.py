"""Fused bilinear MTTKRP: the KRP tile is formed on chip, never in HBM.

Port of ``repro.kernels.fused_mttkrp.fused_mttkrp_bilinear``.  Computes

    pos=0:  M[i,c] = sum_{a,b} T[i,a,b] * A[a,c] * B[b,c]
    pos=1:  M[i,c] = sum_{a,b} T[a,i,b] * A[a,c] * B[b,c]
    pos=2:  M[i,c] = sum_{a,b} T[a,b,i] * A[a,c] * B[b,c]

where ``T`` is a free 3-D view of the tensor and ``A``/``B`` are the two
partial KRPs :func:`repro_torch.kernels.ops.fused_mttkrp` builds.  On the
card the wrapper launches the CUDA kernel of ``csrc/fused_mttkrp.cu``: each
thread block forms the tile ``A[a, :] * B[b-tile, :]`` in shared memory and
contracts the streamed tensor tile against it; the design notes are in that
file.  On the CPU it takes :func:`fused_mttkrp_bilinear_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from ._tiling import check_kernel_operand, check_rank, split_reduction, use_kernel

Tensor = torch.Tensor

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "fused_mttkrp.cu",
    "fused_mttkrp_bilinear_f32",
    [_ptr, _ptr, _ptr, _ptr, _ptr, _int, _c64, _c64, _c64, _int, _c64, _int, _ptr],
)

_SPECS = {0: "iab,ac,bc->ic", 1: "aib,ac,bc->ic", 2: "abi,ac,bc->ic"}


def fused_mttkrp_bilinear_plain(t: Tensor, a: Tensor, b: Tensor, *, pos: int) -> Tensor:
    """The plain PyTorch version: the bilinear einsum."""
    return torch.einsum(_SPECS[pos], t, a, b)


def _dims(t: Tensor, a: Tensor, b: Tensor, pos: int) -> int:
    """Validate the bilinear operands; return the output row count."""
    if t.ndim != 3:
        raise ValueError("t must be a 3-D view")
    if pos not in _SPECS:
        raise ValueError(f"pos must be 0, 1 or 2, got {pos}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"A {tuple(a.shape)} and B {tuple(b.shape)} must be (dim, C)")
    shape = list(t.shape)
    dim_i = shape.pop(pos)
    if shape != [a.shape[0], b.shape[0]]:
        raise ValueError(
            f"t shape {tuple(t.shape)} inconsistent with A/B {tuple(a.shape)}/{tuple(b.shape)}"
        )
    return dim_i


def fused_mttkrp_bilinear(t: Tensor, a: Tensor, b: Tensor, *, pos: int) -> Tensor:
    """``M[i,c] = sum_{a,b} T * A[a,c] * B[b,c]`` with T's i-axis at ``pos``.

    CUDA tensors launch the kernel (contiguous float32 operands, rank up to
    64, else it raises); CPU tensors take the plain version.  Any extent is
    accepted: the kernel masks ragged tiles, so nothing is padded.
    """
    dim_i = _dims(t, a, b, pos)
    if not use_kernel(t, a, b):
        return fused_mttkrp_bilinear_plain(t, a, b, pos=pos)
    c = a.shape[1]
    check_kernel_operand("t", t)
    check_kernel_operand("A", a)
    check_kernel_operand("B", b)
    check_rank(c)
    a_per_split, splits = split_reduction(dim_i, a.shape[0], t.device)
    ws = torch.empty((splits, dim_i, c), dtype=torch.float32, device=t.device)
    out = torch.empty((dim_i, c), dtype=torch.float32, device=t.device)
    d0, d1, d2 = (int(d) for d in t.shape)
    KERNEL.launch(
        t.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(), out.data_ptr(),
        pos, d0, d1, d2, c, a_per_split, splits,
        torch.cuda.current_stream(t.device).cuda_stream,
    )
    return out
