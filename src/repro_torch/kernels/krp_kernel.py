"""Tiled Khatri-Rao product of two matrices (paper Alg. 1, parallel variant).

Port of ``repro.kernels.krp_kernel.krp_pair``.  Materializes
``K = A (.) B`` (``(J_A * J_B, C)``, ``A``'s index slow),

    K[ja * J_B + jb, c] = A[ja, c] * B[jb, c],

tile by tile: block ``(ja, jb-tile)`` owns ``block_b`` contiguous output
rows.  On the card :func:`krp_pair` launches the CUDA kernel of
``csrc/krp_pair.cu`` (design notes there); on the CPU it takes
:func:`krp_pair_plain`.  More than two factors are left-folded by
:func:`repro_torch.kernels.ops.krp_materialize`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import CudaKernel
from ._tiling import kernel_suffix, use_kernel

Tensor = torch.Tensor

# JB tiles of one launch: the grid's y limit.
MAX_TILES = 65535

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "krp_pair.cu", "krp_pair_f32", [_ptr, _ptr, _ptr, _c64, _c64, _int, _int, _ptr],
    {"bf16": "krp_pair.cu", "f16": "krp_pair.cu", "f64": "krp_pair.cu"},
)


def krp_pair_plain(a: Tensor, b: Tensor) -> Tensor:
    """The plain PyTorch version: the row-wise broadcast product, in the
    operands' dtype (each product rounded once to it)."""
    return (a[:, None, :] * b[None, :, :]).reshape(a.shape[0] * b.shape[0], a.shape[1])


def krp_pair(a: Tensor, b: Tensor, *, block_b: int, interpret: bool = False) -> Tensor:
    """KRP of two matrices: ``out[(ja, jb), c] = a[ja, c] * b[jb, c]``.

    ``a`` is ``(J_A, C)`` and ``b`` ``(J_B, C)``.  CUDA tensors launch the
    kernel with ``block_b`` output rows per thread block (contiguous
    operands of one dtype of ``KERNEL_DTYPES``, at most 65535 tiles of
    ``b``, else it raises); the last tile is masked, so nothing is padded.
    CPU tensors take the plain version.  Either returns the operands'
    dtype, each product rounded once to it, as the reference's kernel.  ``interpret`` is the reference's keyword; it never decides
    the device (a CUDA tensor launches the kernel even with
    ``interpret=True``).
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be matrices")
    if a.shape[1] != b.shape[1]:
        raise ValueError("factor column counts differ")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    if not use_kernel(a, b):
        return krp_pair_plain(a, b)
    suffix = kernel_suffix(("a", a), ("b", b))
    ja, jb, c = int(a.shape[0]), int(b.shape[0]), int(a.shape[1])
    if math.ceil(jb / block_b) > MAX_TILES:
        raise ValueError(f"{jb} rows of b in tiles of {block_b} exceed {MAX_TILES} tiles")
    out = a.new_empty((ja * jb, c))
    KERNEL.launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ja, jb, c, block_b,
        torch.cuda.current_stream(a.device).cuda_stream, suffix=suffix,
    )
    return out
