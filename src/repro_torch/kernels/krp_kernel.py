"""Tiled Khatri-Rao product of two matrices (paper Alg. 1, parallel variant).

Port of ``repro.kernels.krp_kernel.krp_pair``.  Materializes
``K = A (.) B`` (``(J_A * J_B, C)``, ``A``'s index slow),

    K[ja * J_B + jb, c] = A[ja, c] * B[jb, c].

On the card :func:`krp_pair` launches the CUDA kernel of ``csrc/krp_pair.cu``
(design notes there): a block holds a fixed tile of B's row span in
registers and walks down A's rows, storing 16 bytes at a time; its geometry
is :func:`launch_shape`, from the shape alone.  On the CPU it takes
:func:`krp_pair_plain`.  More than two factors are left-folded by
:func:`repro_torch.kernels.ops.krp_materialize`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ._build import CudaKernel
from ._tiling import kernel_suffix, use_kernel

Tensor = torch.Tensor

THREADS = 256  # threads of a block (KRP_THREADS in csrc/krp_pair.cu)
SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4  # blocks resident on an SM (the kernel's __launch_bounds__)
UNIT_BYTES = 16  # bytes of one vector load or store
HELD = 8  # elements of B a thread holds in registers (KRP_HELD)

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "krp_pair.cu", "krp_pair_f32",
    [_ptr, _ptr, _ptr, _c64, _c64, _int, _int, _int, _int, _int, _int, _ptr],
    {"bf16": "krp_pair.cu", "f16": "krp_pair.cu", "f64": "krp_pair.cu"},
)
# Launches of the 16-byte instantiation, a part of KERNEL.launches (the rest
# took the one-element instantiation).
KERNEL.vector_launches = 0


class Launch(NamedTuple):
    vec: int  # elements a thread loads and stores at once: 16 bytes' worth, or 1
    per_thread: int  # vectors of B a thread holds (and stores a step)
    tile: int  # span positions a block owns: THREADS * per_thread * vec
    rows_per_step: int  # rows of A a step covers (g); their span is g * J_B * C
    tiles: int  # tiles across a step's span
    blocks: int  # grid x: tiles x walkers, each walker a strided set of row groups


@functools.lru_cache(maxsize=256)
def launch_shape(ja: int, jb: int, c: int, itemsize: int, aligned: bool) -> Launch:
    """The launch for ``A (ja, c) (.) B (jb, c)`` of ``itemsize``-byte
    elements, from the shape alone.  ``aligned``: B and K start on a
    16-byte line.

    The 16-byte path is taken when ``aligned`` and a row span ``jb * c``
    is a whole number of 16-byte units, else one element a store.  A step
    covers ``g`` rows of A, the most whose span fits one full tile (at
    least 1, at most ``ja``); a longer span is cut into the fewest tiles
    of at most ``HELD`` elements a thread, each thread given as few
    vectors as cover it.  The walkers over the ``ceil(ja / g)`` row
    groups fill ``SMS x BLOCKS_PER_SM`` blocks (fewer when there are fewer
    groups; at least one a tile)."""
    if min(ja, jb, c) < 1 or itemsize not in (2, 4, 8):
        raise ValueError(f"no KRP launch for ja={ja}, jb={jb}, c={c}, itemsize={itemsize}")
    row = jb * c
    vec = UNIT_BYTES // itemsize if aligned and row * itemsize % UNIT_BYTES == 0 else 1
    rows = min(ja, max(1, THREADS * HELD // row))
    vectors = rows * row // vec
    tiles = math.ceil(vectors / (THREADS * (HELD // vec)))
    per_thread = math.ceil(vectors / (tiles * THREADS))
    walkers = min(math.ceil(ja / rows), max(1, SMS * BLOCKS_PER_SM // tiles))
    return Launch(vec, per_thread, THREADS * per_thread * vec, rows, tiles, tiles * walkers)


def krp_pair_plain(a: Tensor, b: Tensor) -> Tensor:
    """The plain PyTorch version: the row-wise broadcast product, in the
    operands' dtype (each product rounded once to it)."""
    return (a[:, None, :] * b[None, :, :]).reshape(a.shape[0] * b.shape[0], a.shape[1])


def krp_pair(a: Tensor, b: Tensor, *, block_b: int, interpret: bool = False) -> Tensor:
    """KRP of two matrices: ``out[(ja, jb), c] = a[ja, c] * b[jb, c]``.

    ``a`` is ``(J_A, C)`` and ``b`` ``(J_B, C)``.  CUDA tensors launch the
    kernel once, at the geometry of :func:`launch_shape`, for any shape
    (contiguous operands of one dtype of ``KERNEL_DTYPES``, else it
    raises).  CPU tensors take the plain version.  Either returns the
    operands' dtype, each product rounded once to it, as the reference's
    kernel.  ``block_b`` is the reference's tile keyword: checked ``>= 1``,
    it sets nothing here (every element is independent, so no result
    depends on a tile).  ``interpret`` is the reference's keyword too; it
    never decides the device (a CUDA tensor launches the kernel even with
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
    (ja, c), jb = a.shape, b.shape[0]
    out = a.new_empty((ja * jb, c))
    b_ptr, out_ptr = b.data_ptr(), out.data_ptr()
    aligned = b_ptr % UNIT_BYTES == 0 and out_ptr % UNIT_BYTES == 0  # a view may start off a line
    g = launch_shape(ja, jb, c, a.element_size(), aligned)
    KERNEL.launch(
        a.data_ptr(), b_ptr, out_ptr, ja, jb, c, g.vec, g.per_thread, g.rows_per_step, g.tiles,
        # the raw stream handle, not a Stream object: back-to-back 16-bit
        # calls at the fMRI fold follow each other at a call's host time
        g.blocks, torch._C._cuda_getCurrentRawStream(a.get_device()), suffix=suffix,
    )
    if g.vec > 1:
        KERNEL.vector_launches += 1
    return out
