"""Multi-TTV -- the 2nd step of the 2-step MTTKRP (Alg. 4).

Port of ``repro.kernels.multi_ttv`` (``multi_ttv_kernel``,
``multi_ttv_batched_kernel``, ``multi_ttv``, ``multi_ttv_batched``).
Computes

    M[i, c] = sum_l T[l, i, c] * W[l, c]

where ``T`` is the partial MTTKRP output ``(L, I_n, C)`` and ``W`` the
complementary partial KRP ``(L, C)``; the batched form computes the same
per slab ``s`` of a stack, ``M[s,i,c]`` from ``T[s]`` and ``W[s]``.  On the
card the wrappers launch the CUDA kernel of ``csrc/multi_ttv.cu``: one
thread per output row with its ``C`` sums in registers, ``block_i`` rows a
block, ``L`` split over the grid's y axis and the splits summed in a fixed
order; the design notes are in that file.  On the CPU they take the
``*_plain`` versions.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import CudaKernel
from ._tiling import (
    check_kernel_operand,
    check_rank,
    check_slabs,
    split_reduction,
    use_kernel,
)

Tensor = torch.Tensor

# A block is a whole number of warps, at most the card's 1024 threads.
MAX_BLOCK_I = 1024

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "multi_ttv.cu",
    "multi_ttv_f32",
    [_ptr, _ptr, _ptr, _ptr, _c64, _c64, _int, _int, _c64, _int, _ptr],
)
BATCHED_KERNEL = CudaKernel(
    "multi_ttv.cu",
    "multi_ttv_batched_f32",
    [_ptr, _ptr, _ptr, _ptr, _int, _c64, _c64, _int, _int, _c64, _int, _ptr],
)


def multi_ttv_plain(t: Tensor, w: Tensor) -> Tensor:
    """The plain PyTorch version: ``einsum("lic,lc->ic")``."""
    return torch.einsum("lic,lc->ic", t, w)


def multi_ttv_batched_plain(t: Tensor, w: Tensor) -> Tensor:
    """The plain PyTorch version of the batched kernel:
    ``einsum("slic,slc->sic")``."""
    return torch.einsum("slic,slc->sic", t, w)


def block_threads(dim_i: int, block_i: int) -> int:
    """Threads (rows) per block of a launch: ``block_i`` clamped to the rows
    there are, rounded up to a whole warp.  Raises unless ``block_i`` is a
    multiple of 32 in ``[32, 1024]``."""
    if block_i % 32 or not 32 <= block_i <= MAX_BLOCK_I:
        raise ValueError(f"block_i must be a multiple of 32 in [32, {MAX_BLOCK_I}], got {block_i}")
    return min(block_i, 32 * math.ceil(dim_i / 32))


def launch_shape(
    dim_i: int, big_l: int, device, block_i: int, slabs: int | None = None
) -> tuple[int, int, int]:
    """``(threads, l per split, splits)`` of a launch with ``dim_i`` output
    rows and an ``L`` reduction of ``big_l`` steps, per slab when batched."""
    threads = block_threads(dim_i, block_i)
    return (threads,) + split_reduction(dim_i, big_l, device, slabs or 1, block_rows=threads)


def _dims(t: Tensor, w: Tensor, lead: int) -> None:
    """Validate ``t`` ``(*lead, L, I, C)`` against ``w`` ``(*lead, L, C)``."""
    if t.ndim != 3 + lead:
        want = "(S, L, I, C)" if lead else "(L, I, C)"
        raise ValueError(f"t must be {want}, got {tuple(t.shape)}")
    want = tuple(t.shape[:lead + 1]) + (t.shape[-1],)
    if tuple(w.shape) != want:
        raise ValueError(f"w shape {tuple(w.shape)} != {want}")


def _launch(kernel: CudaKernel, t: Tensor, w: Tensor, block_i: int, slabs: int | None) -> Tensor:
    """Check the operands and launch ``kernel``; ``slabs`` is ``None`` for
    the unbatched entry point.  Returns ``(I, C)`` or ``(S, I, C)``."""
    big_l, dim_i, c = (int(d) for d in t.shape[-3:])
    check_kernel_operand("t", t)
    check_kernel_operand("w", w)
    check_rank(c)
    lead = () if slabs is None else (slabs,)
    if slabs is not None:
        check_slabs(slabs)
    threads, l_per_split, splits = launch_shape(dim_i, big_l, t.device, block_i, slabs)
    ws = torch.empty(lead + (splits, dim_i, c), dtype=torch.float32, device=t.device)
    out = torch.empty(lead + (dim_i, c), dtype=torch.float32, device=t.device)
    kernel.launch(
        t.data_ptr(), w.data_ptr(), ws.data_ptr(), out.data_ptr(), *lead,
        big_l, dim_i, c, threads, l_per_split, splits,
        torch.cuda.current_stream(t.device).cuda_stream,
    )
    return out


def multi_ttv(t: Tensor, w: Tensor, *, block_i: int = 256) -> Tensor:
    """Kernelized multi-TTV:  ``M[i,c] = sum_l t[l,i,c] * w[l,c]``.

    ``t`` is ``(L, I, C)`` and ``w`` ``(L, C)``.  CUDA tensors launch the
    kernel with ``block_i`` rows per thread block (a multiple of 32 up to
    1024, clamped to the rows there are; contiguous float32 operands, rank
    up to 64, else it raises; at rank 48 or more a 1024-row block asks for
    more registers than an SM has and the launch raises); CPU tensors take
    the plain version.  Nothing is padded.  Returns ``t.dtype``.
    """
    _dims(t, w, 0)
    block_threads(int(t.shape[1]), block_i)
    if not use_kernel(t, w):
        return multi_ttv_plain(t, w).to(t.dtype)
    return _launch(KERNEL, t, w, block_i, None).to(t.dtype)


def multi_ttv_batched(
    t: Tensor, w: Tensor, *, block_i: int = 256, block_batch: int = 8
) -> Tensor:
    """Batched multi-TTV: ``M[s,i,c] = sum_l t[s,l,i,c] * w[s,l,c]``.

    ``t`` is ``(S, L, I, C)`` and ``w`` ``(S, L, C)``.  CUDA tensors launch
    the kernel, one slab per block along the grid's z axis (1..65535 slabs;
    otherwise as :func:`multi_ttv`); CPU tensors take the plain version.
    ``block_batch`` is the reference's slab tile, accepted for its
    signature: here every slab is its own z block, so it changes nothing.
    Nothing is padded: not the slabs, not any extent.
    """
    if block_batch < 1:
        raise ValueError(f"block_batch must be >= 1, got {block_batch}")
    _dims(t, w, 1)
    block_threads(int(t.shape[2]), block_i)
    if not use_kernel(t, w):
        return multi_ttv_batched_plain(t, w).to(t.dtype)
    return _launch(BATCHED_KERNEL, t, w, block_i, int(t.shape[0])).to(t.dtype)
