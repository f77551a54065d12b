"""Multi-TTV -- the 2nd step of the 2-step MTTKRP (Alg. 4).

Port of ``repro.kernels.multi_ttv`` (``multi_ttv_kernel``,
``multi_ttv_batched_kernel``, ``multi_ttv``, ``multi_ttv_batched``).
Computes

    M[i, c] = sum_l T[l, i, c] * W[l, c]

where ``T`` is the partial MTTKRP output ``(L, I_n, C)`` and ``W`` the
complementary partial KRP ``(L, C)``; the batched form computes the same
per slab ``s`` of a stack, ``M[s,i,c]`` from ``T[s]`` and ``W[s]``.  On the
card the wrappers make one launch of the CUDA kernel of ``csrc/multi_ttv.cu``:
the flat ``(I * C)`` output plane in tiles of ``block_i`` rows, one tile a
CTA, and the ``L`` reduction split over the warp groups of a CTA and the
CTAs of a thread-block cluster, summed on chip in a fixed order; the design
notes are in that file, the geometry comes from :func:`launch_shape`.  On
the CPU they take the ``*_plain`` versions.

Operands are float32, bfloat16, float16 or float64, both of one dtype.  As
the reference's kernel forms ``t * w`` in that dtype and adds it to a
float32 output, the kernel and the plain versions round each product to
the operands' dtype (a product of doubles to float32) and sum in fp32; the
kernel-level entries return float32, the wrappers ``t.dtype``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ._build import CudaKernel
from ._tiling import check_rank, check_slabs, kernel_suffix, use_kernel

Tensor = torch.Tensor

# Legal row tiles: a whole number of warps' rows, at most 1024 (tile_rows maps
# any other block_i to the nearest one).
MAX_BLOCK_I = 1024
WARP = 32
MAX_THREADS = 1024
# CTAs of a cluster along L (portable cluster sizes are 1..8; powers of two).
MAX_CLUSTER = 8
# l steps a thread aims to sum: a few loads in flight a thread, and a short
# plane still spreads over a cluster of SMs.
L_PER_THREAD = 8

_c64, _ptr, _int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
_GEOMETRY = [_c64, _int, _int, _int, _int]  # tile_rows, threads_x, groups, cluster, vec
_TYPED = {"bf16": "multi_ttv.cu", "f16": "multi_ttv.cu", "f64": "multi_ttv.cu"}
KERNEL = CudaKernel(
    "multi_ttv.cu",
    "multi_ttv_f32",
    [_ptr, _ptr, _ptr, _c64, _c64, _int, *_GEOMETRY, _ptr],
    _TYPED,
)
BATCHED_KERNEL = CudaKernel(
    "multi_ttv.cu",
    "multi_ttv_batched_f32",
    [_ptr, _ptr, _ptr, _int, _c64, _c64, _int, *_GEOMETRY, _ptr],
    _TYPED,
)


def multi_ttv_plain(t: Tensor, w: Tensor) -> Tensor:
    """The plain PyTorch version, float32 out: ``einsum("lic,lc->ic")`` in
    float32, else the reference's algebra, ``t * w`` in the operands' dtype
    cast to float32 and summed over ``l`` (in float32 the two differ only
    in the order of the sum)."""
    if t.dtype == torch.float32:
        return torch.einsum("lic,lc->ic", t, w)
    return (t * w[..., None, :]).to(torch.float32).sum(-3)


def multi_ttv_batched_plain(t: Tensor, w: Tensor) -> Tensor:
    """The plain PyTorch version of the batched kernel, as
    :func:`multi_ttv_plain` with a leading slab axis (``einsum("slic,slc->sic")``
    in float32)."""
    if t.dtype == torch.float32:
        return torch.einsum("slic,slc->sic", t, w)
    return (t * w[..., None, :]).to(torch.float32).sum(-3)


class Launch(NamedTuple):
    """One launch: a grid of ``(tiles, cluster, slabs)`` CTAs of
    ``threads_x * groups`` threads, in clusters of ``(1, cluster, 1)``."""

    tiles: int  # CTAs along the output plane (grid x), tile_rows * C outputs each
    cluster: int  # CTAs of a cluster along L (grid y): 1, 2, 4 or 8
    slabs: int  # grid z
    tile_rows: int  # output rows of a tile: block_i clamped to I
    threads_x: int  # threads across a tile, 4 outputs each per chunk
    groups: int  # warp groups of threads_x threads along L in a CTA
    vec: bool  # float4 reads of T (I * C % 4 == 0)


def tile_rows(dim_i: int, block_i: int) -> int:
    """Output rows one CTA's tile covers: ``block_i`` mapped to the nearest
    legal tile, a multiple of 32 in ``[32, 1024]`` (a tie goes up), then
    clamped to the rows there are.  Any ``block_i >= 1`` is taken, as the
    reference clamps any; a legal ``block_i`` keeps its own tile.  Raises
    for ``block_i < 1``."""
    if block_i < 1:
        raise ValueError(f"block_i must be >= 1, got {block_i}")
    legal = min(MAX_BLOCK_I, max(WARP, WARP * ((block_i + WARP // 2) // WARP)))
    return min(legal, dim_i)


@functools.lru_cache(maxsize=256)
def launch_shape(dim_i: int, big_l: int, rank: int, block_i: int, slabs: int = 1) -> Launch:
    """The launch for ``slabs`` planes of ``dim_i`` rows by ``rank`` and an
    ``L`` reduction of ``big_l`` steps, from the shape alone.

    A tile is ``block_i`` rows (clamped); ``threads_x`` threads cover it 4
    outputs at a time (at most 1024, looping over chunks beyond that).  The
    ``L`` reduction is cut into about ``big_l / 8`` slices: first over a
    cluster of up to 8 CTAs (the largest power of two that fits), then over
    warp groups inside each CTA, as many as fit in 1024 threads.  Neither
    exceeds the ``l`` there are, so no slice is empty."""
    rows = tile_rows(dim_i, block_i)
    threads_x = min(MAX_THREADS, WARP * math.ceil(rows * rank / 4 / WARP))
    slices = math.ceil(big_l / L_PER_THREAD)
    cluster = min(MAX_CLUSTER, 1 << (slices.bit_length() - 1))
    groups = min(MAX_THREADS // threads_x, math.ceil(slices / cluster))
    return Launch(
        math.ceil(dim_i / rows), cluster, slabs, rows, threads_x, groups, dim_i * rank % 4 == 0
    )


def _dims(t: Tensor, w: Tensor, lead: int) -> None:
    """Validate ``t`` ``(*lead, L, I, C)`` against ``w`` ``(*lead, L, C)``."""
    if t.ndim != 3 + lead:
        want = "(S, L, I, C)" if lead else "(L, I, C)"
        raise ValueError(f"t must be {want}, got {tuple(t.shape)}")
    want = tuple(t.shape[:lead + 1]) + (t.shape[-1],)
    if tuple(w.shape) != want:
        raise ValueError(f"w shape {tuple(w.shape)} != {want}")


def _launch(kernel: CudaKernel, t: Tensor, w: Tensor, block_i: int, slabs: int | None) -> Tensor:
    """Check the operands and launch ``kernel`` once: one allocation (the
    output) and one ctypes call, on a path kept short because a call's host
    time, not its device time, sets how fast calls follow each other.
    ``slabs`` is ``None`` for the unbatched entry point.  Returns a float32
    ``(I, C)`` or ``(S, I, C)``."""
    suffix = kernel_suffix(("t", t), ("w", w))
    big_l, dim_i, c = t.shape[-3:]
    check_rank(c)
    lead = () if slabs is None else (slabs,)
    if slabs is not None:
        check_slabs(slabs)
    g = launch_shape(dim_i, big_l, c, block_i, slabs or 1)
    out = t.new_empty(t.shape[:-3] + (dim_i, c), dtype=torch.float32)
    t_ptr = t.data_ptr()
    kernel.launch(
        t_ptr, w.data_ptr(), out.data_ptr(), *lead, big_l, dim_i, c,
        g.tile_rows, g.threads_x, g.groups, g.cluster,
        int(g.vec and t_ptr % 16 == 0),  # a contiguous view may start off a 16-byte line
        # the raw handle of the current stream, without building a Stream
        # object (which costs more than the launch itself)
        torch._C._cuda_getCurrentRawStream(t.device.index),
        suffix=suffix,
    )
    return out


def multi_ttv_kernel(
    t: Tensor, w: Tensor, *, block_i: int, interpret: bool = False
) -> Tensor:
    """``M[i,c] = sum_l t[l,i,c] * w[l,c]`` (t: (L, I, C), w: (L, C)): the
    reference's low-level entry, with its checks.  ``I`` must be a multiple
    of ``block_i`` (``ValueError`` otherwise: the caller pads); the result
    is float32.  A CUDA tensor makes the one launch :func:`multi_ttv` makes,
    a CPU tensor takes the plain version.  ``interpret`` is the
    reference's keyword and changes nothing."""
    big_l, dim_i, c = t.shape
    if tuple(w.shape) != (big_l, c):
        raise ValueError(f"w shape {tuple(w.shape)} != ({big_l}, {c})")
    if dim_i % block_i:
        raise ValueError("I must be padded to the block size")
    if not use_kernel(t, w):
        return multi_ttv_plain(t, w)
    return _launch(KERNEL, t, w, block_i, None)


def multi_ttv_batched_kernel(
    t: Tensor,
    w: Tensor,
    *,
    block_i: int,
    block_batch: int,
    interpret: bool = False,
) -> Tensor:
    """Batched multi-TTV ``M[s,i,c] = sum_l t[s,l,i,c] * w[s,l,c]``: the
    reference's low-level entry, with its checks.  ``S`` and ``I`` must be
    multiples of ``block_batch`` and ``block_i`` (``ValueError``
    otherwise); the result is float32.  One launch of the batched kernel on
    a CUDA tensor (every slab its own z block, so ``block_batch`` only
    checks the padding), the plain version on a CPU tensor."""
    n_batch, big_l, dim_i, c = t.shape
    if tuple(w.shape) != (n_batch, big_l, c):
        raise ValueError(f"w shape {tuple(w.shape)} != ({n_batch}, {big_l}, {c})")
    if dim_i % block_i or n_batch % block_batch:
        raise ValueError("S and I must be padded to the block sizes")
    if not use_kernel(t, w):
        return multi_ttv_batched_plain(t, w)
    return _launch(BATCHED_KERNEL, t, w, block_i, n_batch)


def multi_ttv(
    t: Tensor, w: Tensor, *, block_i: int = 256, interpret: bool | None = None
) -> Tensor:
    """Kernelized multi-TTV:  ``M[i,c] = sum_l t[l,i,c] * w[l,c]``.

    ``t`` is ``(L, I, C)`` and ``w`` ``(L, C)``.  CUDA tensors make one
    launch of the kernel with about ``block_i`` output rows a CTA (any
    ``block_i >= 1``, mapped to a legal tile by :func:`tile_rows`;
    contiguous operands of one dtype of ``KERNEL_DTYPES`` at any rank >= 1,
    else it raises); CPU tensors take the plain version.  Nothing is
    padded.  ``interpret`` is the reference's keyword; it never decides the
    device.  Returns ``t.dtype``, as the reference does: the float32 sum
    cast once (no cast in float32).
    """
    _dims(t, w, 0)
    tile_rows(int(t.shape[1]), block_i)
    if not use_kernel(t, w):
        return multi_ttv_plain(t, w).to(t.dtype)
    return _launch(KERNEL, t, w, block_i, None).to(t.dtype)


def multi_ttv_batched(
    t: Tensor,
    w: Tensor,
    *,
    block_i: int = 256,
    block_batch: int = 8,
    interpret: bool | None = None,
) -> Tensor:
    """Batched multi-TTV: ``M[s,i,c] = sum_l t[s,l,i,c] * w[s,l,c]``.

    ``t`` is ``(S, L, I, C)`` and ``w`` ``(S, L, C)``.  CUDA tensors make
    one launch of the kernel, the slabs along the grid's z axis (1..65535
    slabs; otherwise as :func:`multi_ttv`); CPU tensors take the plain
    version.  ``block_batch`` is the reference's slab tile, accepted for its
    signature: here every slab is its own z block, so it changes nothing;
    ``interpret`` as in :func:`multi_ttv`.  Nothing is padded: not the
    slabs, not any extent.
    """
    if block_batch < 1:
        raise ValueError(f"block_batch must be >= 1, got {block_batch}")
    _dims(t, w, 1)
    tile_rows(int(t.shape[2]), block_i)
    if not use_kernel(t, w):
        return multi_ttv_batched_plain(t, w).to(t.dtype)
    return _launch(BATCHED_KERNEL, t, w, block_i, t.shape[0]).to(t.dtype)
