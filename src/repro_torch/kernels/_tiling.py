"""Shared dispatch and tiling helpers for the kernel wrappers.

Port of ``repro.kernels._tiling``.  The reference's interpret-mode switch
has no counterpart; the rule here is :func:`use_kernel`: a tensor on the
card launches the CUDA kernel, a tensor on the CPU takes the kernel's plain
PyTorch version, and anything else raises.  Nothing falls back.

The CUDA kernels mask ragged tile edges themselves, so the wrappers never
pad the tensor (a padded copy of the fMRI tensor would cost 2.12 GB);
:func:`pad_axis` stays for small operands and the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# The MTTKRP kernels' split knob: the most CTAs an SM is counted to hold
# when their launch geometry (matrix_free.py) splits a reduction.  The
# default is above the kernels' residency (2 at a column block of <= 32
# columns, 1 above), so it changes nothing; smaller values count fewer
# slots a wave.
BLOCKS_PER_SM = 4
# Target-mode rows per thread block of the MTTKRP kernels (BI in
# csrc/mttkrp_common.cuh) and the column-block widths they are compiled for
# (padded_rank there).  A rank above the widest, BLOCK_RANK, is cut into
# column blocks of at most BLOCK_RANK columns (matrix_free.column_blocks),
# so the kernels take any rank.
BLOCK_ROWS = 32
PADDED_RANKS = (4, 8, 12, 16, 24, 32, 48, 64)
BLOCK_RANK = PADDED_RANKS[-1]
# Slabs of a batched launch: one per block along the grid's z axis.
MAX_SLABS = 65535
# The element types the CUDA kernels take, the reference's kernels' dtypes:
# each one's C entry suffix (``matrix_free_mttkrp_bf16``, ...) and its bytes.
# Every operand of a call has one of them, the same one; the MTTKRP and
# multi-TTV kernels sum in fp32 and write float32, the KRP pair writes the
# operands' dtype.
KERNEL_DTYPES = {
    torch.float32: ("f32", 4),
    torch.bfloat16: ("bf16", 2),
    torch.float16: ("f16", 2),
    torch.float64: ("f64", 8),
}


def _plain(t: Tensor) -> bool:
    """A tensor of exactly ``torch.Tensor``, wrapped neither for
    functionalization nor by functorch: never fake, so :func:`use_kernel`
    skips ``is_fake``'s walk for it (a few µs a call, on every launch)."""
    return (type(t) is torch.Tensor and not torch._is_functional_tensor(t)
            and not torch._C._functorch.is_functorch_wrapped_tensor(t))


def use_kernel(*tensors: Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the kernel),
    False when every tensor lies on the CPU (take the plain version).  A
    fake tensor (a dry-run's, which holds no data) raises: a kernel can
    take none, and its plain version would stand in for it unseen."""
    if not all(map(_plain, tensors)):
        from torch._subclasses.fake_tensor import is_fake

        if any(is_fake(t) for t in tensors):
            raise ValueError("a kernel wrapper was given a fake tensor (a dry-run's): "
                             "the CUDA kernels need data on the card")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    if tensors[0].is_cuda:  # (a flag read: cheaper than the device's type)
        return True
    if tensors[0].is_cpu:
        return False
    raise ValueError(f"no kernel and no plain version for device {devices.pop()}")


def kernels_take(device, dtype: torch.dtype, rank: int) -> bool:
    """Whether the MTTKRP kernel paths take a problem of ``dtype`` at
    ``rank`` on ``device``.  On the CPU the plain versions take any rank and
    dtype; on the card the CUDA kernels take the dtypes of
    ``KERNEL_DTYPES`` at any rank >= 1 (a rank above ``BLOCK_RANK`` in
    column blocks).  The tuner asks this before it times a kernel; a forced
    kernel strategy raises instead."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return True
    return dev.type == "cuda" and dtype in KERNEL_DTYPES and rank >= 1


def check_rank(rank: int) -> None:
    """Raise unless ``rank`` is one the CUDA kernels take: any rank >= 1."""
    if rank < 1:
        raise ValueError(f"the CUDA kernels take rank >= 1, got rank {rank}")


def check_kernel_operand(name: str, t: Tensor) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of a dtype in
    ``KERNEL_DTYPES`` (the dtype is checked first)."""
    if t.dtype not in KERNEL_DTYPES:
        names = ", ".join(str(d).removeprefix("torch.") for d in KERNEL_DTYPES)
        raise TypeError(f"{name} is {t.dtype}: the CUDA kernels take {names}")
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on the card, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_suffix(*operands: tuple[str, Tensor]) -> str:
    """Check that the ``(name, tensor)`` operands have one dtype (a mix
    raises ``TypeError`` naming two of them: nothing is converted), then
    each one (:func:`check_kernel_operand`); return the dtype's C entry
    suffix."""
    name0, t0 = operands[0]
    for name, t in operands:
        if t.dtype != t0.dtype:
            raise TypeError(f"{name} is {t.dtype} and {name0} {t0.dtype}: the CUDA kernels "
                            "take operands of one dtype")
    for name, t in operands:
        check_kernel_operand(name, t)
    return KERNEL_DTYPES[t0.dtype][0]


def check_slabs(slabs: int) -> None:
    """Raise unless the CUDA kernels' slab grid axis (z) takes ``slabs``."""
    if not 1 <= slabs <= MAX_SLABS:
        raise ValueError(f"the CUDA kernels take 1..{MAX_SLABS} slabs, got {slabs}")


def pad_axis(x: Tensor, axis: int, mult: int) -> Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult`` (a copy when it pads)."""
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad  # F.pad lists the last axis first
    return F.pad(x, widths)


def reference_tiles(**tiles) -> None:
    """Check the reference's tile keywords a wrapper accepts for its
    signature (``block_i``, ``block_b``, ``block_r``, ``block_batch``,
    ``blocks``): each given size must be >= 1.  They change nothing here:
    the CUDA kernels' tiles are fixed at compile time and the kernels mask
    ragged edges, so no tile sets a pad (nor does ``pad_rank_to``: the rank
    is padded only in the kernels' registers)."""
    for name, size in tiles.items():
        sizes = size if isinstance(size, (list, tuple)) else [size]
        if any(v is not None and int(v) < 1 for v in sizes):
            raise ValueError(f"{name} must be >= 1, got {size}")


def block(dim: int, target: int) -> int:
    """Largest block <= target; dims smaller than target use the dim itself."""
    return min(dim, target)
