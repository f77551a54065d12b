"""The factor update's C x C solve: the Hadamard of Grams and its pseudo-inverse.

For the mode-``n`` update of CP-ALS (paper Sec. 2.2),

    H = *_{k != n} G_k,    P = pinv(H)  (cutoff ``10 * C * eps`` of the largest),

with each Gram ``G_k = U_k^T U_k`` of shape ``(C, C)`` or batched
``(B, C, C)``.  It replaces no TPU kernel: the reference forms ``H`` with
``hadamard_except`` and calls ``jnp.linalg.pinv``.  On the card
:func:`gram_pinv` launches the CUDA kernel of ``csrc/gram_pinv.cu`` (design
notes there): one block a matrix, ``H`` formed in shared memory and
decomposed by a parallel cyclic Jacobi eigensolver, with nothing read back
to the host; ``torch.linalg.pinv`` checks cuSOLVER's info array on the host
after every call, which drained the device queue once an update.

:func:`gram_pinv_plain` is the definition: ``hadamard_except`` then
``torch.linalg.pinv`` at the reference's cutoff, the path every CPU tensor
takes.  It does not repeat the kernel's Jacobi arithmetic: written in
PyTorch that would be about a thousand small operations an update on the
CPU, where the plain call is two.  So the kernel agrees with it to rounding
(``tests/test_torch_gram_pinv.py`` on the card), not bitwise.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core.cpals import hadamard_except

from ._build import CudaKernel
from ._tiling import use_kernel

Tensor = torch.Tensor

MAX_ORDER = 16  # Grams a call takes (MAX_ORDER in csrc/gram_pinv.cu)
SMEM_LIMIT = 232448  # bytes of shared memory a block of the card may use (227 KB)
# The largest C the kernel takes, in float32 and float64: up to C_MAX it was
# no slower a call than torch.linalg.pinv on an H100 (PERF.md section 6).  A
# block holds up to C = 161 in float32 and 114 in float64 (its shared
# memory, smem_bytes, and a round's tasks, MAX_TASKS a thread).
C_MAX = 80
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "gram_pinv.cu", "gram_pinv_f32",
    [ctypes.POINTER(_ptr), _int, _int, _int, _int, _ptr, _ptr],
    {"f64": "gram_pinv.cu"},
)


def smem_bytes(c: int, itemsize: int) -> int:
    """Shared memory of a block at order ``c`` (``smem_elements`` in the
    source): H padded to an even order m (m x m), V (c x m), the diagonal
    (m), each pair's element (m / 2) and rotation (m), 33 for the
    reductions."""
    m = c + c % 2
    return itemsize * (m * m + c * m + 2 * m + m // 2 + 33)


def pinv_rtol(c: int, dtype: torch.dtype) -> float:
    """The reference's cutoff: ``jnp.linalg.pinv`` drops singular values
    below ``10 * max(m, n) * eps`` of the largest, where
    ``torch.linalg.pinv`` defaults to ``max(m, n) * eps``."""
    return 10.0 * c * torch.finfo(dtype).eps


def gram_pinv_plain(gs: Sequence[Tensor], n: int) -> Tensor:
    """The definition: the Hadamard of every Gram but the ``n``-th, left to
    right, then ``torch.linalg.pinv`` at :func:`pinv_rtol`."""
    h = hadamard_except(gs, n)
    return torch.linalg.pinv(h, rtol=pinv_rtol(h.shape[-1], h.dtype))


def _check(gs: Sequence[Tensor], n: int) -> tuple[int, int]:
    """Raise unless the Grams are 2 to ``MAX_ORDER`` square matrices or
    stacks of them of one shape, ``n`` one of them; return ``(C, B)``."""
    if not 2 <= len(gs) <= MAX_ORDER:
        raise ValueError(f"gram_pinv takes 2..{MAX_ORDER} Grams, got {len(gs)}")
    if not 0 <= n < len(gs):
        raise ValueError(f"mode {n} is not one of the {len(gs)} Grams")
    shape = tuple(gs[0].shape)
    if len(shape) not in (2, 3) or shape[-1] != shape[-2] or shape[-1] < 1:
        raise ValueError(f"a Gram must be (C, C) or (B, C, C), got {shape}")
    if any(tuple(g.shape) != shape for g in gs):
        raise ValueError(f"the Grams' shapes differ: {[tuple(g.shape) for g in gs]}")
    return shape[-1], shape[0] if len(shape) == 3 else 1


def refusal(gs: Sequence[Tensor]) -> Exception | None:
    """Why the kernel does not take these Grams, as the error
    :func:`gram_pinv` raises on the card; ``None`` where it takes them:
    float32 or float64 of one dtype, ``C <= C_MAX``, at most ``MAX_ORDER``
    of them.  The one statement of what the kernel takes, for the wrapper
    and for ``plan/sweep.py::_pinv``'s choice of path."""
    dtype = gs[0].dtype
    if dtype not in _SUFFIX or any(g.dtype != dtype for g in gs):
        return TypeError(f"gram_pinv takes float32 or float64 Grams of one dtype, got "
                         f"{sorted({str(g.dtype) for g in gs})}")
    if gs[0].shape[-1] > C_MAX:
        return ValueError(f"gram_pinv takes C <= {C_MAX}, got {gs[0].shape[-1]}")
    if len(gs) > MAX_ORDER:
        return ValueError(f"gram_pinv takes at most {MAX_ORDER} Grams, got {len(gs)}")
    return None


def takes(gs: Sequence[Tensor]) -> bool:
    """Whether the kernel takes these Grams (:func:`refusal` finds nothing)."""
    return refusal(gs) is None


@KERNEL.entry
def gram_pinv(gs: Sequence[Tensor], n: int) -> Tensor:
    """``pinv(*_{k != n} gs[k])`` at :func:`pinv_rtol`, ``(C, C)`` or
    ``(B, C, C)`` in the Grams' dtype.

    CUDA tensors launch the kernel once on the current stream: contiguous
    Grams of one shape, 2 to ``MAX_ORDER`` of them, that it :func:`takes`;
    anything else raises.  A non-finite ``H`` gives NaN in the whole of its
    ``P``.  CPU tensors take :func:`gram_pinv_plain`."""
    c, batch = _check(gs, n)
    if not use_kernel(*gs):
        return gram_pinv_plain(gs, n)
    err = refusal(gs)
    if err is not None:
        raise err
    if not all(g.is_contiguous() for g in gs):
        raise ValueError("the Grams must be contiguous")
    out = torch.empty_like(gs[0])
    KERNEL.launch(
        (_ptr * len(gs))(*[g.data_ptr() for g in gs]), len(gs), n, c, batch, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(out.device.index), suffix=_SUFFIX[gs[0].dtype],
    )
    return out
