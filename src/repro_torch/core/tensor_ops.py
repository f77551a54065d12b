"""Dense-tensor layout primitives underlying the MTTKRP algorithms.

Port of ``repro.core.tensor_ops``.  Same layout convention: for mode ``n``
of an ``N``-way row-major tensor with dims ``I_0 x ... x I_{N-1}``,

    L = prod(I_k for k < n),   R = prod(I_k for k > n)

and the natural buffer is viewed as ``X3 = x.view(L, I_n, R)`` -- a free
view, no data movement.  Nothing here reorders the tensor except
:func:`matricize`, which exists only for the reorder-based baseline.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor

# Mode-index einsum letters shared by every contraction in the package.
# 'c' is reserved for the CP rank axis, 'z' for a kept mode in multi_ttv,
# hence both are absent from the pool.
EINSUM_LETTERS = "abdefghijklm"


def mode_letters(order: int) -> str:
    """Einsum letters for the modes of an order-``order`` tensor."""
    if not 0 < order <= len(EINSUM_LETTERS):
        raise ValueError(
            f"tensor order {order} outside supported range 1..{len(EINSUM_LETTERS)} "
            "('c' is reserved for the CP rank axis, 'z' for the kept mode)"
        )
    return EINSUM_LETTERS[:order]


def dims_split(shape: Sequence[int], n: int) -> tuple[int, int, int]:
    """Return ``(L, I_n, R)`` for mode ``n`` of ``shape``."""
    if not 0 <= n < len(shape):
        raise ValueError(f"mode {n} out of range for order-{len(shape)} tensor")
    L = math.prod(shape[:n]) if n > 0 else 1
    R = math.prod(shape[n + 1 :]) if n < len(shape) - 1 else 1
    return L, int(shape[n]), R


def as_lir(x: Tensor, n: int) -> Tensor:
    """Free (copy-less) view of ``x`` as ``(L, I_n, R)`` for mode ``n``.

    ``view`` raises on a non-contiguous tensor instead of copying it: the
    algorithms never reorder tensor entries.
    """
    L, In, R = dims_split(x.shape, n)
    return x.view(L, In, R)


def matricize(x: Tensor, n: int) -> Tensor:
    """Explicit mode-n matricization ``X_(n)`` of shape ``(I_n, I_neq_n)``.

    This *copies* (a transpose); it exists to implement the paper's
    baseline ("reorder then one GEMM"), which Algs. 2-4 avoid.
    """
    L, In, R = dims_split(x.shape, n)
    return x.reshape(L, In, R).movedim(1, 0).reshape(In, L * R)


def matricize_multi(x: Tensor, n: int) -> Tensor:
    """Generalized matricization ``X_(0:n)`` of shape ``(I_0*...*I_n, rest)``
    -- a free view of the row-major buffer."""
    rows = math.prod(x.shape[: n + 1])
    return x.view(rows, -1)


def ttv(x: Tensor, v: Tensor, n: int) -> Tensor:
    """Tensor-times-vector along mode ``n``: contracts ``I_n`` away."""
    L, In, R = dims_split(x.shape, n)
    if tuple(v.shape) != (In,):
        raise ValueError(f"vector shape {tuple(v.shape)} != ({In},)")
    out = torch.einsum("lir,i->lr", as_lir(x, n), v)
    return out.reshape(tuple(x.shape[:n]) + tuple(x.shape[n + 1 :]))


def ttm(x: Tensor, m: Tensor, n: int) -> Tensor:
    """Tensor-times-matrix along mode ``n``:  Y_(n) = M^T X_(n)."""
    L, In, R = dims_split(x.shape, n)
    if m.shape[0] != In:
        raise ValueError(f"matrix rows {m.shape[0]} != mode dim {In}")
    out = torch.einsum("lir,ij->ljr", as_lir(x, n), m)
    return out.reshape(tuple(x.shape[:n]) + (m.shape[1],) + tuple(x.shape[n + 1 :]))


def multi_ttv(t: Tensor, factors: Sequence[Tensor], cols_last: bool = True) -> Tensor:
    """The paper's *multi-TTV* (2nd step of Alg. 4).

    ``t`` is an ``(M+1)``-way tensor whose last axis is the CP-rank axis;
    its leading ``len(factors)`` modes are contracted column-wise with the
    factors, leaving the ``(I_keep, C)`` MTTKRP result.
    """
    order = t.ndim - 1
    if len(factors) != order - 1:
        raise ValueError("need order-1 factor matrices (one mode stays)")
    letters = mode_letters(order - 1) if order > 1 else ""
    spec_t = letters + "z" + "c"
    spec_fs = [let + "c" for let in letters]
    return torch.einsum(",".join([spec_t] + spec_fs) + "->zc", t, *factors)


def tensor_norm(x: Tensor, *, batched: bool = False) -> Tensor:
    """Frobenius norm of a dense tensor, as float32 (float32 accumulation,
    float64 for a float64 tensor; no squared copy of the tensor).

    With ``batched=True`` the leading axis is a batch of tensors and the
    result is the per-tensor norm vector of shape ``(B,)``.
    """
    dims = tuple(range(1, x.ndim)) if batched else None
    acc = torch.promote_types(x.dtype, torch.float32)  # vector_norm refuses to narrow
    return torch.linalg.vector_norm(x, dim=dims, dtype=acc).to(torch.float32)


def random_tensor(
    generator: torch.Generator,
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    *,
    device: str | torch.device = "cuda",
) -> Tensor:
    """Standard-normal tensor drawn from ``generator`` (which must live on
    ``device``).  Not stream-identical to the JAX package's ``jax.random``."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=device)


def random_factors(
    generator: torch.Generator,
    shape: Sequence[int],
    rank: int,
    dtype: torch.dtype = torch.float32,
    *,
    batch: int = 1,
    device: str | torch.device = "cuda",
) -> list[Tensor]:
    """Per-mode Gaussian factors ``(I_k, C)`` -- or ``(batch, I_k, C)`` when
    ``batch > 1`` -- drawn in mode order from ``generator``."""
    lead = (int(batch),) if batch > 1 else ()
    return [
        torch.randn(lead + (int(dim), rank), generator=generator, dtype=dtype, device=device)
        for dim in shape
    ]


def cp_full(weights: Tensor | None, factors: Sequence[Tensor]) -> Tensor:
    """Densify a CP model  [[lambda; U_0, ..., U_{N-1}]]  (for tests/fit checks)."""
    rank = factors[0].shape[1]
    if weights is None:
        weights = torch.ones((rank,), dtype=factors[0].dtype, device=factors[0].device)
    letters = mode_letters(len(factors))
    spec = ",".join(["c"] + [let + "c" for let in letters]) + "->" + letters
    return torch.einsum(spec, weights, *factors)


def linear_index(multi_index: Sequence[int], shape: Sequence[int]) -> int:
    """Row-major linearization (last index fastest) -- mirrors paper's eq. for l."""
    return int(np.ravel_multi_index(tuple(multi_index), tuple(shape)))
