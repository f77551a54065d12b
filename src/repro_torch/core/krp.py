"""Khatri-Rao product (KRP) algorithms -- paper Algorithm 1 and variants.

Port of ``repro.core.krp``.  Row convention: for
``K = krp([U_0, ..., U_{Z-1}])`` with ``U_z`` of shape ``(J_z, C)``,

    K[j, :] = U_0[j_0, :] * U_1[j_1, :] * ... * U_{Z-1}[j_{Z-1}, :]

where ``j`` is the row-major linearization of ``(j_0, ..., j_{Z-1})`` (first
factor slowest).

* :func:`krp` -- the reuse algorithm (Alg. 1) as a left fold: every partial
  Hadamard prefix is computed once and reused for all its extensions.
* :func:`krp_naive` -- no reuse: ``Z`` full-size gathers, ``Z-1`` products.
* :func:`krp_rowwise_scan` -- a literal port of Alg. 1's row loop.
* :func:`krp_row_block` -- an arbitrary contiguous row block, computed
  independently (the parallel decomposition of Sec. 4.1.2).
* :func:`krp_batched` / :func:`krp_or_ones_batched` -- :func:`krp` per entry
  of a leading batch axis.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor


def _check(mats: Sequence[Tensor]) -> int:
    if len(mats) == 0:
        raise ValueError("KRP of zero matrices is undefined here; see krp_or_ones")
    cols = {int(m.shape[1]) for m in mats}
    if len(cols) != 1:
        raise ValueError(f"all factors must share the column count, got {cols}")
    return cols.pop()


def krp(mats: Sequence[Tensor]) -> Tensor:
    """Reuse-based KRP (vectorized Algorithm 1).  Shape ``(prod J_z, C)``."""
    _check(mats)
    out = mats[0]
    for u in mats[1:]:
        out = (out[:, None, :] * u[None, :, :]).reshape(-1, u.shape[1])
    return out


def krp_naive(mats: Sequence[Tensor]) -> Tensor:
    """No-reuse KRP: Z full-size row gathers + Z-1 full-size Hadamards."""
    c = _check(mats)
    dev = mats[0].device
    grids = torch.meshgrid(
        *[torch.arange(int(m.shape[0]), device=dev) for m in mats], indexing="ij"
    )
    rows = math.prod(int(m.shape[0]) for m in mats)
    out = torch.ones((rows, c), dtype=mats[0].dtype, device=dev)
    for u, g in zip(mats, grids):
        out = out * u[g.reshape(-1)]
    return out


def krp_or_ones(
    mats: Sequence[Tensor],
    cols: int,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> Tensor:
    """KRP that degenerates to a ``(1, C)`` row of ones for an empty factor
    set (the external-mode convention).  ``device`` places that row; it
    defaults to the CPU, as ``torch.ones`` does."""
    if len(mats) == 0:
        return torch.ones((1, cols), dtype=dtype, device=device)
    return krp(mats)


def krp_batched(mats: Sequence[Tensor]) -> Tensor:
    """Reuse-based KRP over a leading batch axis.

    Each ``mats[z]`` is ``(S, J_z, C)``; the result is ``(S, prod J_z, C)``
    with the same row-major linearization as :func:`krp`, per batch entry
    (each entry has its own factors, so nothing is shared across the batch).
    """
    if len(mats) == 0:
        raise ValueError("KRP of zero matrices is undefined here; see krp_or_ones_batched")
    out = mats[0]
    for u in mats[1:]:
        out = (out[:, :, None, :] * u[:, None, :, :]).reshape(out.shape[0], -1, u.shape[2])
    return out


def krp_or_ones_batched(
    mats: Sequence[Tensor],
    batch: int,
    cols: int,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> Tensor:
    """Batched :func:`krp_or_ones`: ``(S, 1, C)`` ones for an empty set."""
    if len(mats) == 0:
        return torch.ones((batch, 1, cols), dtype=dtype, device=device)
    return krp_batched(mats)


def krp_row_block(mats: Sequence[Tensor], start: int, length: int) -> Tensor:
    """Rows ``[start, start+length)`` of the KRP, computed independently:
    unravel the row range into per-factor indices, gather, Hadamard-reduce."""
    _check(mats)
    dims = tuple(int(m.shape[0]) for m in mats)
    rows = np.arange(start, start + length)
    multi = np.unravel_index(rows, dims)  # row-major: first factor slowest
    dev = mats[0].device
    out = mats[0][torch.as_tensor(multi[0], device=dev)]
    for u, idx in zip(mats[1:], multi[1:]):
        out = out * u[torch.as_tensor(idx, device=dev)]
    return out


def krp_rowwise_scan(mats: Sequence[Tensor]) -> Tensor:
    """Literal Algorithm 1: one row per step, multi-index + reused partials.

    ``p[k]`` is the Hadamard prefix through factor ``k`` at the current
    multi-index ``ell``; each step emits ``p[Z-1]`` (line 5), increments the
    row-major odometer (line 6), and recomputes only the prefixes from the
    leftmost changed index on (line 7).  A fidelity reference: one Python
    step per output row.
    """
    c = _check(mats)
    z = len(mats)
    if z < 2:
        return mats[0]
    dims = [int(m.shape[0]) for m in mats]
    ell = [0] * z
    p = [mats[0][0]]
    for k in range(1, z):
        p.append(p[-1] * mats[k][0])
    rows = []
    for _ in range(math.prod(dims)):
        rows.append(p[z - 1])
        k = z - 1
        while k >= 0:  # odometer: bump the last index, carry leftwards
            ell[k] += 1
            if ell[k] < dims[k]:
                break
            ell[k] = 0
            k -= 1
        first = max(k, 0)
        for kk in range(first, z):
            p[kk] = mats[0][ell[0]] if kk == 0 else p[kk - 1] * mats[kk][ell[kk]]
    return torch.stack(rows).reshape(-1, c)
