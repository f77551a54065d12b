"""MTTKRP algorithms: 1-step (Algs. 2-3), 2-step (Alg. 4), baseline, kernels.

Port of ``repro.core.mttkrp``.  Every function computes, for mode ``n`` of
an N-way tensor ``x`` with factors ``U_k`` of shape ``(I_k, C)``,

    M[i, c] = sum_{l, r} X3[l, i, r] * K_L[l, c] * K_R[r, c]

with ``X3 = x.view(L, I_n, R)`` (free view), ``K_L = U_0 (.) ... (.) U_{n-1}``
and ``K_R = U_{n+1} (.) ... (.) U_{N-1}``.  None of the algorithms reorders
tensor entries; only :func:`mttkrp_baseline` does, by design.  The GEMMs are
``torch.matmul`` on free views (cuBLAS on the card, full fp32 unless TF32 is
switched on by the caller); ``"fused"`` and ``"matrix_free"`` reach the
port's hand-written kernels through :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import math
from typing import Literal, Mapping, Sequence

import torch

from .krp import krp, krp_or_ones
from .tensor_ops import as_lir, dims_split, matricize, mode_letters

Tensor = torch.Tensor
Method = Literal[
    "auto", "1step", "2step", "2step-left", "2step-right", "einsum", "baseline",
    "fused", "matrix_free",
]


def _split_factors(factors: Sequence[Tensor], n: int):
    return list(factors[:n]), list(factors[n + 1 :])


def mttkrp_einsum(x: Tensor, factors: Sequence[Tensor], n: int) -> Tensor:
    """Direct einsum oracle (no algorithmic structure; for tests)."""
    letters = mode_letters(x.ndim)
    terms = [letters]
    args: list[Tensor] = [x]
    for k, u in enumerate(factors):
        if k == n:
            continue
        terms.append(letters[k] + "c")
        args.append(u)
    return torch.einsum(",".join(terms) + f"->{letters[n]}c", *args)


def mttkrp_1step(
    x: Tensor, factors: Sequence[Tensor], n: int, *, blocked: bool = False
) -> Tensor:
    """1-step MTTKRP (paper Algs. 2-3): explicit KRP, layout-respecting GEMMs.

    Forms the full KRP with the reuse algorithm, then multiplies it against
    the unreordered tensor: one GEMM for mode 0 (``L == 1``), one transposed
    GEMM for the last mode (``R == 1``; ``X3[:, :, 0]`` is an ``(L, I_n)``
    view), and otherwise Alg. 2's per-block GEMMs ``X3[l] @ K3[l]`` as one
    batched GEMM summed over ``l``.  ``blocked=True`` keeps Alg. 2's
    explicit loop over blocks instead.
    """
    left, right = _split_factors(factors, n)
    c = factors[0].shape[1]
    L, In, R = dims_split(x.shape, n)
    k = krp_or_ones(left + right, c, x.dtype, x.device)  # (L*R, C), reuse Alg. 1
    x3 = as_lir(x, n)
    if L == 1:
        return x3[0] @ k  # external mode n=0: single GEMM (Alg. 2 line 4)
    k3 = k.view(L, R, c)
    if R == 1:
        return x3[:, :, 0].T @ k3[:, 0, :]  # last mode: transposed view, no copy
    if not blocked:
        return torch.bmm(x3, k3).sum(dim=0)
    out = torch.zeros((In, c), dtype=x.dtype, device=x.device)
    for l in range(L):
        out = out + x3[l] @ k3[l]  # Alg. 2 line 9: one row-major GEMM per block
    return out


def mttkrp_2step(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    order: Literal["auto", "left", "right"] = "auto",
) -> Tensor:
    """2-step MTTKRP (paper Alg. 4): partial MTTKRP + multi-TTV.

    right-first:  R_t = x.view(L*I_n, R) @ K_R ;  M = sum_l R_t[l] * K_L[l]
    left-first:   L_t = K_L^T @ x.view(L, I_n*R) ;  M = sum_r L_t[:, :, r] * K_R[r]

    ``order='auto'`` is left-first iff ``L > R`` (Alg. 4 line 4).  External
    modes degenerate to the 1-step single GEMM.
    """
    left, right = _split_factors(factors, n)
    c = factors[0].shape[1]
    L, In, R = dims_split(x.shape, n)
    if L == 1 or R == 1:
        return mttkrp_1step(x, factors, n)
    if order == "auto":
        order = "left" if L > R else "right"
    if order == "right":
        k_r = krp(right)
        r_t = (x.view(L * In, R) @ k_r).view(L, In, c)
        k_l = krp(left)
        return torch.einsum("lic,lc->ic", r_t, k_l)  # multi-TTV (Alg. 4 l.13-15)
    k_l = krp(left)
    l_t = (k_l.T @ x.view(L, In * R)).view(c, In, R)
    k_r = krp(right)
    return torch.einsum("cir,rc->ic", l_t, k_r)  # multi-TTV (Alg. 4 l.7-9)


def mttkrp_baseline(x: Tensor, factors: Sequence[Tensor], n: int) -> Tensor:
    """Paper's baseline: explicitly reorder to ``X_(n)`` then one big GEMM."""
    left, right = _split_factors(factors, n)
    c = factors[0].shape[1]
    xn = matricize(x, n)  # data movement happens here
    k = krp_or_ones(left + right, c, x.dtype, x.device)
    return xn @ k


def _kernel_knobs(tiles: Mapping[str, int] | None) -> dict[str, int]:
    """The run-time knob a tuned tile config holds for the MTTKRP kernels."""
    if tiles and "blocks_per_sm" in tiles:
        return {"blocks_per_sm": int(tiles["blocks_per_sm"])}
    return {}


def mttkrp(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
) -> Tensor:
    """Dispatching MTTKRP.

    ``method='auto'`` is the paper's recommended configuration (Sec. 5.3.3):
    1-step for external modes, 2-step for internal ones.  ``'fused'`` and
    ``'matrix_free'`` run the port's CUDA kernels (their plain versions for
    a tensor on the CPU).  ``tiles`` is the planner's ``NodePlan.tiles``:
    for ``'fused'`` and ``'matrix_free'`` its ``blocks_per_sm`` (the
    kernels' split knob, tuned by ``repro_torch.plan.tune``) is passed to
    the kernel; every other key, and every other method, ignores it (the
    kernels' row and reduction tiles are fixed when they are compiled).
    """
    if method == "auto":
        method = "1step" if n in (0, len(factors) - 1) else "2step"
    if method == "1step":
        return mttkrp_1step(x, factors, n)
    if method == "2step":
        return mttkrp_2step(x, factors, n, order="auto")
    if method == "2step-left":
        return mttkrp_2step(x, factors, n, order="left")
    if method == "2step-right":
        return mttkrp_2step(x, factors, n, order="right")
    if method == "einsum":
        return mttkrp_einsum(x, factors, n)
    if method == "baseline":
        return mttkrp_baseline(x, factors, n)
    if method == "fused":
        from repro_torch.kernels import ops as kops

        return kops.fused_mttkrp(x, list(factors), n, **_kernel_knobs(tiles))
    if method == "matrix_free":
        from repro_torch.kernels import ops as kops

        return kops.matrix_free_mttkrp(x, list(factors), n, **_kernel_knobs(tiles))
    raise ValueError(f"unknown method {method!r}")


def mttkrp_batched(
    x: Tensor,
    factors: Sequence[Tensor],
    n: int,
    *,
    method: Method = "auto",
    tiles: Mapping[str, int] | None = None,
) -> Tensor:
    """MTTKRP over a leading batch axis: one call for B stacked problems.

    ``x`` is ``(B, *shape)`` and each factor is ``(B, I_k, C)``; the result
    is ``(B, I_n, C)``.  ``'fused'`` and ``'matrix_free'`` launch the batched
    CUDA kernels (one launch for all B problems, a slab per block along the
    grid's z axis; their plain versions for a tensor on the CPU).  The other
    methods are ``torch.func.vmap`` of the unbatched algorithms, whose GEMMs
    become batched GEMMs.  A kernel wrapper is never vmapped: its launch
    takes ``data_ptr()``, which a vmapped tensor does not have.  ``tiles``
    is read as by :func:`mttkrp`: its ``blocks_per_sm`` reaches the batched
    kernels, every other key is ignored.
    """
    if method == "auto":
        method = "1step" if n in (0, len(factors) - 1) else "2step"
    if method == "fused":
        from repro_torch.kernels import ops as kops

        return kops.fused_mttkrp_batched(x, list(factors), n, **_kernel_knobs(tiles))
    if method == "matrix_free":
        from repro_torch.kernels import ops as kops

        return kops.matrix_free_mttkrp_batched(x, list(factors), n, **_kernel_knobs(tiles))

    def one(xb, *fb):
        return mttkrp(xb, list(fb), n, method=method, tiles=tiles)

    return torch.func.vmap(one)(x, *factors)


def mttkrp_flops(
    shape: Sequence[int],
    rank: int,
    n: int,
    *,
    dtype=None,
    itemsize: float | None = None,
    batch: int = 1,
) -> dict[str, float]:
    """Analytic flop/byte model per algorithm (the ``plan`` cost model's
    base terms): GEMM flops, KRP flops, and tensor/KRP bytes.  Byte terms
    scale with ``itemsize`` (or ``dtype``; default 4-byte elements)."""
    if itemsize is None:
        from repro_torch.analysis.roofline import dtype_itemsize

        itemsize = float(dtype_itemsize(dtype)) if dtype is not None else 4.0
    b = float(batch)
    L, In, R = dims_split(shape, n)
    total = math.prod(shape)
    gemm = 2.0 * total * rank * b
    krp_full = float((L * R) * rank) * b
    krp_naive = float((L * R) * rank * max(1, len(shape) - 2)) * b
    second_step = (
        2.0 * In * rank * min(L, R) * b if 0 < n < len(shape) - 1 else 0.0
    )
    return {
        "gemm_flops": gemm,
        "krp_flops": krp_full,
        "krp_naive_flops": krp_naive,
        "second_step_flops": second_step,
        "tensor_bytes": itemsize * total * b,
        "krp_bytes": itemsize * L * R * rank * b,
        "itemsize": float(itemsize),
    }
