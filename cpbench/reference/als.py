"""Plain CP-ALS: the reference that decides whether the port's answers are right.

The algorithm the port states (paper Sec. 2.2, the Tensor Toolbox's
``cp_als``), written down with nothing but ``torch`` contractions: for each
sweep and each mode ``n`` in order,

    M   = MTTKRP(X, {U_k}, n)           the tensor contracted with every other factor
    H   = *_{k != n} U_k^T U_k          Hadamard product of the Grams
    U_n = M pinv(H)                     H's pseudo-inverse, the port's stated update
    lambda = column norms of U_n        2-norms on the first sweep, max(1, norm) after
    U_n = U_n / lambda

``pinv`` drops the singular values of ``H`` below ``10 C eps`` of the
largest, ``eps`` that of the dtype the configuration states (the cutoff of
``numpy.linalg.pinv`` and of the port), whatever precision the reference
itself computes in.  After the sweep the fit
``1 - ||X - [[lambda; U]]|| / ||X||`` by
``||X - Y||^2 = ||X||^2 - 2 <X, Y> + ||Y||^2``.  No kernel, no plan, no
batching: one tensor, one mode after another.

``precision`` is ``"float64"`` (the reference), ``"float32"``, or
``"tf32"``: float32 with both operands of every contraction rounded to
TF32's 10-bit mantissa first, which is what a float32 GEMM computes with
TF32 switched on (the control that the comparison has to fail).
"""

from __future__ import annotations

from typing import Sequence

import torch

LETTERS = "abdefghijklm"  # 'c' is the rank axis

PRECISIONS = ("float64", "float32", "tf32")


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), kept in float32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


class _Contract:
    """The contractions of one precision: ``matmul`` and ``einsum`` whose
    operands are rounded to TF32 first when ``tf32``."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} is none of {PRECISIONS}")
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.round = to_tf32 if precision == "tf32" else (lambda t: t)

    def matmul(self, a, b):
        return self.round(a) @ self.round(b)

    def einsum(self, spec, *ops):
        return torch.einsum(spec, *(self.round(t) for t in ops))


def mttkrp(x: torch.Tensor, factors: Sequence[torch.Tensor], n: int,
           con: _Contract) -> torch.Tensor:
    """``M = X_(n) (U_{N-1} kr ... kr U_{n+1} kr U_{n-1} kr ... kr U_0)``,
    ``(I_n, C)``: the tensor is read once, contracted with the last factor
    (or the first, for the last mode) in one GEMM; every other mode is then
    contracted out of that ``C`` times smaller partial."""
    order = x.ndim
    rank = factors[0].shape[1]
    if n != order - 1:
        t = con.matmul(x.reshape(-1, x.shape[-1]), factors[-1]).reshape(*x.shape[:-1], rank)
        axes = list(range(order - 1))
    else:
        t = con.matmul(factors[0].T, x.reshape(x.shape[0], -1))
        t = t.reshape(rank, *x.shape[1:]).movedim(0, -1)
        axes = list(range(1, order))
    for m in reversed([k for k in axes if k != n]):
        spec_t = "".join(LETTERS[k] for k in axes) + "c"
        axes.remove(m)
        spec_out = "".join(LETTERS[k] for k in axes) + "c"
        t = con.einsum(f"{spec_t},{LETTERS[m]}c->{spec_out}", t, factors[m])
    return t


def pinv_rtol(rank: int, dtype: torch.dtype) -> float:
    """The update's cutoff: ``10 * rank * eps(dtype)``, relative to the
    largest singular value of the ``rank x rank`` system."""
    return 10.0 * rank * torch.finfo(dtype).eps


def _fit(norm_x, grams, weights, m_last, u_last) -> float:
    full_h = grams[0]
    for g in grams[1:]:
        full_h = full_h * g
    norm_y_sq = weights @ full_h @ weights
    inner = torch.sum(m_last * u_last * weights)
    resid_sq = torch.clamp(norm_x**2 - 2.0 * inner + norm_y_sq, min=0.0)
    return float(1.0 - torch.sqrt(resid_sq) / norm_x)


def cp_als(x: torch.Tensor, init: Sequence[torch.Tensor], sweeps: int,
           precision: str = "float64", stated: torch.dtype = torch.float32):
    """``sweeps`` ALS sweeps of ``x`` from the factors ``init`` (neither is
    modified), the update's cutoff that of the dtype ``stated``.  Returns
    ``(factors, weights, fits)``: the factors and weights after the last
    sweep, in the precision's dtype, and the fit after each sweep (Python
    floats)."""
    con = _Contract(precision)
    x = x.to(con.dtype)
    factors = [u.to(con.dtype) for u in init]
    grams = [con.matmul(u.T, u) for u in factors]
    weights = torch.ones(factors[0].shape[1], dtype=con.dtype, device=x.device)
    norm_x = torch.linalg.vector_norm(x)
    rtol = pinv_rtol(factors[0].shape[1], stated)
    fits = []
    for it in range(sweeps):
        for n in range(x.ndim):
            m = mttkrp(x, factors, n, con)
            h = None
            for k, g in enumerate(grams):
                if k != n:
                    h = g if h is None else h * g
            u = con.matmul(m, torch.linalg.pinv(h, rtol=rtol))
            norms = torch.linalg.vector_norm(u, dim=0)
            if it > 0:
                norms = torch.clamp(norms, min=1.0)
            factors[n] = u / norms
            weights = norms
            grams[n] = con.matmul(factors[n].T, factors[n])
        fits.append(_fit(norm_x, grams, weights, m, factors[-1]))
    if not fits:
        raise ValueError("cp_als needs at least one sweep")
    return factors, weights, fits
