"""CP-factorized layers: the paper's technique as an LM compression hook.

Port of ``repro.core.cp_layers``.  A dense weight W (d_in x d_out) is a
2-way tensor; its rank-r CP model is W ~= A @ B (A: d_in x r, B: r x d_out)
with the rank-1 terms as columns -- fit here with the same CP-ALS machinery
(for matrices, ALS converges to the truncated-SVD subspace).  3-way weights
(MoE expert stacks (E, d, f)) use the full 3-way CP decomposition, whose
factor updates are exactly the MTTKRP.

:func:`factorize_linear` / :func:`compress_ffn` convert a dense weight into
the factorized parameterization.  Everything runs where the weight lies.
"""

from __future__ import annotations

import torch

from .cpals import CPConfig, cp_als

Tensor = torch.Tensor


def factorize_linear(w: Tensor, rank: int, *, n_iters: int = 60) -> tuple[Tensor, Tensor]:
    """Rank-r CP (== low-rank) factorization of a matrix:  W ~= A @ B."""
    st = cp_als(w, CPConfig(rank=rank, n_iters=n_iters, tol=1e-7, method="auto"))
    a, b = st.factors
    return a * st.weights[None, :], b.T  # fold lambda into A


def factorize_expert_stack(w: Tensor, rank: int, *, n_iters: int = 60):
    """3-way CP of an (E, d_in, d_out) expert stack -> (E-, in-, out-) factors."""
    st = cp_als(w, CPConfig(rank=rank, n_iters=n_iters, tol=1e-7, method="auto"))
    e, a, b = st.factors
    return e * st.weights[None, :], a, b


def reconstruction_error(w: Tensor, a: Tensor, b: Tensor) -> float:
    """``||W - A @ B||_F / ||W||_F`` as a Python float."""
    approx = a @ b
    return float(torch.linalg.norm(w - approx) / torch.linalg.norm(w))


def compress_ffn(ffn_params: dict, rank: int) -> dict:
    """Dense FFN params {gate, up, down} -> CP-factorized {._a, ._b} dict,
    the reference's ``cp_rank`` parameterization."""
    out = {}
    for name in ("gate", "up", "down"):
        if name not in ffn_params:
            continue
        a, b = factorize_linear(ffn_params[name], rank)
        out[f"{name}_a"] = a
        out[f"{name}_b"] = b
    return out
