"""Plain-torch oracles for the kernels (tests compare against these).

Port of ``repro.kernels.ref``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.krp import krp as _krp_reuse
from repro_torch.core.mttkrp import mttkrp_einsum

Tensor = torch.Tensor


def fused_mttkrp_ref(x: Tensor, factors: Sequence[Tensor], n: int) -> Tensor:
    """Oracle for kernels.ops.fused_mttkrp: the direct einsum MTTKRP."""
    return mttkrp_einsum(x, factors, n)


def bilinear_ref(t: Tensor, a: Tensor, b: Tensor, pos: int) -> Tensor:
    """Oracle for the unified bilinear form of fused_mttkrp_bilinear."""
    spec = {0: "iab,ac,bc->ic", 1: "aib,ac,bc->ic", 2: "abi,ac,bc->ic"}[pos]
    return torch.einsum(spec, t, a, b)


def krp_ref(mats: Sequence[Tensor]) -> Tensor:
    """Oracle for an explicit KRP: the reuse-fold KRP."""
    return _krp_reuse(mats)


def multi_ttv_ref(t: Tensor, w: Tensor) -> Tensor:
    """Oracle for multi-TTV:  M[i,c] = sum_l t[l,i,c] w[l,c]."""
    return torch.einsum("lic,lc->ic", t, w)


def multi_ttv_batched_ref(t: Tensor, w: Tensor) -> Tensor:
    """Oracle for batched multi-TTV:  M[s,i,c] = sum_l t[s,l,i,c] w[s,l,c]."""
    return torch.einsum("slic,slc->sic", t, w)
