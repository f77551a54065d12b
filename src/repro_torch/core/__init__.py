"""Core library: KRP, MTTKRP and the CP-ALS algebra, in PyTorch."""

from .cpals import CPState, fit_from_last_mttkrp, grams, hadamard_except, normalize_columns
from .dimtree import contract_from_partial, partial_mttkrp_range
from .krp import krp, krp_naive, krp_or_ones, krp_row_block, krp_rowwise_scan
from .mttkrp import (
    mttkrp,
    mttkrp_1step,
    mttkrp_2step,
    mttkrp_baseline,
    mttkrp_einsum,
    mttkrp_flops,
)
from .tensor_ops import (
    EINSUM_LETTERS,
    as_lir,
    cp_full,
    dims_split,
    linear_index,
    matricize,
    matricize_multi,
    mode_letters,
    multi_ttv,
    random_factors,
    random_tensor,
    tensor_norm,
    ttm,
    ttv,
)

__all__ = [
    "CPState",
    "EINSUM_LETTERS",
    "as_lir",
    "contract_from_partial",
    "cp_full",
    "dims_split",
    "fit_from_last_mttkrp",
    "grams",
    "hadamard_except",
    "krp",
    "krp_naive",
    "krp_or_ones",
    "krp_row_block",
    "krp_rowwise_scan",
    "linear_index",
    "matricize",
    "matricize_multi",
    "mode_letters",
    "multi_ttv",
    "mttkrp",
    "mttkrp_1step",
    "mttkrp_2step",
    "mttkrp_baseline",
    "mttkrp_einsum",
    "mttkrp_flops",
    "normalize_columns",
    "partial_mttkrp_range",
    "random_factors",
    "random_tensor",
    "tensor_norm",
    "ttm",
    "ttv",
]
