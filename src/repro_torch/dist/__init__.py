"""Distributed-memory extension of the paper's shared-memory MTTKRP.

Port of ``repro.dist``, distribution slices 1-3 (flat sharded CP-ALS, its
reductions overlapped with the contractions, and compressed).
``dist_mttkrp``: block-distributed MTTKRP/CP-ALS over a
``torch.distributed`` DeviceMesh -- the device-for-thread port of the
paper's parallelization, with the communication structure of
Ballard/Knight/Rouse (comm lower bounds for MTTKRP) and
Ballard/Hayashi/Kannan (parallel dense CP).  One process a rank: each
rank runs the local shared-memory MTTKRP on its natural-layout block and
one reduction over the axes of the contracted modes completes it
(``dist_mttkrp``; ``dist_contract_range`` / ``dist_contract_partial`` for
the nodes of a dimension-tree schedule).  Results are this rank's blocks.

The overlapped entry (``dist_mttkrp_overlapped``) cuts the local MTTKRP
into slabs and issues each slab's reduction behind the next slab's
contraction; the compressed ones (``dist_mttkrp_compressed``,
``dist_contract_*_compressed``) complete with the int8 error-feedback
gather, this rank's residuals (``init_mttkrp_error_state``) threaded
through.

``collectives``: the ordered gather-sum every exact reduction of the port
runs (deterministic: a fixed summation order, the same bits on every
rank), with its call counter ``GATHERS``, its asynchronous form, and
``compressed_psum``/``init_error_state``.

Later slices add the hierarchical collectives (4) and sharded pairwise
perturbation (5); the compressed data-parallel train step comes with the
LM substrate.
"""

from .collectives import (
    GATHERS,
    INT8_GATHERS,
    compressed_psum,
    gather_cat,
    gather_sum,
    init_error_state,
    ordered_psum,
    ordered_psum_async,
)
from .dist_mttkrp import (
    DEFAULT_OVERLAP_CHUNKS,
    SLAB_COPIES,
    dist_als_sweep,
    dist_contract_partial,
    dist_contract_partial_compressed,
    dist_contract_range,
    dist_contract_range_compressed,
    dist_cp_als,
    dist_dimtree_sweep,
    dist_mttkrp,
    dist_mttkrp_compressed,
    dist_mttkrp_overlapped,
    init_mttkrp_error_state,
    shard_problem,
)

__all__ = [
    "DEFAULT_OVERLAP_CHUNKS",
    "GATHERS",
    "INT8_GATHERS",
    "SLAB_COPIES",
    "compressed_psum",
    "gather_cat",
    "gather_sum",
    "init_error_state",
    "ordered_psum",
    "ordered_psum_async",
    "dist_als_sweep",
    "dist_contract_partial",
    "dist_contract_partial_compressed",
    "dist_contract_range",
    "dist_contract_range_compressed",
    "dist_cp_als",
    "dist_dimtree_sweep",
    "dist_mttkrp",
    "dist_mttkrp_compressed",
    "dist_mttkrp_overlapped",
    "init_mttkrp_error_state",
    "shard_problem",
]
