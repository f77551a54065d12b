"""Distributed-memory extension of the paper's shared-memory MTTKRP.

Port of ``repro.dist``, distribution slice 1 (flat sharded CP-ALS).
``dist_mttkrp``: block-distributed MTTKRP/CP-ALS over a
``torch.distributed`` DeviceMesh -- the device-for-thread port of the
paper's parallelization, with the communication structure of
Ballard/Knight/Rouse (comm lower bounds for MTTKRP) and
Ballard/Hayashi/Kannan (parallel dense CP).  One process a rank: each
rank runs the local shared-memory MTTKRP on its natural-layout block and
one reduction over the axes of the contracted modes completes it
(``dist_mttkrp``; ``dist_contract_range`` / ``dist_contract_partial`` for
the nodes of a dimension-tree schedule).  Results are this rank's blocks.

``collectives``: the ordered gather-sum every reduction of the port runs
(deterministic: a fixed summation order, the same bits on every rank),
with its call counter ``GATHERS``.

Later slices add the overlapped entries (2), the compressed collectives
(3), the hierarchical ones (4) and sharded pairwise perturbation (5).
"""

from .collectives import GATHERS, gather_cat, gather_sum, ordered_psum
from .dist_mttkrp import (
    dist_als_sweep,
    dist_contract_partial,
    dist_contract_range,
    dist_cp_als,
    dist_dimtree_sweep,
    dist_mttkrp,
    shard_problem,
)

__all__ = [
    "GATHERS",
    "gather_cat",
    "gather_sum",
    "ordered_psum",
    "dist_als_sweep",
    "dist_contract_partial",
    "dist_contract_range",
    "dist_cp_als",
    "dist_dimtree_sweep",
    "dist_mttkrp",
    "shard_problem",
]
