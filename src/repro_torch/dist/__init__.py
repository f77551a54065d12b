"""Distributed-memory extension of the paper's shared-memory MTTKRP.

Port of ``repro.dist``: flat sharded CP-ALS, its reductions overlapped
with the contractions or compressed, the two-level (hierarchical)
reductions of a node mesh, and sharded pairwise perturbation.
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

Every entry takes ``collective="hierarchical"`` with a ``node_axis``: the
reduction is then the reduce-scatter within the node, the ordered sum of
the ``1/k`` shard across nodes and the all-gather back, so only a ``1/k``
of each block crosses the slow level.  ``dist_pp_pairs`` builds the
pairwise-perturbation intermediates of a block-distributed tensor.

``collectives``: the ordered gather-sum every exact reduction of the port
runs (deterministic: a fixed summation order, the same bits on every
rank), with its call counter ``GATHERS``, its asynchronous form,
``compressed_psum``/``init_error_state``, and the two-level
``reduce_scatter`` (counted in ``SCATTERS``), ``all_gather`` and
``hierarchical_psum``.  The compressed data-parallel train step comes with
the sharded LM (``ROADMAP.md`` queue 1).
"""

from .collectives import (
    GATHERS,
    INT8_GATHERS,
    SCATTERS,
    all_gather,
    compressed_psum,
    gather_cat,
    gather_sum,
    hierarchical_psum,
    init_error_state,
    ordered_psum,
    ordered_psum_async,
    reduce_scatter,
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
    dist_pp_pairs,
    init_mttkrp_error_state,
    shard_problem,
)

__all__ = [
    "DEFAULT_OVERLAP_CHUNKS",
    "GATHERS",
    "INT8_GATHERS",
    "SCATTERS",
    "SLAB_COPIES",
    "all_gather",
    "compressed_psum",
    "gather_cat",
    "gather_sum",
    "hierarchical_psum",
    "init_error_state",
    "ordered_psum",
    "ordered_psum_async",
    "reduce_scatter",
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
    "dist_pp_pairs",
    "init_mttkrp_error_state",
    "shard_problem",
]
