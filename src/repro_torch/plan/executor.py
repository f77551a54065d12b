"""Executors: where a planned contraction actually runs.

Port of the single-device part of ``repro.plan.executor``: the
:class:`Executor` protocol, :class:`LocalExecutor` (schedule nodes and
the pairwise-perturbation intermediates) and :func:`make_executor`.  The
sharded, overlapping and compressed executors come with the distribution
slice of the port.
"""

from __future__ import annotations

from typing import Mapping, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core.dimtree import contract_from_partial, partial_mttkrp_range
from repro_torch.core.mttkrp import mttkrp, mttkrp_batched
from repro_torch.core.tensor_ops import mode_letters

from .cost import EXECUTORS
from .schedule import ContractionNode

Tensor = torch.Tensor


def _node_is_batched(node: ContractionNode, src: Tensor) -> bool:
    """True when ``src`` carries a leading batch axis over the node's shape.

    The unbatched source of a node has a known rank from the topology alone:
    the raw tensor's order for root contractions, the parent's kept modes
    plus the rank axis for partial-to-partial ones.  One extra axis = batch.
    """
    expected = (node.parent_hi - node.parent_lo) + (0 if node.from_root else 1)
    return src.ndim == expected + 1


@runtime_checkable
class Executor(Protocol):
    """The contractions an ALS sweep needs, placement included.

    The schedule walker drives everything through :meth:`contract` -- one
    entry point per :class:`repro_torch.plan.schedule.ContractionNode`,
    whether the node is a full mode MTTKRP, a root-level partial GEMM, or a
    partial-to-partial multi-TTV.
    """

    def prepare(self, problem, x: Tensor, factors: Sequence[Tensor]):
        """Place tensor + factors for this executor (identity when local)."""
        ...

    def contract(
        self, node: ContractionNode, src: Tensor, factors: Sequence[Tensor],
        algorithm: str = "auto", tiles: Mapping[str, int] | None = None,
    ) -> Tensor:
        """Run one schedule node's contraction of ``src`` (the parent's
        output; the raw tensor for children of the root)."""
        ...


class LocalExecutor:
    """Single-device execution of the paper's shared-memory algorithms on
    whatever device the tensor lies on."""

    def prepare(self, problem, x: Tensor, factors: Sequence[Tensor]):
        """No placement needed on one device: returns inputs unchanged."""
        return x, list(factors)

    def contract(
        self, node: ContractionNode, src: Tensor, factors: Sequence[Tensor],
        algorithm: str = "auto", tiles: Mapping[str, int] | None = None,
    ) -> Tensor:
        """One schedule node: the planned MTTKRP for leaves off the root,
        the range GEMM for internal nodes off the root, a multi-TTV einsum
        for anything contracted from a partial.  A leading batch axis on
        ``src`` (and every factor) runs the batched MTTKRP for leaves (the
        batched kernels under ``fused``/``matrix_free``) and a
        ``torch.func.vmap`` of the same contraction otherwise."""
        batched = _node_is_batched(node, src)
        if node.from_root:
            if node.is_leaf:
                run = mttkrp_batched if batched else mttkrp
                return run(src, list(factors), node.mode, method=algorithm, tiles=tiles)
            if batched:
                return torch.func.vmap(
                    lambda t, *fs: partial_mttkrp_range(t, list(fs), node.lo, node.hi)
                )(src, *factors)
            return partial_mttkrp_range(src, list(factors), node.lo, node.hi)
        if batched:
            return torch.func.vmap(
                lambda t, *fs: contract_from_partial(
                    t, dict(zip(node.contracted, fs)), node.lo, node.hi, node.parent_lo
                )
            )(src, *[factors[m] for m in node.contracted])
        sibs = {m: factors[m] for m in node.contracted}
        return contract_from_partial(src, sibs, node.lo, node.hi, node.parent_lo)

    def pp_pairs(
        self, problem, x: Tensor, factors: Sequence[Tensor]
    ) -> dict[tuple[int, int], Tensor]:
        """All pairwise-perturbation intermediates at the current factors:
        ``{(n, m): M_nm}`` for every ``n < m`` with
        ``M_nm[c, i_n, i_m] = sum X * prod_{k not in {n,m}} U_k[i_k, c]``
        in the rank-major layout of :class:`repro_torch.plan.schedule.PPPair`.
        One einsum a pair, contracted rank-last (the GEMM orientation), then
        rank moved to the front and made contiguous, so every correction is
        a stride-1 batched GEMM; a leading batch axis on ``x`` and the
        factors broadcasts through the ``...`` prefix."""
        order = problem.ndim
        letters = mode_letters(order)
        out: dict[tuple[int, int], Tensor] = {}
        for n in range(order):
            for m in range(n + 1, order):
                others = [k for k in range(order) if k not in (n, m)]
                spec = (
                    ",".join(["..." + letters] + ["..." + letters[k] + "c" for k in others])
                    + "->..." + letters[n] + letters[m] + "c"
                )
                p = torch.einsum(spec, x, *[factors[k] for k in others])
                out[(n, m)] = torch.movedim(p, -1, -3).contiguous()
        return out


def make_executor(kind: str, mesh=None, mode_axes=None) -> Executor:
    """Instantiate the executor for a planner-chosen kind (``"local"``; the
    sharded kinds come with the distribution slice of the port)."""
    if kind not in EXECUTORS:
        raise ValueError(f"unknown executor kind {kind!r} (choose from {EXECUTORS})")
    if kind != "local":
        raise NotImplementedError(
            f"executor {kind!r} comes with the distribution slice of the port"
        )
    return LocalExecutor()
