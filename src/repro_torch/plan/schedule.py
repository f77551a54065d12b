"""Contraction-schedule IR: general dimension trees as planner currency.

Port of ``repro.plan.schedule``: every builder, and the
pairwise-perturbation pair metadata (:class:`PPPair`, :func:`pp_pairs`).

The paper's Sec. 6 names dimension trees as the natural next step beyond
per-mode MTTKRP; Ma & Solomonik (arXiv:2010.12056) show *multi-level* trees
with partial reuse are where the real per-sweep savings live for order >= 4.
This module makes the tree shape itself a first-class plan object:

* :class:`ContractionNode` -- one GEMM over a mode subset: the contiguous
  mode range it keeps, the modes it contracts away from its parent, its
  reuse edges (children), and the psum axes/volume its placement requires.
* :class:`Schedule` -- a validated tree of nodes whose leaves are the N
  per-mode updates of one ALS sweep, in increasing mode order.

The flat per-mode sweep and the classic binary two-partial split are just
two degenerate trees (:func:`flat_schedule`, :func:`binary_schedule`);
:func:`chain_schedule` builds the maximal-reuse caterpillar tree, and
:func:`enumerate_schedules` is the candidate set ``plan_sweep`` argmins
over.  Arbitrary shapes come from :func:`build_schedule`'s nested spec.

Correctness invariant (why *any* schedule reproduces exact ALS iterates):
children partition their parent's contiguous range **in order**, and the
engine walks nodes in pre-order, materializing each node just before its
first descendant leaf updates.  At that moment every contracted mode below
the leaf's index is fresh (already updated this sweep) and every contracted
mode above it still holds its pre-sweep value -- exactly the factor state
standard ALS uses for that mode's update.  The binary tree's familiar
"T_L from old right factors, T_R from fresh left factors" recipe is the
two-node instance of this rule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .problem import Problem

# id of the schedule root (the raw tensor X; never contracted, never costed)
ROOT = 0


def ring_allreduce_bytes(block_bytes: float, participants: int) -> float:
    """Per-device wire bytes of a ring all-reduce of a ``block_bytes`` blob."""
    if participants <= 1:
        return 0.0
    return 2.0 * block_bytes * (participants - 1) / participants


@dataclass(frozen=True)
class ContractionNode:
    """One contraction of a schedule: a GEMM over a mode subset.

    The node keeps the contiguous tensor-mode range ``[lo, hi)`` and
    contracts ``contracted`` (the rest of its parent's range) with those
    modes' factors.  ``children`` are its reuse edges -- every child reads
    this node's output instead of recomputing it from the raw tensor.
    Placement metadata is stamped at build time from the Problem:
    ``reduce_axes`` are the mesh axes mapped to the modes contracted *here*
    (the psum that completes this node), ``psum_participants`` their device
    product, and ``psum_bytes`` the per-device ring all-reduce volume of the
    node's local output block.
    """

    id: int
    parent: int  # ROOT for children of the raw tensor; -1 on the root itself
    lo: int
    hi: int  # kept modes are range(lo, hi)
    parent_lo: int
    parent_hi: int
    contracted: tuple[int, ...]
    children: tuple[int, ...]
    shape: tuple[int, ...]  # global kept dims + (rank,); raw dims on the root
    local_shape: tuple[int, ...]  # per-device block dims of ``shape``
    reduce_axes: tuple[str, ...]
    psum_participants: int
    psum_bytes: float

    @property
    def modes(self) -> tuple[int, ...]:
        """The tensor modes surviving in this node's output, in order."""
        return tuple(range(self.lo, self.hi))

    @property
    def is_root(self) -> bool:
        """True for the schedule root (the raw tensor; not a contraction)."""
        return self.parent < 0

    @property
    def is_leaf(self) -> bool:
        """True when this node is one mode's MTTKRP (a factor update site)."""
        return not self.is_root and not self.children

    @property
    def mode(self) -> int:
        """The single kept mode of a leaf node."""
        if not self.is_leaf:
            raise ValueError(f"node {self.id} keeps modes {self.modes}, not one")
        return self.lo

    @property
    def from_root(self) -> bool:
        """True when this node contracts the raw tensor (not a partial)."""
        return self.parent == ROOT

    def as_dict(self) -> dict:
        """JSON-ready projection: topology + placement metadata."""
        return {
            "node": self.id,
            "parent": self.parent,
            "modes": list(self.modes),
            "contracted": list(self.contracted),
            "children": list(self.children),
            "shape": list(self.shape),
            "reduce_axes": list(self.reduce_axes),
            "psum_participants": self.psum_participants,
            "psum_bytes": self.psum_bytes,
        }


@dataclass(frozen=True)
class Schedule:
    """A contraction tree whose leaves are the N mode updates of one sweep.

    ``nodes`` is stored in pre-order (the engine's evaluation order): node 0
    is the root (the raw tensor), and every other node appears immediately
    after its parent and before its own subtree.  Validation enforces the
    ALS-exactness invariant -- contiguous kept ranges, children partitioning
    their parent's range in increasing order -- so every valid Schedule
    reproduces standard-ALS iterates by construction.
    """

    problem: Problem
    nodes: tuple[ContractionNode, ...]
    name: str = "custom"

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        self._validate()

    def _validate(self) -> None:
        n = self.problem.ndim
        if not self.nodes or self.nodes[0].parent != -1:
            raise ValueError("schedule must start with the root node")
        root = self.nodes[0]
        if (root.lo, root.hi) != (0, n):
            raise ValueError(f"root must keep all modes [0, {n})")
        by_id = {node.id: node for node in self.nodes}
        if sorted(by_id) != list(range(len(self.nodes))):
            raise ValueError("node ids must be consecutive from 0")
        leaves: list[int] = []
        for node in self.nodes[1:]:
            parent = by_id[node.parent]
            if not parent.lo <= node.lo < node.hi <= parent.hi:
                raise ValueError(
                    f"node {node.id} range [{node.lo}, {node.hi}) escapes its "
                    f"parent's [{parent.lo}, {parent.hi})"
                )
            if node.is_leaf:
                leaves.append(node.lo)
        for node in self.nodes:
            if node.children:
                if len(node.children) < 2:
                    raise ValueError(f"node {node.id} has a single child")
                spans = [(by_id[c].lo, by_id[c].hi) for c in node.children]
                bounds = [node.lo]
                for a, b in spans:
                    if a != bounds[-1]:
                        raise ValueError(
                            f"children of node {node.id} do not partition "
                            f"[{node.lo}, {node.hi}) in order"
                        )
                    bounds.append(b)
                if bounds[-1] != node.hi:
                    raise ValueError(
                        f"children of node {node.id} do not cover [{node.lo}, "
                        f"{node.hi})"
                    )
        if leaves != list(range(n)):
            raise ValueError(f"leaves must be modes 0..{n - 1} in order, got {leaves}")

    @property
    def root(self) -> ContractionNode:
        """The root node (the raw tensor)."""
        return self.nodes[0]

    def walk(self) -> tuple[ContractionNode, ...]:
        """Every contraction in evaluation order (pre-order, root excluded)."""
        return self.nodes[1:]

    def leaves(self) -> tuple[ContractionNode, ...]:
        """The N leaf nodes in increasing mode order."""
        return tuple(node for node in self.nodes if node.is_leaf)

    def leaf_for_mode(self, n: int) -> ContractionNode:
        """The leaf node updating mode ``n``."""
        for node in self.nodes:
            if node.is_leaf and node.lo == n:
                return node
        raise ValueError(f"no leaf for mode {n}")

    @property
    def is_flat(self) -> bool:
        """True for the degenerate tree: every leaf hangs off the root."""
        return all(node.is_leaf for node in self.nodes[1:])

    @property
    def split(self) -> int | None:
        """The binary half boundary, when the tree is the classic two-partial
        split: the root has exactly two children and each is a leaf or a
        one-level half (all grandchildren leaves).  ``None`` for every other
        shape (flat, chains, deeper trees)."""
        kids = self.root.children
        if self.is_flat or len(kids) != 2:
            return None
        for cid in kids:
            child = self.nodes[cid]
            if any(not self.nodes[g].is_leaf for g in child.children):
                return None
        return self.nodes[kids[1]].lo

    def describe(self) -> dict:
        """JSON-ready topology summary (name + per-node metadata rows)."""
        return {
            "name": self.name,
            "n_nodes": len(self.nodes) - 1,
            "nodes": [node.as_dict() for node in self.nodes[1:]],
        }


def _span(spec) -> tuple[int, int]:
    """Contiguous ``[lo, hi)`` covered by a nested spec; raises on gaps."""
    if isinstance(spec, int):
        return spec, spec + 1
    parts = list(spec)
    if not parts:
        raise ValueError("empty schedule spec")
    lo, hi = _span(parts[0])
    for sub in parts[1:]:
        a, b = _span(sub)
        if a != hi:
            raise ValueError(f"spec modes not contiguous/increasing at {a} (expected {hi})")
        hi = b
    return lo, hi


def build_schedule(problem: Problem, spec, name: str = "custom") -> Schedule:
    """Build a Schedule from a nested mode spec.

    ``spec`` is a nested sequence of tensor modes: an ``int`` is a leaf, a
    sequence is an internal node whose children are its elements, e.g.
    ``[0, 1, 2]`` (flat order-3), ``[[0, 1], [2, 3]]`` (binary order-4),
    ``[[[0, 1], 2], 3]`` (the chain).  Modes must appear exactly once, in
    increasing order, in contiguous runs -- the validity condition under
    which any tree reproduces exact ALS iterates.
    """
    lo, hi = _span(spec)
    if (lo, hi) != (0, problem.ndim):
        raise ValueError(
            f"spec covers modes [{lo}, {hi}), problem has [0, {problem.ndim})"
        )
    nodes: list[ContractionNode] = []

    def make(sub, parent_id: int, parent_lo: int, parent_hi: int) -> int:
        lo, hi = _span(sub)
        nid = len(nodes)
        contracted = tuple(
            m for m in range(parent_lo, parent_hi) if not lo <= m < hi
        )
        mapped = [m for m in sorted(problem.mode_axes) if m in set(contracted)]
        axes = tuple(problem.mode_axes[m] for m in mapped)
        participants = math.prod(problem.axis_sizes[a] for a in axes) if axes else 1
        local = tuple(problem.local_shape[m] for m in range(lo, hi))
        # batched problems psum one partial per local batch entry, so the
        # per-device wire volume scales with local_batch (zero for pure
        # batch-parallel placements, where no mode is mapped at all)
        block_bytes = (
            math.prod(local) * problem.rank * problem.itemsize
            * problem.local_batch
        )
        nodes.append(
            ContractionNode(
                id=nid,
                parent=parent_id,
                lo=lo,
                hi=hi,
                parent_lo=parent_lo,
                parent_hi=parent_hi,
                contracted=contracted,
                children=(),  # patched below once children exist
                shape=tuple(problem.shape[m] for m in range(lo, hi))
                + (problem.rank,),
                local_shape=local + (problem.rank,),
                reduce_axes=axes,
                psum_participants=participants,
                psum_bytes=ring_allreduce_bytes(block_bytes, participants),
            )
        )
        if not isinstance(sub, int):
            kids = tuple(make(s, nid, lo, hi) for s in sub)
            object.__setattr__(nodes[nid], "children", kids)
        return nid

    # the root: keeps everything, contracts nothing, shape = the raw tensor
    nodes.append(
        ContractionNode(
            id=ROOT,
            parent=-1,
            lo=0,
            hi=problem.ndim,
            parent_lo=0,
            parent_hi=problem.ndim,
            contracted=(),
            children=(),
            shape=tuple(problem.shape),
            local_shape=tuple(problem.local_shape),
            reduce_axes=(),
            psum_participants=1,
            psum_bytes=0.0,
        )
    )
    kids = tuple(make(s, ROOT, 0, problem.ndim) for s in spec)
    object.__setattr__(nodes[ROOT], "children", kids)
    return Schedule(problem=problem, nodes=tuple(nodes), name=name)


@dataclass(frozen=True)
class PPPair:
    """Placement metadata of one pairwise-perturbation intermediate.

    ``M_{n,m}[c, i_n, i_m] = sum X * prod_{k not in {n, m}} V_k[i_k, c]`` --
    the cached two-mode partial of Ma & Solomonik's pairwise perturbation
    (arXiv 2010.12056), built once per exact sweep and reused by every
    approximate sweep until factor drift crosses ``Problem.pp_tol``.  The
    stored layout is rank-major ``(C, I_n, I_m)`` so every per-sweep
    correction contraction is a stride-1 batched GEMM over the rank axis
    (the index-major layout forces a transpose per correction, which on
    CPU costs more than the GEMM itself).  Like :class:`ContractionNode`,
    placement is stamped at build time: ``reduce_axes`` are the mesh axes
    mapped to the modes contracted away (everything but ``n`` and ``m``),
    ``psum_participants`` their device product, and ``psum_bytes`` the
    per-device ring all-reduce volume of the local ``(C, I_n, I_m)`` block.
    """

    n: int
    m: int
    shape: tuple[int, int, int]  # global (rank, I_n, I_m)
    local_shape: tuple[int, int, int]  # per-device block dims of ``shape``
    reduce_axes: tuple[str, ...]
    psum_participants: int
    psum_bytes: float

    def as_dict(self) -> dict:
        """JSON-ready projection: pair topology + placement metadata."""
        return {
            "pair": [self.n, self.m],
            "shape": list(self.shape),
            "reduce_axes": list(self.reduce_axes),
            "psum_participants": self.psum_participants,
            "psum_bytes": self.psum_bytes,
        }


def pp_pairs(problem: Problem) -> tuple[PPPair, ...]:
    """Every pairwise intermediate of one PP cache, in ``(n, m)`` order.

    One :class:`PPPair` per unordered mode pair ``n < m`` -- the reuse set a
    pairwise-perturbation sweep reads: mode ``n``'s approximate MTTKRP takes
    its base term plus one small correction GEMM against ``M_{n,m}`` for
    every other mode ``m``.  The psum metadata mirrors the schedule nodes'
    convention (ring all-reduce over the axes mapped to contracted modes),
    so sharded PP builds need only the same per-node collectives.
    """
    c = problem.rank
    s = problem.itemsize
    lb = problem.local_batch
    out = []
    for n in range(problem.ndim):
        for m in range(n + 1, problem.ndim):
            mapped = [
                k for k in sorted(problem.mode_axes) if k != n and k != m
            ]
            axes = tuple(problem.mode_axes[k] for k in mapped)
            participants = (
                math.prod(problem.axis_sizes[a] for a in axes) if axes else 1
            )
            local = (
                c, problem.local_shape[n], problem.local_shape[m]
            )
            block_bytes = math.prod(local) * s * lb
            out.append(
                PPPair(
                    n=n,
                    m=m,
                    shape=(c, problem.shape[n], problem.shape[m]),
                    local_shape=local,
                    reduce_axes=axes,
                    psum_participants=participants,
                    psum_bytes=ring_allreduce_bytes(block_bytes, participants),
                )
            )
    return tuple(out)


def flat_schedule(problem: Problem) -> Schedule:
    """The degenerate tree of the per-mode sweep: N leaves off the root."""
    return build_schedule(problem, list(range(problem.ndim)), name="flat")


def binary_schedule(problem: Problem, split: int | None = None) -> Schedule:
    """The classic two-partial dimension tree with the half boundary at
    ``split`` (default: the balanced half).  Size-1 halves degenerate to
    leaves hanging directly off the root -- that half's "partial" *is* the
    mode's full MTTKRP."""
    n = problem.ndim
    m = split if split is not None else (n + 1) // 2
    if not 0 < m < n:
        raise ValueError(f"split {m} out of range for order-{n} tensor")
    left = list(range(m)) if m > 1 else 0
    right = list(range(m, n)) if n - m > 1 else m
    return build_schedule(problem, [left, right], name=f"binary@{m}")


def chain_schedule(problem: Problem) -> Schedule:
    """The maximal-reuse caterpillar tree (Ma & Solomonik's deep chain):
    each level contracts exactly one trailing mode, so the partial for modes
    ``[0, k)`` is reused -- not recomputed -- by every level below it."""
    n = problem.ndim
    if n < 3:
        return flat_schedule(problem)
    spec = [0, 1]
    for m in range(2, n):
        spec = [spec, m]
    return build_schedule(problem, spec, name="chain")


def enumerate_schedules(problem: Problem) -> list[Schedule]:
    """The planner's candidate tree shapes for ``problem``.

    Flat, the binary split at every boundary, and -- for order >= 4, where
    multi-level reuse starts paying (Ma & Solomonik) -- the chain tree.
    Order-3 already yields 3 distinct shapes; order-4 yields 5.
    """
    scheds = [flat_schedule(problem)]
    if problem.ndim >= 3:
        for m in range(1, problem.ndim):
            scheds.append(binary_schedule(problem, m))
    if problem.ndim >= 4:
        scheds.append(chain_schedule(problem))
    return scheds
