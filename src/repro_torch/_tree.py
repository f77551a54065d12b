"""Nested parameter trees: leaf paths in the reference's checkpoint form.

The reference's parameters, optimizer state and checkpoints are JAX
pytrees, and its checkpoint keys are their leaf paths joined by ``"/"``
(a dict key, a sequence index, a named tuple's field name).  The port's
trees are plain dicts, lists, tuples and named tuples of tensors, walked
here in the same order (dict keys sorted) under the same paths.

One node differs by design: a :class:`Stacked` list holds the per-layer
subtrees of a stack that the reference runs under ``lax.scan`` and stores
as one array per leaf with a leading layer axis.  The port loops over the
layers, so it keeps them apart; :func:`flatten` stacks them under the
reference's keys (no layer index in the path) and :func:`rebuild` slices a
stacked array back into its layers.
"""

from __future__ import annotations

from typing import Any, Callable

SEP = "/"


class Stacked(list):
    """Per-layer subtrees the reference stacks along a leading layer axis."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """``(path part, child)`` pairs of an inner node; ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _join(path: str, part: str) -> str:
    return f"{path}{SEP}{part}" if path else part


def flatten(tree: Any, leaf: Callable[[Any], Any], stack: Callable[[list], Any],
            path: str = "", is_leaf: Callable[[Any], bool] | None = None) -> dict[str, Any]:
    """``{leaf path: leaf(x)}`` in the reference's order; the layers of a
    :class:`Stacked` node meet under one path through ``stack``.  ``None``
    is an empty node, as in a pytree; ``is_leaf`` stops the walk at nodes
    it accepts (a spec tuple, say)."""
    if tree is None:
        return {}
    if isinstance(tree, Stacked):
        per_layer = [flatten(t, leaf, lambda xs: xs, is_leaf=is_leaf) for t in tree]
        if not per_layer:
            return {}
        return {_join(path, k): stack([p[k] for p in per_layer]) for k in per_layer[0]}
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return {path: leaf(tree)}
    out: dict[str, Any] = {}
    for part, child in kids:
        out.update(flatten(child, leaf, stack, _join(path, part), is_leaf))
    return out


def rebuild(template: Any, fetch: Callable[[str], Any],
            convert: Callable[[Any, Any, str], Any], path: str = "") -> Any:
    """A tree of ``template``'s structure whose leaf at ``path`` is
    ``convert(fetch(path), template_leaf, path)``.  A :class:`Stacked` node
    fetches each stacked array once and converts layer ``i``'s slice
    ``[i]`` against layer ``i``'s template leaf."""
    if template is None:
        return None
    if isinstance(template, Stacked):
        memo: dict[str, Any] = {}

        def layer(i):
            def get(key):
                if key not in memo:
                    memo[key] = fetch(key)
                    if len(memo[key]) != len(template):
                        raise ValueError(f"{key}: {len(memo[key])} stacked layers, "
                                         f"template {len(template)}")
                return memo[key][i]
            return get

        return Stacked(rebuild(t, layer(i), convert, path) for i, t in enumerate(template))
    kids = _children(template)
    if kids is None:
        return convert(fetch(path), template, path)
    rebuilt = {part: rebuild(child, fetch, convert, _join(path, part)) for part, child in kids}
    if isinstance(template, dict):
        return {k: rebuilt[str(k)] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(rebuilt[f] for f in template._fields))
    return type(template)(rebuilt[str(i)] for i in range(len(template)))


def leaves(tree: Any) -> list:
    """Every leaf of ``tree``, the layers of a stack one by one."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for _, c in kids for x in leaves(c)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf ``x`` replaced by ``fn(x)``, called in the
    order of :func:`leaves`."""
    if tree is None:
        return None
    if isinstance(tree, Stacked):
        return Stacked(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):  # visited in sorted key order, as leaves() lists them
        mapped = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: mapped[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, c) for c in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c) for c in tree)
    return fn(tree)


def unflatten_like(tree: Any, new_leaves: list) -> Any:
    """``tree``'s structure with its leaves replaced, in :func:`leaves` order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)


def _spec_walk(tree: Any, specs: Any, out: list) -> None:
    """``specs``' node at each leaf of ``tree``, in :func:`leaves` order:
    the walk follows ``tree``'s structure, so a plain tuple of subtrees (a
    ``(params, opt_state)`` pair) is a node there and a spec at a leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _spec_walk(tree[k], specs[k], out)
    elif _is_namedtuple(tree):
        for f in tree._fields:
            _spec_walk(getattr(tree, f), getattr(specs, f), out)
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            _spec_walk(c, specs[i], out)
    else:
        out.append(specs)


def specs_of(tree: Any, specs: Any) -> list:
    """The spec of each leaf of ``tree`` (as ``Model.partition_specs``
    gives a spec tree of its structure), in the order of :func:`leaves`."""
    out: list = []
    _spec_walk(tree, specs, out)
    return out


def map_with_specs(fn: Callable[[Any, Any], Any], tree: Any, specs: Any) -> Any:
    """``tree`` with every leaf ``x`` replaced by ``fn(x, spec)``, its spec
    from the matching spec tree, called in the order of :func:`leaves`."""
    return unflatten_like(tree, [fn(x, s) for x, s in zip(leaves(tree), specs_of(tree, specs))])
