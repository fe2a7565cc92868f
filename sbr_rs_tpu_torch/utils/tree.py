"""Parameter trees: nested dicts and lists of tensors (or arrays), walked in
one fixed order.

The order is the JAX package's (``jax.tree_util``): dict keys sorted, list
items in order, depth first. So ``flatten`` of a port tree and
``jax.tree_util.tree_leaves`` of the same JAX tree line up leaf by leaf.
A leaf's path joins its keys and list indices with dots (``"w_h"``,
``"layers.0.w_qkv"``, ``"ln_f.scale"``); a segment of digits is a list
index, so dict keys hold no dots and are not all digits.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` of ``tree`` in the JAX package's leaf order."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(flatten(sub, f"{prefix}.{key}" if prefix else key))
    return out


def unflatten(paths: Sequence[str], leaves: Sequence[Any]) -> Any:
    """The tree whose :func:`flatten` gives ``zip(paths, leaves)``: nested
    dicts, and lists where a path segment is a list index."""
    if len(paths) != len(leaves):
        raise ValueError(f"{len(paths)} paths for {len(leaves)} leaves")
    if not paths:
        return {}
    if list(paths) == [""]:
        return leaves[0]
    groups = {}  # first segment -> (rest paths, leaves), in first-seen order
    for path, leaf in zip(paths, leaves):
        head, _, rest = path.partition(".")
        sub_paths, sub_leaves = groups.setdefault(head, ([], []))
        sub_paths.append(rest)
        sub_leaves.append(leaf)
    children = {head: unflatten(*group) for head, group in groups.items()}
    if all(head.isdigit() for head in children):
        if sorted(int(h) for h in children) != list(range(len(children))):
            raise ValueError(f"list indices {sorted(children)} are not 0..{len(children) - 1}")
        return [children[str(i)] for i in range(len(children))]
    return children


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)``; empty dicts and
    lists are kept."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)
