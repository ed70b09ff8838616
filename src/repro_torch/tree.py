"""Nested-dict trees of tensors, walked as ``jax.tree`` walks them.

The optimizer state, the gradients and the LM's parameters are nested
dicts whose leaves are tensors (the reference's pytrees). A dict is
walked in sorted key order, the order ``jax.tree.leaves`` flattens it
in, so a sum over leaves (``adamw.global_norm``) and a count over them
(``grad_compress.compress``'s wire bytes) add in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def leaves(tree) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf (whatever is not a dict), in sorted key
    order."""
    # an explicit stack, not a recursive closure: a closure that calls
    # itself is a reference cycle, which would keep the leaves it listed
    # (parameters, gradients) alive until the collector runs
    out: List[Tuple[Path, Any]] = []
    stack = [((), tree)]
    while stack:
        path, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((path + (k,), node[k])
                         for k in sorted(node, reverse=True))
        else:
            out.append((path, node))
    return out


def unflatten(pairs) -> Dict[str, Any]:
    """The nested dict of ``(path, leaf)`` pairs; the inverse of
    ``leaves`` for a tree that is a dict."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree) -> Dict[str, Any]:
    """``tree`` with ``fn`` applied to each leaf."""
    return unflatten((p, fn(x)) for p, x in leaves(tree))
