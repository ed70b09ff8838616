"""Trees of tensors, walked as ``jax.tree`` walks them.

The optimizer state, the gradients and the models' parameters are nested
dicts and lists whose leaves are tensors (the reference's pytrees): the
LM's are dicts, the GNNs' and xDeepFM's hold lists of layers. A dict is
walked in sorted key order and a list or tuple in index order, the order
``jax.tree.leaves`` flattens them in, so a sum over leaves
(``adamw.global_norm``) and a count over them (``grad_compress.
compress``'s wire bytes) add in the reference's order. A path holds a
dict's keys and a list's indices (ints).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

Path = Tuple[Union[str, int], ...]


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf (whatever is not a dict, list or tuple,
    or what ``is_leaf`` accepts), in ``jax.tree.leaves``' order."""
    # an explicit stack, not a recursive closure: a closure that calls
    # itself is a reference cycle, which would keep the leaves it listed
    # (parameters, gradients) alive until the collector runs
    out: List[Tuple[Path, Any]] = []
    stack = [((), tree)]
    while stack:
        path, node = stack.pop()
        if is_leaf is not None and is_leaf(node):
            out.append((path, node))
        elif isinstance(node, dict):
            stack.extend((path + (k,), node[k])
                         for k in sorted(node, reverse=True))
        elif isinstance(node, (list, tuple)):
            stack.extend((path + (i,), node[i])
                         for i in reversed(range(len(node))))
        else:
            out.append((path, node))
    return out


def unflatten(pairs):
    """The tree of ``(path, leaf)`` pairs, given in ``leaves``' order: a
    dict where a path holds a key, a list where it holds an index. The
    inverse of ``leaves`` for a tree of dicts and lists."""
    root: List[Any] = [None]
    for path, leaf in pairs:
        parent, slot = root, 0
        for k in path:
            node = (parent[slot] if isinstance(parent, list)
                    else parent.get(slot))
            if node is None:
                node = parent[slot] = [] if isinstance(k, int) else {}
            if isinstance(k, int) and k == len(node):
                node.append(None)
            parent, slot = node, k
        parent[slot] = leaf
    return {} if root[0] is None else root[0]


def is_shape(x) -> bool:
    """Whether ``x`` is a shape (a tuple of ints): the leaf of a tree of
    shapes, which ``leaves`` would otherwise walk into."""
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to each leaf."""
    return unflatten((p, fn(x)) for p, x in leaves(tree))
