"""Walks over the port's parameter and optimizer trees: nested dicts,
tuples (a ``NamedTuple`` by field) and lists of tensors, in the order
``jax.tree_util`` flattens the reference's pytrees (dict keys sorted)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def items(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf; a path is ``/``-joined keys, field
    names and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from items(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def leaves(tree) -> List[Any]:
    return [v for _, v in items(tree)]


def unflatten(tree_like, new_leaves) -> Any:
    """``tree_like``'s structure holding ``new_leaves`` (in ``items``
    order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map_(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (the same structure), keeping ``tree``'s structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in zip(leaves(tree),
                                                      *others)])
