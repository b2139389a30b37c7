"""Nested-dict helpers: the port's parameter trees are dicts of dicts of
tensors. Leaves are visited in sorted-key order, which is the order
``jax.tree_util.tree_flatten`` gives dicts in the reference."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree: Any, path: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_from_items(items: Iterable[Tuple[Tuple[str, ...], Any]]) -> Dict:
    """Inverse of ``tree_items``: nested dicts from (path, leaf) pairs."""
    tree: Dict = {}
    for path, leaf in items:
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return tree
