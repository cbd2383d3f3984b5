"""Nested dict / list trees of tensors (the port's parameter, gradient and
optimizer-state trees): map over leaves in step, and list them with their
paths. The reference uses ``jax.tree``; a leaf is anything that is not a dict
or a list / tuple, or what ``is_leaf`` accepts (a quantized {"q", "scale"}
moment, say)."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Path = Tuple[Any, ...]  # dict keys and list indices from the root


def _is_leaf(x, is_leaf) -> bool:
    return (is_leaf is not None and is_leaf(x)) or not isinstance(x, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest`` (the
    same structure, or deeper: their subtree at each of ``tree``'s leaves is
    passed whole), rebuilding ``tree``'s structure."""
    if _is_leaf(tree, is_leaf):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf) for i, v in enumerate(tree)]


def tree_leaves_with_path(tree, is_leaf: Optional[Callable] = None,
                          path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs, depth first in key / index order."""
    if _is_leaf(tree, is_leaf):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [pl for k, v in items for pl in tree_leaves_with_path(v, is_leaf, path + (k,))]


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]
