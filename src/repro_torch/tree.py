"""The trees of the port's training path: nested dicts, NamedTuples,
lists and tuples of tensors (parameters, `TrainState`, `OptState`).

Leaves come out in the order JAX flattens the same structure (dict keys
sorted, NamedTuple fields in declaration order, None an empty subtree),
and `tree_paths` names each leaf as `jax.tree_util.keystr` does
(``.params['blocks']['attn']['wq']``, ``.opt.count``), so a checkpoint
written by one package restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key string, child) pairs of an inner node, in flattening order."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return [(f"[{i}]", c) for i, c in enumerate(tree)]


def _is_inner(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in flattening order."""
    if tree is None:
        return []
    if not _is_inner(tree):
        return [(prefix, tree)]
    return [pl for key, child in _children(tree)
            for pl in tree_paths(child, prefix + key)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(f: Callable, tree, *rest, with_path: bool = False,
             _path: str = ""):
    """``f`` applied leaf by leaf, in flattening order, to ``tree`` and
    the trees of the same structure in ``rest``; ``with_path=True``
    passes the leaf's keystr path first. The structure (dict, NamedTuple,
    list, tuple, None) is kept."""
    if tree is None:
        return None
    if not _is_inner(tree):
        args = (tree,) + tuple(rest)
        return f(_path, *args) if with_path else f(*args)
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    kids = [tree_map(f, tree[k], *(r[k] for r in rest),
                     with_path=with_path, _path=_path + key)
            for k, (key, _c) in zip(keys, _children(tree))]
    if isinstance(tree, dict):
        return dict(zip(keys, kids))
    if _is_namedtuple(tree):
        return type(tree)(*kids)
    return type(tree)(kids)


def tree_unflatten(like, leaves):
    """``leaves``, in flattening order, put into the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _x: next(it), like)
