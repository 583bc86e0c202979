"""Param trees: nested dicts and lists (or tuples) whose leaves are
tensors, the port's counterpart of JAX pytrees.  A path is the tuple of
dict keys and list indices from the root to a leaf."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_path(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, dicts in their key order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in leaves_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree: Any, *rest: Any,
                  path: Path = ()) -> Any:
    """``fn(path, leaf, *leaves of rest at path)`` over ``tree``'s
    structure (``rest`` share it)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` over ``tree``'s structure."""
    return map_with_path(lambda _, *ls: fn(*ls), tree, *rest)


def unflatten(like: Any, flat: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced by ``flat`` in
    `leaves` order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def path_key(path: Path) -> str:
    """``("layers", 3, "mixer", "wq")`` -> ``"layers/3/mixer/wq"``."""
    return "/".join(str(p) for p in path)


def at(tree: Any, path: Path) -> Any:
    """The subtree (or leaf) of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def unzip(like: Any, tree: Any, n: int) -> Tuple[Any, ...]:
    """``n`` trees of ``like``'s structure from ``tree``, which holds an
    n-tuple at each of ``like``'s leaves (what `map_with_path` gives for
    a function returning tuples)."""
    return tuple(map_with_path(lambda path, _: at(tree, path)[i], like)
                 for i in range(n))
