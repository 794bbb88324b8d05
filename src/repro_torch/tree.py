"""Parameter trees: nested dicts and lists of tensors, the port's form of
the reference's pytrees (``params``, gradients, optimizer moments)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Every leaf with its path, in order: dict keys and list indices
    joined by "/", each with a leading "/" (``/groups/0/b0/attn/dsa/p``),
    the form of the reference optimizer's paths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which share its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
