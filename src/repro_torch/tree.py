"""Nested containers of tensors taken leaf by leaf in ``jax.tree``'s order.

A dict's values come in sorted key order; a tuple's, a list's and a
NamedTuple's in field order; ``None`` holds no leaf; anything else is a
leaf.  The optimizer and the checkpoint store walk their trees in this
order, so the port sums the gradient norm, and numbers checkpoint leaves,
as the JAX package does.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _collect(tree, out)
    return out


def _collect(tree: Any, out: List[Any]) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            _collect(tree[key], out)
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            _collect(item, out)
    else:
        out.append(tree)


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """``like``'s structure with ``new_leaves`` in its leaves' places."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


_END = object()


def _build(node: Any, it: Iterator[Any]) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {key: _build(node[key], it) for key in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[_build(item, it) for item in node])
    if isinstance(node, (tuple, list)):
        return type(node)(_build(item, it) for item in node)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the structure holds")
    return leaf


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, in its structure."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def describe(tree: Any) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` spells it, ``*`` for
    each leaf (the checkpoint's ``treedef``, equal to the JAX package's)."""
    return f"PyTreeDef({_spell(tree)})"


def _spell(tree: Any) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        inner = ", ".join(f"{key!r}: {_spell(tree[key])}" for key in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ", ".join(_spell(v) for v in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, tuple):
        inner = ", ".join(_spell(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_spell(v) for v in tree) + "]"
    return "*"
