"""Pytree helpers for the port's nested params and train states.

The JAX package leans on ``jax.tree_util``; the port keeps the same leaf
order, because optimizer states, gradient sums and checkpoints are lists of
leaves in that order and a checkpoint written by one package is read by the
other:

  - a dict's children come in sorted-key order,
  - a list's or tuple's in their own order,
  - a dataclass's in field order (``TrainState`` is (params, opt), as the
    reference registers it),
  - ``None`` holds no leaf; anything else is a leaf.

``str(treedef)`` prints the structure the way ``jax.tree_util`` prints a
``PyTreeDef``, so the checkpoints' ``tree.json`` reads the same.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["TreeDef", "tree_flatten", "tree_unflatten", "tree_leaves",
           "tree_map", "tree_paths"]


@dataclasses.dataclass(frozen=True)
class TreeDef:
    kind: str                   # leaf | none | dict | list | tuple | dataclass
    meta: Any = None            # dict keys (sorted) or the dataclass type
    children: tuple = ()

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        parts = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {p}"
                                   for k, p in zip(self.meta, parts)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(parts) + "]"
        if self.kind == "tuple":
            return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") \
                + ")"
        return f"CustomNode({self.meta.__name__}[()], [{', '.join(parts)}])"

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"


def _is_dataclass_instance(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _walk(node, leaves: list, is_leaf=None) -> TreeDef:
    if node is None:
        return TreeDef("none")
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return TreeDef("leaf")
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys, tuple(_walk(node[k], leaves, is_leaf)
                                           for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, None, tuple(_walk(c, leaves, is_leaf)
                                         for c in node))
    if _is_dataclass_instance(node):
        return TreeDef("dataclass", type(node), tuple(
            _walk(getattr(node, f.name), leaves, is_leaf)
            for f in dataclasses.fields(node)))
    leaves.append(node)
    return TreeDef("leaf")


def tree_flatten(tree: Any, is_leaf: Callable | None = None
                 ) -> tuple[list, TreeDef]:
    """(leaves, treedef); ``is_leaf(node)`` true keeps a container whole as
    one leaf (a spec tuple in a tree of specs)."""
    # Module-level recursion: a nested recursive function is a reference
    # cycle that would keep ``leaves`` (and so every tensor in it) alive
    # until the garbage collector runs.
    leaves: list = []
    return leaves, _walk(tree, leaves, is_leaf)


def _paths(td: TreeDef, prefix: tuple, out: list) -> None:
    if td.kind == "leaf":
        out.append(prefix)
    elif td.kind == "dict":
        for k, c in zip(td.meta, td.children):
            _paths(c, prefix + (("key", k),), out)
    elif td.kind in ("list", "tuple"):
        for i, c in enumerate(td.children):
            _paths(c, prefix + (("index", i),), out)
    elif td.kind == "dataclass":
        for f, c in zip(dataclasses.fields(td.meta), td.children):
            _paths(c, prefix + (("attr", f.name),), out)


def tree_paths(tree: Any) -> list[tuple]:
    """Each leaf's path, in leaf order: a tuple of ``("key", dict key)``,
    ``("index", list or tuple index)`` and ``("attr", dataclass field)``
    steps, as ``jax.tree_util``'s ``DictKey``, ``SequenceKey`` and
    ``GetAttrKey``."""
    out: list = []
    _paths(tree_flatten(tree)[1], (), out)
    return out


def _build(td: TreeDef, it) -> Any:
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.meta, kids))
    if td.kind == "list":
        return kids
    if td.kind == "tuple":
        return tuple(kids)
    return td.meta(*kids)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and each of ``rest``
    (which must have ``tree``'s structure)."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {r_def}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
