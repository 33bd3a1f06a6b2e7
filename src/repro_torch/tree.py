"""Parameter trees: nested dicts walked in ``jax.tree_util`` order.

The JAX package names each leaf by ``jax.tree_util.keystr`` of its path
(``"['blocks']['q']['w']"``) and visits dict keys in sorted order.
Recipe regexes, rung assignments, pager keys and the order of per-leaf
ledger events all depend on both, so the port reproduces them exactly.
Trees here are nested ``dict``s; anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def keystr(path: Tuple[str, ...]) -> str:
    """``('blocks', 'q', 'w')`` -> ``"['blocks']['q']['w']"``."""
    return "".join(f"[{k!r}]" for k in path)


def flatten_with_path(tree, _prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_path(tree[k], _prefix + (k,)))
        return out
    return [(keystr(_prefix), tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` (in
    :func:`flatten_with_path` order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree,
                  _prefix: Tuple[str, ...] = ()) -> Any:
    """Apply ``fn(keystr, leaf)`` to every leaf; structure is kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], _prefix + (k,))
                for k in sorted(tree)}
    return fn(keystr(_prefix), tree)
