"""Map over the tensors of a state: NamedTuples (nested) of tensors, and
over parameter trees: nested dicts of tensors.

The port's states are NamedTuples whose every tensor carries the stream
axis first, so slicing streams, stacking states and moving them between
numpy and torch are one ``tree_map`` each.  A model's parameters, their
gradients and an optimizer's per-parameter state are nested dicts with
the same keys; ``map_dicts`` walks them in sorted key order, the order in
which ``jax.tree_util`` flattens a dict.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over one or more trees of the same structure."""
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") \
            else type(tree)(mapped)
    return fn(tree, *rest)


def take(tree: Any, idx) -> Any:
    """The streams ``idx`` (a LongTensor or slice) of every leaf."""
    if isinstance(idx, slice):
        return tree_map(lambda x: x[idx], tree)
    return tree_map(lambda x: x.index_select(0, idx), tree)


def leaves(tree: Any):
    """The tensors of a state or of nested dicts, depth first (dict keys
    sorted)."""
    if isinstance(tree, tuple):
        for x in tree:
            yield from leaves(x)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def map_dicts(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over nested dicts with the same keys; any
    value that is not a dict is a leaf."""
    if isinstance(tree, dict):
        return {k: map_dicts(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)
