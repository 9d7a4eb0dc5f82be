"""Map over the tensors of a state: NamedTuples (nested) of tensors.

The port's states are NamedTuples whose every tensor carries the stream
axis first, so slicing streams, stacking states and moving them between
numpy and torch are one ``tree_map`` each.
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
    """The tensors of a state, depth first."""
    if isinstance(tree, tuple):
        for x in tree:
            yield from leaves(x)
    else:
        yield tree
