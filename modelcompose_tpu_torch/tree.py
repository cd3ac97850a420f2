"""Walks over parameter trees: nested dicts and lists of tensors.

Paths are tuples of dict keys and list indices, as ``jax.tree_util`` paths
are; dict keys are visited in sorted order, as ``jax.tree.leaves`` visits
them, so the port's leaves line up with the JAX package's one for one.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

Path = Tuple[Any, ...]


def tree_leaves(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map_with_path(fn: Callable[[Path, Any], Any], tree, path: Path = ()):
    """The same tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def numpy_to_torch(tree, dtype, device=None):
    """A tree of numpy arrays -> the same tree of ``dtype`` tensors on
    ``device`` (the checkpoint converters' last step)."""
    import numpy as np
    import torch
    return tree_map_with_path(
        lambda _, a: torch.from_numpy(np.array(a)).to(device=device,
                                                      dtype=dtype), tree)
