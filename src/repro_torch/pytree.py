"""Trees of tensors in the JAX package's leaf order.

The port keeps the JAX package's trees as plain containers: dicts of
tensors (parameters, optimizer states), tuples and lists, and dataclasses
(`runtime.train.TrainState`, whose fields are its children, as the JAX
package registers them). `leaves_with_paths` walks a tree the way
`jax.tree_util.tree_flatten_with_path` does: dict keys in sorted order,
sequences and dataclass fields by position. Sums over leaves (the global
gradient norm) and checkpoint keys ("0/embed", "1/m/layers/attn/wq", "2")
follow that order, so they match the JAX package's.
"""
from __future__ import annotations

import dataclasses


def _children(node):
    """[(key, child)] of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(i, getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    return None


def leaves_with_paths(tree) -> list[tuple[tuple, object]]:
    """[(path, leaf)] in the JAX package's flattening order; a path is the
    tuple of dict keys and positions from the root. None is an empty
    subtree, as in JAX."""
    out = []
    _walk(tree, (), out)
    return out


def _walk(node, path: tuple, out: list) -> None:
    # a module-level function: a nested one that calls itself is a
    # reference cycle through its closure, which would keep ``out`` (and
    # the leaves, a card's tensors) alive until the cyclic collector runs
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, path + (key,), out)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_str(path: tuple) -> str:
    """The JAX package's checkpoint key of a path: its parts joined by
    '/'."""
    return "/".join(str(p) for p in path)


def get(tree, path: tuple):
    """The subtree at ``path`` of dicts, sequences and dataclasses."""
    for key in path:
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            tree = getattr(tree, dataclasses.fields(tree)[key].name)
        else:
            tree = tree[key]
    return tree


def put(tree, path: tuple, value) -> None:
    """Set the leaf at ``path`` of dicts and lists to ``value``, in place."""
    parent = get(tree, path[:-1])
    parent[path[-1]] = value


def tree_map(fn, tree):
    """A new tree of dicts, tuples and lists with ``fn`` applied to every
    leaf (dataclasses are not rebuilt)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
