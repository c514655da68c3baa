"""Parameter and cache trees (nested dicts): mapping, flattening, named
flattening and byte accounting of tensors (the port's parameter and
cache leaves)."""

from __future__ import annotations

import math
from typing import Any

from repro_torch.common import hw


def tree_map(fn, *trees):
    """`fn` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the reference's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def named_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Leaves of nested dicts (the port's parameter and cache trees) as
    ('a/b/c', leaf), in the reference's order and spelling
    (`repro.common.pytree`): keys sorted, as jax flattens a dict."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += named_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def leaf_bytes(leaf) -> int:
    """Bytes of one tensor (meta tensors included: shape and dtype only)."""
    shape = tuple(getattr(leaf, "shape", ()))
    n = math.prod(shape) if shape else 1
    return n * hw.dtype_size(leaf.dtype)
