"""Parameter and cache trees: named flattening and byte accounting of
tensors (the port's parameter and cache leaves)."""

from __future__ import annotations

import math
from typing import Any

from repro_torch.common import hw


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
