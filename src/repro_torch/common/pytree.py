"""Byte accounting of tensors (the port's parameter and cache leaves)."""

from __future__ import annotations

import math

from repro_torch.common import hw


def leaf_bytes(leaf) -> int:
    """Bytes of one tensor (meta tensors included: shape and dtype only)."""
    shape = tuple(getattr(leaf, "shape", ()))
    n = math.prod(shape) if shape else 1
    return n * hw.dtype_size(leaf.dtype)

