"""Parameter trees: seeded initialization and loading from numpy.

Parameters are plain nested dicts of tensors with the reference's keys
(`embed/embedding`, `final_norm/scale`, `blocks/pos{j}/attn/wq`, ...) and
its stacked leading `nb` layer axis on every block leaf, so a tree from
`repro.models.model.init_model` converts leaf for leaf
(`load_numpy_params`). Beside the values every initializer records the
reference's logical-axis tree (one name or None per dim, "layers" on the
stacked axis), which the sharding rules (`runtime.sharding`) resolve
into each rank's shard over a mesh.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def torch_dtype(name) -> torch.dtype:
    """torch dtype of a config dtype name ("float32", "bfloat16", ...)."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


class Initializer:
    """Collects parameters during init, drawing from one
    `torch.Generator` (so a seed fixes every weight).

    `lead` is a shape prefix given to every parameter — the stacked `nb`
    layer axis — while the initializer scale still follows the per-layer
    shape, as the reference's vmapped init does: "normal" draws
    N(0, 1/fan_in) with fan_in = shape[0], "embedding" N(0, 0.02^2).
    The numbers differ from the reference's `jax.random` draws; the
    shapes and scales do not. With no generator the parameters are meta
    tensors (shapes and dtypes only, nothing allocated), the counterpart
    of the reference's `shape_mode()`. `axes` names each dim of `shape`
    as the reference's `init.param` does; the lead axis is "layers"."""

    def __init__(self, generator: Optional[torch.Generator],
                 dtype=torch.float32, lead: tuple = ()):
        self._gen = generator
        self._dtype = dtype
        self._lead = tuple(lead)
        self._values: dict = {}
        self._axes: dict = {}

    def param(self, name: str, shape: tuple, axes: tuple,
              init: str = "normal",
              scale: Optional[float] = None) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} vs axes {axes}")
        full = self._lead + tuple(shape)
        dev = torch.device("meta") if self._gen is None else self._gen.device
        if init == "zeros":
            v = torch.zeros(full, dtype=self._dtype, device=dev)
        elif init == "ones":
            v = torch.ones(full, dtype=self._dtype, device=dev)
        elif init in ("normal", "embedding"):
            if scale is None:
                fan_in = shape[0] if shape else 1
                scale = (1.0 / math.sqrt(max(fan_in, 1))
                         if init == "normal" else 0.02)
            v = torch.randn(full, generator=self._gen, dtype=self._dtype,
                            device=dev) * scale
        else:
            raise ValueError(f"unknown init {init}")
        self._values[name] = v
        self._axes[name] = ("layers",) * len(self._lead) + tuple(axes)
        return v

    def child(self, name: str) -> "Initializer":
        sub = Initializer(self._gen, self._dtype, self._lead)
        self._values[name] = sub._values
        self._axes[name] = sub._axes
        return sub

    def collect(self) -> dict:
        return self._values

    def axes(self) -> dict:
        """The logical-axis tree matching `collect()`."""
        return self._axes


def load_numpy_params(tree, *, device, dtype=None):
    """The port's parameter tree from the reference's, as numpy arrays
    (`jax.tree.map(np.asarray, init_model(cfg, PRNGKey(0))[0])`): same
    keys, same shapes, values copied to `device`; floating leaves cast to
    `dtype` when given."""
    if isinstance(tree, dict):
        return {k: load_numpy_params(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(torch_dtype(dtype))
    return t


def cast_params(tree, dtype):
    """Floating leaves cast to `dtype` (the serving copy of f32 master
    weights: casting once gives the values the reference casts at every
    use)."""
    dt = torch_dtype(dtype)
    if isinstance(tree, dict):
        return {k: cast_params(v, dt) for k, v in tree.items()}
    return tree.to(dt) if tree.is_floating_point() else tree


def layer_slice(tree, i: int):
    """Layer `i` of a tree stacked on a leading layer axis (views)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]
