"""Int8 gradient compression with error feedback, for the cross-pod
all-reduce (port of `repro.optim.compress`).

Each gradient leaf, plus the residual its last quantization left
(error feedback), is quantized to int8 with one float32 scale per
tensor; the int8 payload is summed as int32 over the process groups of
the named mesh axes, and so are the scales; the mean is dequantized with
the mean scale. The residual is kept per leaf and added to the next
step's gradient, which keeps SGD unbiased in expectation. On the wire
the payload is 4 bytes an element as int32 here (`torch.distributed`
sums no int8 without overflow); an int8 wire needs a collective that
widens as it sums.

The reference's train step does not call `compressed_psum` (its
`TrainConfig.compress_grads` is read nowhere), so neither does the
port's (ROADMAP §C).
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.parallel import ParallelCtx, psum
from repro_torch.common.pytree import tree_map


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on `like`'s device: CUDA divides by a Python
    scalar as a multiplication by its rounded reciprocal, one bit off the
    reference's division; by a device tensor it divides."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def quantize(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale), the
    rounding half to even (`jnp.round`'s)."""
    absmax = torch.max(torch.abs(g))
    scale = torch.clamp_min(absmax, 1e-12) / _const(127.0, g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def residual(g: torch.Tensor, q: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """g - dequantize(q, scale) rounded once to float32: the fused
    multiply-add the reference's compiled step computes (XLA contracts
    the product into the subtraction). q * scale and the difference are
    exact in float64 (|g - q * scale| <= scale / 2 where q is not 0), so
    the one rounding is the cast back."""
    return (g.to(torch.float64)
            - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)


def init_error_state(params):
    """Zero float32 residuals shaped like `params`."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, error_state, ctx: ParallelCtx, axis_names):
    """The mean of each gradient leaf over the ranks of `axis_names`, in
    int8 wire format with error feedback: every rank of those axes calls
    it with its own `grads` and residuals. Returns (mean_grads,
    new_error_state), each shaped like `grads`."""
    axes = tuple(axis_names)
    n = math.prod(ctx.axis_size(a) for a in axes)

    def one(g, e):
        g = g.to(torch.float32) + e
        q, scale = quantize(g)
        new_e = residual(g, q, scale)
        summed = psum(q.to(torch.int32), ctx, axes)
        scale_sum = psum(scale, ctx, axes)   # a conservative shared scale
        n_ = _const(n, g)
        mean = summed.to(torch.float32) * (scale_sum / n_) / n_
        return mean, new_e

    pairs = tree_map(one, grads, error_state)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)
