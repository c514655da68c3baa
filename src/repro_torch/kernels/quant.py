"""Per-page int8 block quantization for the paged KV pool (port of
`repro.kernels.quant`, same math to the bit).

The pool payload is int8 with one float32 (scale, zero) pair per
(physical page, KV head) — the ``*_sz`` tensors next to every quantized
``k``/``v`` pool leaf, laid out ``(..., n_phys_pages, KV, 2)`` with
``[..., 0] = scale`` and ``[..., 1] = zero``. Affine mid-range:

    zero  = (max(x) + min(x)) / 2
    scale = max((max(x) - min(x)) / (2 * 127), MIN_SCALE)
    q     = round((x - zero) / scale)            # always in [-127, 127]
    x_hat = q * scale + zero                     # |x_hat - x| <= scale/2

`torch.round` rounds half to even like `jnp.round`, and the quotient is a
true division by `scale` as in the reference, so both packages land on
the same int8 grid. Per-token sub-scales (one pair per token row,
``(..., page, KV, 2)``) are the speculative-decoding layout.
"""

from __future__ import annotations

import torch

INT8_QMAX = 127
# floor keeps constant pages exact: (x - zero) == 0 -> q == 0 -> zero
MIN_SCALE = 1e-8
SZ_CHANNELS = 2                      # [scale, zero]


def page_sz(x: torch.Tensor, dims) -> torch.Tensor:
    """(scale, zero) over the reduction ``dims`` of ``x``, stacked on a
    trailing size-2 channel: ``x.shape`` minus ``dims`` plus ``(2,)``,
    float32."""
    x = x.float()
    hi = x.amax(dim=dims)
    lo = x.amin(dim=dims)
    zero = (hi + lo) * 0.5
    scale = torch.clamp_min((hi - lo) / (2.0 * INT8_QMAX), MIN_SCALE)
    return torch.stack([scale, zero], dim=-1)


def quantize(x: torch.Tensor, sz: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` (float) to int8 with broadcastable ``sz`` whose
    trailing dim is the (scale, zero) channel."""
    scale, zero = sz[..., 0], sz[..., 1]
    q = torch.round((x.float() - zero) / scale)
    return torch.clamp(q, -INT8_QMAX, INT8_QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, sz: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Dequantize int8 ``q`` with broadcastable ``sz``."""
    scale, zero = sz[..., 0], sz[..., 1]
    return (q.float() * scale + zero).to(dtype)


def _per_page(sz: torch.Tensor) -> torch.Tensor:
    """(..., KV, 2) -> (..., 1, KV, 1, 2): broadcast over (page, hd)."""
    return sz[..., None, :, None, :]


def quantize_pages(pages: torch.Tensor):
    """Quantize whole page tiles ``(..., page_tokens, KV, hd)`` with one
    (scale, zero) per (page, KV head). Returns ``(q8, sz)``, ``sz``
    ``(..., KV, 2)``."""
    sz = page_sz(pages, dims=(-3, -1))
    return quantize(pages, _per_page(sz)), sz


def dequantize_pages(q8: torch.Tensor, sz: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_pages`: ``q8`` ``(..., page, KV, hd)``,
    ``sz`` ``(..., KV, 2)``."""
    return dequantize(q8, _per_page(sz), dtype=dtype)


def token_sz(x: torch.Tensor) -> torch.Tensor:
    """(scale, zero) per token row over the trailing head_dim."""
    return page_sz(x, dims=(-1,))


def quantize_tokens(x: torch.Tensor):
    """Quantize token rows ``(..., hd)`` with one (scale, zero) per row.
    Returns ``(q8, sz)`` with ``sz`` ``(..., 2)``."""
    sz = token_sz(x)
    return quantize(x, sz[..., None, :]), sz


def dequantize_tokens(q8: torch.Tensor, sz: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_tokens`."""
    return dequantize(q8, sz[..., None, :], dtype=dtype)
