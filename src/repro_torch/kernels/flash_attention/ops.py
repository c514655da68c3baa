"""Public dense attention op (bucket prefill): a CUDA tensor launches the
flash kernel, a CPU tensor takes the plain masked softmax."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import ref


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        kv_offset: int = 0, impl: Optional[str] = None) -> torch.Tensor:
    """Multi-head (GQA) attention: q (B,Sq,H,D), k/v (B,Skv,KV,D)."""
    if kernels.select_impl(q, impl) == "reference":
        kernels.REFERENCE_CALLS["mha"] += 1
        return ref.mha(q, k, v, causal=causal, scale=scale,
                       kv_offset=kv_offset)
    from repro_torch.kernels.flash_attention import flash_attention as fa

    out, _ = fa.flash_mha_cuda(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, scale=scale,
                               kv_offset=kv_offset)
    return out
