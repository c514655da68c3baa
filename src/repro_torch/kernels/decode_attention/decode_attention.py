"""ctypes wrapper of the CUDA flash decode over a contiguous KV cache
(`csrc/decode_attention.cu`), the port of
`repro.kernels.decode_attention.decode_attention.flash_decode`. It takes
the paged decode's launch plan (`paged.decode_plan`) with the capacity S,
so both split a slot's keys the same way."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.build import SMEM_LIMIT, copy_width
from repro_torch.kernels.decode_attention.paged import (
    MAX_HEAD_DIM,
    MAX_REP,
    decode_plan,
    scratch,
)

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode_cuda: {msg}")


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, *,
                      scale: Optional[float] = None,
                      span: Optional[int] = None, return_lse: bool = False):
    """q (B,H,D) vs the contiguous cache k/v (B,S,KV,D), all float32 or
    all bfloat16; lengths (B,) int32 valid keys per row (values past S
    read the whole cache). All contiguous on one CUDA device. Returns
    (B,H,D) in q's dtype, launched on the current stream, and with
    `return_lse` also the (B,H) float32 log-sum-exp of the scaled logits
    (-1e30 for a row of length 0); a `span` other than the default only
    times the options."""
    dev = q.device
    tensors = [q, k, v, lengths]
    _check(q.is_cuda and all(t.device == dev for t in tensors),
           "needs CUDA tensors on one device")
    _check(all(t.is_contiguous() for t in tensors), "needs contiguous "
           "tensors")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    _check(lengths.dtype == torch.int32, "int32 lengths")
    _check(q.dim() == 3 and k.dim() == 4 and v.shape == k.shape,
           "q (B,H,D), k/v (B,S,KV,D)")
    B, H, D = q.shape
    Bk, S, KV, Dk = k.shape
    _check(Bk == B and Dk == D and H % KV == 0 and H // KV <= MAX_REP
           and 0 < D <= MAX_HEAD_DIM and B <= 65535 and KV <= 65535,
           f"q {tuple(q.shape)} vs cache {tuple(k.shape)}")
    _check(lengths.shape == (B,), "lengths (B,)")
    plan = decode_plan(B, H, KV, D, S, k.dtype, span)
    _check(plan.n_span <= 65535 and plan.smem_bytes <= SMEM_LIMIT,
           f"plan {plan} exceeds the card's limits")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    tickets, part, part_ml = scratch(dev, B * KV,
                                     B * KV * plan.n_span * (H // KV), D)
    vb = copy_width(D * k.element_size(), k.data_ptr(), v.data_ptr())
    fn = build.library("decode_attention").repro_flash_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr(),
             part.data_ptr(), part_ml.data_ptr(),
             tickets.data_ptr(), B, H, KV, D, S, build.dtype_code(q.dtype),
             float(scale), plan.span, plan.n_span, vb, plan.smem_bytes,
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.LAUNCHES["flash_decode_lse" if return_lse
                     else "flash_decode"] += 1
    build.check(err, "flash_decode")
    return (out, lse) if return_lse else out
