"""ctypes wrapper of the CUDA flash-attention forward
(`csrc/flash_attention.cu`), the port of
`repro.kernels.flash_attention.flash_attention._fwd_pallas`."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build

MAX_HEAD_DIM = 256
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, scale: Optional[float] = None,
                   kv_offset: int = 0):
    """q (B,Sq,H,D), k/v (B,Skv,KV,D), contiguous, one CUDA device, all
    float32 or all bfloat16, H a multiple of KV, D <= 256. Returns
    (out (B,Sq,H,D) in q's dtype, lse (B,H,Sq) float32), launched on the
    current stream."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_mha_cuda needs CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mha_cuda: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype} (need one of float32/bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_mha_cuda: q (B,Sq,H,D), k/v (B,Skv,KV,D)")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV:
        raise ValueError(f"flash_mha_cuda: q {tuple(q.shape)} vs "
                         f"k {tuple(k.shape)}")
    if not 0 < D <= MAX_HEAD_DIM or H > 65535 or B > 65535:
        raise ValueError(f"flash_mha_cuda: D={D}, H={H}, B={B} out of "
                         "range")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_mha_cuda needs contiguous tensors")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = build.library("flash_attention").repro_flash_mha
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, Sq, Skv, H, KV, D, build.dtype_code(q.dtype),
             float(scale), int(causal), int(kv_offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_mha"] += 1
    build.check(err, "flash_mha")
    return out, lse
