"""ctypes wrapper of the CUDA paged flash decode (`csrc/paged_decode.cu`),
the port of `repro.kernels.decode_attention.paged.paged_flash_decode`."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build

MAX_HEAD_DIM = 256
MAX_REP = 16             # query heads per KV head one block computes
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float] \
    + [ctypes.c_void_p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_flash_decode_cuda: {msg}")


def paged_flash_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor, *,
                            k_sz: Optional[torch.Tensor] = None,
                            v_sz: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,D) float32/bfloat16 vs the physical pool k/v
    (P_phys, page, KV, D) float32/bfloat16, or int8 with float32
    `k_sz`/`v_sz` of rank 3 (per page, (P_phys, KV, 2)) or rank 4 (per
    token, (P_phys, page, KV, 2)); block_tables (B, n_pages) int32 whose
    every entry names a real page (ops clamps dead ones), lengths (B,)
    int32. All contiguous on one CUDA device. Returns (B,H,D) in q's
    dtype, launched on the current stream."""
    dev = q.device
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    if k_sz is not None:
        tensors += [k_sz, v_sz]
    _check(q.is_cuda and all(t is not None and t.device == dev
                             for t in tensors),
           "needs CUDA tensors on one device")
    _check(all(t.is_contiguous() for t in tensors), "needs contiguous "
           "tensors")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"q dtype {q.dtype}")
    _check(v_pages.dtype == k_pages.dtype
           and k_pages.dtype in (torch.float32, torch.bfloat16, torch.int8),
           f"pool dtype {k_pages.dtype}/{v_pages.dtype}")
    _check(block_tables.dtype == torch.int32
           and lengths.dtype == torch.int32, "int32 tables and lengths")
    _check(q.dim() == 3 and k_pages.dim() == 4
           and v_pages.shape == k_pages.shape, "q (B,H,D), pages "
           "(P,page,KV,D)")
    B, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    _check(Dk == D and H % KV == 0 and H // KV <= MAX_REP
           and 0 < D <= MAX_HEAD_DIM and B <= 65535,
           f"q {tuple(q.shape)} vs pages {tuple(k_pages.shape)}")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B
           and lengths.shape == (B,), "block_tables (B,n_pages), lengths (B,)")
    quantized = k_pages.dtype == torch.int8
    _check(quantized == (k_sz is not None), "int8 pools need k_sz/v_sz and "
           "fp pools take none")
    sz_mode = 0
    if quantized:
        _check(k_sz.dtype == torch.float32 and v_sz.shape == k_sz.shape,
               "float32 sz")
        if k_sz.shape == (P, page, KV, 2):
            sz_mode = 2
        else:
            _check(k_sz.shape == (P, KV, 2), f"sz {tuple(k_sz.shape)}")
            sz_mode = 1
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    fn = build.library("paged_decode").repro_paged_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_sz.data_ptr() if quantized else None,
             v_sz.data_ptr() if quantized else None,
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             B, H, KV, D, page, block_tables.shape[1],
             build.dtype_code(q.dtype), build.dtype_code(k_pages.dtype),
             sz_mode, float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.LAUNCHES["paged_flash_decode"] += 1
    build.check(err, "paged_flash_decode")
    return out
