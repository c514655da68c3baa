"""ctypes wrappers of the CUDA paged chunked-prefill kernels
(`csrc/paged_prefill.cu`), the ports of
`repro.kernels.flash_attention.paged_prefill`: `paged_prefill_flash`
(gather-only), `paged_prefill_insert_flash` (fused fp chunk write) and
`paged_prefill_insert_flash_q8` (fused int8 chunk write).

The fused kernels write the chunk into the pool tensors they are given,
in place (the reference aliases them input to output); they return only
the attention output."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build

MAX_HEAD_DIM = 256
MAX_REP = 16             # query heads per KV head one block computes
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float] \
    + [ctypes.c_void_p]


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}_cuda: {msg}")


def _launch(name, q, k_pages, v_pages, block_tables, c0, *, k_sz=None,
            v_sz=None, k_new=None, v_new=None, ksz_new=None, vsz_new=None,
            scale=None) -> torch.Tensor:
    """Check the operands of one of the three kernels and launch it on
    the current stream; `k_new` given selects a fused kernel."""
    fused = k_new is not None
    dev = q.device
    tensors = [q, k_pages, v_pages, block_tables, c0]
    for t in (k_sz, v_sz, k_new, v_new, ksz_new, vsz_new):
        if t is not None:
            tensors.append(t)
    _check(name, q.is_cuda and all(t.device == dev for t in tensors),
           "needs CUDA tensors on one device")
    _check(name, all(t.is_contiguous() for t in tensors),
           "needs contiguous tensors")
    _check(name, q.dtype in (torch.float32, torch.bfloat16),
           f"q dtype {q.dtype}")
    _check(name, v_pages.dtype == k_pages.dtype and k_pages.dtype in (
        q.dtype, torch.int8),
        f"pool dtype {k_pages.dtype}/{v_pages.dtype} (int8 or q's "
        f"{q.dtype})")
    _check(name, block_tables.dtype == torch.int32
           and c0.dtype == torch.int32, "int32 block tables and c0")
    _check(name, q.dim() == 4 and k_pages.dim() == 4
           and v_pages.shape == k_pages.shape,
           "q (B,C,H,D), pages (P,page,KV,D)")
    B, C, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    n_pages = block_tables.shape[1] if block_tables.dim() == 2 else 0
    _check(name, Dk == D and H % KV == 0 and H // KV <= MAX_REP
           and 0 < D <= MAX_HEAD_DIM and B <= 65535 and KV <= 65535,
           f"q {tuple(q.shape)} vs pages {tuple(k_pages.shape)}")
    _check(name, block_tables.dim() == 2 and block_tables.shape[0] == B
           and c0.shape == (B,), "block_tables (B,n_pages), c0 (B,)")
    quantized = k_pages.dtype == torch.int8
    _check(name, quantized == (k_sz is not None) and (k_sz is None) == (
        v_sz is None), "int8 pools need k_sz/v_sz and fp pools take none")
    sz_mode = 0
    if quantized:
        _check(name, k_sz.dtype == torch.float32
               and v_sz.shape == k_sz.shape, "float32 sz")
        if k_sz.shape == (P, page, KV, 2):
            sz_mode = 2
        else:
            _check(name, k_sz.shape == (P, KV, 2), f"sz {tuple(k_sz.shape)}")
            sz_mode = 1
    if fused:
        n_wp = C // page
        _check(name, C % page == 0 and n_wp <= n_pages,
               f"chunk {C} must be whole pages of {page} within the table")
        _check(name, k_new.shape == (B, C, KV, D) and v_new.shape ==
               k_new.shape and k_new.dtype == k_pages.dtype
               and v_new.dtype == k_pages.dtype,
               "k_new/v_new (B,C,KV,D) in the pool dtype")
        _check(name, sz_mode != 2, "the fused kernels take per-page sz")
        _check(name, quantized == (ksz_new is not None),
               "int8 chunks need ksz_new/vsz_new")
        if quantized:
            _check(name, ksz_new.shape == (B, n_wp, KV, 2)
                   and vsz_new.shape == ksz_new.shape
                   and ksz_new.dtype == torch.float32
                   and vsz_new.dtype == torch.float32,
                   "ksz_new/vsz_new (B,C/page,KV,2) float32")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn = build.library("paged_prefill").repro_paged_prefill
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             ptr(k_sz), ptr(v_sz), ptr(k_new), ptr(v_new), ptr(ksz_new),
             ptr(vsz_new), block_tables.data_ptr(), c0.data_ptr(),
             out.data_ptr(), B, C, H, KV, D, page, n_pages,
             build.dtype_code(q.dtype), build.dtype_code(k_pages.dtype),
             sz_mode, int(fused), float(scale),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.LAUNCHES[name] += 1
    build.check(err, name)
    return out


def paged_prefill_flash_cuda(q, k_pages, v_pages, block_tables, c0, *,
                             k_sz: Optional[torch.Tensor] = None,
                             v_sz: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Gather-only chunk attention: q (B,C,H,D) float32/bfloat16 at
    positions [c0[b], c0[b]+C) vs the pool k/v (P,page,KV,D) in q's
    dtype, or int8 with float32 `k_sz`/`v_sz` per page (P,KV,2) or per
    token (P,page,KV,2); the chunk is already in the pool.
    block_tables (B,n_pages) int32 (entries above the frontier clamped by
    ops), c0 (B,) int32 on the device. Returns (B,C,H,D) in q's dtype."""
    return _launch("paged_prefill_flash", q, k_pages, v_pages, block_tables,
                   c0, k_sz=k_sz, v_sz=v_sz, scale=scale)


def paged_prefill_insert_flash_cuda(q, k_pages, v_pages, k_new, v_new,
                                    block_tables, c0, *,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Fused fp chunk write + attention: k_new/v_new (B,C,KV,D) in the pool
    dtype land in k_pages/v_pages at the chunk's pages, in place; c0 and C
    page-aligned, the chunk's entries live and uniquely owned. Returns
    the attention output (B,C,H,D) in q's dtype."""
    return _launch("paged_prefill_insert_flash", q, k_pages, v_pages,
                   block_tables, c0, k_new=k_new, v_new=v_new, scale=scale)


def paged_prefill_insert_flash_q8_cuda(q, k_pages, v_pages, k_sz, v_sz,
                                       k8_new, v8_new, ksz_new, vsz_new,
                                       block_tables, c0, *,
                                       scale: Optional[float] = None
                                       ) -> torch.Tensor:
    """Fused int8 chunk write + attention: the pre-quantized payload
    k8/v8_new (B,C,KV,D) and its per-page rows ksz/vsz_new (B,C/page,KV,2)
    land in the int8 pool and its (P,KV,2) sz, in place. Returns the
    attention output (B,C,H,D) in q's dtype."""
    return _launch("paged_prefill_insert_flash_q8", q, k_pages, v_pages,
                   block_tables, c0, k_sz=k_sz, v_sz=v_sz, k_new=k8_new,
                   v_new=v8_new, ksz_new=ksz_new, vsz_new=vsz_new,
                   scale=scale)
