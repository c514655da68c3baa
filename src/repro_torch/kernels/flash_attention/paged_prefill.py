"""ctypes wrappers of the CUDA paged chunked-prefill kernels
(`csrc/paged_prefill.cu`), the ports of
`repro.kernels.flash_attention.paged_prefill`: `paged_prefill_flash`
(gather-only), `paged_prefill_insert_flash` (fused fp chunk write) and
`paged_prefill_insert_flash_q8` (fused int8 chunk write).

The fused kernels write the chunk into the pool tensors they are given,
in place (the reference aliases them input to output); they return only
the attention output.

`launch_plan` is the kernels' launch geometry as a plain function of the
shapes (rows per block, grid, key splits, shared-memory bytes), so that
it can be checked without a card; the C entry recomputes the shared
memory from its own layout and refuses a plan that disagrees."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.build import N_SM, SMEM_LIMIT, copy_width

MAX_HEAD_DIM = 256
MAX_REP = 16             # query heads per KV head one block computes
KEY_TILE = 64            # keys per tile of the tensor-core body
ROWS = 64                # (query, head) rows per tensor-core block
_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [ctypes.c_float]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry of one call. Block (x, y, z) computes query
    positions [x * bq, x * bq + bq) of KV head y for all rep heads of its
    group (rows = bq * rep of its `rows` row slots), batch row z //
    n_split, over key split z % n_split of its causal key range."""

    tensor_core: bool    # bf16 q: mma body; float32 q: FMA body
    rows: int            # row slots a block computes (16 per warp)
    threads: int
    bq: int              # query positions a block covers
    grid: tuple          # (x, y, z)
    n_split: int         # key splits merged by the combine kernel
    n_tab: int           # block-table entries a block stages
    stages: int          # K/V tiles in shared memory (ring depth)
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(B: int, C: int, H: int, KV: int, D: int, page: int,
                n_pages: int, q_dtype, kv_dtype) -> Plan:
    """The launch geometry `csrc/paged_prefill.cu` takes for these shapes:
    float32 q runs the FMA body (16 rows, 32-key tiles staged as f32);
    bf16 q the tensor-core body with 64 rows per block and its key range
    split for about two blocks per SM (the fastest plan at the main
    shape, PERF.md)."""
    if q_dtype == torch.float32:
        rep = H // KV
        bq = 1 if rep >= 16 else 16 // rep
        pitch = D + 1 if D % 2 == 0 else D
        return Plan(False, 16, 128, bq, (_ceil(C, bq), KV, B), 1, 0, 1,
                    4 * (16 * D + 2 * 32 * pitch))
    return _mma_plan(B, C, H, KV, D, page, n_pages, kv_dtype)


def _mma_plan(B: int, C: int, H: int, KV: int, D: int, page: int,
              n_pages: int, kv_dtype, rows: int = ROWS,
              n_split: Optional[int] = None) -> Plan:
    """The tensor-core body's plan with `rows` (32 or 64) rows per block
    and `n_split` key splits (default: enough for two blocks per SM);
    other values than the defaults only time the options
    (`scripts/paged_prefill_plans.py`)."""
    rep = H // KV
    if rows not in (32, 64) or rep > rows:
        raise ValueError(f"rows {rows} per block with rep {rep}")
    bq = rows // rep
    n_tiles = max(1, _ceil(n_pages * page, KEY_TILE))
    blocks = _ceil(C, bq) * KV * B
    if n_split is None:              # about two blocks per SM
        n_split = _ceil(2 * N_SM, blocks)
    n_split = max(1, min(n_split, n_tiles))
    t_max = _ceil(n_tiles, n_split)
    n_tab = max(1, min(n_pages, _ceil(t_max * KEY_TILE, page) + 1))
    dp = _ceil(D, 16) * 16
    qp = 2 * (dp + 8)                  # bf16 row pitch, bytes
    i8 = kv_dtype == torch.int8
    smem = (rows * qp                                 # q rows
            + 2 * 2 * KEY_TILE * (dp if i8 else qp)   # K/V ring
            + (2 * KEY_TILE * qp if i8 else 0)        # bf16 copy of int8
            + (2 * 2 * KEY_TILE * 8 if i8 else 0)     # (scale, zero) rows
            + _ceil(n_tab * 4, 16) * 16)              # block-table slice
    return Plan(True, rows, 2 * rows, bq,
                (_ceil(C, bq), KV, B * n_split), n_split, n_tab, 2, smem)


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}_cuda: {msg}")


def _launch(name, q, k_pages, v_pages, block_tables, c0, *, k_sz=None,
            v_sz=None, k_new=None, v_new=None, ksz_new=None, vsz_new=None,
            scale=None, plan: Optional[Plan] = None) -> torch.Tensor:
    """Check the operands of one of the three kernels and launch it on
    the current stream; `k_new` given selects a fused kernel. `plan`
    replaces `launch_plan`'s (only to time the options)."""
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
    plan = plan or launch_plan(B, C, H, KV, D, page, n_pages, q.dtype,
                               k_pages.dtype)
    _check(name, plan.smem_bytes <= SMEM_LIMIT
           and plan.grid[2] <= 65535,
           f"plan {plan} exceeds the card's limits")
    out = torch.empty_like(q)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    kv_ptrs = [t.data_ptr() for t in (k_pages, v_pages, k_new, v_new)
               if t is not None]
    vb = copy_width(D * k_pages.element_size(), *kv_ptrs)
    if quantized and any(t.data_ptr() % 8 for t in (
            k_sz, v_sz, ksz_new, vsz_new) if t is not None):
        vb = 1                         # (scale, zero) rows copy 8 bytes
    vbq = copy_width(D * q.element_size(), q.data_ptr())
    part = part_ml = None
    if plan.n_split > 1:
        rows_out = B * C * H
        part = torch.empty((plan.n_split, rows_out, _ceil(D, 16) * 16),
                           dtype=torch.float32, device=dev)
        part_ml = torch.empty((plan.n_split, rows_out, 2),
                              dtype=torch.float32, device=dev)
    fn = build.library("paged_prefill").repro_paged_prefill
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             ptr(k_sz), ptr(v_sz), ptr(k_new), ptr(v_new), ptr(ksz_new),
             ptr(vsz_new), block_tables.data_ptr(), c0.data_ptr(),
             out.data_ptr(), B, C, H, KV, D, page, n_pages,
             build.dtype_code(q.dtype), build.dtype_code(k_pages.dtype),
             sz_mode, int(fused), float(scale), plan.rows, plan.n_split,
             plan.n_tab, vb, vbq, plan.smem_bytes, ptr(part), ptr(part_ml),
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
