"""ctypes wrapper of the CUDA paged flash decode (`csrc/paged_decode.cu`),
the port of `repro.kernels.decode_attention.paged.paged_flash_decode`,
and the launch plan it shares with the contiguous flash decode.

`decode_plan` is the split body's launch geometry as a plain function of
the shapes (span, grid, shared-memory bytes) and `key_spans` its key
partition, so that both can be checked without a card; the C entry
recomputes the shared memory from its own layout and refuses a plan that
disagrees."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.build import SMEM_LIMIT, copy_width

MAX_HEAD_DIM = 256
MAX_REP = 16             # query heads per KV head one block computes
SPAN = 64                # key positions per span of the split body, D <= 128
WIDE_SPAN = 32           # ... above D 128 (one KV head: twice the blocks)
MAX_SPANS = 32           # spans a slot uses at most (`kMaxSpans`); longer
                         # slots take spans of a multiple of `span` keys
MAX_SPAN = 256           # the longest base span timed as an option
KEY_TILE = 32            # keys a tile: one a lane (4 a warp step above D 128)
WARPS = 4                # a block's warps above D 128 and up to rep 4
MAX_WARPS = 5            # ... else (up to D 128 from rep 5)
STAGES = 2               # rounds of tiles in the cp.async ring
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Launch geometry of one decode call: block (g, b, s) computes the
    query heads of KV head g for slot b over span s of the slot's key
    range (`key_spans`: `span` keys a span while the slot needs at most
    `MAX_SPANS` of them, else longer spans)."""

    span: int
    n_span: int          # span blocks per (slot, KV head)
    grid: tuple          # (KV, B, n_span)
    threads: int
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def default_span(D: int) -> int:
    """The base span at head dim D: `SPAN`, or `WIDE_SPAN` above D 128,
    where the body scores a key with 8 lanes and the one KV head of the
    archs that have such heads leaves the card short of blocks. A
    function of the shape only, so every caller of a model (paged or
    dense, any batch) splits a length alike."""
    return SPAN if D <= 128 else WIDE_SPAN


def span_len(n_keys: int, span: int) -> int:
    """Keys a span of a slot with `n_keys` keys covers (`span_len` in
    `csrc/decode_body.cuh`): `span` while ceil(n_keys / span) <=
    MAX_SPANS, else the least multiple of `span` that keeps the count at
    MAX_SPANS."""
    nb = _ceil(n_keys, span)
    return span if nb <= MAX_SPANS else span * _ceil(nb, MAX_SPANS)


def block_warps(D: int, rep: int) -> int:
    """Warps of a block (`block_warps` in the kernel): 5 from rep 5 up
    to D 128 (one warp a query row at rep 5, where 4 warps left one warp
    two rows), else 4."""
    return WARPS if D > 128 or rep <= WARPS else MAX_WARPS


def round_keys(D: int, esize: int) -> int:
    """Keys a round of the ring stages (`round_keys` in the kernel): two
    tiles, one for a float32 pool above D 128."""
    return KEY_TILE if esize == 4 and D > 128 else 2 * KEY_TILE


def decode_plan(B: int, H: int, KV: int, D: int, capacity: int,
                kv_dtype, span: Optional[int] = None) -> DecodePlan:
    """The launch geometry `csrc/decode_body.cuh` takes: n_span =
    min(ceil(capacity / span), MAX_SPANS) blocks per (slot, KV head),
    from the capacity alone (n_pages * page or S), so the host never reads
    the lengths; the shared memory mirrors the kernel's `Smem` layout (a
    ring of two rounds of `round_keys` keys, which the merge's factors
    reuse, the int8 pool's (scale, zero) rows, the keys' cache rows, q,
    and above D 128 each warp's scores). `span` defaults to
    `default_span(D)`; other values only time the options."""
    span = default_span(D) if span is None else span
    if span % 32 or not 32 <= span <= MAX_SPAN:
        raise ValueError(f"span {span} (a multiple of 32 up to {MAX_SPAN})")
    esize = torch.empty((), dtype=kv_dtype).element_size()
    chunks = _ceil(D * esize, 16)
    pitch = 16 * (chunks | 1)
    dq = chunks * (16 // esize)
    rep = H // KV
    rk = round_keys(D, esize)
    ring = STAGES * 2 * rk * pitch
    cw = _ceil(rep * (MAX_SPANS + 1) * 8, 16) * 16   # over the ring
    smem = (max(ring, cw) + (STAGES * rk * 16 if esize == 1 else 0)
            + STAGES * rk * 8 + rep * dq * 4
            + (4 * 4 * (KEY_TILE + 4) * 4 if D > 128 else 0))
    n_span = max(1, min(_ceil(capacity, span), MAX_SPANS))
    return DecodePlan(span, n_span, (KV, B, n_span), 32 * block_warps(D, rep),
                      smem)


def key_spans(length: int, capacity: int, span: int = SPAN) -> list:
    """The kernel's partition of one slot's keys: [lo, hi) of each span
    block that computes (the key range is [0, min(length, capacity));
    at least span 0, whose empty range writes the mean of V, as the
    reference's all-masked softmax does). Depends only on the length,
    the capacity's clamp, the span and the span cap: a slot keeps spans
    of `span` keys up to MAX_SPANS * span keys, and beyond that uses
    MAX_SPANS spans or fewer of a multiple of `span` keys."""
    n_keys = max(0, min(length, capacity))
    L = span_len(n_keys, span)
    n_used = max(1, _ceil(n_keys, L))
    return [(u * L, min(u * L + L, n_keys)) for u in range(n_used)]


_SCRATCH: dict = {}


def scratch(device, n_slots: int, n_rows: int, D: int):
    """(tickets, part, part_ml) of the split body on `device`: n_slots
    int32 tickets, zero between calls (the kernel resets each one it
    takes), and n_rows partial rows of D and of (m, l) float32. Kept per
    device and grown on demand; calls on one stream run one after
    another, so they share it."""
    t, p = _SCRATCH.get(device, (None, None))
    if t is None or t.numel() < n_slots:
        t = torch.zeros(n_slots, dtype=torch.int32, device=device)
    if p is None or p.numel() < n_rows * (D + 2):
        p = torch.empty(n_rows * (D + 2), dtype=torch.float32, device=device)
    _SCRATCH[device] = (t, p)
    # (m, l) pairs first, so their float2 stores stay 8-byte aligned
    return t, p[2 * n_rows:n_rows * (D + 2)], p[:2 * n_rows]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_flash_decode_cuda: {msg}")


def paged_flash_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor, *,
                            k_sz: Optional[torch.Tensor] = None,
                            v_sz: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None,
                            span: Optional[int] = None) -> torch.Tensor:
    """q (B,H,D) float32/bfloat16 vs the physical pool k/v
    (P_phys, page, KV, D) float32/bfloat16, or int8 with float32
    `k_sz`/`v_sz` of rank 3 (per page, (P_phys, KV, 2)) or rank 4 (per
    token, (P_phys, page, KV, 2)); block_tables (B, n_pages) int32 whose
    entries below each slot's length name real pages (the kernel reads
    the others but never dereferences them), lengths (B,) int32. All contiguous on one CUDA device. Returns (B,H,D) in q's
    dtype, launched on the current stream; a `span` other than the default
    only times the options."""
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
    n_pages = block_tables.shape[1] if block_tables.dim() == 2 else 0
    _check(Dk == D and H % KV == 0 and H // KV <= MAX_REP
           and 0 < D <= MAX_HEAD_DIM and B <= 65535 and KV <= 65535,
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
    plan = decode_plan(B, H, KV, D, n_pages * page, k_pages.dtype, span)
    _check(plan.n_span <= 65535 and plan.smem_bytes <= SMEM_LIMIT,
           f"plan {plan} exceeds the card's limits")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    tickets, part, part_ml = scratch(dev, B * KV,
                                     B * KV * plan.n_span * (H // KV), D)
    vb = copy_width(D * k_pages.element_size(), k_pages.data_ptr(),
                    v_pages.data_ptr())
    sz_vb = 8 if not quantized or (k_sz.data_ptr() % 8 == 0
                                   and v_sz.data_ptr() % 8 == 0) else 1
    fn = build.library("paged_decode").repro_paged_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_sz.data_ptr() if quantized else None,
             v_sz.data_ptr() if quantized else None,
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             part.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
             B, H, KV, D, page, n_pages,
             build.dtype_code(q.dtype), build.dtype_code(k_pages.dtype),
             sz_mode, float(scale), plan.span, plan.n_span, vb, sz_vb,
             plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    kernels.LAUNCHES["paged_flash_decode"] += 1
    build.check(err, "paged_flash_decode")
    return out
