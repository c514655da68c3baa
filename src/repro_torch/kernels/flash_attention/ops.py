"""Public attention ops: dense attention (prefill and training, with its
backward) and paged chunked prefill. A CUDA tensor launches the
hand-written kernel, a CPU tensor takes the plain version.

The paged chunked-prefill surface has two tiers, as in the reference:

* `paged_prefill_mha` — gather-only attention over a pool whose chunk
  K/V was already scattered (the per-token int8 pool's path, and the
  parity oracle).
* `paged_prefill_insert_mha` / `paged_prefill_insert_mha_q8` — the FUSED
  ops: the chunk's K/V (int8: pre-quantized payload + (scale, zero) rows)
  goes in as an operand and the kernel writes it into the pool tensors
  in place while the chunk attends. The plain versions scatter, then
  attend, so either target keeps the one-call contract the chunk cell is
  built on.

`c0` (the chunk starts, (B,) int32) stays on the device: no op here reads
it on the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention.ops import clamp_dead_entries
from repro_torch.kernels.flash_attention import ref


def attn_pairs(B: int, Sq: int, Skv: int, H: int, causal: bool,
               kv_offset: int = 0) -> int:
    """Unmasked (query, key) pairs of one attention call: row i sees
    keys [0, kv_offset + i] when causal (clamped to [0, Skv]), all Skv
    otherwise."""
    if not causal:
        return B * H * Sq * Skv
    lo, hi = kv_offset + 1, kv_offset + Sq      # row i sees lo + i keys
    a, b = max(lo, 1), min(hi, Skv)             # rows inside (0, Skv]
    inner = (a + b) * (b - a + 1) // 2 if b >= a else 0
    full = max(0, hi - max(Skv + 1, lo) + 1)    # rows that see every key
    return B * H * (inner + full * Skv)


def mha_cost(q_shape, k_shape, *, causal: bool = True, kv_offset: int = 0,
             itemsize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one flash_mha forward: QK^T and PV over the
    unmasked pairs (4 D operations a pair), q and out, k and v moved once
    at `itemsize` bytes, the float32 lse written once. The kernels
    table's bound (`chip_smoke.py`) and the dry-run's unit
    (`profiler.cost`) both read it."""
    B, Sq, H, D = q_shape
    Skv = k_shape[1]
    pairs = attn_pairs(B, Sq, Skv, H, causal, kv_offset)
    nbytes = itemsize * (2 * B * Sq * H * D + 2 * math.prod(k_shape)) \
        + 4 * B * H * Sq
    return 4 * D * pairs, nbytes


def mha_bwd_cost(q_shape, k_shape, *, causal: bool = True,
                 kv_offset: int = 0, itemsize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one flash_mha backward: 10 D operations a
    pair (S = QK^T again, dV, dP, dQ, dK); q, out, dout read and dq
    written, k, v read and dk, dv written, at `itemsize` bytes, the
    float32 lse read once."""
    B, Sq, H, D = q_shape
    Skv = k_shape[1]
    pairs = attn_pairs(B, Sq, Skv, H, causal, kv_offset)
    nbytes = itemsize * (4 * B * Sq * H * D + 4 * math.prod(k_shape)) \
        + 4 * B * H * Sq
    return 10 * D * pairs, nbytes


class _FlashMha(torch.autograd.Function):
    """`flash_mha_cuda` forward, `flash_mha_bwd_cuda` backward, as the
    reference's custom_vjp pairs `_fwd_pallas` with `_flash_bwd`. (q, k,
    v, out, lse) are saved only when a grad is needed; under no_grad and
    inference_mode the forward is the serving path's one launch. On meta
    tensors under the cost mode each pass is one kernel unit."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_offset):
        from repro_torch.kernels.flash_attention import flash_attention as fa

        ctx.args = dict(causal=causal, scale=scale, kv_offset=kv_offset)
        ctx.unit = kernels.costed(q)
        if ctx.unit:
            B, Sq, H, _ = q.shape
            out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            lse = torch.empty((B, H, Sq), dtype=torch.float32,
                              device=q.device)
            kernels.record_unit("flash_mha", *mha_cost(
                q.shape, k.shape, causal=causal, kv_offset=kv_offset,
                itemsize=q.element_size()), (q, k, v), (out, lse))
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = fa.flash_mha_cuda(q, k, v, causal=causal,
                                         scale=scale, kv_offset=kv_offset)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.flash_attention import flash_attention as fa

        q, k, v, out, lse = ctx.saved_tensors
        if ctx.unit:
            dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype,
                                      device=t.device) for t in (q, k, v))
            a = ctx.args
            kernels.record_unit("flash_mha_bwd", *mha_bwd_cost(
                q.shape, k.shape, causal=a["causal"],
                kv_offset=a["kv_offset"], itemsize=q.element_size()),
                (q, k, v, out, lse, dout), (dq, dk, dv))
            return dq, dk, dv, None, None, None
        dq, dk, dv = fa.flash_mha_bwd_cuda(q, k, v, out, lse,
                                           dout.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None


class _CountPlainBwd(torch.autograd.Function):
    """Identity whose backward counts one plain attention backward
    (`REFERENCE_CALLS["mha_bwd"]`); the gradient itself flows through
    the plain version's own autograd."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        kernels.REFERENCE_CALLS["mha_bwd"] += 1
        return g


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        kv_offset: int = 0, impl: Optional[str] = None) -> torch.Tensor:
    """Multi-head (GQA) attention: q (B,Sq,H,D), k/v (B,Skv,KV,D),
    differentiable. The plain version builds the full score tensor up to
    256 x 256 scores and goes block by block above
    (`chunked.mha_chunked`, whose backward is the reference's chunked
    one), as the reference's does; the kernel path's backward is the
    CUDA backward kernel. Under the cost mode a meta call is one unit of
    flash_mha (and of flash_mha_bwd in the backward)."""
    if kernels.costed(q):
        return _FlashMha.apply(q, k, v, causal, scale, kv_offset)
    if kernels.select_impl(q, impl) == "reference":
        kernels.REFERENCE_CALLS["mha"] += 1
        if q.shape[1] * k.shape[1] <= 256 * 256:
            out = ref.mha(q, k, v, causal=causal, scale=scale,
                          kv_offset=kv_offset)
        else:
            from repro_torch.kernels.flash_attention import chunked

            out = chunked.mha_chunked(q, k, v, causal, scale, kv_offset)
        return _CountPlainBwd.apply(out) if out.requires_grad else out
    return _FlashMha.apply(q, k, v, causal, scale, kv_offset)


def _c0_vec(c0, B: int, device) -> torch.Tensor:
    """Chunk starts as a contiguous (B,) int32 device tensor (a scalar
    broadcasts)."""
    return torch.as_tensor(c0, device=device).to(torch.int32).broadcast_to(
        (B,)).contiguous()


def _clamp_frontier(block_tables, n_pages, page, c0, C):
    """Clamp block-table entries above the causal frontier c0+C to
    physical page 0 (`decode_attention.ops.clamp_dead_entries`); the
    causal mask keeps them out of the math."""
    return clamp_dead_entries(block_tables, n_pages, page, c0 + C)


def paged_prefill_mha(q, k_pages, v_pages, block_tables, c0, *,
                      k_sz=None, v_sz=None, scale: Optional[float] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Chunked prefill vs a PAGED cache: q (B, C, H, D) — C prompt tokens
    at absolute positions [c0, c0+C) — against the pool k/v
    (P_phys, page, KV, D) through (B, n_logical) block tables, causal.
    The chunk's own K/V must already be in the pool. `k_sz`/`v_sz`
    float32 switch to an int8 pool, per page (P_phys, KV, 2) or per
    token (P_phys, page, KV, 2)."""
    B, C = q.shape[0], q.shape[1]
    n_pages = block_tables.shape[1]
    page = k_pages.shape[1]
    c0 = _c0_vec(c0, B, q.device)
    block_tables = _clamp_frontier(block_tables, n_pages, page, c0, C)
    if kernels.select_impl(q, impl) == "reference":
        kernels.REFERENCE_CALLS["paged_prefill_mha"] += 1
        return ref.paged_prefill_mha(q, k_pages, v_pages, block_tables, c0,
                                     k_sz=k_sz, v_sz=v_sz, scale=scale)
    from repro_torch.kernels.flash_attention import paged_prefill as pp

    return pp.paged_prefill_flash_cuda(
        q.contiguous(), k_pages, v_pages, block_tables, c0, k_sz=k_sz,
        v_sz=v_sz, scale=scale)


def paged_prefill_insert_mha(q, k_pages, v_pages, k_new, v_new,
                             block_tables, c0, *,
                             scale: Optional[float] = None,
                             impl: Optional[str] = None):
    """FUSED chunk insert + attention (fp pools): write the chunk's K/V
    (B, C, KV, D) into the pools at the block table's pages, in place,
    AND attend the chunk queries in one pass. Returns (o, k_pages,
    v_pages). C and c0 must be page-aligned and the chunk's table entries
    live and uniquely owned."""
    B, C = q.shape[0], q.shape[1]
    n_pages = block_tables.shape[1]
    page = k_pages.shape[1]
    c0 = _c0_vec(c0, B, q.device)
    block_tables = _clamp_frontier(block_tables, n_pages, page, c0, C)
    # pre-cast so the in-chunk attention sees exactly the stored values
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    if kernels.select_impl(q, impl) == "reference":
        kernels.REFERENCE_CALLS["paged_prefill_insert_mha"] += 1
        return ref.paged_prefill_insert_mha(
            q, k_pages, v_pages, k_new, v_new, block_tables, c0,
            scale=scale)
    from repro_torch.kernels.flash_attention import paged_prefill as pp

    o = pp.paged_prefill_insert_flash_cuda(
        q.contiguous(), k_pages, v_pages, k_new.contiguous(),
        v_new.contiguous(), block_tables, c0, scale=scale)
    return o, k_pages, v_pages


def paged_prefill_insert_mha_q8(q, k_pages, v_pages, k_sz, v_sz,
                                k8_new, v8_new, ksz_new, vsz_new,
                                block_tables, c0, *,
                                scale: Optional[float] = None,
                                impl: Optional[str] = None):
    """FUSED chunk insert + attention for int8 pools: the pre-quantized
    chunk payload (B, C, KV, D) and its per-page (scale, zero) rows
    (B, C//page, KV, 2) land in the pool tensors in place while the chunk
    attends — older pages dequantize through `k_sz`/`v_sz`, the chunk's
    own pages through the fresh rows. Returns
    (o, k_pages, v_pages, k_sz, v_sz)."""
    B, C = q.shape[0], q.shape[1]
    n_pages = block_tables.shape[1]
    page = k_pages.shape[1]
    c0 = _c0_vec(c0, B, q.device)
    block_tables = _clamp_frontier(block_tables, n_pages, page, c0, C)
    if kernels.select_impl(q, impl) == "reference":
        kernels.REFERENCE_CALLS["paged_prefill_insert_mha_q8"] += 1
        return ref.paged_prefill_insert_mha_q8(
            q, k_pages, v_pages, k_sz, v_sz, k8_new, v8_new, ksz_new,
            vsz_new, block_tables, c0, scale=scale)
    from repro_torch.kernels.flash_attention import paged_prefill as pp

    o = pp.paged_prefill_insert_flash_q8_cuda(
        q.contiguous(), k_pages, v_pages, k_sz, v_sz, k8_new.contiguous(),
        v8_new.contiguous(), ksz_new.contiguous(), vsz_new.contiguous(),
        block_tables, c0, scale=scale)
    return o, k_pages, v_pages, k_sz, v_sz
