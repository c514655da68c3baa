"""ctypes wrappers of the CUDA flash-attention forward
(`csrc/flash_attention.cu`), the port of
`repro.kernels.flash_attention.flash_attention._fwd_pallas`, and of its
backward (`csrc/flash_attention_bwd.cu`), the port of `_flash_bwd`.

`launch_plan` and `bwd_plan` are the kernels' launch geometry as plain
functions of the shapes (row slots or keys per block, grid, key splits,
shared-memory bytes), so that it can be checked without a card; the C
entries recompute the shared memory from their own layouts and refuse a
plan that disagrees."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.build import N_SM, SMEM_LIMIT, copy_width

MAX_HEAD_DIM = 256
KEY_TILE = 64            # keys per tile of the tensor-core body, D <= 128
ROWS = 32                # (query, head) row slots per tensor-core block
THREADS = 128            # 4 warps: rows / 16 row groups x key groups
# above D 128 (D padded to 16): each row group's output columns split
# over COL_GROUPS warps, 32-key tiles, at most WIDE_THREADS a block
COL_GROUPS = 4
WIDE_KEY_TILE = 32
WIDE_THREADS = 256
WIDE_ROWS = 16
WIDE_KEY_GROUPS = 2
S_PITCH = WIDE_KEY_TILE + 8  # f32 pitch of a partial S tile above D 128
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry of one call. bf16: block (x, y, z) computes rows
    [x * rows, x * rows + rows) of KV head y's Sq * rep rows (row = query
    position * rep + head of the group), batch row z // n_split, over key
    split z % n_split of its causal key range; its warps are rows / 16
    row groups times `key_groups`, which take the split's key tiles in
    turn and merge in shared memory, times `col_groups` (above D 128),
    which split the output's columns; causal blocks above D 128 run in
    reverse x order (the longest key ranges first). float32: block (x, y,
    z) computes 16 query positions of query head y, batch row z."""

    tensor_core: bool    # bf16: mma body; float32: FMA body
    rows: int            # row slots a block computes (16 per row group)
    key_groups: int      # warp groups that share a row group's key tiles
    threads: int
    grid: tuple          # (x, y, z)
    n_split: int         # key splits merged by the combine kernel
    smem_bytes: int
    col_groups: int = 1  # warps splitting a row group's output columns
    key_tile: int = KEY_TILE


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(B: int, Sq: int, Skv: int, H: int, KV: int, D: int, dtype,
                causal: bool = True, kv_offset: int = 0) -> Plan:
    """The launch geometry `csrc/flash_attention.cu` takes for these
    shapes: float32 runs the FMA body (16 query positions per block per
    query head, 32-key tiles staged as f32); bfloat16 the tensor-core
    body with 32 row slots and two key groups of 64-key tiles per block
    up to D 128; above it 16 row slots whose output columns split over 4
    warps, two key groups of 32-key tiles; its key range split across
    blocks only where the blocks are fewer than the SMs and the split
    keeps every key group busy (PERF.md, `scripts/attention_plans.py`)."""
    if dtype == torch.float32:
        pitch = D + 1 if D % 2 == 0 else D
        return Plan(False, 16, 1, 128, (_ceil(Sq, 16), H, B), 1,
                    4 * (16 * D + 2 * 32 * pitch))
    return _mma_plan(B, Sq, Skv, H, KV, D, causal, kv_offset)


def _col_groups(D: int) -> int:
    """Warps that split a row group's output columns: 4 above D 128 (D
    padded to 16), else 1."""
    return COL_GROUPS if _ceil(D, 16) * 16 > 128 else 1


def _key_tile(D: int) -> int:
    return WIDE_KEY_TILE if _col_groups(D) > 1 else KEY_TILE


def _key_groups(rows: int) -> int:
    """Warps of a block that share one row group up to D 128: 4 warps /
    (rows / 16)."""
    return THREADS // 32 // (rows // 16)


def mma_options(D: int) -> list:
    """The (rows, key_groups) geometries the tensor-core body takes at
    head dim D: up to D 128 four warps as rows / 16 row groups x key
    groups; above it 4 column warps a row group and at most 256
    threads."""
    if _col_groups(D) == 1:
        return [(r, _key_groups(r)) for r in (16, 32, 64)]
    return [(r, kg) for r in (16, 32, 64) for kg in (1, 2, 4)
            if 32 * COL_GROUPS * (r // 16) * kg <= WIDE_THREADS]


def _mma_smem(rows: int, D: int, key_groups: Optional[int] = None) -> int:
    """Dynamic shared memory of the tensor-core body (`MmaSmem`): q rows,
    two rounds of one K/V tile slot per key group and, above D 128, a
    float32 partial S tile per (row group, key group, column warp)."""
    kp = key_groups if key_groups is not None else _key_groups(rows)
    qp = 2 * (_ceil(D, 16) * 16 + 8)     # bf16 row pitch, bytes
    cgs = _col_groups(D)
    sx = rows // 16 * kp * cgs * 16 * S_PITCH * 4 if cgs > 1 else 0
    return rows * qp + 2 * kp * 2 * _key_tile(D) * qp + sx


def _mma_plan(B: int, Sq: int, Skv: int, H: int, KV: int, D: int,
              causal: bool = True, kv_offset: int = 0,
              rows: Optional[int] = None,
              n_split: Optional[int] = None,
              key_groups: Optional[int] = None) -> Plan:
    """The tensor-core body's plan with `rows` (16, 32 or 64) row slots
    per block and `key_groups` groups of warps sharing them (up to D 128
    four warps in all: default `ROWS`, or 64 rows where two key groups'
    tiles do not fit; above D 128 `WIDE_ROWS` rows and `WIDE_KEY_GROUPS`
    groups of 4 column warps) and `n_split` key splits (default: none
    where the blocks fill the card, else about two blocks per SM, each
    split keeping every key group busy); other values than the defaults
    only time the options (`scripts/attention_plans.py`)."""
    cgs = _col_groups(D)
    if cgs > 1:
        rows = WIDE_ROWS if rows is None else rows
        kp = WIDE_KEY_GROUPS if key_groups is None else key_groups
    else:
        if rows is None:
            rows = ROWS if _mma_smem(ROWS, D) <= SMEM_LIMIT else 64
        kp = _key_groups(rows) if rows in (16, 32, 64) else 0
        if key_groups not in (None, kp):
            raise ValueError(f"key_groups {key_groups} at rows {rows}")
    if (rows, kp) not in mma_options(D):
        raise ValueError(f"rows {rows} x key groups {kp} per block at D {D}")
    rep = H // KV
    blocks = _ceil(Sq * rep, rows) * KV * B
    tile = _key_tile(D)
    # keys any row can see: the last query position's causal frontier
    n_keys = max(0, min(Skv, kv_offset + Sq)) if causal else Skv
    n_tiles = max(1, _ceil(n_keys, tile))
    if n_split is None:
        n_split = min(_ceil(2 * N_SM, blocks) if blocks < N_SM else 1,
                      max(1, n_tiles // kp))
    n_split = max(1, min(n_split, n_tiles))
    return Plan(True, rows, kp, 32 * cgs * (rows // 16) * kp,
                (_ceil(Sq * rep, rows), KV, B * n_split), n_split,
                _mma_smem(rows, D, kp), cgs, tile)


def flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, scale: Optional[float] = None,
                   kv_offset: int = 0, plan: Optional[Plan] = None):
    """q (B,Sq,H,D), k/v (B,Skv,KV,D), contiguous, one CUDA device, all
    float32 or all bfloat16, H a multiple of KV, D <= 256. Returns
    (out (B,Sq,H,D) in q's dtype, lse (B,H,Sq) float32), launched on the
    current stream. `plan` replaces `launch_plan`'s (only to time the
    options)."""
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_mha_cuda needs contiguous tensors")
    scale = scale if scale is not None else D ** -0.5
    plan = plan or launch_plan(B, Sq, Skv, H, KV, D, q.dtype, causal,
                               kv_offset)
    if not (0 < D <= MAX_HEAD_DIM and max(plan.grid[1:]) <= 65535
            and plan.smem_bytes <= SMEM_LIMIT):
        raise ValueError(f"flash_mha_cuda: D={D}, plan {plan} out of "
                         "range")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    part = part_ml = None
    if plan.n_split > 1:
        part = torch.empty((plan.n_split, B * Sq * H, _ceil(D, 16) * 16),
                           dtype=torch.float32, device=q.device)
        part_ml = torch.empty((plan.n_split, B * Sq * H, 2),
                              dtype=torch.float32, device=q.device)
    vb = copy_width(D * q.element_size(), q.data_ptr(), k.data_ptr(),
                    v.data_ptr())
    fn = build.library("flash_attention").repro_flash_mha
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, Sq, Skv, H, KV, D, build.dtype_code(q.dtype),
             float(scale), int(causal), int(kv_offset), plan.rows,
             plan.key_groups, plan.n_split, vb, plan.smem_bytes,
             part.data_ptr() if part is not None else None,
             part_ml.data_ptr() if part_ml is not None else None,
             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_mha"] += 1
    build.check(err, "flash_mha")
    return out, lse


BWD_KEY_TILE = 64        # dq pass: keys per staged K/V tile
BWD_ROW_TILE = 64        # dk/dv pass: rows per staged q/dout tile
BWD_DQ_ROWS = 64         # bf16 dq pass: rows a block, 16 a warp
BWD_DKV_KEYS = 16        # bf16 dk/dv pass: keys a block
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """Launch geometry of one backward call, 4 warps a block. bf16: dq
    block (x, y) computes rows [r, r + rows) of KV head x % KV's Sq * rep
    rows (row = query position * rep + head of the group), batch row
    x // KV, r = (grid_y - 1 - y) * rows, 16 rows a warp. dk/dv block
    (x, y) computes keys [y * keys, y * keys + keys) of the same KV head
    and batch row; its warps are `row_groups` (which take the 16-row
    chunks of each 64-row tile in turn) times `col_groups` (which split
    dk/dv's 16-column tiles), and the row groups merge in a fixed order.
    float32: dq block (x, y, z) computes 16 query positions of query head
    y, batch row z; dk/dv block (x, y, z) 32 keys of KV head y, batch row
    z."""

    tensor_core: bool    # bf16: mma bodies; float32: FMA bodies
    rows: int            # dq pass: rows (bf16) or query positions a block
    keys: int            # dk/dv pass: keys a block
    row_groups: int      # bf16 dk/dv pass: warps sharing a key group
    col_groups: int      # bf16 dk/dv pass: warps splitting the columns
    dq_grid: tuple
    dkv_grid: tuple
    dq_smem: int
    dkv_smem: int


def _bwd_mma_smem(D: int) -> tuple:
    """Dynamic shared memory of the tensor-core passes (`MmaSmem` in
    csrc/flash_attention_bwd.cu): dq: q and dout rows and two K/V tiles;
    dk/dv: the block's K/V rows and two q/dout row tiles with their lse
    and delta."""
    qp = 2 * (_ceil(D, 16) * 16 + 8)     # bf16 row pitch, bytes
    return (2 * BWD_DQ_ROWS * qp + 2 * 2 * BWD_KEY_TILE * qp,
            2 * BWD_DKV_KEYS * qp + 2 * 2 * BWD_ROW_TILE * qp
            + 2 * 2 * BWD_ROW_TILE * 4)


def bwd_scratch_floats(B: int, Sq: int, H: int, KV: int) -> int:
    """float32 scratch of the backward: delta (B, H, Sq) for the FMA
    bodies, the lse and delta rows (2, B * KV, Sq * H / KV rounded up to
    64) for the tensor-core bodies."""
    return max(B * H * Sq, 2 * B * KV * _ceil(Sq * (H // KV), 64) * 64)


def bwd_plan(B: int, Sq: int, Skv: int, H: int, KV: int,
             D: int, dtype) -> BwdPlan:
    """The launch geometry `csrc/flash_attention_bwd.cu` takes for these
    shapes. float32 runs the FMA bodies (16 query positions of one head
    per dq block, 32 keys per dk/dv block, tiles staged as f32). bfloat16
    runs the tensor-core bodies: 64 rows per dq block, 16 keys per dk/dv
    block in 4 row groups (2 row groups of 2 column groups above D 128),
    so that the most warps share a causal block's rows (PERF.md records
    the other geometries measured)."""
    if dtype == torch.float32:
        pitch = D + 1 if D % 2 == 0 else D
        return BwdPlan(False, 16, 32, 1, 1, (_ceil(Sq, 16), H, B),
                       (_ceil(Skv, 32), KV, B),
                       4 * (2 * 16 * D + 2 * 32 * pitch),
                       4 * (2 * 32 * pitch + 2 * 16 * D + 2 * 16 * 33
                            + 2 * 16 + 2 * 32 * D))
    col_groups = 2 if _ceil(D, 16) * 16 > 128 else 1
    dq_smem, dkv_smem = _bwd_mma_smem(D)
    return BwdPlan(True, BWD_DQ_ROWS, BWD_DKV_KEYS, 4 // col_groups,
                   col_groups,
                   (B * KV, _ceil(Sq * (H // KV), BWD_DQ_ROWS)),
                   (B * KV, _ceil(Skv, BWD_DKV_KEYS)), dq_smem, dkv_smem)


def flash_mha_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, *, causal: bool = True,
                       scale: Optional[float] = None, kv_offset: int = 0):
    """The backward of `flash_mha_cuda`: q, out, dout (B,Sq,H,D), k/v
    (B,Skv,KV,D), contiguous, one CUDA device, all float32 or all
    bfloat16, and the forward's lse (B,H,Sq) float32. Returns (dq, dk, dv)
    in the inputs' dtype, launched on the current stream (float32: three
    kernels, bf16: two; one count)."""
    ts = (q, k, v, out, dout)
    if not (all(t.is_cuda and t.device == q.device for t in ts)
            and lse.device == q.device):
        raise ValueError("flash_mha_bwd_cuda needs CUDA tensors on one "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in ts) \
            or lse.dtype != torch.float32:
        raise TypeError("flash_mha_bwd_cuda: q, k, v, out, dout in one of "
                        "float32/bfloat16 and lse float32, got "
                        f"{[t.dtype for t in ts]} and {lse.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_mha_bwd_cuda: q (B,Sq,H,D), k/v "
                         "(B,Skv,KV,D)")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or H % KV
            or out.shape != q.shape or dout.shape != q.shape
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"flash_mha_bwd_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}")
    if not all(t.is_contiguous() for t in (*ts, lse)):
        raise ValueError("flash_mha_bwd_cuda needs contiguous tensors")
    plan = bwd_plan(B, Sq, Skv, H, KV, D, q.dtype)
    if not (0 < D <= MAX_HEAD_DIM
            and all(max(g[1:]) <= 65535
                    for g in (plan.dq_grid, plan.dkv_grid))
            and max(plan.dq_smem, plan.dkv_smem) <= SMEM_LIMIT):
        raise ValueError(f"flash_mha_bwd_cuda: D={D}, H={H}, B={B}, plan "
                         f"{plan} out of range")
    scale = scale if scale is not None else D ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty(bwd_scratch_floats(B, Sq, H, KV),
                        dtype=torch.float32, device=q.device)
    vb = copy_width(D * q.element_size(), *(t.data_ptr() for t in ts))
    fn = build.library("flash_attention_bwd").repro_flash_mha_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), B, Sq, Skv, H, KV, D,
             build.dtype_code(q.dtype), float(scale), int(causal),
             int(kv_offset), vb, plan.dq_smem, plan.dkv_smem,
             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_mha_bwd"] += 1
    build.check(err, "flash_mha_bwd")
    return dq, dk, dv
