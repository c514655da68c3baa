"""ctypes wrapper of the CUDA W8A8 int8 matmul (`csrc/matmul_w8a8.cu`),
the port of `repro.kernels.matmul_w8a8.matmul_w8a8.matmul_w8a8_pallas`.

`launch_plan` is the launch geometry as a plain function of the shape
(block tile, grid, shared-memory bytes), so that it can be checked
without a card; the C entry recomputes the shared memory from the
kernel's own layout and refuses a plan that disagrees."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.build import N_SM, copy_width

BK = 64                                   # K bytes per tile
STAGES = 4                                # K tiles in the cp.async ring
TILES = ((128, 128), (64, 128), (32, 64))  # (bm, bn), largest first
# blocks a tile's grid needs to be chosen: three quarters of the SMs (at
# SmolLM-360M's M=1024 down projection, 128 blocks of 64 x 128 beat 480
# of 32 x 64 by a quarter on the H100)
MIN_BLOCKS = 3 * N_SM // 4
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class W8A8Plan:
    """Block (j, i) computes out[i * bm : i * bm + bm, j * bn : j * bn +
    bn] over all of K."""

    bm: int
    bn: int
    grid: tuple          # (ceil(N / bn), ceil(M / bm))
    threads: int
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(bm: int, bn: int) -> int:
    """The kernel's `Layout`: four stages of the A tile (bm rows of 64
    bytes at an 80-byte pitch) and of the B tile (64 rows of bn bytes at
    a pitch of bn + 16)."""
    return STAGES * (bm * 80 + BK * (bn + 16))


def launch_plan(M: int, N: int, tile: Optional[tuple] = None) -> W8A8Plan:
    """The largest block tile of `TILES` whose grid has `MIN_BLOCKS`
    blocks, else the smallest; `tile` other than the default only times
    the options."""
    if tile is None:
        tile = next((t for t in TILES
                     if _ceil(M, t[0]) * _ceil(N, t[1]) >= MIN_BLOCKS),
                    TILES[-1])
    if tile not in TILES:
        raise ValueError(f"tile {tile} (one of {TILES})")
    bm, bn = tile
    return W8A8Plan(bm, bn, (_ceil(N, bn), _ceil(M, bm)), 256,
                    smem_bytes(bm, bn))


def matmul_w8a8_cuda(a8: torch.Tensor, b8: torch.Tensor, sa: torch.Tensor,
                     sb: torch.Tensor, *,
                     plan: Optional[W8A8Plan] = None) -> torch.Tensor:
    """a8 (M, K) int8 @ b8 (K, N) int8 with sa (M,) and sb (N,) float32,
    all contiguous on one CUDA device, any M, N, K. Returns (M, N)
    float32 `float(acc) * sa[m] * sb[n]`, launched on the current
    stream; `plan` other than `launch_plan`'s only times the options."""
    dev = a8.device
    tensors = (a8, b8, sa, sb)
    if not (a8.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("matmul_w8a8_cuda needs CUDA tensors on one device")
    if (a8.dtype != torch.int8 or b8.dtype != torch.int8
            or sa.dtype != torch.float32 or sb.dtype != torch.float32):
        raise TypeError(
            f"matmul_w8a8_cuda: a8 {a8.dtype}, b8 {b8.dtype}, sa "
            f"{sa.dtype}, sb {sb.dtype} (need int8 operands, f32 scales)")
    if a8.dim() != 2 or b8.dim() != 2 or a8.shape[1] != b8.shape[0]:
        raise ValueError(f"matmul_w8a8_cuda: a8 {tuple(a8.shape)} @ b8 "
                         f"{tuple(b8.shape)}")
    M, K = a8.shape
    N = b8.shape[1]
    if sa.shape != (M,) or sb.shape != (N,):
        raise ValueError(f"matmul_w8a8_cuda: sa {tuple(sa.shape)}, sb "
                         f"{tuple(sb.shape)} for M={M}, N={N}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("matmul_w8a8_cuda needs contiguous tensors")
    plan = plan or launch_plan(M, N)
    if plan.grid[1] > 65535 or max(K, N) >= 2**31:
        raise ValueError(f"matmul_w8a8_cuda: shape ({M}, {K}, {N}) past "
                         "the grid's limits")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    fn = build.library("matmul_w8a8").repro_matmul_w8a8
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(a8.data_ptr(), b8.data_ptr(), sa.data_ptr(), sb.data_ptr(),
             out.data_ptr(), M, N, K, plan.bm, plan.bn,
             copy_width(K, a8.data_ptr()), copy_width(N, b8.data_ptr()),
             plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    kernels.LAUNCHES["matmul_w8a8"] += 1
    build.check(err, "matmul_w8a8")
    return out
