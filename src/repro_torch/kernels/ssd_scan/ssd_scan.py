"""ctypes wrapper of the CUDA chunked-SSD kernels (`csrc/ssd_scan.cu`),
the port of `repro.kernels.ssd_scan.ssd_scan.ssd_pallas`'s forward (its
backward, in `ops.py`, is the vjp of `chunked.ssd_chunked`, as the
reference's). Its plain version is `chunked.ssd_chunked`.

`launch_plan` is the launch geometry as a plain function of the shapes
(body, P columns per block, grid, chunk stages, shared-memory bytes), so
that it can be checked without a card; the C entry recomputes the shared
memory from the body's own layout and refuses a plan that disagrees."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.build import N_SM, SMEM_LIMIT, copy_width

Q = 64                   # the kernels' chunk length
MMA_MAX_N = 128          # state columns the tensor-core body holds
MMA_PB = (64, 32, 16)    # its P columns per block, widest first
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
             + [ctypes.c_longlong, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """Launch geometry of one call. body "mma": block (pj, h, b) computes
    head h of batch row b for P columns [pj * pb, pj * pb + pb), on the
    bf16 tensor cores, with `stages` chunk buffers; body "fma": block (h,
    b) computes the whole head in float32 FMAs (pb = 0)."""

    body: str
    pb: int
    stages: int
    grid: tuple
    threads: int
    smem_bytes: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def mma_smem(pb: int, N: int, stages: int) -> int:
    """Shared memory of the tensor-core body (`tc::Layout`): per stage the
    chunk's B and C rows (N rounded up to 64, plus 8 bf16 of pitch), its
    x rows (pb + 8 bf16) and dt; the state as hi and lo bf16 rows; the
    float64 cumsum and the decay weights."""
    nn = _ceil(N, 64) * 64
    bp, xp = (nn + 8) * 2, (pb + 8) * 2
    stage = 2 * Q * bp + Q * xp + Q * 4
    return stages * stage + 2 * pb * bp + Q * 8 + Q * 4


def fma_smem(P: int, N: int) -> int:
    """Shared memory of the FMA body (`fma::layout`), in float32 words x
    4: the cumsum (kQ doubles), B and C chunks at an odd pitch of N
    rounded up to 64, x at P's, the state, the scores and dt, w."""
    pp, pn = _ceil(P, 64) * 64, _ceil(N, 64) * 64
    words = (2 * Q + 2 * Q * (pn + 1) + Q * (pp + 1) + pp * (pn + 1)
             + Q * (Q + 1) + 2 * Q)
    return 4 * words


def launch_plan(B: int, H: int, P: int, N: int, dtype,
                pb: Optional[int] = None,
                stages: Optional[int] = None) -> SsdPlan:
    """bf16 with N <= 128 takes the tensor-core body: P split into blocks
    of pb columns, by default the widest of 64, 32, 16 (and no wider than
    P rounded up to 16) whose grid reaches one block per SM, else 16;
    two chunk stages (they fit in shared memory at every pb and N <=
    128). Everything else takes the FMA body, one block per (head, batch
    row). `pb` and `stages` other than the defaults only time the
    options."""
    if dtype == torch.bfloat16 and N <= MMA_MAX_N:
        if pb is None:
            fits = [w for w in MMA_PB if w <= _ceil(P, 16) * 16] or [16]
            pb = next((w for w in fits if _ceil(P, w) * H * B >= N_SM),
                      fits[-1])
        if pb not in MMA_PB:
            raise ValueError(f"pb {pb} (one of {MMA_PB})")
        stages = 2 if stages is None else stages
        if stages not in (1, 2):
            raise ValueError(f"stages {stages} (1 or 2)")
        return SsdPlan("mma", pb, stages, (_ceil(P, pb), H, B), 256,
                       mma_smem(pb, N, stages))
    return SsdPlan("fma", 0, 1, (H, B), 256, fma_smem(P, N))


def _f32(t: Optional[torch.Tensor], shape: tuple, what: str):
    if t is None:
        return None
    if tuple(t.shape) != shape:
        raise ValueError(f"ssd_cuda: {what} must be {shape}, got "
                         f"{tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor,
             D: Optional[torch.Tensor] = None,
             init_state: Optional[torch.Tensor] = None, *,
             plan: Optional[SsdPlan] = None):
    """x (B,S,H,P) and Bmat/Cmat (B,S,G,N), contiguous, float32 or bf16
    (one dtype), on a CUDA device; dt (B,S,H), A (H,), D (H,) and
    init_state (B,H,P,N) are taken in float32. Returns (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) float32), launched on the current
    stream; `plan` other than `launch_plan`'s only times the options."""
    if not x.is_cuda:
        raise ValueError("ssd_cuda needs CUDA tensors")
    Bz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if tuple(Bmat.shape) != (Bz, S, G, N) or Cmat.shape != Bmat.shape:
        raise ValueError(f"ssd_cuda: B/C must be ({Bz},{S},G,N), got "
                         f"{tuple(Bmat.shape)} and {tuple(Cmat.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_cuda: heads {H} not a multiple of groups {G}")
    if Bmat.dtype != x.dtype or Cmat.dtype != x.dtype:
        raise TypeError("ssd_cuda: x, B and C must share one dtype")
    if not all(t.is_contiguous() for t in (x, Bmat, Cmat)):
        raise ValueError("ssd_cuda needs contiguous x, B and C")
    dt32 = _f32(dt, (Bz, S, H), "dt")
    A32 = _f32(A, (H,), "A")
    D32 = _f32(D, (H,), "D")
    h0 = _f32(init_state, (Bz, H, P, N), "init_state")
    code = build.dtype_code(x.dtype)
    plan = plan or launch_plan(Bz, H, P, N, x.dtype)
    if plan.smem_bytes > SMEM_LIMIT or max(plan.grid[1:]) > 65535:
        raise ValueError(f"ssd_cuda: head dim {P} and state {N} need "
                         f"{plan.smem_bytes} bytes of shared memory "
                         f"(limit {SMEM_LIMIT}) or a grid {plan.grid} past "
                         "the card's limits")
    y = torch.empty_like(x)
    hT = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    esize = x.element_size()
    vb_bc = copy_width(N * esize, Bmat.data_ptr(), Cmat.data_ptr())
    vb_x = copy_width(P * esize, x.data_ptr())
    fn = build.library("ssd_scan").repro_ssd_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(code, x.data_ptr(), dt32.data_ptr(), A32.data_ptr(),
             Bmat.data_ptr(), Cmat.data_ptr(), ptr(D32), ptr(h0),
             y.data_ptr(), hT.data_ptr(), Bz, S, H, P, G, N, plan.pb,
             plan.stages, vb_bc, vb_x, plan.smem_bytes,
             torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["ssd_scan"] += 1
    build.check(err, "ssd_scan")
    return y, hT
