"""ctypes wrapper of the CUDA chunked-SSD kernel (`csrc/ssd_scan.cu`), the
port of `repro.kernels.ssd_scan.ssd_scan.ssd_pallas` (forward only: the
backward waits for training, ROADMAP A14). Its plain version is
`chunked.ssd_chunked`."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.build import SMEM_LIMIT

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


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
             init_state: Optional[torch.Tensor] = None):
    """x (B,S,H,P) and Bmat/Cmat (B,S,G,N), contiguous, float32 or bf16
    (one dtype), on a CUDA device; dt (B,S,H), A (H,), D (H,) and
    init_state (B,H,P,N) are taken in float32. Returns (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) float32), launched on the current
    stream."""
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
    lib = build.library("ssd_scan")
    smem_fn = lib.repro_ssd_smem_bytes
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    if smem_fn(P, N) > SMEM_LIMIT:
        raise ValueError(f"ssd_cuda: head dim {P} and state {N} need "
                         f"{smem_fn(P, N)} bytes of shared memory, over the "
                         f"{SMEM_LIMIT} a block may use")
    y = torch.empty_like(x)
    hT = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    fn = lib.repro_ssd_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(code, x.data_ptr(), dt32.data_ptr(), A32.data_ptr(),
             Bmat.data_ptr(), Cmat.data_ptr(), ptr(D32), ptr(h0),
             y.data_ptr(), hT.data_ptr(), Bz, S, H, P, G, N,
             torch.cuda.current_stream(x.device).cuda_stream)
    kernels.LAUNCHES["ssd_scan"] += 1
    build.check(err, "ssd_scan")
    return y, hT
