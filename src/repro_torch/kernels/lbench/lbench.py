"""ctypes wrapper of the CUDA LBench kernel (`csrc/lbench.cu`), the port
of `repro.kernels.lbench.lbench.lbench_pallas`."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def lbench_cuda(a: torch.Tensor, nflop: int,
                alpha: float = 0.5) -> torch.Tensor:
    """`a` contiguous float32 on a CUDA device, any element count.
    Returns a new tensor shaped like `a` holding the FMA chain of
    `ref.lbench`, launched on the current stream. The kernel computes in
    float32 only: another dtype raises (the reference's Pallas kernel
    runs its chain in the input dtype, its oracle in float32)."""
    if not a.is_cuda:
        raise ValueError("lbench_cuda needs a CUDA tensor")
    if a.dtype != torch.float32:
        raise TypeError(f"lbench_cuda computes in float32, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("lbench_cuda needs a contiguous tensor")
    if not 0 <= nflop < 2**31:
        raise ValueError(f"nflop out of range: {nflop}")
    out = torch.empty_like(a)
    fn = build.library("lbench").repro_lbench
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(a.data_ptr(), out.data_ptr(), a.numel(), nflop, float(alpha),
             torch.cuda.current_stream(a.device).cuda_stream)
    kernels.LAUNCHES["lbench"] += 1
    build.check(err, "lbench")
    return out
