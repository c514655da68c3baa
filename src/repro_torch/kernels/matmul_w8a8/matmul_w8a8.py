"""ctypes wrapper of the CUDA W8A8 int8 matmul (`csrc/matmul_w8a8.cu`),
the port of `repro.kernels.matmul_w8a8.matmul_w8a8.matmul_w8a8_pallas`."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# the grid's y axis walks row tiles of 64
_MAX_M = 65535 * 64


def matmul_w8a8_cuda(a8: torch.Tensor, b8: torch.Tensor, sa: torch.Tensor,
                     sb: torch.Tensor) -> torch.Tensor:
    """a8 (M, K) int8 @ b8 (K, N) int8 with sa (M,) and sb (N,) float32,
    all contiguous on one CUDA device, any M, N, K. Returns (M, N)
    float32 `float(acc) * sa[m] * sb[n]`, launched on the current
    stream."""
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
    if M > _MAX_M or max(K, N) >= 2**31:
        raise ValueError(f"matmul_w8a8_cuda: shape ({M}, {K}, {N}) past "
                         "the grid's limits")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    fn = build.library("matmul_w8a8").repro_matmul_w8a8
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(a8.data_ptr(), b8.data_ptr(), sa.data_ptr(), sb.data_ptr(),
             out.data_ptr(), M, N, K,
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.LAUNCHES["matmul_w8a8"] += 1
    build.check(err, "matmul_w8a8")
    return out
