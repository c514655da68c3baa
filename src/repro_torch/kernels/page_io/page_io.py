"""ctypes wrapper of the CUDA page writer (`csrc/page_io.cu`), the port of
`repro.kernels.page_io.page_io.write_pages_pallas`."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]


def write_pages_cuda(pool: torch.Tensor, tiles: torch.Tensor,
                     phys: torch.Tensor) -> torch.Tensor:
    """pool (nb, P_phys, *page_dims), tiles (nb, n_wp, *page_dims) in the
    pool's dtype, phys (n_wp,) int32 unique physical page ids; all
    contiguous on one CUDA device. Writes `pool[:, phys[j]] = tiles[:, j]`
    in place on the current stream and returns `pool`."""
    if not (pool.is_cuda and tiles.device == pool.device
            and phys.device == pool.device):
        raise ValueError("write_pages_cuda needs CUDA tensors on one device")
    if tiles.dtype != pool.dtype or phys.dtype != torch.int32:
        raise TypeError(
            f"write_pages_cuda: pool {pool.dtype}, tiles {tiles.dtype}, "
            f"phys {phys.dtype} (need tiles in the pool dtype, int32 phys)")
    if (pool.dim() < 2 or tiles.dim() != pool.dim()
            or tiles.shape[0] != pool.shape[0]
            or tiles.shape[2:] != pool.shape[2:]
            or phys.shape != (tiles.shape[1],)):
        raise ValueError(
            f"write_pages_cuda: pool {tuple(pool.shape)}, tiles "
            f"{tuple(tiles.shape)}, phys {tuple(phys.shape)}")
    if not (pool.is_contiguous() and tiles.is_contiguous()
            and phys.is_contiguous()):
        raise ValueError("write_pages_cuda needs contiguous tensors")
    nb, P, n_wp = pool.shape[0], pool.shape[1], tiles.shape[1]
    if n_wp > 65535 or nb > 65535:
        raise ValueError("write_pages_cuda: grid y/z limit is 65535")
    M = math.prod(pool.shape[2:]) * pool.element_size()
    lib = build.library("page_io")
    fn = lib.repro_write_pages
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(pool.data_ptr(), tiles.data_ptr(), phys.data_ptr(), nb, P,
             n_wp, M, torch.cuda.current_stream(pool.device).cuda_stream)
    kernels.LAUNCHES["write_pages"] += 1
    build.check(err, "write_pages")
    return pool
