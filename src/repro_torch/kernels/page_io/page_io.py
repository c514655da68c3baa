"""ctypes wrapper of the grouped CUDA page copy (`csrc/page_io.cu`), the
port of `repro.kernels.page_io.page_io.write_pages_pallas`, of the
substrate's page streams (`repro.serving.substrate.tier_substrate`) and
of the fleet's handoff copy (`repro.serving.fleet.roles.copy_pages`).

`plan` turns a list of `Segment`s into the kernel's int64 descriptor:
per segment the vector width its alignment allows, its vector and tile
counts, the multiply-shift divisions that locate a vector's page, and
whether its page ids are staged in shared memory. The CPU tests emulate
the kernel's walk over exactly this descriptor."""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import build

# layout constants of `csrc/page_io.cu` (checked against the library)
HEADER, SEG_FIELDS = 4, 17
MAX_SEGS, ID_CAP = 32, 4096
THREADS, UNROLL = 256, 4
TILE = THREADS * UNROLL           # vectors a block moves per tile
BLOCKS_PER_SM = 2048 // THREADS   # resident 256-thread blocks per SM
MAX_VEC = 2**31 - TILE            # vectors of one segment (32-bit math)


class HostMappingError(RuntimeError):
    """A host tensor is not mapped into the device's address space
    (`cudaHostGetDevicePointer` failed)."""


@dataclasses.dataclass(frozen=True)
class Segment:
    """`dst[i, dst_ids[j]] = src[i, src_ids[j]]` for i < nb, j < n, pages
    of M bytes; an id pointer of 0 means page j. Pointers are device
    addresses (ints)."""
    dst: int
    src: int
    dst_ids: int
    src_ids: int
    nb: int
    P_dst: int
    P_src: int
    n: int
    M: int


def magic(d: int) -> tuple[int, int]:
    """(mul, shift) with v // d == (v * mul) >> shift for 0 <= v < 2^31
    (Granlund and Montgomery, 1994: mul = ceil(2^(31 + L) / d), L =
    ceil(log2 d); mul < 2^32 for d < 2^31)."""
    if not 1 <= d < 2**31:
        raise ValueError(f"page copy: divisor {d} out of range")
    L = (d - 1).bit_length()
    return -(-(1 << (31 + L)) // d), 31 + L


def vec_width(M: int, *ptrs: int) -> int:
    """Widest vector (16, 8, 4, 2 or 1 bytes) that divides a page and
    every base address: every page row is then a whole number of aligned
    vectors."""
    for w in (16, 8, 4, 2):
        if M % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


@dataclasses.dataclass(frozen=True)
class Plan:
    desc: np.ndarray     # int64 descriptor words
    grid: tuple          # (x, segments): blocks of the launch
    n_tiles: int         # tiles of all segments


def _split(seg: Segment) -> list[Segment]:
    """Split a segment along its levels so each part stays under the
    kernel's 32-bit vector count."""
    per_level = seg.n * seg.M
    max_levels = max(1, MAX_VEC // max(1, per_level))
    if seg.nb <= max_levels:
        return [seg]
    parts = []
    for i0 in range(0, seg.nb, max_levels):
        k = min(max_levels, seg.nb - i0)
        parts.append(dataclasses.replace(
            seg, nb=k, dst=seg.dst + i0 * seg.P_dst * seg.M,
            src=seg.src + i0 * seg.P_src * seg.M))
    return parts


def plan(segments: Sequence[Segment], *, n_sm: int = build.N_SM) -> Plan:
    """The descriptor of one launch over `segments` (at most MAX_SEGS
    after splitting; empty segments are left out)."""
    segs = [p for s in segments if s.nb and s.n and s.M for p in _split(s)]
    if len(segs) > MAX_SEGS:
        raise ValueError(f"page copy: {len(segs)} segments, at most "
                         f"{MAX_SEGS} in one launch")
    for s in segs:       # the kernel's page offsets are 32-bit products
        if max(s.nb * s.P_dst, s.nb * s.P_src, s.M) >= 2**31:
            raise ValueError(f"page copy: {s.nb} levels x {s.P_dst} / "
                             f"{s.P_src} pages of {s.M} B exceed 2^31")
    desc = np.zeros(HEADER + MAX_SEGS * SEG_FIELDS, dtype=np.int64)
    n_tiles = max_tiles = 0
    for k, s in enumerate(segs):
        w = vec_width(s.M, s.dst, s.src)
        per_page = s.M // w
        n_vec = s.nb * s.n * per_page
        tiles = -(-n_vec // TILE)
        ids = int(bool(s.dst_ids)) + int(bool(s.src_ids))
        stage = int(ids > 0 and 2 * s.n <= ID_CAP)
        desc[HEADER + k * SEG_FIELDS:HEADER + (k + 1) * SEG_FIELDS] = (
            s.dst, s.src, s.dst_ids, s.src_ids, s.P_dst, s.P_src, s.M,
            n_vec, tiles, per_page, *magic(per_page), s.n,
            *magic(s.n), w, stage)
        n_tiles += tiles
        max_tiles = max(max_tiles, tiles)
    desc[0] = len(segs)
    grid_x = min(max_tiles, max(1, n_sm * BLOCKS_PER_SM // max(1, len(segs))))
    return Plan(desc=desc, grid=(grid_x, len(segs)), n_tiles=n_tiles)


_LAYOUT_CHECKED = False


def _lib():
    global _LAYOUT_CHECKED
    lib = build.library("page_io")
    if not _LAYOUT_CHECKED:
        out = (ctypes.c_longlong * 5)()
        lib.repro_page_copy_layout(out)
        want = (HEADER, SEG_FIELDS, MAX_SEGS, ID_CAP, TILE)
        if tuple(out) != want:
            raise RuntimeError(f"page_io.cu layout {tuple(out)} != {want}")
        lib.repro_page_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.repro_page_copy.restype = ctypes.c_int
        lib.repro_host_device_ptr.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.repro_host_device_ptr.restype = ctypes.c_int
        _LAYOUT_CHECKED = True
    return lib


def host_device_ptr(t: torch.Tensor) -> int:
    """The device address of pinned host tensor `t`'s data (through
    `cudaHostGetDevicePointer`); raises `HostMappingError` when the memory
    is not mapped, ValueError when it is not pinned. No staged fallback."""
    if t.is_cuda:
        return t.data_ptr()
    if not t.is_pinned():
        raise ValueError("page copy: a host tensor must be pinned "
                         "(pin_memory=True) for the kernel to reach it")
    # resolve the allocation's base, then step to the tensor's data
    base = t.untyped_storage().data_ptr()
    dev = ctypes.c_void_p()
    err = _lib().repro_host_device_ptr(base, ctypes.byref(dev))
    if err != 0 or not dev.value:
        raise HostMappingError(
            f"page copy: cudaHostGetDevicePointer failed (CUDA error {err}):"
            " the host tensor is not mapped into the device's address space")
    return int(dev.value) + t.data_ptr() - base


def launch(segments: Sequence[Segment], name: str,
           device: torch.device) -> None:
    """One launch of the grouped page copy over `segments` on the current
    stream of `device`; counts one launch of `name`."""
    p = plan(segments)
    if p.n_tiles == 0:
        return
    err = _lib().repro_page_copy(
        p.desc.ctypes.data, p.grid[0],
        torch.cuda.current_stream(device).cuda_stream)
    kernels.LAUNCHES[name] += 1
    build.check(err, name)


def _page_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[2:]) * t.element_size()


def _check_ids(ids: torch.Tensor, n: int, device: torch.device) -> None:
    if ids.dtype != torch.int32 or ids.shape != (n,) \
            or not ids.is_contiguous() or ids.device != device:
        raise ValueError(
            f"page copy: ids must be ({n},) contiguous int32 on {device}, "
            f"got {tuple(ids.shape)} {ids.dtype} on {ids.device}")


def write_segments(pools: Sequence[torch.Tensor],
                   tiles: Sequence[torch.Tensor],
                   phys: torch.Tensor) -> list[Segment]:
    """The segments of `pool[:, phys[j]] = tiles[:, j]` for each pair."""
    segs = []
    for pool, t in zip(pools, tiles, strict=True):
        if not (pool.is_cuda and t.device == pool.device):
            raise ValueError("write_pages_cuda needs CUDA tensors on one "
                             "device")
        if t.dtype != pool.dtype:
            raise TypeError(f"write_pages_cuda: pool {pool.dtype}, tiles "
                            f"{t.dtype} (need tiles in the pool dtype)")
        if (pool.dim() < 2 or t.dim() != pool.dim()
                or t.shape[0] != pool.shape[0]
                or t.shape[2:] != pool.shape[2:]):
            raise ValueError(f"write_pages_cuda: pool {tuple(pool.shape)},"
                             f" tiles {tuple(t.shape)}")
        if not (pool.is_contiguous() and t.is_contiguous()):
            raise ValueError("write_pages_cuda needs contiguous tensors")
        _check_ids(phys, t.shape[1], pool.device)
        segs.append(Segment(
            dst=pool.data_ptr(), src=t.data_ptr(), dst_ids=phys.data_ptr(),
            src_ids=0, nb=pool.shape[0], P_dst=pool.shape[1],
            P_src=t.shape[1], n=t.shape[1], M=_page_bytes(pool)))
    return segs


def write_pages_cuda(pools: Sequence[torch.Tensor],
                     tiles: Sequence[torch.Tensor],
                     phys: torch.Tensor) -> None:
    """`pools[k][:, phys[j]] = tiles[k][:, j]` for every k in ONE launch:
    pools (nb, P_phys, *page_dims), tiles (nb, n_wp, *page_dims) in the
    pool's dtype, phys (n_wp,) int32 unique physical page ids, all
    contiguous on one CUDA device, on the current stream. An id outside
    [0, P_phys) is dropped."""
    launch(write_segments(pools, tiles, phys), "write_pages",
           pools[0].device)


def copy_segments(dst: Sequence[torch.Tensor],
                  dst_ids: Optional[torch.Tensor],
                  src: Sequence[torch.Tensor],
                  src_ids: Optional[torch.Tensor]) -> list[Segment]:
    """The segments of `dst[k][:, dst_ids[j]] = src[k][:, src_ids[j]]`;
    a pinned host tensor is reached through its mapped device address."""
    device = next(t.device for t in (*dst, *src) if t.is_cuda)
    segs = []
    for d, s in zip(dst, src, strict=True):
        if d.dtype != s.dtype or d.shape[0] != s.shape[0] \
                or d.shape[2:] != s.shape[2:]:
            raise ValueError(f"copy_pages: dst {tuple(d.shape)} {d.dtype},"
                             f" src {tuple(s.shape)} {s.dtype}")
        if not (d.is_contiguous() and s.is_contiguous()):
            raise ValueError("copy_pages needs contiguous tensors")
        for t in (d, s):
            if t.is_cuda and t.device != device:
                raise ValueError("copy_pages: tensors on two devices")
        ids = src_ids if src_ids is not None else dst_ids
        n = s.shape[1] if ids is None else ids.shape[0]
        for ids in (dst_ids, src_ids):
            if ids is not None:
                _check_ids(ids, n, device)
        if dst_ids is None and d.shape[1] < n or \
                src_ids is None and s.shape[1] < n:
            raise ValueError(f"copy_pages: {n} pages do not fit "
                             f"dst {tuple(d.shape)} / src {tuple(s.shape)}")
        segs.append(Segment(
            dst=host_device_ptr(d), src=host_device_ptr(s),
            dst_ids=0 if dst_ids is None else dst_ids.data_ptr(),
            src_ids=0 if src_ids is None else src_ids.data_ptr(),
            nb=d.shape[0], P_dst=d.shape[1], P_src=s.shape[1], n=n,
            M=_page_bytes(d)))
    return segs


def copy_pages_cuda(dst: Sequence[torch.Tensor],
                    dst_ids: Optional[torch.Tensor],
                    src: Sequence[torch.Tensor],
                    src_ids: Optional[torch.Tensor], *,
                    name: str) -> None:
    """`dst[k][:, dst_ids[j]] = src[k][:, src_ids[j]]` for every leaf k in
    ONE launch (ids None: page j), on the current stream; `name`
    ("page_out", "page_in", "handoff" or "layer_in") is the launch
    counted."""
    segs = copy_segments(dst, dst_ids, src, src_ids)
    launch(segs, name, next(t.device for t in (*dst, *src) if t.is_cuda))
