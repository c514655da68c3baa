"""Build and load the CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with `ctypes`. All sources that need a build compile in
parallel, one nvcc process each, at first use. Libraries land in
`build/kernels/` at the repository root, named by a hash of the source,
the shared headers and the flags, so an edited source rebuilds and an
unchanged one loads as is. `nvcc -Xptxas -v` output (registers, shared
memory, spills per kernel) is kept next to each library as `<lib>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("page_io", "flash_attention", "flash_attention_bwd",
           "paged_decode", "paged_prefill", "decode_attention", "lbench",
           "matmul_w8a8", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

# limits of the card the launch plans size themselves for (H100 SXM)
SMEM_LIMIT = 232448      # dynamic shared memory a block may use (227 KB)
N_SM = 132               # streaming multiprocessors

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds the last build_all() spent compiling (0.0 when all were cached)
LAST_BUILD_S = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once, and
    return {name: library path}. Raises with nvcc's output on failure."""
    global LAST_BUILD_S
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n, p in paths.items() if not p.exists()]
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    LAST_BUILD_S = time.perf_counter() - t0 if todo else 0.0
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building all sources on the
    first call."""
    with _LOCK:
        if name not in _LIBS:
            for n, path in build_all().items():
                _LIBS.setdefault(n, ctypes.CDLL(str(path)))
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def copy_width(row_bytes: int, *ptrs: int) -> int:
    """Widest cp.async (16 or 4 bytes) that divides a row and every base
    address; 1 means synchronous byte copies."""
    for w in (16, 4):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def dtype_code(dtype) -> int:
    """The `repro::DType` code of a torch dtype (csrc/common.cuh)."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    if dtype not in codes:
        raise TypeError(f"no kernel instantiation for {dtype}")
    return codes[dtype]
