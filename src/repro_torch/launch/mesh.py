"""Mesh construction (port of `repro.launch.mesh`).

A mesh is a process group: one process per rank, and a
`torch.distributed.device_mesh.DeviceMesh` over them with named axes
("data", "model") or ("pod", "data", "model"). Each axis's sub-groups are
made here with `new_group` and the mesh's timeout, so a collective that
one rank never joins fails after `timeout_s` instead of hanging the run.

The backend is the caller's choice, never a fallback: a "cuda" device
takes "nccl", a "cpu" device "gloo", and `backend=` asks for another
explicitly (several ranks sharing one card run "gloo": NCCL refuses two
ranks of one communicator on the same GPU).

`run_ranks` spawns the ranks of a mesh on this host (the tests,
`scripts/dev_serve_torch.py` and `chip_smoke.py` use it); on a cluster
the launcher of each host starts its ranks and calls `init_ranks`
itself.

`AbstractMesh` stands for a mesh no process group backs (the
reference's production meshes, `production_mesh`): the dry-run traces
one rank's step over it on meta tensors, where each collective of
`common.parallel` records its bytes instead of running.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.common.parallel import ParallelCtx, axis_sizes

TIMEOUT_S = 300.0            # every process group's collective timeout
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device: torch.device, backend: Optional[str]) -> str:
    if backend is not None:
        return backend
    if device.type not in BACKENDS:
        raise ValueError(f"no backend for device {device}")
    return BACKENDS[device.type]


def init_ranks(rank: int, world: int, init_method: str, *, device=None,
               backend: Optional[str] = None,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group as `rank` of `world` through
    `init_method` (a "file://" or "tcp://host:port" rendezvous), with a
    collective timeout of `timeout_s`."""
    device = resolve_device(device)
    backend = _backend(device, backend)
    _bind(device, rank)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def _bind(device: torch.device, rank: int) -> None:
    """Make a card this process's current one: the device's own index,
    or for a bare "cuda" the rank's card among this host's (ranks past
    the card count share them)."""
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else rank % torch.cuda.device_count())


def _make_mesh(shape: Sequence[int], axes: Sequence[str], device,
               backend: str, timeout_s: float):
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh was asked for {backend!r}")
    rank = dist.get_rank()
    ranks = torch.arange(world).reshape(shape)
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = []
    for i, n in enumerate(shape):
        mine = None
        # every rank creates every sub-group, in the same order
        for row in ranks.movedim(i, -1).reshape(-1, n).tolist():
            g = dist.new_group(row, timeout=timeout, backend=backend)
            if rank in row:
                mine = g
        groups.append(mine)
    mesh = DeviceMesh.from_group(groups, device.type, mesh=ranks,
                                 mesh_dim_names=axes)
    # each axis answers before anything is sharded over it
    for name, n in zip(axes, shape):
        one = torch.ones(1, device=device)
        dist.all_reduce(one, group=mesh.get_group(name))
        if int(one.item()) != n:
            raise RuntimeError(f"mesh axis {name!r}: {int(one.item())} "
                               f"ranks answered, {n} expected")
    return mesh


class AbstractMesh:
    """A mesh of `shape` over the named `axes` with no process group
    behind it: `shape` maps each axis to its size (what
    `common.parallel.axis_sizes` and the sharding rules read), `size` is
    the number of ranks, `get_local_rank(axis)` the coordinate of the
    rank it stands for (`coords`, 0 by default) and `get_group` raises,
    so only a step on meta tensors under the cost mode runs over it."""

    def __init__(self, shape, axes, coords=None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} vs axes {axes}")
        self.shape = dict(zip(axes, shape))
        self.coords = dict(coords or {})
        bad = {a: c for a, c in self.coords.items()
               if a not in self.shape or not 0 <= c < self.shape[a]}
        if bad:
            raise ValueError(f"coords {bad} outside the mesh {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def name(self) -> str:
        """"16x16", "2x16x16": the sizes in axis order."""
        return "x".join(str(n) for n in self.shape.values())

    def get_local_rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def get_group(self, axis: str):
        raise RuntimeError(
            f"an AbstractMesh {self.shape} has no process group for "
            f"{axis!r}: only meta tensors under the cost mode run over it")

    def __repr__(self):
        return f"AbstractMesh({self.shape}, coords={self.coords})"


def production_mesh(*, multi_pod: bool = False,
                    mesh: str | None = None) -> AbstractMesh:
    """The reference's production mesh as an `AbstractMesh`: (16, 16)
    ("data", "model"), or (2, 16, 16) with a leading "pod" axis; `mesh`
    "DxM" gives a (D, M) ("data", "model") mesh instead (the
    reference's `--mesh`)."""
    if mesh:
        d, m = (int(x) for x in mesh.split("x"))
        return AbstractMesh((d, m), ("data", "model"))
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         backend: Optional[str] = None,
                         timeout_s: float = TIMEOUT_S):
    """The reference's production mesh, (16, 16) ("data", "model") or
    (2, 16, 16) with a leading "pod" axis, over an initialised process
    group of exactly that many ranks (raises otherwise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError(
            f"the production mesh {shape} needs {math.prod(shape)} ranks: "
            "initialise their process group first (launch.mesh.init_ranks)")
    device = resolve_device(device)
    return _make_mesh(shape, axes, device, _backend(device, backend),
                      timeout_s)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"), *, device=None,
                    backend: Optional[str] = None,
                    timeout_s: float = TIMEOUT_S):
    """A small mesh over the ranks of the initialised process group. With
    no group initialised, a (1, 1) mesh initialises a one-rank group
    itself (an in-process store); any other shape raises."""
    device = resolve_device(device)
    backend = _backend(device, backend)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks: "
                "initialise their process group first "
                "(launch.mesh.init_ranks or run_ranks)")
        _bind(device, 0)
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s))
    return _make_mesh(shape, axes, device, backend, timeout_s)


def ctx_for_mesh(mesh, *, fsdp: bool = True, remat: str = "block",
                 shard_seq_moe: bool = True) -> ParallelCtx:
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    return ParallelCtx(
        mesh=mesh,
        dp_axes=dp,
        fsdp_axis="data" if (fsdp and "data" in sizes
                             and sizes["data"] > 1) else None,
        tp_axis="model" if "model" in sizes else None,
        shard_seq_moe=shard_seq_moe,
        remat=remat,
    )


def close_ranks() -> None:
    """Leave the default process group (and every mesh over it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------- ranks on this host
def _rank_main(rank, world, init_method, fn, args, results, device,
               backend, timeout_s, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_ranks(rank, world, init_method, device=device,
                   backend=backend, timeout_s=timeout_s)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:                  # noqa: BLE001 - reported
        results.put((rank, False, traceback.format_exc()))
    finally:
        close_ranks()


def run_ranks(fn: Callable, world: int, args: tuple = (), *, device=None,
              backend: Optional[str] = None,
              timeout_s: float = TIMEOUT_S, wall_s: float = 900.0,
              threads: int = 0) -> list:
    """Run `fn(rank, world, *args)` in `world` spawned processes joined in
    one process group (a "file://" rendezvous in a fresh temporary
    directory, the given backend, collective timeout `timeout_s`).
    `fn` must be importable by name (a module-level function). Returns
    the ranks' results in rank order; raises with every failing rank's
    traceback, or when the ranks are not done within `wall_s` (all are
    then terminated). `threads` > 0 caps each rank's intra-op threads."""
    if device is not None:
        device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    store = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, world, f"file://{os.path.join(store, 'rendezvous')}", fn,
              args, results, device, backend, timeout_s, threads),
        daemon=False) for r in range(world)]
    got: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + wall_s
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" not done within {wall_s:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank processes exited without a result: "
                        f"{[(p.name, p.exitcode) for p in dead]}")
                continue
            got[rank] = (ok, out)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(store, ignore_errors=True)
    errors = [f"rank {r}:\n{out}" for r, (ok, out) in sorted(got.items())
              if not ok]
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(errors))
    return [got[r][1] for r in range(world)]
