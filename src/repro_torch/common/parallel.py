"""Parallel context threaded through the model's apply functions (port of
`repro.common.parallel`).

The reference carries a jax mesh and lets XLA partition every einsum,
with `shard_map` bodies where it wants explicit collectives (attention,
MoE expert parallelism). The port runs SPMD with LOCAL shards: one
process per rank of a `torch.distributed.device_mesh.DeviceMesh`, every
parameter and cache a plain tensor holding the rank's slice
(`runtime.sharding.shard_tree`), and each layer issuing its collectives
itself over the process group of a mesh axis (`mesh.get_group(name)`).
The collectives below are those calls; over an axis of size 1 they are
the identity and issue nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or of any object whose
    `shape` is already that mapping (a stand-in for a mesh of more ranks
    than the process has, as the reference's sharding rules only read
    `mesh.shape`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[object] = None       # DeviceMesh (None: one device)
    dp_axes: tuple[str, ...] = ()       # batch axes, e.g. ("pod","data")
    fsdp_axis: Optional[str] = None     # param-shard axis (usually "data")
    tp_axis: Optional[str] = None       # tensor/expert-parallel axis ("model")
    shard_seq_moe: bool = True          # reshard seq over tp inside MoE
    remat: str = "block"                # none | block
    moe_fsdp_mode: str = "rowcol"       # rowcol | gather (see models/moe.py)

    @property
    def all_axes(self) -> tuple[str, ...]:
        return (tuple(axis_sizes(self.mesh)) if self.mesh is not None
                else ())

    def axis_size(self, name: Optional[str]) -> int:
        if self.mesh is None or name is None:
            return 1
        return axis_sizes(self.mesh)[name]

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.axis_size(a)
        return n

    def batch_spec(self):
        from repro_torch.runtime.sharding import P

        return P(self.dp_axes if self.dp_axes else None)

    def constrain(self, x, spec):
        """The identity: the reference pins a global array's layout with a
        sharding constraint, while a local tensor here already is the
        rank's shard in the layout its producer gave it."""
        del spec
        return x

    # -------------------------------------------------------- the rank
    def index(self, axes) -> int:
        """This rank's index along one axis or, for a tuple of axes, along
        their row-major product (0 without a mesh)."""
        if self.mesh is None or axes is None:
            return 0
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + self.mesh.get_local_rank(a)
        return i

    def batch_rows(self, B: int) -> tuple[int, int]:
        """The [start, stop) rows of a global batch of B that this rank
        holds: its block over the dp axes when B divides by their size
        (the reference's `B % dp_size == 0` rule), else all of them."""
        if self.dp_size > 1 and B % self.dp_size == 0:
            n = B // self.dp_size
            r = self.index(self.dp_axes)
            return r * n, (r + 1) * n
        return 0, B

    def batch_split(self, B: int) -> bool:
        return self.batch_rows(B) != (0, B)


SINGLE = ParallelCtx()  # no mesh: pure single-device semantics


# ------------------------------------------------------------ collectives
def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def psum(x: torch.Tensor, ctx: ParallelCtx, axes) -> torch.Tensor:
    """Sum of `x` over the ranks of `axes` (one name or several), in
    place; the identity over size-1 axes or without a mesh."""
    for a in _axes(axes):
        if ctx.axis_size(a) > 1:
            dist.all_reduce(x, group=ctx.mesh.get_group(a))
    return x


def all_gather(x: torch.Tensor, ctx: ParallelCtx, axes,
               dim: int) -> torch.Tensor:
    """The ranks' `x` along `axes` concatenated on `dim` in rank order
    (row-major over several axes, as `index` counts them)."""
    for a in reversed(_axes(axes)):
        n = ctx.axis_size(a)
        if n > 1:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(),
                            group=ctx.mesh.get_group(a))
            x = torch.cat(parts, dim=dim)
    return x


def all_to_all(x: torch.Tensor, ctx: ParallelCtx, axis: str) -> torch.Tensor:
    """x (n, ...) with n the axis size: block i goes to the axis's rank i,
    and block j of the result came from rank j (`jax.lax.all_to_all` with
    split_axis = concat_axis = 0)."""
    if ctx.axis_size(axis) == 1:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(),
                           group=ctx.mesh.get_group(axis))
    return out


def local_slice(x: torch.Tensor, ctx: ParallelCtx, axes,
                dim: int) -> torch.Tensor:
    """This rank's block of `x` along `dim`, split evenly over `axes`."""
    n = math.prod(ctx.axis_size(a) for a in _axes(axes))
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, ctx.index(_axes(axes)) * size, size)
