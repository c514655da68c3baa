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

Training runs through them with autograd. Without grad (serving) each is
the plain call, `psum` in place. With grad each is a
`torch.autograd.Function` whose backward is the transpose under the
convention of Megatron's tensor parallelism: over the tp axis the ranks
hold the same rows and compute the same loss, so a value used alike on
every rank has the same cotangent on every rank; over the dp axes the
ranks hold different rows and the step sums their gradients
(`runtime.train`). Hence:

* `psum` of partial sums: backward the identity over the tp axis and a
  sum over the dp axes it reduced (every rank's loss reads the sum);
* `enter_region` (identity forward) where a replicated value enters
  rank-specific work (a split head or ff dim, the rank's own tokens):
  backward the sum of the ranks' partial cotangents;
* `all_gather`: backward the rank's own block of the cotangent, or with
  `reduce_grad` (the gathered value is used by ranks of different rows
  or tokens: FSDP, the MoE router) the sum over the ranks first, a
  reduce-scatter;
* `all_to_all`: backward the inverse exchange, which is the same call;
* `count_once` (identity forward) where every rank of an axis computes
  the same value from the same inputs, and those inputs entered the
  region: backward the cotangent divided by the axis size, so that the
  ranks' gradients, summed over the axis, count the work once;
* `local_slice` is a view, whose backward is zeros around the cotangent.

`torch.distributed.nn.functional.all_reduce` is not used: its backward
sums the cotangent again, which multiplies a replicated downstream's
gradient by the axis size.

On a meta tensor under the cost mode (`kernels.costed`: the dry-run
traces one rank's step over a `launch.mesh.AbstractMesh`) a collective
over an axis of n > 1 ranks issues nothing: it returns a meta result of
the right shape and records its kind and wire bytes under the
reference's ring model (`repro.profiler.hlo`): all-gather out (n-1)/n,
all-reduce 2 in (n-1)/n, reduce-scatter and all-to-all in (n-1)/n. A
real tensor over an `AbstractMesh` raises (it has no process groups).
`log_collectives` records (kind, input shape, axis) of each collective
either path issues.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import kernels


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


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


_LOG: Optional[list] = None


@contextlib.contextmanager
def log_collectives():
    """Yield a list that gets (kind, input shape, axis) of every
    collective issued over an axis of size > 1 while the block runs, in
    issue order: "all-reduce", "all-gather", "all-to-all" or
    "reduce-scatter", the shape of the tensor handed to it."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


def _issue(kind: str, x: torch.Tensor, axis: str, n: int) -> bool:
    """Log one collective of `x` over `axis` (n ranks); under the cost
    mode record its wire bytes (ring model, module docstring) and return
    True: the caller then issues nothing and returns a meta result."""
    if _LOG is not None:
        _LOG.append((kind, tuple(x.shape), axis))
    if not kernels.costed(x):
        return False
    nbytes = x.numel() * x.element_size()
    wire = (2 * nbytes if kind == "all-reduce" else
            n * nbytes if kind == "all-gather" else nbytes) * (n - 1) / n
    kernels.record_collective(kind, wire, tuple(x.shape), axis)
    return True


def _all_reduce_(x: torch.Tensor, ctx: ParallelCtx, axes) -> torch.Tensor:
    for a in _axes(axes):
        n = ctx.axis_size(a)
        if n > 1 and not _issue("all-reduce", x, a, n):
            dist.all_reduce(x, group=ctx.mesh.get_group(a))
    return x


def _live(ctx: ParallelCtx, axes) -> bool:
    return any(ctx.axis_size(a) > 1 for a in _axes(axes))


def _gather(x: torch.Tensor, ctx: ParallelCtx, axes, dim: int):
    for a in reversed(_axes(axes)):
        n = ctx.axis_size(a)
        if n > 1:
            x = x.contiguous()
            if _issue("all-gather", x, a, n):
                x = torch.cat([x] * n, dim=dim)
                continue
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=ctx.mesh.get_group(a))
            x = torch.cat(parts, dim=dim)
    return x


def _block(x: torch.Tensor, ctx: ParallelCtx, axes, dim: int):
    n = math.prod(ctx.axis_size(a) for a in _axes(axes))
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, ctx.index(_axes(axes)) * size, size)


def _exchange(x: torch.Tensor, ctx: ParallelCtx, axis: str,
              kind: str = "all-to-all"):
    x = x.contiguous()          # a cotangent may come strided
    out = torch.empty_like(x)
    if not _issue(kind, x, axis, ctx.axis_size(axis)):
        dist.all_to_all_single(out, x, group=ctx.mesh.get_group(axis))
    return out


def _reduce_scatter(x: torch.Tensor, ctx: ParallelCtx, axes, dim: int):
    """The sum of `x` over the ranks of `axes`, this rank's block of it
    along `dim` (row-major over several axes): per axis one exchange
    (block j to rank j) and a local sum of the blocks received, half the
    bytes of an all-reduce."""
    for a in _axes(axes):
        n = ctx.axis_size(a)
        if n == 1:
            continue
        y = x.movedim(dim, 0)
        y = _exchange(y.reshape((n, y.shape[0] // n) + tuple(y.shape[1:])),
                      ctx, a, "reduce-scatter")
        x = y.sum(0).movedim(0, dim)
    return x


class _Reduce(torch.autograd.Function):
    """Forward the sum over `fwd` axes, backward the sum over `bwd`."""

    @staticmethod
    def forward(fctx, x, ctx, fwd, bwd):
        fctx.pctx, fctx.bwd = ctx, bwd
        return _all_reduce_(x.clone(), ctx, fwd) if _live(ctx, fwd) else x

    @staticmethod
    def backward(fctx, g):
        if _live(fctx.pctx, fctx.bwd):
            g = _all_reduce_(g.clone(), fctx.pctx, fctx.bwd)
        return g, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim, reduce_grad):
        fctx.pctx, fctx.axes, fctx.dim = ctx, axes, dim
        fctx.reduce_grad = reduce_grad
        return _gather(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        if fctx.reduce_grad:
            g = _reduce_scatter(g, fctx.pctx, fctx.axes, fctx.dim)
        else:
            g = _block(g, fctx.pctx, fctx.axes, fctx.dim)
        return g.contiguous(), None, None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis):
        fctx.pctx, fctx.axis = ctx, axis
        return _exchange(x, ctx, axis)

    @staticmethod
    def backward(fctx, g):
        return _exchange(g, fctx.pctx, fctx.axis), None, None


def psum(x: torch.Tensor, ctx: ParallelCtx, axes) -> torch.Tensor:
    """Sum of `x` over the ranks of `axes` (one name or several); the
    identity over size-1 axes or without a mesh. Without grad it sums in
    place and returns `x`; with grad it returns a new tensor, and its
    backward sums the cotangent over those of `axes` that are dp axes
    (module docstring)."""
    if not _grad_path(x):
        return _all_reduce_(x, ctx, axes)
    bwd = tuple(a for a in _axes(axes) if a in ctx.dp_axes)
    return _Reduce.apply(x, ctx, _axes(axes), bwd)


def enter_region(x: torch.Tensor, ctx: ParallelCtx, axes) -> torch.Tensor:
    """The identity; with grad, its backward sums the cotangent over
    `axes`: `x` is replicated over them and the ranks use it for
    different work (their own heads, ff columns or tokens)."""
    if not _grad_path(x) or not _live(ctx, axes):
        return x
    return _Reduce.apply(x, ctx, (), _axes(axes))


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, n):
        fctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return g / fctx.n, None


def count_once(x: torch.Tensor, ctx: ParallelCtx, axes) -> torch.Tensor:
    """The identity; with grad, its backward divides the cotangent by the
    size of `axes`: every rank of them computed `x` alike (replicated
    work on replicated inputs that entered the region), and each rank's
    cotangent is the whole one."""
    n = math.prod(ctx.axis_size(a) for a in _axes(axes))
    if not _grad_path(x) or n == 1:
        return x
    return _CountOnce.apply(x, n)


def all_gather(x: torch.Tensor, ctx: ParallelCtx, axes, dim: int, *,
               reduce_grad: bool = False) -> torch.Tensor:
    """The ranks' `x` along `axes` concatenated on `dim` in rank order
    (row-major over several axes, as `index` counts them). With grad the
    backward is the rank's block of the cotangent, summed over the ranks
    first when `reduce_grad` (a reduce-scatter)."""
    if not _grad_path(x) or not _live(ctx, axes):
        return _gather(x, ctx, axes, dim)
    return _Gather.apply(x, ctx, _axes(axes), dim, reduce_grad)


def gather_param(w: torch.Tensor, ctx: ParallelCtx, dim: int,
                 full: int) -> torch.Tensor:
    """A weight whose dim `dim` (`full` long whole) the training rules
    split over the fsdp axis, gathered whole before use (FSDP); its
    backward reduce-scatters the gradient over that axis. A whole dim is
    returned as it is."""
    if w.shape[dim] == full:
        return w
    out = all_gather(w, ctx, ctx.fsdp_axis, dim, reduce_grad=True)
    if out.shape[dim] != full:
        raise ValueError(
            f"a weight of shape {tuple(w.shape)} holds {w.shape[dim]} of "
            f"{full} on dim {dim}; gathered over the fsdp axis "
            f"{ctx.fsdp_axis!r} it holds {out.shape[dim]}")
    return out


def all_to_all(x: torch.Tensor, ctx: ParallelCtx, axis: str) -> torch.Tensor:
    """x (n, ...) with n the axis size: block i goes to the axis's rank i,
    and block j of the result came from rank j (`jax.lax.all_to_all` with
    split_axis = concat_axis = 0). Its own transpose, so its backward is
    the same exchange of the cotangent."""
    if ctx.axis_size(axis) == 1:
        return x
    if _grad_path(x):
        return _Exchange.apply(x, ctx, axis)
    return _exchange(x, ctx, axis)


def local_slice(x: torch.Tensor, ctx: ParallelCtx, axes,
                dim: int) -> torch.Tensor:
    """This rank's block of `x` along `dim`, split evenly over `axes` (a
    view: its backward is zeros around the cotangent's block)."""
    return _block(x, ctx, axes, dim)
