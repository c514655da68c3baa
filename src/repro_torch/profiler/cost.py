"""Cost model of one eager step, counted on meta tensors (the port's
counterpart of `repro.profiler.hlo`, renamed: there is no HLO to parse).

`analyze_step(fn, *args)` runs `fn` on meta tensors under a
`TorchDispatchMode` that sees every aten op the step dispatches, and
derives the roofline's inputs from them:

  * flops     — products at 2·M·N·K (`torch.utils.flop_counter`'s
                registry: mm, bmm, addmm, baddbmm, convolution, SDPA);
                the other ops count operations per output element as the
                reference approximates the ops outside its dots (4 for a
                transcendental or a divide, 1 for an add, a select or a
                reduce's output)
  * hbm_bytes — each eager op reads its inputs and writes its outputs
                once: that is eager PyTorch's real traffic (no fusion), so
                `hbm_bytes == hbm_bytes_raw` except for kernel units.
                Views move nothing; an in-place scatter moves its values
                twice, not the tensor it lands in
  * wire      — the bytes each collective of the traced rank puts on
                the wire under the reference's ring model (`repro.
                profiler.hlo`: all-gather out (n-1)/n, all-reduce 2 in
                (n-1)/n, reduce-scatter and all-to-all in (n-1)/n), by
                kind in `collective_by_kind`: over a `launch.mesh.
                AbstractMesh` a collective of `common.parallel` on a meta
                tensor records itself and issues nothing. 0 on one card

A hand-written kernel's op is ONE unit (`kernels.costed`): on a meta
tensor it returns empty outputs of the right shapes and records the
kernel's flops and bytes from the `cost(...)` formula of its `ops.py`,
the same formula the kernels table's bound is computed from. Its plain
version is not traced: the chunked plain attention at prefill_32k would
take tens of thousands of Python block steps and bill its S×S scores as
memory traffic, as the reference leaves the bytes inside a Pallas
kernel's VMEM scope out (`hlo.VMEM_SCOPE_RE`). `hbm_bytes_raw` counts a
unit's boundary tensors instead.

`temp_bytes` is the peak of the bytes of live intermediates (a storage is
freed when its last reference dies), the stand-in for the reference's
`memory_analysis().temp_size_in_bytes`. Nothing here allocates: meta
tensors have shapes and dtypes only.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

aten = torch.ops.aten

# ops that move no bytes and do no work: allocation without a fill, and
# aliases the schema does not mark as views
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.lift_fresh.default,
    aten.detach.default, aten.alias.default, aten._unsafe_view.default,
}
# operations per output element of the ops outside the products, the
# reference's approximation (`repro.profiler.hlo`: 4 for a transcendental
# or a divide, 1 for an add, a compare or a select, 1 per output element
# of a reduce; other elementwise and shape ops are free), with the fused
# ops PyTorch dispatches whole counted as their parts
_OPS_PER_ELEM = {
    **dict.fromkeys(("exp", "exp2", "log", "log2", "log1p", "rsqrt", "sqrt",
                     "tanh", "pow", "div", "sigmoid", "expm1", "erf",
                     "reciprocal", "cos", "sin"), 4),
    **dict.fromkeys(("add", "sub", "rsub", "mul", "neg", "abs", "maximum",
                     "minimum", "eq", "ne", "lt", "le", "gt", "ge", "where",
                     "clamp", "clamp_min", "clamp_max", "logical_and",
                     "logical_or", "logical_xor", "logical_not",
                     "bitwise_and", "bitwise_or", "bitwise_xor", "relu",
                     "sign", "floor", "ceil", "round", "remainder",
                     "fmod", "masked_fill"), 1),
    "silu": 5,            # logistic, multiply
    "softplus": 9,        # exp, log1p, add, compare, select
    "gelu": 12,           # tanh form: 3 multiplies, power, add, tanh, ...
    "_softmax": 10,       # max, subtract, exp, sum, divide
    "_log_softmax": 11,   # max, subtract, exp, sum, log, subtract
    "addcmul": 2, "addcdiv": 5, "lerp": 3,
}
# reductions (one operation per output element, as the reference's reduce)
_REDUCES = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
            "prod", "any", "all", "norm", "linalg_vector_norm", "var",
            "var_mean", "std", "logsumexp", "cumsum", "sort", "topk"}
# in-place scatters: the values are read and written, the destination
# tensor is not swept
_SCATTERS = {
    "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
    "scatter_reduce_", "index_copy_", "index_add_", "masked_scatter_",
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor spans once: its elements, a broadcast (stride 0)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class CostModel:
    """`HloCostModel`'s fields, plus what the dispatch mode saw: the
    argument, output and peak intermediate bytes, the kernel units by
    name and the number of ops dispatched."""

    flops: float
    hbm_bytes: float           # eager traffic, kernel units by formula
    hbm_bytes_raw: float       # eager traffic, units by boundary tensors
    wire_bytes: float
    collective_by_kind: dict
    warnings: list
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    units: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    # (kind, input shape, mesh axis) of each collective, in issue order
    collectives: list = dataclasses.field(default_factory=list)
    collective_counts: dict = dataclasses.field(default_factory=dict)

    def scaled(self, f: float) -> "CostModel":
        """Flops and bytes times `f` (memory and counts unchanged)."""
        return dataclasses.replace(
            self, flops=self.flops * f, hbm_bytes=self.hbm_bytes * f,
            hbm_bytes_raw=self.hbm_bytes_raw * f,
            wire_bytes=self.wire_bytes * f,
            collective_by_kind={k: v * f for k, v in
                                self.collective_by_kind.items()},
            warnings=list(self.warnings))


def _scope(depth: int) -> str:
    """The hotspot group of the op being dispatched: the port's model
    functions on the Python stack, outermost first ("blocks.stack_apply/
    blocks._apply_layer_train/attention.self_attention"), else its other
    functions (the optimizer, the train step); a backward op is grouped
    by its autograd node."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return "(backward)/" + node.name()
    models, other = [], []
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and \
                not mod.startswith("repro_torch.profiler"):
            name = f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}"
            (models if mod.startswith("repro_torch.models.")
             else other).append(name)
        f = f.f_back
    parts = list(reversed(models or other))
    return "/".join(parts[:depth]) if parts else "(unscoped)"


class CostMode(TorchDispatchMode):
    """Counts flops, bytes, kernel units and live intermediate bytes of
    every op dispatched while it is active. With `depth`, each op's cost
    is also grouped by `_scope(depth)` in `groups`."""

    def __init__(self, depth: Optional[int] = None):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0      # the registry's products alone
        self.fused = 0.0
        self.raw = 0.0
        self.n_ops = 0
        self.units: collections.Counter = collections.Counter()
        self.depth = depth
        self.wire = 0.0
        self.by_kind: collections.Counter = collections.Counter()
        self.collectives: list = []
        self.groups: dict = collections.defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0, "count": 0})
        self._keep: set = set()       # storages of the arguments
        self._live: dict = {}         # storage id -> (storage, bytes)
        self._live_bytes = 0
        self.peak = 0

    # ------------------------------------------------------ bookkeeping
    def hold(self, tensors) -> None:
        """Storages that exist before the step (its arguments): not
        intermediates."""
        for t in tensors:
            self._keep.add(t.untyped_storage()._cdata)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._keep or key in self._live:
                continue
            self._live[key] = (st, st.nbytes())
            self._live_bytes += st.nbytes()
        if self._live_bytes > self.peak:
            # drop what died since (only this dict holds it), then raise
            # the peak on what is really live
            for key in [k for k, (st, _) in self._live.items()
                        if torch._C._storage_Use_Count(st._cdata) <= 1]:
                self._live_bytes -= self._live.pop(key)[1]
            self.peak = max(self.peak, self._live_bytes)

    def _add(self, flops: float, fused: float, raw: float) -> None:
        self.flops += flops
        self.fused += fused
        self.raw += raw
        if self.depth is not None:
            g = self.groups[_scope(self.depth)]
            g["flops"] += flops
            g["bytes"] += fused
            g["count"] += 1

    # ------------------------------------------------------------ units
    def unit(self, name: str, flops: float, nbytes: float, inputs,
             outputs) -> None:
        """One kernel unit (`kernels.record_unit`)."""
        raw = sum(tensor_bytes(t) for t in inputs if t is not None) + sum(
            tensor_bytes(t) for t in outputs)
        self.units[name] += 1
        self._add(float(flops), float(nbytes), float(raw))

    def collective(self, kind: str, wire: float, shape, axis) -> None:
        """One collective (`kernels.record_collective`): its wire bytes,
        by kind, and (kind, input shape, axis) in issue order."""
        self.wire += float(wire)
        self.by_kind[kind] += float(wire)
        self.collectives.append((kind, tuple(shape), axis))

    # ------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        if func in _FREE:
            self._track(_tensors(out))
            return out
        rets = func._schema.returns
        alias = rets[0].alias_info if rets else None
        if alias is not None and not alias.is_write:
            return out                     # a view: no bytes, no work
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if alias is not None:              # in place: the output is an input
            written = {id(t) for t in outs}
            others = [t for t in ins if id(t) not in written]
            if func._schema.name.split("::")[-1] in _SCATTERS:
                # the values are read and written, the indices read
                moved = sum(tensor_bytes(t) for t in others) + sum(
                    tensor_bytes(t) for t in others if t.dtype not in
                    (torch.int64, torch.int32, torch.bool))
            else:
                moved = sum(tensor_bytes(t) for t in others) + 2 * sum(
                    tensor_bytes(t) for t in outs)
        else:
            moved = sum(tensor_bytes(t) for t in ins) + sum(
                tensor_bytes(t) for t in outs)
            self._track(outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.product_flops += flops
        else:
            base = packet.__name__.rstrip("_")
            per = _OPS_PER_ELEM.get(base, 1 if base in _REDUCES else 0)
            flops = per * sum(t.numel() for t in outs)
        self._add(float(flops), float(moved), float(moved))
        return out


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def run_counted(fn: Callable, *args, depth: Optional[int] = None,
                **kwargs):
    """`fn(*args, **kwargs)` under a `CostMode` with the kernel units on.
    Returns (fn's result, the mode)."""
    if kernels._COST_SINK is not None:
        raise RuntimeError("the cost mode is already counting")
    mode = CostMode(depth)
    mode.hold(_tensors((args, kwargs)))
    kernels._COST_SINK = mode
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        kernels._COST_SINK = None
    return out, mode


def analyze_step(fn: Callable, *args, **kwargs) -> CostModel:
    """The cost of one call of `fn` on meta tensors (`args` and every
    tensor `fn` makes live on the meta device)."""
    out, mode = run_counted(fn, *args, **kwargs)
    return CostModel(
        flops=mode.flops, hbm_bytes=mode.fused, hbm_bytes_raw=mode.raw,
        wire_bytes=mode.wire, collective_by_kind=dict(mode.by_kind),
        warnings=[], collectives=list(mode.collectives),
        collective_counts=dict(collections.Counter(
            k for k, _, _ in mode.collectives)),
        argument_bytes=_unique_bytes(_tensors((args, kwargs))),
        output_bytes=_unique_bytes(_tensors(out)),
        temp_bytes=mode.peak, units=dict(mode.units), n_ops=mode.n_ops)
