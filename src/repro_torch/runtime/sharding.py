"""Logical-axis -> mesh-axis sharding rules (port of
`repro.runtime.sharding`).

Every parameter carries logical axis names (`models.module.Initializer`
records them beside the values). Rules map each logical axis to an
ordered list of candidate mesh axes; resolution is greedy per tensor: a
candidate is taken iff the dim is divisible by the mesh axis size and
the mesh axis is not already used by an earlier dim. Non-divisible dims
fall back to replication (e.g. kv_heads=8 on a 16-way model axis — the
Megatron GQA duplication), and qwen's 40 heads fall through to
replication too, since head_dim is never sharded.

The resolved specs (`P`, a tuple of one mesh axis, a tuple of axes or
None per dim, as jax's `PartitionSpec`) say which slice of each global
tensor a rank holds: `shard_tree` cuts a global tree into the rank's
local tensors and `unshard_tree` gathers them back, in place of the
reference's `NamedSharding`s (`shardings_for_tree`, `named`). The spec
functions read only the mesh's axis sizes, so a stand-in object whose
`shape` maps axis names to sizes resolves a production mesh's specs in
one process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common.parallel import (
    ParallelCtx,
    all_gather,
    axis_sizes,
    local_slice,
)


def _entry(e):
    if isinstance(e, tuple) and len(e) <= 1:
        return e[0] if e else None
    return e


class P(tuple):
    """A partition spec: per tensor dim, a mesh axis name, a tuple of
    names (split over their row-major product) or None (replicated). A
    one-name tuple is that name and an empty one None, as jax's
    `PartitionSpec` spells them."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """mapping: logical axis -> tuple of candidate mesh axes (in order)."""

    mapping: dict

    @staticmethod
    def for_training(fsdp_axis: Optional[str] = "data",
                     tp_axis: Optional[str] = "model"):
        tp = (tp_axis,) if tp_axis else ()
        fsdp = (fsdp_axis,) if fsdp_axis else ()
        return ShardingRules(
            mapping={
                "layers": (),
                "embed": fsdp,
                "vocab": tp,
                "qheads": tp,
                "kvheads": tp,
                # head_dim is deliberately NOT sharded: a contraction over
                # a sharded head_dim sums the score matrix across ranks
                # inside the attention loop; archs whose head counts do
                # not divide the model axis replicate attention instead
                "head_dim": (),
                "ff": tp,
                "experts": tp,
                "moe_ff": fsdp,
                "ssm_inner": tp,
                "ssm_heads": (),
            }
        )

    @staticmethod
    def for_serving(data_axis: Optional[str] = "data",
                    tp_axis: Optional[str] = "model"):
        """Weight-stationary serving: no FSDP weight gathers on the decode
        path. Dense projections are TP-sharded or replicated; only the
        MoE expert tensors keep a second shard axis."""
        tp = (tp_axis,) if tp_axis else ()
        d = (data_axis,) if data_axis else ()
        return ShardingRules(
            mapping={
                "layers": (),
                "embed": (),
                "vocab": tp,
                "qheads": tp,
                "kvheads": tp,
                "head_dim": (),
                "ff": tp,
                "experts": tp,
                "moe_ff": d,
                "ssm_inner": tp,
                "ssm_heads": (),
            }
        )

    @staticmethod
    def replicated():
        return ShardingRules(mapping={})


def _resolve(axes, shape, rules: ShardingRules, mesh) -> P:
    """The spec of one tensor of `shape` whose dims carry the logical
    names `axes`."""
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for dim, logical in zip(shape, axes):
        chosen = None
        if logical is not None:
            for cand in rules.mapping.get(logical, ()):
                if cand is None or cand in used or cand not in sizes:
                    continue
                if dim % sizes[cand] != 0:
                    continue
                chosen = cand
                break
        out.append(chosen)
        if chosen is not None:
            used.add(chosen)
    return P(*out)


def _map2(fn, values, other):
    if isinstance(values, dict):
        return {k: _map2(fn, values[k], other[k]) for k in values}
    return fn(values, other)


def pspecs_for_tree(values, axes_tree, rules: ShardingRules, mesh):
    """The spec of every leaf of a (params | moments) tree, from the
    matching tree of logical-axis tuples."""
    return _map2(lambda v, a: _resolve(a, v.shape, rules, mesh), values,
                 axes_tree)


def _dp(dp_axes, mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in dp_axes:
        n *= sizes[a]
    return n


def batch_pspec(batch, dp_axes, mesh) -> dict:
    """Shard dim0 (global batch) over dp axes when divisible."""
    dp_size = _dp(dp_axes, mesh)

    def one(x):
        if x.shape and x.shape[0] % dp_size == 0 and dp_size > 1:
            return P(dp_axes)
        return P()

    return {k: one(v) for k, v in batch.items()}


def _map_named(fn, caches):
    return {pos: {name: fn(name, x) for name, x in c.items()}
            for pos, c in caches.items()}


def cache_pspec(caches, dp_axes, tp_axis, mesh):
    """Decode-cache sharding: batch over dp when divisible; the long seq
    dim of attention KV over the model axis (sequence-sharded KV); SSM
    heads over model. Leaf layout (see blocks.init_caches):
      k/v/cross_k/cross_v: (nb, B, S, KV, hd)
      state:               (nb, B, H, P, N)
      tail_*:              (nb, B, W-1, C)
    """
    dp_size = _dp(dp_axes, mesh)
    tp = axis_sizes(mesh).get(tp_axis, 1) if tp_axis else 1

    def one(name, x):
        b_ax = dp_axes if (x.shape[1] % dp_size == 0 and dp_size > 1) \
            else None
        if name in ("k", "v", "cross_k", "cross_v"):
            s_ax = tp_axis if (tp > 1 and x.shape[2] % tp == 0) else None
            return P(None, b_ax, s_ax, None, None)
        if name == "state":
            h_ax = tp_axis if (tp > 1 and x.shape[2] % tp == 0) else None
            return P(None, b_ax, h_ax, None, None)
        # conv tails: (nb, B, W-1, C): channel over model if divisible
        c_ax = tp_axis if (tp > 1 and x.shape[3] % tp == 0) else None
        return P(None, b_ax, None, c_ax)

    return _map_named(one, caches)


def paged_cache_pspec(caches, dp_axes, tp_axis, mesh):
    """Paged-layout cache sharding (see blocks.init_paged_caches):

      k/v:        (nb, P_phys, page_tokens, KV, hd) — KV heads over the
                  model (tp) axis when divisible. The physical page axis
                  is gathered through the block table, so it stays
                  unsharded: every data rank holds the whole pool of its
                  heads.
      k_sz/v_sz:  (nb, P_phys, KV, 2) per-page, or (nb, P_phys,
                  page_tokens, KV, 2) per-token — the int8 (scale, zero)
                  leaves split on the SAME head axis as the payload:
                  each tp shard dequantizes, and requantizes its tail
                  pages for, exactly its own heads.
      resident leaves (dense per-slot axis 1): slots over dp when
                  divisible — state (nb, B, H, P, N) also takes heads
                  over tp, conv tails (nb, B, W-1, C) channel over tp,
                  cross_k/v (nb, B, enc, KV, hd) heads over tp.

    The (n_slots, n_pages) block tables are replicated: every shard
    resolves the same logical->physical mapping and gathers its own head
    slice."""
    dp_size = _dp(dp_axes, mesh)
    tp = axis_sizes(mesh).get(tp_axis, 1) if tp_axis else 1

    def tp_ax(dim):
        return tp_axis if (tp > 1 and dim % tp == 0) else None

    def one(name, x):
        if name in ("k", "v"):
            return P(None, None, None, tp_ax(x.shape[3]), None)
        if name in ("k_sz", "v_sz"):
            if x.ndim == 5:                    # per-token sub-scales
                return P(None, None, None, tp_ax(x.shape[3]), None)
            return P(None, None, tp_ax(x.shape[2]), None)
        b_ax = dp_axes if (x.shape[1] % dp_size == 0 and dp_size > 1) \
            else None
        if name in ("cross_k", "cross_v"):
            return P(None, b_ax, None, tp_ax(x.shape[3]), None)
        if name == "state":
            return P(None, b_ax, tp_ax(x.shape[2]), None, None)
        # conv tails: (nb, B, W-1, C)
        return P(None, b_ax, None, tp_ax(x.shape[3]))

    return _map_named(one, caches)


# ------------------------------------------------- local shards
def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of a rank's shard of a global `shape` under `spec`."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes[a]
    return tuple(out)


def shard_tree(values, pspecs, mesh):
    """This rank's local shard of every leaf of a global tree: each dim
    with a mesh axis in its spec keeps the rank's block along it (a copy,
    so the global leaf can be freed); a replicated leaf is kept as it is."""
    ctx = ParallelCtx(mesh=mesh)

    def one(x, spec):
        local = x
        for d, entry in enumerate(spec):
            if entry is not None:
                local = local_slice(local, ctx, entry, d)
        if local is not x:
            local = local.clone()
        return local

    return _map2(one, values, pspecs)


def zeros_for_shards(values, pspecs, mesh, device):
    """Zeroed local shards of a global (meta) tree: each leaf of its
    rank's shape (`local_shape`) and the leaf's dtype, on `device`."""
    return _map2(lambda x, spec: torch.zeros(
        local_shape(x.shape, spec, mesh), dtype=x.dtype, device=device),
        values, pspecs)


def unshard_tree(local, pspecs, mesh):
    """The global tree from every rank's shards (a collective: every rank
    of the mesh calls it): each sharded dim gathered over its axes."""
    ctx = ParallelCtx(mesh=mesh)

    def one(x, spec):
        for d, entry in enumerate(spec):
            if entry is not None:
                x = all_gather(x, ctx, entry, d)
        return x

    return _map2(one, local, pspecs)


def tree_nbytes_scale(pspecs, mesh) -> dict:
    """Per leaf, how many local shards make up the global tensor (the
    product of the sizes of the axes its spec names)."""
    sizes = axis_sizes(mesh)

    def one(spec, _):
        n = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= sizes[a]
        return n

    return _map2(one, pspecs, pspecs)
