"""Train-step builder (port of `repro.runtime.train`): microbatched
grad accumulation, global-norm clipping, AdamW and the warmup-cosine
schedule, over nested dicts of tensors, on one device or over a mesh.

The state is {"step": int32 scalar, "params": float32 master weights,
"opt": {"m", "v", "count"}}, the reference's tree. A step runs eagerly,
as every op of the port does: the master weights are cast to cfg.dtype
INSIDE the differentiated function, as the reference does, so the FSDP
gathers move compute-dtype tensors and the grads come back to the
float32 masters through the casts. Nothing is updated in place: a step
returns a new state, as the reference's jitted step does.

Over a mesh (`make_bundle(mesh=, rules=)`, the reference's FSDP + TP
layout under `ShardingRules.for_training`: every `embed` dim over the
fsdp axis, heads, ff, vocab and experts over the tp axis) one process
runs each rank: every state leaf is the rank's local shard under
`state_pspecs` (`runtime.sharding.shard_tree`), the batch is the rank's
rows (`rank_batch`), and each layer issues its own collectives
(`common.parallel`, autograd through them). Each rank differentiates the
mean loss over its own rows; the gradient of a leaf that no collective
reduced over a dp axis is summed over it, and every gradient divided by
the dp size, which gives the reference's gradient of the mean loss over
the global batch. The global norm sums each leaf's local sum of squares
over exactly the axes that split it, AdamW runs on the local shards, and
the metrics are averaged over the dp ranks. Every stack of the catalog
trains so: dense and MoE decoders, SSM and hybrid stacks (the SSM block
on the rank's block of `d_inner`, as virtual heads where it cuts a
head), the vision prefix (the rank's rows of `patches`)
and the encoder-decoder (the rank's rows of `frames` through the
encoder).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.parallel import SINGLE, ParallelCtx, axis_sizes, psum
from repro_torch.common.pytree import named_leaves
from repro_torch.models import model as M
from repro_torch.models.module import torch_dtype
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import sharding as shd

METRIC_KEYS = ("loss", "nll", "z_loss", "moe_aux", "accuracy")


def init_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device=None, seed: int = 0) -> dict:
    """Seeded float32 master weights (`models.model.init_model`: on the
    generator's device, else on `device`, the card by default), zero
    AdamW moments and step 0."""
    params = M.init_model(cfg, generator, device=device, seed=seed)
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "params": params,
        "opt": adamw.adamw_init(params),
    }


def abstract_train_state(cfg: ModelConfig) -> dict:
    """The state's tree on the meta device (shapes and dtypes, nothing
    allocated): what `core.access.train_profile` prices."""
    params = M.init_model(cfg, device="meta")
    zeros = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa
                                  device="meta")
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return {
        "step": scalar,
        "params": params,
        "opt": {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": scalar},
    }


def state_pspecs(state, axes, rules: shd.ShardingRules, mesh) -> dict:
    """The state's specs: the params' from `rules`, the moments the
    params', the step and count replicated (the reference's)."""
    p = shd.pspecs_for_tree(state["params"], axes, rules, mesh)
    return {"step": shd.P(), "params": p,
            "opt": {"m": p, "v": p, "count": shd.P()}}


def _microbatch(batch: dict, k: int) -> list:
    """The batch split into k microbatches along the leading axis."""
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def rank_batch(batch: dict, ctx: ParallelCtx, microbatches: int = 1):
    """This rank's rows of a global batch (numpy arrays or tensors) split
    over the ctx's dp axes, laid out so that its microbatch i is the
    rank's block of the global batch's microbatch i (the reference
    splits the global batch into microbatches and each over the dp
    axes): with one microbatch, the rank's block of rows."""
    dp, r = ctx.dp_size, ctx.index(ctx.dp_axes)
    if dp == 1:
        return batch
    k = microbatches

    def one(x):
        B = x.shape[0]
        if B % (k * dp):
            raise ValueError(f"a batch of {B} rows does not split into "
                             f"{k} microbatches over {dp} dp ranks")
        n = B // (k * dp)
        x = x.reshape((k, B // k) + tuple(x.shape[1:]))[:, r * n:(r + 1) * n]
        return x.reshape((k * n,) + tuple(x.shape[2:]))

    return {name: one(x) for name, x in batch.items()}


def batch_keys(cfg: ModelConfig) -> tuple:
    """The inputs of a train batch: the tokens, and the frontend's
    embeddings (`patches` for the vision prefix, `frames` for the
    encoder), every one with the rows on dim 0."""
    return ("tokens",) + {"vision_stub": ("patches",),
                          "audio_stub": ("frames",)}.get(cfg.frontend, ())


def _as_tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class _MeshReduce:
    """The dp reduction of the grads, the split-aware global norm and the
    dp mean of the metrics of one rank, from the params' specs."""

    def __init__(self, cfg: ModelConfig, ctx: ParallelCtx, rules):
        params, axes = M.init_model(cfg, device="meta", with_axes=True)
        specs = dict(named_leaves(shd.pspecs_for_tree(params, axes, rules,
                                                      ctx.mesh)))
        sizes = axis_sizes(ctx.mesh)
        ok = {a for a in (ctx.fsdp_axis, ctx.tp_axis) if a}
        self.split = {}
        for name, spec in specs.items():
            used = tuple(a for e in spec if e is not None
                         for a in ((e,) if isinstance(e, str) else e)
                         if sizes[a] > 1)
            bad = set(used) - ok
            if bad:
                raise ValueError(
                    f"{name}: the rules split it over {sorted(bad)}, which "
                    f"the context's fsdp / tp axes ({ctx.fsdp_axis!r}, "
                    f"{ctx.tp_axis!r}) do not name")
            self.split[name] = used
        self.ctx = ctx

    def _psum_groups(self, named: list) -> list:
        """[(name, tensor, axes)] -> the tensors each summed over its
        axes, one all-reduce per distinct axes (flattened together)."""
        out = [t for _, t, _ in named]
        groups: dict = {}
        for i, (_, _, axes) in enumerate(named):
            if any(self.ctx.axis_size(a) > 1 for a in axes):
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            psum(flat, self.ctx, axes)
            for i, part in zip(idx, flat.split([out[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(out[i])
        return out

    def grads(self, grads: dict) -> dict:
        """Each leaf summed over the dp axes no collective reduced it
        over, every leaf divided by the dp size."""
        dp = self.ctx.dp_size
        named = [(n, g, tuple(a for a in self.ctx.dp_axes
                              if a not in self.split[n]))
                 for n, g in named_leaves(grads)]
        summed = dict(zip((n for n, _, _ in named),
                          self._psum_groups(named)))
        if dp > 1:
            summed = {n: g / dp for n, g in summed.items()}
        return _by_name(grads, summed)

    def norm_sq(self, names: list):
        def reduce(sq: list) -> list:
            return self._psum_groups([(n, t, self.split[n])
                                      for n, t in zip(names, sq)])
        return reduce

    def metrics(self, metrics: dict) -> dict:
        """The per-rank means averaged over the dp ranks (equal rows, no
        mask: the global batch's means); `moe_aux` is global already."""
        dp = self.ctx.dp_size
        if dp == 1:
            return metrics
        keys = [k for k in METRIC_KEYS if k != "moe_aux"]
        v = torch.stack([metrics[k] for k in keys])
        psum(v, self.ctx, self.ctx.dp_axes)
        return dict(metrics, **{k: x / dp for k, x in zip(keys, v)})


def _by_name(tree, by_name: dict, prefix: str = ""):
    """`tree` with each leaf replaced by `by_name[its 'a/b/c' name]`."""
    if isinstance(tree, dict):
        return {k: _by_name(v, by_name,
                                  f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return by_name[prefix]


def build_train_step(cfg: ModelConfig, ctx, tcfg: Optional[TrainConfig]
                     = None, opt_cfg: Optional[adamw.AdamWConfig] = None,
                     *, rules=None) -> Callable:
    """step(state, batch) -> (new_state, metrics), the reference's
    `build_train_step(cfg, ctx, tcfg)`; `(cfg, tcfg[, opt_cfg])` builds
    the one-device step. The metrics are the loss's (averaged over
    microbatches and, over a mesh, over the dp ranks) plus `grad_norm`
    (before clipping) and `lr`, all float32 scalars on the state's
    device. Over a mesh (`ctx.mesh`) the state is the rank's shard under
    `state_pspecs(..., rules, mesh)` (`rules` default
    `for_training(ctx.fsdp_axis, ctx.tp_axis)`) and the batch its rows
    (`rank_batch`). The step carries `grads(params, batch) -> (metrics,
    grads)`: the reduced grads before clipping."""
    if isinstance(ctx, TrainConfig):           # (cfg, tcfg[, opt_cfg])
        ctx, tcfg, opt_cfg = SINGLE, ctx, tcfg
    opt_cfg = opt_cfg or adamw.AdamWConfig(weight_decay=tcfg.weight_decay)
    compute_dtype = torch_dtype(cfg.dtype)
    mesh_red = None
    if ctx.mesh is not None:
        mesh_red = _MeshReduce(cfg, ctx, rules or shd.ShardingRules
                               .for_training(ctx.fsdp_axis, ctx.tp_axis))
    local = ctx.mesh is not None

    def cast(p):
        return p.to(compute_dtype) if p.is_floating_point() else p

    def value_and_grad(params, mb):
        leaves = tree_map(
            lambda p: p.detach().requires_grad_(p.is_floating_point()),
            params)
        # master -> compute cast inside the differentiated function
        with torch.enable_grad():
            loss, metrics = M.loss_fn(tree_map(cast, leaves), mb, cfg,
                                      remat=tcfg.remat, ctx=ctx,
                                      local_batch=local)
            flat = [p for p in tree_leaves(leaves) if p.requires_grad]
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        by_leaf = {id(p): g for p, g in zip(flat, got)}

        def grad_of(p):        # a leaf the loss does not reach gets 0
            g = by_leaf.get(id(p))
            return g if g is not None else torch.zeros_like(
                p, dtype=torch.float32)

        return ({k: v.detach() for k, v in metrics.items()},
                tree_map(grad_of, leaves))

    def grads(params, batch):
        dev = tree_leaves(params)[0].device
        batch = _as_tensors(batch, dev)
        if tcfg.microbatches > 1:
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
                     for k in METRIC_KEYS}
            for mb in _microbatch(batch, tcfg.microbatches):
                metrics, g = value_and_grad(params, mb)
                g_acc = tree_map(torch.add, g_acc, g)
                m_acc = {k: m_acc[k] + metrics[k] for k in METRIC_KEYS}
            g = tree_map(lambda g: g / tcfg.microbatches, g_acc)
            metrics = {k: v / tcfg.microbatches for k, v in m_acc.items()}
        else:
            metrics, g = value_and_grad(params, batch)
        if mesh_red is not None:
            g, metrics = mesh_red.grads(g), mesh_red.metrics(metrics)
        return metrics, g

    def train_step(state: dict, batch: dict):
        params = state["params"]
        lr = schedule.warmup_cosine(
            state["step"], peak_lr=tcfg.learning_rate,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)
        metrics, g = grads(params, batch)
        reduce = (None if mesh_red is None else
                  mesh_red.norm_sq([n for n, _ in named_leaves(g)]))
        g, gnorm = adamw.clip_by_global_norm(g, tcfg.grad_clip, reduce)
        new_params, new_opt = adamw.adamw_update(g, state["opt"], params,
                                                 lr, opt_cfg)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt": new_opt}
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr)

    train_step.grads = grads
    return train_step


@dataclasses.dataclass
class TrainBundle:
    """What the launcher needs to run a step: the step, the state's meta
    tree and its logical axes; over a mesh also the state's and the
    batch's specs (the reference's shardings), the mesh and the
    context. `shard(state)` cuts a global state into the rank's."""

    step_fn: Any
    abstract_state: Any
    axes: Any = None
    state_pspecs: Any = None
    batch_pspecs: Any = None
    mesh: Any = None
    ctx: ParallelCtx = SINGLE

    def shard(self, state):
        if self.mesh is None:
            return state
        return shd.shard_tree(state, self.state_pspecs, self.mesh)


def make_bundle(cfg: ModelConfig, tcfg: TrainConfig, *,
                ctx: Optional[ParallelCtx] = None, mesh=None,
                rules=None) -> TrainBundle:
    """The train step and the abstract state, on one device or over
    `mesh` (a `DeviceMesh`; `ctx` defaults to `ctx_for_mesh(mesh)`,
    `rules` to `for_training(ctx.fsdp_axis, ctx.tp_axis)`): the step
    over the rank's shards, the state's specs under `rules` and the
    batch's over the dp axes."""
    if mesh is None and ctx is not None:
        mesh = ctx.mesh
    astate = abstract_train_state(cfg)
    axes = M.init_model(cfg, device="meta", with_axes=True)[1]
    if mesh is None:
        if rules is not None:
            raise ValueError("rules shard over a mesh; none was given")
        return TrainBundle(build_train_step(cfg, tcfg), astate, axes)
    if ctx is None:
        from repro_torch.launch.mesh import ctx_for_mesh

        ctx = ctx_for_mesh(mesh, remat=tcfg.remat)
    if ctx.mesh is not mesh:
        raise ValueError("ctx.mesh is not the mesh given")
    rules = rules or shd.ShardingRules.for_training(ctx.fsdp_axis,
                                                    ctx.tp_axis)
    return TrainBundle(
        build_train_step(cfg, ctx, tcfg, rules=rules), astate, axes,
        state_pspecs=state_pspecs(astate, axes, rules, mesh),
        batch_pspecs={k: shd.P(ctx.dp_axes or None)
                      for k in batch_keys(cfg)},
        mesh=mesh, ctx=ctx)
