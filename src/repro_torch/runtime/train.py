"""Train-step builder (port of the meshless path of
`repro.runtime.train`): microbatched grad accumulation, global-norm
clipping, AdamW and the warmup-cosine schedule, over nested dicts of
tensors.

The state is {"step": int32 scalar, "params": float32 master weights,
"opt": {"m", "v", "count"}}, the reference's tree. A step runs eagerly,
as every op of the port does: the master weights are cast to cfg.dtype INSIDE the
differentiated function, as the reference does, so the grads come back
to the float32 masters through the casts. Nothing is updated in place:
a step returns a new state, as the reference's jitted step does.

Mesh sharding of the state and the batch (the reference's
`state_pspecs`, `make_bundle`'s shardings and donation) ports with the
mesh (ROADMAP A16b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.models.module import torch_dtype
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import tree_leaves, tree_map

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


def _microbatch(batch: dict, k: int) -> list:
    """The batch split into k microbatches along the leading axis."""
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def _as_tensors(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     opt_cfg: Optional[adamw.AdamWConfig] = None
                     ) -> Callable:
    """step(state, batch) -> (new_state, metrics). The metrics are the
    loss's (averaged over microbatches) plus `grad_norm` (before
    clipping) and `lr`, all float32 scalars on the state's device."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(weight_decay=tcfg.weight_decay)
    compute_dtype = torch_dtype(cfg.dtype)

    def cast(p):
        return p.to(compute_dtype) if p.is_floating_point() else p

    def value_and_grad(params, mb):
        leaves = tree_map(
            lambda p: p.detach().requires_grad_(p.is_floating_point()),
            params)
        # master -> compute cast inside the differentiated function
        with torch.enable_grad():
            loss, metrics = M.loss_fn(tree_map(cast, leaves), mb, cfg,
                                      remat=tcfg.remat)
            flat = [p for p in tree_leaves(leaves) if p.requires_grad]
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        by_leaf = {id(p): g for p, g in zip(flat, got)}

        def grad_of(p):        # a leaf the loss does not reach gets 0
            g = by_leaf.get(id(p))
            return g if g is not None else torch.zeros_like(
                p, dtype=torch.float32)

        return ({k: v.detach() for k, v in metrics.items()},
                tree_map(grad_of, leaves))

    def train_step(state: dict, batch: dict):
        params = state["params"]
        dev = state["step"].device
        batch = _as_tensors(batch, dev)
        lr = schedule.warmup_cosine(
            state["step"], peak_lr=tcfg.learning_rate,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)
        if tcfg.microbatches > 1:
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
                     for k in METRIC_KEYS}
            for mb in _microbatch(batch, tcfg.microbatches):
                metrics, g = value_and_grad(params, mb)
                g_acc = tree_map(torch.add, g_acc, g)
                m_acc = {k: m_acc[k] + metrics[k] for k in METRIC_KEYS}
            grads = tree_map(lambda g: g / tcfg.microbatches, g_acc)
            metrics = {k: v / tcfg.microbatches for k, v in m_acc.items()}
        else:
            metrics, grads = value_and_grad(params, batch)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        new_params, new_opt = adamw.adamw_update(grads, state["opt"], params,
                                                 lr, opt_cfg)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt": new_opt}
        return new_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


@dataclasses.dataclass
class TrainBundle:
    """What the launcher needs to run a step: the step and the state's
    meta tree. The reference's bundle also carries the state's and the
    batch's shardings over a mesh (ROADMAP A16b)."""

    step_fn: Any
    abstract_state: Any


def make_bundle(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None,
                rules=None) -> TrainBundle:
    """The train step and the abstract state, on one device. `mesh` and
    `rules` (sharding the state over a mesh) port with ROADMAP A16b."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "sharding the train state over a mesh ports with ROADMAP A16b")
    return TrainBundle(build_train_step(cfg, tcfg), abstract_train_state(cfg))
