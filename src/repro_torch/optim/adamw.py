"""AdamW over nested dicts of tensors (port of `repro.optim.adamw`).

The moment tensors are first-class tier-placement candidates: they are
the coldest large state in training (touched once per step, never by
forward or backward), which makes them the prime pool-tier residents
under the paper's hotness ordering.

The arithmetic is float32 in the reference's order. Decoupled weight
decay is added into the step (`step + wd * p`, then `p - lr * step`), as
the reference does; `torch.optim.AdamW` applies `p * (1 - lr * wd)` before
the step instead, so it is not used.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def adamw_init(params) -> dict:
    """Zero float32 moments shaped like `params` and a zero step count."""
    leaf = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def adamw_update(grads, opt_state, params, lr, cfg: AdamWConfig):
    """One AdamW step: returns (new params, new optimizer state). `lr` is
    a float or a float32 scalar tensor; nothing is updated in place."""
    count = opt_state["count"] + 1
    c = count.to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=c.device), c)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        return (p - lr * step).to(p.dtype), m, v

    flat = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    pick = lambda i: tree_map(lambda t: t[i], flat)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}


def global_norm(tree, reduce=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares. Over a mesh
    the leaves are local shards: `reduce` maps the list of the leaves'
    local sums of squares (in `tree_leaves` order) to their sums over the
    ranks that split each leaf, so a replicated leaf counts once."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(tree)]
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float, reduce=None):
    """Grads scaled by min(1, max_norm / norm); returns (grads, norm).
    `reduce` as `global_norm`'s (None: the whole tree is local)."""
    norm = global_norm(grads, reduce)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
