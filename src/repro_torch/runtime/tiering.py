"""Glue: the paper's placement engine -> where the train state's leaves
live (port of `repro.runtime.tiering`).

Takes a built `TrainBundle`, derives the per-card access profile of the
training state, runs the placement policy against the emulated tier
topology (paper-style `pool_fraction`), and returns a bundle whose step
keeps the pool-tier leaves in pinned host memory. Where the reference
re-jits the step with `pinned_host` memory kinds on those leaves, the
tiered step here moves them itself: each step brings every host leaf
onto the card through the grouped page copy (`kernels.page_io`, stream
`state_in`, one launch per group of at most `page_io.MAX_SEGS` leaves),
runs the untiered step on the card copies, and writes the updated leaves
back into the same pinned tensors with the same copy (`state_out`). The
state is donated, as the reference donates it where the backend can
place outputs on the host: its host leaves are rewritten in place. A
tier changes where bytes live, not what they are, so the tiered step is
bit-equal to the untiered one from the same state and batch.

On the CPU there is no pinned memory: the host leaves are ordinary CPU
tensors and the copies take the plain version. `info["host_annotation"]`
says which: "inputs+outputs" where the page copy reaches pinned host
memory (the card), "logical-only" where it does not.
`info["substrate_mode"]` is the serving substrate's resolution of the
same probes (`capability.substrate_mode`).

Over a mesh (a bundle of `runtime.train.make_bundle(mesh=)`) the profile
is per rank: each leaf's bytes divided by its shard count under the
bundle's `state_pspecs` (`shard_counts`, `per_device_profile`, the
reference's), and each rank places and moves its own shards through its
own tiered step, as on one card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.common.parallel import axis_sizes
from repro_torch.common.pytree import leaf_bytes, named_leaves
from repro_torch.core import access as acc
from repro_torch.core import placement as plc
from repro_torch.core import tiers as tr
from repro_torch.kernels.page_io.page_io import MAX_SEGS
from repro_torch.runtime import capability
from repro_torch.runtime import train as train_rt

_PAGE_LIMIT = 2**31      # bytes of one page of the copy's descriptor


def shard_counts(pspec_tree, mesh=None) -> dict:
    """Shards of each leaf: the product of the sizes of the mesh axes its
    spec names (the reference's); 1 for every leaf of any tree without a
    mesh (one card)."""
    if mesh is None:
        return {name: 1 for name, _ in named_leaves(pspec_tree)}
    sizes = axis_sizes(mesh)
    out = {}
    for name, spec in named_leaves(pspec_tree):
        n = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= sizes[a]
        out[name] = n
    return out


def per_device_profile(state, pspecs, mesh=None, cfg=None, shape=None,
                       remat=None) -> list:
    """The train state's access profile per card (`core.access`), each
    leaf's bytes divided by its shard count: `(state, pspecs, mesh, cfg,
    shape, remat)`, the reference's, or `(state, cfg, shape, remat)` on
    one card."""
    if isinstance(pspecs, ModelConfig):          # (state, cfg, shape, remat)
        pspecs, mesh, cfg, shape, remat = state, None, pspecs, mesh, cfg
    profile = acc.train_profile(state, cfg, shape, remat)
    counts = shard_counts(pspecs, mesh)
    return [dataclasses.replace(a, bytes=a.bytes // max(counts.get(a.name,
                                                                    1), 1))
            for a in profile]


def _pages(t: torch.Tensor) -> torch.Tensor:
    """`t` viewed as (1, n, page) with pages under the copy's 2 GiB
    limit (and fewer than 2^31 of them): the whole leaf as one page, else
    its leading dims as pages."""
    flat = t.reshape(-1) if t.dim() else t.reshape(1)
    for j in range(t.dim() + 1):
        n = math.prod(t.shape[:j])
        if flat.numel() // max(n, 1) * t.element_size() < _PAGE_LIMIT \
                and n < _PAGE_LIMIT:
            return flat.view(1, n, -1)
    raise ValueError(f"leaf of shape {tuple(t.shape)} does not split into "
                     "the page copy's pages (under 2 GiB, under 2^31)")


def copy_plan(names: list) -> list:
    """The launches of one direction of the tiered step's copies: the
    host leaves in sorted-name order, at most MAX_SEGS to a launch."""
    return [names[i:i + MAX_SEGS] for i in range(0, len(names), MAX_SEGS)]


def _get(tree, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def _put(tree, name: str, value) -> dict:
    """A copy of `tree` (dicts only) with leaf `name` replaced."""
    k, _, rest = name.partition("/")
    out = dict(tree)
    out[k] = _put(tree[k], rest, value) if rest else value
    return out


def build_tiered_step(step_fn, host_names):
    """step(state, batch) -> (state, metrics) with the leaves named in
    `host_names` kept off the card: brought in through the page copy
    before `step_fn` runs on the card copies, written back into the same
    host tensors after. The body runs on the device of the state's other
    leaves (the first in name order). The step
    carries its `host_names`, its `plan` (the leaves of each launch, one
    direction) and its two halves, `bring_in(state, device) -> card
    copies` and `write_back(card leaves, host leaves)`."""
    host = sorted(host_names)
    plan = copy_plan(host)

    def bring_in(state, dev) -> dict:
        from repro_torch.kernels.page_io import ops as pops

        bufs = {}
        for group in plan:
            for n in group:
                x = _get(state, n)
                bufs[n] = torch.empty(x.shape, dtype=x.dtype, device=dev)
            pops.copy_pages([_pages(bufs[n]) for n in group], None,
                            [_pages(_get(state, n)) for n in group], None,
                            name="state_in")
        return bufs

    def write_back(card: dict, leaves: dict) -> None:
        from repro_torch.kernels.page_io import ops as pops

        for group in plan:
            pops.copy_pages([_pages(leaves[n]) for n in group], None,
                            [_pages(card[n]) for n in group], None,
                            name="state_out")

    def tiered_step(state, batch):
        dev = next(x.device for n, x in named_leaves(state)
                   if n not in host_names)
        leaves = {n: _get(state, n) for n in host}
        on_card = state
        for n, buf in bring_in(state, dev).items():
            on_card = _put(on_card, n, buf)
        new_state, metrics = step_fn(on_card, batch)
        del on_card
        write_back({n: _get(new_state, n) for n in host}, leaves)
        for n in host:
            new_state = _put(new_state, n, leaves[n])
        return new_state, metrics

    tiered_step.host_names = tuple(host)
    tiered_step.plan = plan
    tiered_step.bring_in = bring_in
    tiered_step.write_back = write_back
    return tiered_step


def place_state(state, host_names, *, pin: bool) -> dict:
    """`state` with the leaves named in `host_names` moved to host memory
    (pinned when `pin`, for the card's page copy to reach them); the
    other leaves as they are."""
    for n in sorted(host_names):
        x = _get(state, n)
        h = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                        pin_memory=pin)
        h.copy_(x)
        state = _put(state, n, h)
    return state


def apply_tier_shardings(cfg: ModelConfig, tcfg: TrainConfig,
                         bundle: train_rt.TrainBundle, shape: ShapeConfig,
                         *, policy: str, pool_fraction: float, device=None):
    """Returns (abstract_state, new bundle, tier_info dict). The new
    bundle's step keeps the pool-tier leaves in host memory (see the
    module docstring); `place_state` moves a state's leaves there (over
    a mesh each rank places its own shards). `device` is the card the
    probes ask about (the card by default); the emulation's base
    topology is one H100's (`tiers.emulated`). The byte counts are a
    rank's."""
    astate = bundle.abstract_state
    profile = per_device_profile(astate, bundle.state_pspecs or astate,
                                 bundle.mesh, cfg, shape, tcfg.remat)
    counts = shard_counts(bundle.state_pspecs or astate, bundle.mesh)
    working_set = sum(a.bytes for a in profile)
    topo_e = tr.emulated(pool_fraction, working_set)
    placement = plc.place(profile, topo_e, policy, pool_fraction)

    host_ok = capability.supports_host_input(device)
    out_ok = capability.supports_host_output(device)
    host = {name for name, _ in named_leaves(astate)
            if placement.tier_of(name) == "host"}
    step = build_tiered_step(bundle.step_fn, host)
    new_bundle = dataclasses.replace(bundle, step_fn=step)
    info = {
        "policy": policy,
        "pool_fraction": pool_fraction,
        "corridor": plc.corridor_check(placement),
        "pool_bytes_per_dev": placement.pool_bytes,
        "local_bytes_per_dev": placement.local_bytes,
        "predicted_t_memory_s": placement.t_memory,
        "predicted_slowdown_vs_all_hbm": placement.slowdown,
        "host_annotation": "inputs" if host_ok and not out_ok else (
            "inputs+outputs" if out_ok else "logical-only"),
        # the serving substrate's resolution of the same probe set
        "substrate_mode": capability.substrate_mode("auto", device),
        "n_pool_tensors": sum(
            1 for v in placement.assignment.values() if v == "host"),
        "pool_leaf_bytes": sum(leaf_bytes(_get(astate, n)) // counts[n]
                               for n in host),
        "copy_launches_per_step": 2 * len(step.plan),
    }
    return astate, new_bundle, info
