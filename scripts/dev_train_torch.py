"""Dev lane for the PyTorch port's training over a mesh (the train-side
counterpart of `scripts/dev_serve_torch.py --mesh`; it imports only
`repro_torch`).

The rank functions here run under `launch.mesh.run_ranks` (one spawned
process per rank; they must be importable by name), which
`tests/test_torch_mesh_train.py`, `tests/test_torch_parallel_grad.py`,
`tests/test_torch_compress.py` and `chip_smoke.py` use:

* `mesh_train_rank`: the train bundle over a (dp, tp) mesh
  (`runtime.train.make_bundle(mesh=)`, FSDP + TP under the training
  rules), steps from the same global float32 masters and batches as the
  meshless step, with the first step's reduced gradients, the losses, the
  final state (gathered whole), each leaf's digest by shard, the rank's
  state bytes against its spec share, and optionally the tiered step
  (`runtime.tiering`) and `optim.compress.compressed_psum` on the rank;
* `moe_grad_rank`: `moe.moe_ep`'s gradients with the expert weights split
  under the training rules;
* `ssm_grad_rank`: `ssm.ssm_block`'s gradients with its weights split
  under the training rules;
* `collective_grad_rank`: each autograd collective's forward and backward.

The CLI runs the meshless step and the mesh step side by side:

    PYTHONPATH=src python scripts/dev_train_torch.py --mesh dp2tp2 \\
        --device cpu [--arch granite_3_2b] [--steps 3]

and exits 1 when a loss or grad norm differs by more than 1e-5 or a
replica differs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.common.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.common.pytree import leaf_bytes, named_leaves  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import compress  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import tiering  # noqa: E402
from repro_torch.runtime import train as train_rt  # noqa: E402

TOL = 1e-5


def rank_mesh(dp: int, tp: int, device):
    import torch.distributed as dist

    return mesh_mod.make_smoke_mesh((dp, tp), device=torch.device(device),
                                    backend=dist.get_backend())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def global_state(params, device) -> dict:
    """Step 0 of the train state on the given float32 masters (numpy or
    tensors; tensors are used as they are)."""
    if not isinstance(next(iter(named_leaves(params)))[1], torch.Tensor):
        params = load_numpy_params(params, device=device)
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "params": params, "opt": adamw.adamw_init(params)}


def token_nll(params, batch, cfg, ctx=None) -> torch.Tensor:
    """The per-token next-token NLL (float32, one row a batch row) of a
    teacher-forced forward of the master weights cast to cfg.dtype, as
    the train step's loss reads them (without grad; over a mesh the
    rank's rows, `ctx` its context)."""
    from repro_torch.common.parallel import SINGLE
    from repro_torch.models import model as M
    from repro_torch.models.module import cast_params

    ctx = ctx or SINGLE
    dev = next(iter(named_leaves(params)))[1].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    with torch.no_grad():
        logits = M.forward(cast_params(params, cfg.dtype),
                           dict(batch, tokens=tokens[:, :-1]), cfg,
                           ctx=ctx, local_batch=ctx.mesh is not None)[0]
        logits = logits.float()
        labels = tokens[:, 1:].long()
        return (torch.logsumexp(logits, -1)
                - torch.gather(logits, -1, labels[..., None])[..., 0])


@contextlib.contextmanager
def tp_split_products(tp: int):
    """Within it, the model's two row-parallel products (the MLP's down
    projection over ff, attention's output projection over the heads)
    are computed as a tp-way tensor-parallel mesh computes them: each
    rank's block of the contraction in the operands' dtype, the blocks
    summed in that dtype in rank order. A one-process witness of the
    rounding the split adds."""
    einsum = torch.einsum
    dims = {"bsf,fd->bsd": (-1, 0), "bshk,hkd->bsd": (2, 0)}

    def split(eq, a, b):
        if eq not in dims or a.dtype == torch.float32:
            return einsum(eq, a, b)
        da, db = dims[eq]
        n = a.shape[da] // tp
        out = None
        for i in range(tp):
            p = einsum(eq, a.narrow(da, i * n, n), b.narrow(db, i * n, n))
            out = p if out is None else out + p
        return out

    torch.einsum = split
    try:
        yield
    finally:
        torch.einsum = einsum


def rank_state(params, bundle, device) -> dict:
    """Step 0 of the rank's shard of the train state: the given global
    float32 masters cut by the bundle's specs, then zero moments of the
    shards (never the global moments: each rank would hold two
    model-sized trees before cutting them)."""
    if not isinstance(next(iter(named_leaves(params)))[1], torch.Tensor):
        params = load_numpy_params(params, device=device)
    local = shd.shard_tree(params, bundle.state_pspecs["params"],
                           bundle.mesh) if bundle.mesh is not None \
        else params
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "params": local, "opt": adamw.adamw_init(local)}


def shard_digests(state, pspecs, ctx) -> dict:
    """{leaf: (the rank's block coordinate, sha1 of its bytes)}: ranks of
    equal coordinates hold replicas of one block, which must be equal."""
    specs = dict(named_leaves(pspecs))
    out = {}
    for name, x in named_leaves(state):
        axes = [a for e in specs[name] if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        key = tuple(ctx.index(a) for a in axes)
        data = x.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        out[name] = (key, hashlib.sha1(data.numpy().tobytes()).hexdigest())
    return out


def replicas_equal(per_rank: list) -> list:
    """The leaves whose replicas (equal block coordinates) differ across
    the ranks' `shard_digests`."""
    bad = set()
    for name in per_rank[0]:
        seen = {}
        for d in per_rank:
            key, sha = d[name]
            if seen.setdefault(key, sha) != sha:
                bad.add(name)
    return sorted(bad)


def share_bytes(abstract_state, pspecs, mesh) -> int:
    """The bytes of a rank's shard of the state under `pspecs`."""
    counts = tiering.shard_counts(pspecs, mesh)
    return sum(leaf_bytes(x) // counts[n]
               for n, x in named_leaves(abstract_state))


def _compress_check(g: dict, ctx, axes) -> dict:
    """`compressed_psum` over one step's local grads: its new error state
    against a plain numpy recomputation (g - q * scale rounded once to
    float32, bit for bit), its mean
    against the plain float32 psum mean within the quantization bound
    (per leaf: sum over ranks of 127 |mean scale - scale_r| + scale_r / 2,
    over n), and the bytes each sends."""
    from repro_torch.common.parallel import all_gather, psum

    err0 = compress.init_error_state(g)
    mean, new_e = compress.compressed_psum(g, err0, ctx, axes)
    n = int(np.prod([ctx.axis_size(a) for a in axes]))
    same, worst, bytes_q, bytes_f = True, 0.0, 0, 0
    for name, x in named_leaves(g):
        x32 = x.detach().float().cpu().numpy()
        scale = np.float32(max(np.abs(x32).max(), np.float32(1e-12))) \
            / np.float32(127.0)
        q = np.clip(np.rint(x32 / scale), -127, 127).astype(np.int8)
        want_e = (x32.astype(np.float64) - q.astype(np.float64)
                  * np.float64(scale)).astype(np.float32)
        got_e = dict(named_leaves(new_e))[name].cpu().numpy()
        same &= bool(np.array_equal(got_e.view(np.uint32),
                                    want_e.view(np.uint32)))
        plain = psum(x.detach().float().clone(), ctx, axes) / n
        scales = all_gather(torch.tensor([float(scale)], device=x.device),
                            ctx, axes, 0).cpu().numpy().astype(np.float64)
        bound = float(np.sum(127 * np.abs(scales.mean() - scales)
                             + scales / 2) / n)
        err = float((dict(named_leaves(mean))[name] - plain).abs().max())
        worst = max(worst, err / max(bound, 1e-30))
        bytes_q += 4 * x.numel() + 4
        bytes_f += 4 * x.numel()
    return dict(axes=tuple(axes), error_state_equal=same,
                mean_over_bound=worst, wire_bytes_int32=bytes_q,
                wire_bytes_float32=bytes_f)


def mesh_train_rank(rank: int, world: int, cfg, dp: int, tp: int, params,
                    batches, runs, device) -> list:
    """One rank of the train bundle over a (dp, tp) mesh, from the global
    float32 masters `params` (numpy, or tensors shared by the caller) and
    the global `batches` (dicts of numpy, one a step). Each run dict:
      name; dtype (cfg.dtype by default); tcfg (TrainConfig fields);
      steps (default: every batch); grads: the first step's reduced
      grads, gathered whole (returned on rank 0); state: the final state
      gathered whole (rank 0); tier: {"policy", "pool_fraction"} runs the
      tiered step beside the untiered one from each state (the first
      `tier_steps`), bit-equal; compress: axis tuples for
      `compressed_psum` over the first step's local grads;
      deterministic: the steps under deterministic algorithms;
      against_meshless: the meshless bundle's steps from the
      same state and batches in this process too, losses, grad norms and
      every leaf compared bit for bit (a (1, 1) mesh, whose shard is the
      whole state); compare: {"state": a meshless final state (global,
      tensors), "lr_sum": its steps' lr summed} held leaf by leaf against
      the rank's shard (`_compare_state`); token_nll: before each step,
      the per-token NLL of the state's weights on the step's batch
      (`token_nll`), gathered over the dp axes (the global batch's rows).
    Returns per run: losses and grad norms a step, the ms of each step,
    the launches and plain calls of the run (counts reset before it),
    the digests by shard, the rank's state bytes and its spec share, the
    peak device memory of the steps (GB, on the card), the mesh
    coordinate and the extras asked for."""
    import torch.distributed as dist

    from repro_torch.runtime.sharding import unshard_tree

    dev = torch.device(device)
    mesh = rank_mesh(dp, tp, device)
    out = []
    for run in runs:
        rcfg = dataclasses.replace(cfg, dtype=run.get("dtype", cfg.dtype))
        tcfg = TrainConfig(**run.get("tcfg", {}))
        bundle = train_rt.make_bundle(rcfg, tcfg, mesh=mesh)
        ctx = bundle.ctx
        state = rank_state(params, bundle, dev)
        n_steps = run.get("steps", len(batches))
        res = dict(name=run.get("name"), coord=(ctx.index("data"),
                                                ctx.index("model")),
                   losses=[], grad_norms=[], step_ms=[])
        local = [train_rt.rank_batch(b, ctx, tcfg.microbatches)
                 for b in batches[:n_steps]]
        if run.get("grads") or run.get("compress"):
            metrics, g = bundle.step_fn.grads(state["params"], local[0])
            res["grad_metrics"] = {k: float(v) for k, v in metrics.items()}
            if run.get("grads"):
                whole = unshard_tree(g, bundle.state_pspecs["params"], mesh)
                res["grads"] = to_numpy(whole) if rank == 0 else None
                del whole
            if run.get("compress"):
                res["compress"] = [_compress_check(g, ctx, axes)
                                   for axes in run["compress"]]
            del g
        tier = None
        if run.get("tier"):
            shape = ShapeConfig("mesh", 16, 8, "train")
            _, tb, info = tiering.apply_tier_shardings(
                rcfg, tcfg, bundle, shape, device=dev, **run["tier"])
            tier = dict(info=info, equal=[], host=tb.step_fn.host_names)
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(run.get("deterministic", prev),
                                           warn_only=True)
        meshless = None
        if run.get("against_meshless"):
            one = train_rt.make_bundle(rcfg, tcfg)
            meshless = dict(state=global_state(params, dev), steps=[])
            for b in batches[:n_steps]:
                meshless["state"], m = one.step_fn(meshless["state"], b)
                meshless["steps"].append((float(m["loss"]),
                                          float(m["grad_norm"])))
        params0 = state["params"] if run.get("compare") else None
        dist.barrier()
        kernels.reset_counters()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if run.get("token_nll"):
            res["token_nll"] = []
        for i, b in enumerate(local):
            if run.get("token_nll"):
                from repro_torch.common.parallel import all_gather

                nll = token_nll(state["params"], b, rcfg, ctx)
                res["token_nll"].append(all_gather(
                    nll, ctx, ctx.dp_axes, 0).cpu().numpy())
            if tier is not None and i < run.get("tier_steps", n_steps):
                placed = tiering.place_state(state, tier["host"],
                                             pin=dev.type == "cuda")
                t_state, t_metrics = tb.step_fn(placed, b)
            _sync(dev)
            t0 = time.perf_counter()
            new_state, metrics = bundle.step_fn(state, b)
            _sync(dev)
            res["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if tier is not None and i < run.get("tier_steps", n_steps):
                want = dict(named_leaves(new_state))
                tier["equal"].append(all(
                    torch.equal(a.to(want[n].device), want[n])
                    for n, a in named_leaves(t_state)) and all(
                    torch.equal(t_metrics[k], metrics[k]) for k in metrics))
                del placed, t_state
            state = new_state
            res["losses"].append(float(metrics["loss"]))
            res["grad_norms"].append(float(metrics["grad_norm"]))
        res["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        res["plain"] = {k: v for k, v in kernels.REFERENCE_CALLS.items()
                        if v}
        res["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if dev.type == "cuda" else None)
        torch.use_deterministic_algorithms(prev)
        if meshless is not None:
            want = dict(named_leaves(meshless["state"]))
            res["meshless"] = dict(
                steps=meshless["steps"],
                steps_equal=meshless["steps"] == list(zip(
                    res["losses"], res["grad_norms"])),
                leaves=len(want), leaves_equal=sum(
                    torch.equal(x, want[n]) for n, x in named_leaves(state)))
            del meshless, want
        if run.get("compare"):
            res["compare"] = _compare_state(
                state, params0, run["compare"]["state"], bundle,
                run["compare"]["lr_sum"])
        del params0
        res["digests"] = shard_digests(state, bundle.state_pspecs, ctx)
        res["state_bytes"] = sum(leaf_bytes(x)
                                 for _, x in named_leaves(state))
        res["share_bytes"] = share_bytes(bundle.abstract_state,
                                         bundle.state_pspecs, mesh)
        if tier is not None:
            res["tier"] = dict(equal=tier["equal"],
                               pool_bytes=tier["info"]["pool_leaf_bytes"],
                               n_host=len(tier["host"]),
                               host_annotation=tier["info"][
                                   "host_annotation"])
        if run.get("state"):
            whole = unshard_tree(state, bundle.state_pspecs, mesh)
            res["state"] = to_numpy(whole) if rank == 0 else None
            del whole
        out.append(res)
        del state, bundle
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _compare_state(local, params0, want_global, bundle,
                   lr_sum: float) -> dict:
    """The rank's shard of a state after some steps against its block of a
    meshless state after the same steps (`want_global`): for the params,
    the smallest share of a leaf's elements whose update is within 1e-2
    lr_sum of the meshless update and the largest update error over
    lr_sum; for the moments, the largest error over the largest entry of
    the leaf's block; the step and the count equal."""
    want = dict(named_leaves(bundle.shard(want_global)))
    old = dict(named_leaves({"params": params0}))
    out = dict(update_share=1.0, update_err_over_lr=0.0, moment_err=0.0,
               counts_equal=True)
    for name, x in named_leaves(local):
        y = want[name].to(x.device)
        if name.startswith("params/"):
            err = ((x - old[name]) - (y - old[name])).abs()
            out["update_share"] = min(out["update_share"], float(
                (err <= 1e-2 * lr_sum).float().mean()))
            out["update_err_over_lr"] = max(out["update_err_over_lr"],
                                            float(err.max()) / lr_sum)
        elif x.is_floating_point():
            out["moment_err"] = max(out["moment_err"], float(
                (x - y).abs().max()) / max(float(y.abs().max()), 1e-30))
        else:
            out["counts_equal"] &= bool(torch.equal(x, y))
    return out


MOE_AXES = {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "moe_ff"),
            "w_up": ("experts", "embed", "moe_ff"),
            "w_down": ("experts", "moe_ff", "embed")}


def moe_objective(y, aux, cot, n_aux: int = 1):
    """<y, cot> over the rows plus `n_aux` times 0.01 * the aux loss. Each
    rank of `moe_grad_rank` differentiates its rows' objective with the
    global aux once; the ranks' objectives add, so their gradients sum to
    the whole batch's objective with `n_aux` = the dp size."""
    return (y.float() * cot).sum() + n_aux * 0.01 * aux


def moe_grad_rank(rank: int, world: int, dp: int, tp: int, params, x, cot,
                  cfg, device) -> dict:
    """`moe.moe_ep` with grad over a (dp, tp) mesh, the MoE layer's global
    params (numpy) cut by the training rules (experts over `model`, the
    embed dim over `data`), x and the cotangent `cot` (B, S, d) split
    into the rank's rows: the gradient of the ranks' `moe_objective`s
    (that of the whole batch with `n_aux=dp`) for every weight (whole,
    rank 0) and for x (gathered), y, aux, the specs and the ms of the
    forward + backward."""
    from repro_torch.common.parallel import all_gather, psum
    from repro_torch.models import moe

    dev = torch.device(device)
    mesh = rank_mesh(dp, tp, device)
    ctx = mesh_mod.ctx_for_mesh(mesh, remat="none")
    full = load_numpy_params(params, device=dev)
    rules = shd.ShardingRules.for_training(ctx.fsdp_axis, ctx.tp_axis)
    specs = shd.pspecs_for_tree(full, {k: MOE_AXES[k] for k in full}, rules,
                                mesh)
    local = {k: v.detach().clone().requires_grad_() for k, v in
             shd.shard_tree(full, specs, mesh).items()}
    rows = train_rt.rank_batch({"x": np.asarray(x), "c": np.asarray(cot)},
                               ctx)
    xl = torch.as_tensor(rows["x"], device=dev).requires_grad_()
    cl = torch.as_tensor(rows["c"], device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    y, aux = moe.moe_ep(local, xl, cfg, ctx, local_batch=True)
    moe_objective(y, aux, cl).backward()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    grads = {}
    for k, v in local.items():
        g = v.grad
        if "data" not in [e for e in specs[k] if e]:
            g = psum(g.clone(), ctx, ctx.dp_axes)
        grads[k] = g
    whole = shd.unshard_tree(grads, specs, mesh)
    return dict(grads=to_numpy(whole) if rank == 0 else None,
                x_grad=all_gather(xl.grad, ctx, ctx.dp_axes, 0).cpu().numpy(),
                y=all_gather(y.detach(), ctx, ctx.dp_axes, 0).cpu().numpy(),
                aux=float(aux.detach()), ms=ms, specs={k: tuple(v)
                                              for k, v in specs.items()})


def ssm_grad_rank(rank: int, world: int, dp: int, tp: int, params, x, cot,
                  cfg, fsdp: bool, device) -> dict:
    """`ssm.ssm_block` with grad on a (dp, tp) mesh, one SSM layer's
    global params (numpy) cut by the training rules: with `fsdp` the
    rows of x and `cot` (B, S, d) over `data`, every `embed` dim over it
    and the grads of the leaves it does not split summed over it (as the
    train step sums them); without, no dp axis (`data`'s ranks are
    replicas, each a dp1 x tp mesh) and only `model` splits. The
    gradient of <y, cot> for every weight (whole, rank 0) and for x
    (gathered), and y (gathered)."""
    from repro_torch.common.parallel import ParallelCtx, all_gather, psum
    from repro_torch.models import ssm
    from repro_torch.models.module import Initializer

    dev = torch.device(device)
    mesh = rank_mesh(dp, tp, device)
    ctx = ParallelCtx(mesh=mesh, dp_axes=("data",) if fsdp else (),
                      fsdp_axis="data" if fsdp else None, tp_axis="model",
                      remat="none")
    init = Initializer(None)
    ssm.ssm_init(init, cfg)
    full = load_numpy_params(params, device=dev)
    rules = shd.ShardingRules.for_training(ctx.fsdp_axis, ctx.tp_axis)
    specs = shd.pspecs_for_tree(full, init.axes(), rules, mesh)
    local = {k: v.detach().clone().requires_grad_() for k, v in
             shd.shard_tree(full, specs, mesh).items()}
    rows = train_rt.rank_batch({"x": np.asarray(x), "c": np.asarray(cot)},
                               ctx)
    xl = torch.as_tensor(rows["x"], device=dev).requires_grad_()
    y = ssm.ssm_block(local, xl, cfg, ctx=ctx)
    (y.float() * torch.as_tensor(rows["c"], device=dev)).sum().backward()
    grads = {}
    for k, v in local.items():
        g = v.grad
        if ctx.dp_axes and "data" not in [e for e in specs[k] if e]:
            g = psum(g.clone(), ctx, ctx.dp_axes)
        grads[k] = g
    whole = shd.unshard_tree(grads, specs, mesh)
    return dict(grads=to_numpy(whole) if rank == 0 else None,
                x_grad=all_gather(xl.grad, ctx, ctx.dp_axes, 0).cpu().numpy(),
                y=all_gather(y.detach(), ctx, ctx.dp_axes, 0).cpu().numpy(),
                specs={k: tuple(v) for k, v in specs.items()})


def compress_rank(rank: int, world: int, dp: int, tp: int, grads, errors,
                  axis_sets, device) -> list:
    """`optim.compress.compressed_psum` on this rank of a (dp, tp) mesh,
    with this rank's gradient and error trees (`grads[rank]`,
    `errors[rank]`, numpy): per axis tuple of `axis_sets` the mean and the
    new error state (numpy)."""
    from repro_torch.common.parallel import ParallelCtx

    dev = torch.device(device)
    mesh = rank_mesh(dp, tp, device)
    ctx = ParallelCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")
    g = load_numpy_params(grads[rank], device=dev)
    e = load_numpy_params(errors[rank], device=dev)
    out = []
    for axes in axis_sets:
        mean, new_e = compress.compressed_psum(g, e, ctx, axes)
        out.append(dict(mean=to_numpy(mean), error=to_numpy(new_e)))
    return out


def collective_grad_rank(rank: int, world: int, cases, device) -> list:
    """Each autograd collective of `common.parallel` on this rank's
    inputs, over a (1, world) mesh's "model" axis (tp) and a (world, 1)
    mesh's "data" axis (dp): per case {"op", "axis", "x": per-rank inputs
    (numpy, indexed by rank), "c": per-rank cotangents, ...} the output
    and the gradient of <out, c[rank]> with respect to x."""
    from repro_torch.common import parallel as par

    dev = torch.device(device)
    meshes = {"model": rank_mesh(1, world, device),
              "data": rank_mesh(world, 1, device)}
    out = []
    for case in cases:
        mesh = meshes[case["axis"]]
        ctx = par.ParallelCtx(mesh=mesh, dp_axes=("data",),
                              fsdp_axis="data", tp_axis="model")
        a = case["axis"]
        x = torch.as_tensor(case["x"][rank], device=dev).requires_grad_()
        op = case["op"]
        if op == "psum":
            y = par.psum(x, ctx, a)
        elif op == "enter_region":
            y = par.enter_region(x, ctx, a) * (rank + 1.0)
        elif op == "all_gather":
            y = par.all_gather(x, ctx, a, case["dim"],
                               reduce_grad=case.get("reduce_grad", False))
        elif op == "gather_param":
            y = par.gather_param(x, ctx, case["dim"], case["full"])
        elif op == "all_to_all":
            y = par.all_to_all(x, ctx, a)
            if case.get("strided"):       # a strided cotangent comes back
                y = y.transpose(-1, -2)
        elif op == "local_slice":
            y = par.local_slice(x, ctx, a, case["dim"])
        else:
            raise ValueError(op)
        c = torch.as_tensor(case["c"][rank], device=dev)
        (y * c).sum().backward()
        out.append(dict(y=y.detach().cpu().numpy(),
                        grad=x.grad.cpu().numpy()))
    return out


# ------------------------------------------------------------------- CLI
def _mesh_shape(spec: str) -> tuple:
    m = re.fullmatch(r"dp(\d+)tp(\d+)", spec)
    if not m:
        raise argparse.ArgumentTypeError(f"--mesh {spec!r}: expected dpDtpT")
    return int(m.group(1)), int(m.group(2))


def main(argv=None) -> int:
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models import model as M

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=_mesh_shape, default=(2, 2))
    ap.add_argument("--arch", default="granite_3_2b",
                    choices=configs.list_archs())
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    dp, tp = args.mesh
    dev = torch.device(args.device)
    cfg = dataclasses.replace(configs.reduced(args.arch), dtype="float32")
    if cfg.num_experts:
        # the meshless step runs `moe_dense`, which drops no pair: at
        # capacity 8.0 `moe_ep` drops none either
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    tcfg = dict(total_steps=10, warmup_steps=2, remat="block")
    params = to_numpy(M.init_model(cfg, torch.Generator(dev).manual_seed(0)))
    batches = [make_batch_for(cfg, 16, 4 * dp, s) for s in range(args.steps)]
    step = train_rt.build_train_step(cfg, TrainConfig(**tcfg))
    state = global_state(params, dev)
    ref = []
    for b in batches:
        state, m = step(state, b)
        ref.append((float(m["loss"]), float(m["grad_norm"])))
    got = mesh_mod.run_ranks(
        mesh_train_rank, dp * tp,
        (cfg, dp, tp, params, batches, [dict(name="mesh", tcfg=tcfg)],
         args.device), device=args.device, backend=args.backend)
    res = [g[0] for g in got]
    bad = replicas_equal([r["digests"] for r in res])
    ok = not bad
    for i, (loss, gn) in enumerate(ref):
        ml, mg = res[0]["losses"][i], res[0]["grad_norms"][i]
        close = (abs(ml - loss) <= TOL * abs(loss)
                 and abs(mg - gn) <= TOL * abs(gn))
        ok &= close
        print(f"step {i}: loss meshless {loss:.6f} mesh {ml:.6f}; grad norm "
              f"meshless {gn:.6f} mesh {mg:.6f} {'ok' if close else 'FAIL'}")
    print(f"replicas equal: {not bad} {bad}; state bytes a rank "
          f"{[r['state_bytes'] for r in res]} (share "
          f"{res[0]['share_bytes']})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
