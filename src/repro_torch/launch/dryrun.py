"""Dry-run: trace every (arch x shape) cell's step on meta tensors, print
its memory and cost analysis, derive the 3-term roofline on one H100 or
per rank of a mesh of H100s (port of `repro.launch.dryrun`).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k \\
      --tier-policy hotness --pool-fraction 0.5
  python -m repro_torch.launch.dryrun --mesh 16x16 --arch qwen2.5-32b \\
      --shape decode_32k
  python -m repro_torch.launch.dryrun --all --multi-pod [--no-fsdp]
  python -m repro_torch.launch.dryrun --mesh 1x32 --arch mamba2-780m

Every cell runs at its published widths on the meta device: the serve
bundle's meta params and caches (`runtime.serve.make_bundle`), the train
state's (`runtime.train.abstract_train_state`) and the cell's meta
inputs (`launch.specs`). Nothing is allocated and the card is idle: the
cost model (`profiler.cost`) counts the ops the port's eager step
dispatches, a hand-written kernel as one unit priced by its `cost(...)`
formula. A train cell with `--tier-policy` other than none traces the
tiered step (`runtime.tiering`): its pool-tier leaves come in and go out
through the page copy's units. Where there is more than one piece to
trace (`--all`, or a train cell extrapolated from two traces), the
pieces run in spawned processes, at most one per core this process
may run on.

With `--mesh DxM` or `--multi-pod` the step is rank 0's of the
reference's mesh ((D, M) ("data", "model"); (2, 16, 16) with "pod"), an
`AbstractMesh`: params, train state, caches and inputs are the rank's
shards (`runtime.sharding.local_shape` of the specs of the reference's
rules: `for_training` for train cells, `for_serving` for prefill and
decode; the context `ctx_for_mesh(mesh, fsdp=not --no-fsdp)`), every
collective records its wire bytes under the ring model instead of
running (`common.parallel`), and the roofline prices one card of
`mesh.size`. A train cell's microbatches are the table's, capped at the
rank's rows. Every stack's cells run over a mesh, one whose model axis
cuts an SSM head across two ranks included (`models.ssm`, trap (d): a
decode step gathers each layer's state over it). `--arch` without
`--shape` traces every cell of the arch.

Writes one JSON per cell under results/dryrun_torch/ (the reference's
TPU records under results/dryrun/ are never read), named by arch, shape
and mesh ("1" for one card, "16x16", "2x16x16", "DxM").
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import sys
import time
import traceback

from repro_torch import configs
from repro_torch.common import hw
from repro_torch.common.config import SHAPES, ShapeConfig, TrainConfig
from repro_torch.core import roofline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as S
from repro_torch.profiler.cost import CostModel, analyze_step
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import tiering
from repro_torch.runtime import train as train_rt

MESH = "1"
OUTDIR = os.path.join("results", "dryrun_torch")

# Grad-accumulation factors: the least power of two whose train_4k step
# (remat by block) keeps the port's own peak intermediate bytes (the cost
# mode's temp_bytes) within half of one H100's 80 GB, the other half
# left to the state where it fits; where no factor does, the least one
# at which the temp bytes stop falling (their floor is the update's
# state-sized intermediates, which microbatching does not shrink).
# `scripts/dryrun_microbatches.py` prints each arch's temp bytes by
# factor and this table.
TRAIN_MICROBATCHES = {
    "granite_moe_1b_a400m": 64,
    "kimi_k2_1t_a32b": 2,
    "mamba2_780m": 64,
    "jamba_1_5_large_398b": 8,
    "mistral_nemo_12b": 16,
    "qwen2_5_32b": 8,
    "smollm_360m": 32,
    "granite_3_2b": 32,
    "seamless_m4t_large_v2": 256,
    "paligemma_3b": 128,
}


def mesh_of(args):
    """The `AbstractMesh` of `--mesh` / `--multi-pod` (rank 0's
    coordinates), or None for one card."""
    if args.mesh or args.multi_pod:
        return mesh_mod.production_mesh(multi_pod=args.multi_pod,
                                        mesh=args.mesh)
    if args.no_fsdp:
        raise ValueError("--no-fsdp applies to a mesh (--mesh or "
                         "--multi-pod)")
    return None


def mesh_name(mesh) -> str:
    return MESH if mesh is None else mesh.name


def _sub_batch(batch: dict, rows: int) -> dict:
    return {k: v[:rows] for k, v in batch.items()}


def _extrapolate(c2: CostModel, c3: CostModel, k: int) -> CostModel:
    """The cost of k identical microbatches from the traced steps of 2
    and 3: each one more adds c3 - c2 (its forward, backward and the
    accumulation, their collectives included), the rest (the update, the
    copies, the grads' reduction) is in c2. The list of collectives is
    a traced step's, so the extrapolation keeps none."""
    lin = lambda a, b: a + (k - 2) * (b - a)  # noqa: E731

    def lin_d(a: dict, b: dict) -> dict:
        return {n: lin(a.get(n, 0), b.get(n, 0)) for n in set(a) | set(b)}

    return dataclasses.replace(
        c2, flops=lin(c2.flops, c3.flops),
        hbm_bytes=lin(c2.hbm_bytes, c3.hbm_bytes),
        hbm_bytes_raw=lin(c2.hbm_bytes_raw, c3.hbm_bytes_raw),
        wire_bytes=lin(c2.wire_bytes, c3.wire_bytes),
        collective_by_kind=lin_d(c2.collective_by_kind,
                                 c3.collective_by_kind),
        collective_counts=lin_d(c2.collective_counts, c3.collective_counts),
        collectives=[],
        temp_bytes=max(c2.temp_bytes, c3.temp_bytes),
        units=lin_d(c2.units, c3.units),
        n_ops=lin(c2.n_ops, c3.n_ops))


def _microbatches(cfg, microbatches: int = 0, mesh=None,
                  shape: ShapeConfig = None) -> int:
    """The train cell's microbatches: the table's (or the caller's);
    over a mesh at most the rank's rows (global_batch / dp)."""
    mb = microbatches or TRAIN_MICROBATCHES.get(
        configs.canonical(cfg.name), 8)
    if mesh is not None and shape is not None:
        rows = shape.global_batch // mesh_mod.ctx_for_mesh(mesh).dp_size
        mb = min(mb, max(rows, 1))
    return mb


def _shards(tree, pspecs, mesh) -> dict:
    """The rank's meta shards of a meta tree under `pspecs`."""
    return shd.zeros_for_shards(tree, pspecs, mesh, "meta")


def _rank_inputs(batch: dict, ctx) -> dict:
    """The rank's rows of a meta batch: its block over the dp axes where
    the rows divide by their size (the reference's `batch_pspec`)."""
    return _shards(batch, shd.batch_pspec(batch, ctx.dp_axes, ctx.mesh),
                   ctx.mesh)


def train_part(cfg, shape: ShapeConfig, tcfg: TrainConfig, m: int, *,
               tier_policy: str = "none", pool_fraction: float = 0.5,
               ctx=None):
    """(CostModel, tier info or None) of the train step of `cfg` over `m`
    of the `tcfg.microbatches` microbatches of `shape` (each
    `global_batch / microbatches` rows, over a mesh (`ctx.mesh`) the
    rank's share of them). With a tier policy the step is the tiered
    bundle's."""
    k = tcfg.microbatches
    batch = S.train_batch_specs(cfg, shape)
    mesh = ctx.mesh if ctx is not None else None
    kw = {}
    if mesh is not None:
        batch = _rank_inputs(batch, ctx)
        kw = dict(ctx=ctx, mesh=mesh)      # the training rules
    n_rows = next(iter(batch.values())).shape[0]
    if n_rows % k:
        raise ValueError(f"batch {n_rows} is not a multiple of {k} "
                         "microbatches")
    bundle = train_rt.make_bundle(cfg, dataclasses.replace(
        tcfg, microbatches=m), **kw)
    astate, info, step = bundle.abstract_state, None, bundle.step_fn
    if tier_policy != "none":
        astate, tiered, info = tiering.apply_tier_shardings(
            cfg, tcfg, bundle, shape, policy=tier_policy,
            pool_fraction=pool_fraction)
        step = tiered.step_fn
    if mesh is not None:
        astate = _shards(astate, bundle.state_pspecs, mesh)
    # the sub-batch is a view of the whole batch: its bytes are all in
    # the step's arguments
    rows = n_rows // k
    return analyze_step(step, astate, _sub_batch(batch, m * rows)), info


def cell_parts(cfg, shape: ShapeConfig, microbatches: int = 0,
               mesh=None) -> list:
    """The traced pieces of a cell: [None] (the whole cell), or [2, 3]
    for a train cell above 3 microbatches, extrapolated from its steps of
    2 and 3 microbatches of the same size (the microbatches are
    identical, so the cost is linear in their number)."""
    if shape.kind == "train" and _microbatches(cfg, microbatches, mesh,
                                               shape) > 3:
        return [2, 3]
    return [None]


def part_cost(cfg, shape: ShapeConfig, m=None, *, remat: str = "block",
              microbatches: int = 0, tier_policy: str = "none",
              pool_fraction: float = 0.5, mesh=None, fsdp: bool = True):
    """(CostModel, model flops, tier info or None, microbatches) of one
    piece of `cell_parts`: the train step over `m` microbatches (all of
    them when None), or the prefill or decode step, of `cfg` at `shape`
    on meta tensors; over `mesh` (an `AbstractMesh`) the step of its
    rank at `mesh.coords` on that rank's shards."""
    n_active = cfg.active_param_count()
    ctx = None
    if mesh is not None:
        ctx = mesh_mod.ctx_for_mesh(mesh, fsdp=fsdp, remat=remat)
    if shape.kind == "train":
        mb = _microbatches(cfg, microbatches, mesh, shape)
        cost, info = train_part(
            cfg, shape, TrainConfig(microbatches=mb, remat=remat), m or mb,
            tier_policy=tier_policy, pool_fraction=pool_fraction, ctx=ctx)
        return cost, roofline.model_flops_train(n_active, shape.tokens), \
            info, mb
    ins = S.cell_specs(cfg, shape)
    kw = {} if ctx is None else dict(mesh=mesh, ctx=ctx)  # serving rules
    sb = serve_rt.make_bundle(
        cfg, batch=shape.global_batch, max_seq=shape.seq_len,
        enc_len=shape.seq_len if cfg.frontend == "audio_stub" else 0, **kw)
    params, caches = sb.abstract_params, sb.abstract_caches
    if ctx is not None:
        params = _shards(params, sb.param_pspecs, mesh)
        caches = _shards(caches, sb.cache_pspecs, mesh)
        if shape.kind == "prefill":
            ins = dict(ins, batch=_rank_inputs(ins["batch"], ctx))
        else:
            ins = dict(ins, token=_rank_inputs(
                {"token": ins["token"]}, ctx)["token"])
    if shape.kind == "prefill":
        cost = analyze_step(sb.prefill_fn, params, ins["batch"])
        mf = roofline.model_flops_decode(n_active, shape.tokens)
    else:
        cost = analyze_step(sb.decode_fn, params, ins["token"], caches,
                            ins["t"])
        mf = roofline.model_flops_decode(n_active, shape.global_batch)
    return cost, mf, None, None


def combine(parts: list):
    """The cell's (CostModel, model flops, tier info, microbatches) from
    the `part_cost` of each of its `cell_parts`."""
    cost, mf, info, mb = parts[0]
    if len(parts) > 1:
        cost = _extrapolate(cost, parts[1][0], mb)
    return cost, mf, info, mb


def cell_cost(cfg, shape: ShapeConfig, **kw):
    """(CostModel, model flops, tier info or None, microbatches) of one
    cell: the train step, the prefill step or the decode step of `cfg`
    at `shape` on meta tensors; `kw` are `part_cost`'s."""
    return combine([part_cost(cfg, shape, m, **kw) for m in
                    cell_parts(cfg, shape, kw.get("microbatches", 0))])


def lower_cell(arch: str, shape_name: str, args, m=None):
    """The `part_cost` of piece `m` of the cell."""
    return part_cost(configs.get(arch), SHAPES[shape_name], m,
                     remat=args.remat, microbatches=args.microbatches,
                     tier_policy=args.tier_policy,
                     pool_fraction=args.pool_fraction, mesh=mesh_of(args),
                     fsdp=not args.no_fsdp)


def record_of(arch: str, shape_name: str, tier_policy: str, cost, model_flops,
              tier_info, microbatches, mesh=None) -> dict:
    """The cell's record: memory and cost analysis and the roofline on one
    H100, or per rank of `mesh` (an `AbstractMesh` of H100s)."""
    name = mesh_name(mesh)
    rep = roofline.report(arch, shape_name, name, cost,
                          n_devices=1 if mesh is None else mesh.size,
                          model_flops=model_flops, chip=hw.H100)
    record = {"arch": arch, "shape": shape_name, "mesh": name,
              "n_devices": 1 if mesh is None else mesh.size,
              "tier_policy": tier_policy, "status": "ok"}
    if microbatches is not None:
        record["microbatches"] = microbatches
    if tier_info is not None:
        record["tier"] = tier_info
    record.update(
        memory_analysis={
            "argument_bytes": cost.argument_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": cost.temp_bytes,
            "host_argument_bytes": (tier_info or {}).get("pool_leaf_bytes",
                                                         0),
        },
        dispatch_cost={"ops": cost.n_ops, "flops": cost.flops,
                       "bytes_accessed": cost.hbm_bytes_raw,
                       "units": dict(cost.units)},
        hlo_cost={
            "flops_per_device": rep.flops,
            "hbm_bytes_per_device": rep.hbm_bytes,
            "wire_bytes_per_device": rep.wire_bytes,
            "collectives": rep.collective_by_kind,
            "collective_counts": dict(cost.collective_counts),
            "warnings": rep.warnings[:10],
        },
        roofline={
            "t_compute_s": rep.t_compute,
            "t_memory_s": rep.t_memory,
            "t_collective_s": rep.t_collective,
            "dominant": rep.dominant,
            "model_flops": rep.model_flops,
            "useful_ratio": rep.useful_ratio,
            "bound_overlap_s": rep.bound_overlap,
            "bound_serial_s": rep.bound_serial,
            "roofline_fraction": rep.roofline_fraction,
        },
    )
    return record


def run_part(arch: str, shape_name: str, args, m) -> dict:
    """One piece of the cell's `cell_parts`: its `part_cost`, or the error
    that stopped it."""
    t0 = time.time()
    try:
        return {"part": lower_cell(arch, shape_name, args, m),
                "secs": time.time() - t0}
    except Exception as e:
        traceback.print_exc()
        return {"error": f"{type(e).__name__}: {e}",
                "secs": time.time() - t0}


def finish_cell(arch: str, shape_name: str, args, parts: list,
                outdir: str) -> dict:
    """The cell's record from its traced pieces, printed and written."""
    errors = [p["error"] for p in parts if "error" in p]
    mesh = mesh_of(args)
    name = mesh_name(mesh)
    if errors:
        record = {"arch": arch, "shape": shape_name, "mesh": name,
                  "tier_policy": args.tier_policy, "status": "error",
                  "error": "; ".join(errors)}
    else:
        record = record_of(arch, shape_name, args.tier_policy,
                           *combine([p["part"] for p in parts]), mesh=mesh)
        ma, rl = record["memory_analysis"], record["roofline"]
        print(f"[{arch} x {shape_name} @ {name}] temp="
              f"{ma['temp_bytes'] / 1e9:.2f}GB args="
              f"{ma['argument_bytes'] / 1e9:.2f}GB units="
              f"{record['dispatch_cost']['units']} wire="
              f"{record['hlo_cost']['wire_bytes_per_device'] / 1e9:.3f}GB "
              f"{record['hlo_cost']['collective_counts']} "
              f"compute={rl['t_compute_s']:.4f}s memory="
              f"{rl['t_memory_s']:.4f}s collective="
              f"{rl['t_collective_s']:.4f}s -> {rl['dominant']}-bound, "
              f"roofline_fraction={rl['roofline_fraction']:.3f}",
              flush=True)
    record["wall_s"] = round(sum(p["secs"] for p in parts), 1)
    os.makedirs(outdir, exist_ok=True)
    suffix = "" if args.tier_policy == "none" else f"_{args.tier_policy}"
    fn = os.path.join(outdir, f"{arch}_{shape_name}_{name}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(record, f, indent=1)
    return record


def _parts_of(arch: str, shape_name: str, args) -> list:
    return cell_parts(configs.get(arch), SHAPES[shape_name],
                      args.microbatches, mesh_of(args))


def run_cell(arch: str, shape_name: str, args, outdir: str) -> dict:
    parts = [run_part(arch, shape_name, args, m)
             for m in _parts_of(arch, shape_name, args)]
    return finish_cell(arch, shape_name, args, parts, outdir)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default="block", choices=["none", "block"])
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = per-arch table (TRAIN_MICROBATCHES)")
    ap.add_argument("--tier-policy", default="none",
                    choices=["none", "first_touch", "hotness", "balanced_bw",
                             "capacity"])
    ap.add_argument("--pool-fraction", type=float, default=0.5)
    ap.add_argument("--outdir", default=OUTDIR)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    try:
        mesh = mesh_of(args)
    except ValueError as e:
        _parser().error(str(e))
    if args.all:
        # the train cells take longest: start them first
        cells = sorted(configs.all_cells(),
                       key=lambda c: SHAPES[c[1]].kind != "train")
    elif args.arch and args.shape:
        cells = [(configs.canonical(args.arch), args.shape)]
    elif args.arch:
        arch = configs.canonical(args.arch)
        cells = [(arch, s.name) for s in configs.shapes_for(arch)]
    else:
        _parser().error("give --arch (and --shape), or --all")
    tasks = [(a, s, m) for a, s in cells for m in _parts_of(a, s, args)]
    if len(tasks) > 1:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(len(tasks), len(os.sched_getaffinity(0))),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            done = iter(pool.map(run_part, *zip(*[
                (a, s, args, m) for a, s, m in tasks])))
            results = [finish_cell(a, s, args,
                                   [next(done) for _ in _parts_of(a, s,
                                                                  args)],
                                   args.outdir) for a, s in cells]
    else:
        results = [run_cell(a, s, args, args.outdir) for a, s in cells]
    n_ok = sum(1 for r in results if r["status"] == "ok")
    print(f"\n{n_ok}/{len(results)} cells OK on mesh {mesh_name(mesh)}")
    if n_ok < len(results):
        for r in results:
            if r["status"] != "ok":
                print(" FAIL", r["arch"], r["shape"], r["error"])
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
