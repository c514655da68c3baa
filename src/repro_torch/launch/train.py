"""Training launcher (port of `repro.launch.train`): the end-to-end loop
with checkpoint/restart, the straggler watchdog and the prefetching data
pipeline, through the smoke mesh as the reference's.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --steps 200 --batch 8 --seq 128

Runs on the card unless `--device` names another (`--device cpu
--reduced` is the CPU smoke configuration). The reference's flags, plus
`--device`. As the reference's, it trains through `make_smoke_mesh()`,
a (1, 1) ("data", "model") mesh (NCCL on the card, gloo on the CPU),
with `ctx_for_mesh(mesh, fsdp=False)` and the training rules without an
fsdp axis; the process group it makes for that mesh is destroyed on
exit (one it found already made is left as it was).

The steps run under `torch.use_deterministic_algorithms(True)` (the
embedding's and the label gather's backward accumulate with atomics
otherwise), with `CUBLAS_WORKSPACE_CONFIG=:4096:8` set before the first
cuBLAS handle unless the caller set it, so a run resumed from a
checkpoint is bit-equal to a straight one, as the reference's is.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.config import TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.data import PrefetchPipeline
from repro_torch.data.pipeline import to_device
from repro_torch.data.synthetic import make_batch_for
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import train as train_rt
from repro_torch.runtime.fault import StragglerWatchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # cuBLAS reads its workspace config when its first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(
        args.arch)
    tcfg = TrainConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 10, 1),
        microbatches=args.microbatches,
        remat="block",
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        seed=args.seed,
    )
    made_group = not torch.distributed.is_initialized()
    try:
        mesh = mesh_mod.make_smoke_mesh(device=device)
        ctx = mesh_mod.ctx_for_mesh(mesh, fsdp=False, remat="block")
        rules = shd.ShardingRules.for_training(fsdp_axis=None,
                                               tp_axis=ctx.tp_axis)
        bundle = train_rt.make_bundle(cfg, tcfg, ctx=ctx, mesh=mesh,
                                      rules=rules)
        return _train(args, cfg, bundle, device)
    finally:
        if made_group:
            mesh_mod.close_ranks()


def _train(args, cfg, bundle, device):
    ckpt = CheckpointManager(args.ckpt_dir)
    start_step = 0
    state = bundle.shard(train_rt.init_train_state(cfg, device=device,
                                                   seed=args.seed))
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, state)
        print(f"resumed from step {start_step}")

    pipeline = PrefetchPipeline(
        lambda s: make_batch_for(cfg, args.seq, args.batch, s, args.seed),
        start_step=start_step, transfer=to_device(device))
    watchdog = StragglerWatchdog(
        on_straggler=lambda r: print(
            f"[straggler] step {r.step}: {r.step_time:.3f}s "
            f"({r.ratio:.1f}x ewma)"))

    losses = []
    t_start = time.time()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for step in range(start_step, args.steps):
            ds_step, batch = pipeline.get()
            if ds_step != step:
                raise RuntimeError(f"pipeline at step {ds_step}, loop at "
                                   f"{step}")
            watchdog.start_step()
            state, metrics = bundle.step_fn(
                state, train_rt.rank_batch(batch, bundle.ctx,
                                           args.microbatches))
            loss = float(metrics["loss"])
            watchdog.end_step(step)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"acc {float(metrics['accuracy']):.3f} "
                      f"gnorm {float(metrics['grad_norm']):.2f}")
            if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
                ckpt.save(step + 1, state)
    finally:
        torch.use_deterministic_algorithms(deterministic)
        pipeline.close()
        ckpt.wait()

    wall = time.time() - t_start
    if losses:
        print(f"done: {args.steps - start_step} steps in {wall:.1f}s, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{len(watchdog.flagged)} straggler events")
        if not math.isfinite(losses[-1]):
            raise FloatingPointError(f"loss {losses[-1]}")
    return losses


if __name__ == "__main__":
    main()
