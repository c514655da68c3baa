"""End-to-end driver of the PyTorch port: train a ~100M-param LM for a few
hundred steps on the synthetic pipeline, with checkpoint/restart and the
straggler watchdog (the twin of `examples/train_lm.py`).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --smoke --device cpu

Runs on the card unless `--device` names another; `--smoke` shrinks the
model to seconds on the CPU.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.device import resolve_device  # noqa: E402
from repro_torch.data import PrefetchPipeline  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.runtime import train as train_rt  # noqa: E402
from repro_torch.runtime.fault import StragglerWatchdog  # noqa: E402


def hundred_m_config():
    """~100M-param llama-style config (d=768, 12L, 32k vocab)."""
    base = configs.get("smollm_360m")
    return dataclasses.replace(
        base, name="lm-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
        tie_embeddings=True,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny dims for CI (seconds, not minutes)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = hundred_m_config()
    if args.smoke:
        cfg = dataclasses.replace(cfg, num_layers=2, d_model=128,
                                  num_heads=4, num_kv_heads=2, head_dim=32,
                                  d_ff=256, vocab_size=512)
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M")

    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=args.steps // 10)
    bundle = train_rt.make_bundle(cfg, tcfg)
    state = train_rt.init_train_state(cfg, device=device, seed=0)

    ckpt = CheckpointManager(args.ckpt_dir)
    pipe = PrefetchPipeline(
        lambda s: make_batch_for(cfg, args.seq, args.batch, s),
        transfer=to_device(device))
    dog = StragglerWatchdog()
    losses = []
    try:
        for step in range(args.steps):
            _, batch = pipe.get()
            dog.start_step()
            state, metrics = bundle.step_fn(state, batch)
            dog.end_step(step)
            losses.append(float(metrics["loss"]))
            if step % 25 == 0 or step == args.steps - 1:
                print(f"step {step:4d} loss {losses[-1]:.4f} "
                      f"acc {float(metrics['accuracy']):.3f}")
            if (step + 1) % 100 == 0:
                ckpt.save(step + 1, state)
    finally:
        pipe.close()
        ckpt.wait()
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(dog.flagged)} straggler events)")
    if not losses[-1] < losses[0]:
        raise AssertionError("did not learn")
    return losses


if __name__ == "__main__":
    main()
