#!/usr/bin/env python3
"""Where the float32 grads of a mamba2-780m train step through the
ssd_scan kernel part from the plain versions' grads, on one state.

From the seed-0 init and the step-0 synthetic batch (batch 4 x seq 256,
float32, published widths, remat "none"), one forward and backward runs
through the kernels and one through the plain versions
(`kernels.force_backend("reference")`). Every SSD call of both runs is
recorded: its inputs (x, dt, A, B, C, D), its output y and the grads
that reach them. Printed:

- per SSM layer (forward order): how far the kernels run's SSD inputs
  and y are from the plain run's, and how far each run's y is from a
  float64 evaluation of its own inputs (`chunked.ssd_chunked` in
  float64), all as max |a - b| / max |b|;
- per layer: the gap of the incoming dy and of the grads of x, dt, A,
  B, C and D between the runs;
- the SSD backward rule alone: on the last layer's kernels-run inputs
  and dy, the kernel's autograd rule against autograd through the plain
  chunked version (the rule is that vjp, so a gap here is the rule's);
- the param grads leaf by leaf: the leaves with the largest relative
  gap, and the leaves that carry most of the grad norm's gap;
- the grad norms of both runs and their relative gap.

    python3 scripts/ssd_grad_gap.py [--batch 4] [--seq 256]
    python3 scripts/ssd_grad_gap.py --device cpu --reduced   # smoke test

On the CPU both runs take the plain versions (the code path is
exercised, the gaps are 0). Needs a CUDA card otherwise."""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def rel(a, b) -> float:
    """max |a - b| / max |b| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def run(torch, cfg, params, batch, backend, remat):
    """One forward + backward through `backend`; returns (loss, param
    grads by name, the SSD calls' records)."""
    from repro_torch import kernels
    from repro_torch.common.pytree import named_leaves
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.optim.adamw import tree_map

    calls = []
    orig = ssm.ssd_ops.ssd

    def recording_ssd(x, dt, A, Bm, Cm, D=None, init_state=None, **kw):
        ins = [t.clone() if t is not None else None
               for t in (x, dt, A, Bm, Cm, D)]
        rec = {"in": [t.detach().clone() if t is not None else None
                      for t in ins], "grad": [None] * 6}
        for i, t in enumerate(ins):
            if t is not None and t.requires_grad:
                t.register_hook(
                    lambda g, i=i: rec["grad"].__setitem__(i, g.detach()))
        y, state = orig(*ins, init_state, **kw)
        rec["y"] = y.detach().clone()
        y.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        calls.append(rec)
        return y, state

    leaves = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    kernels.force_backend(backend)
    ssm.ssd_ops.ssd = recording_ssd
    try:
        loss, _ = M.loss_fn(leaves, batch, cfg, remat=remat)
        loss.backward()
    finally:
        ssm.ssd_ops.ssd = orig
        kernels.force_backend(None)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in named_leaves(leaves) if p.is_floating_point()}
    return float(loss.detach()), grads, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a CPU smoke test)")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ssd_grad_gap: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.kernels.ssd_scan import chunked
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.runtime.train import init_train_state

    base = configs.reduced("mamba2_780m") if args.reduced \
        else configs.get("mamba2_780m")
    cfg = dataclasses.replace(base, dtype="float32")
    gen = torch.Generator(args.device).manual_seed(0)
    params = init_train_state(cfg, gen)["params"]
    batch = {k: v.to(args.device) for k, v in
             make_batch_for(cfg, args.seq, args.batch, 0).items()}
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(f"{cfg.name} float32: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}; batch {args.batch} x seq {args.seq}, seed-0 "
          "init, step-0 batch, remat none")

    kern = "cuda" if args.device == "cuda" else "reference"
    lk, gk, ck = run(torch, cfg, params, batch, kern, "none")
    lp, gp, cp = run(torch, cfg, params, batch, "reference", "none")
    assert len(ck) == len(cp) == cfg.num_layers
    print(f"loss kernels {lk:.9f} plain {lp:.9f} gap "
          f"{abs(lk - lp) / abs(lp):.3e}")

    names = ("x", "dt", "A", "B", "C", "D")
    print("per layer, forward: inputs' gap kernels vs plain (max over x, "
          "dt, B, C), y gap, and each run's y against float64 on its own "
          "inputs")
    print("per layer, backward: gap of dy and of the grads of "
          + ", ".join(names))
    for li, (a, b) in enumerate(zip(ck, cp)):
        in_gap = max(rel(x, y) for x, y in zip(a["in"], b["in"])
                     if x is not None)
        y64 = [chunked.ssd_chunked(*[t.double() if t is not None else None
                                     for t in r["in"]])[0] for r in (a, b)]
        fwd = (f"in {in_gap:.2e} y {rel(a['y'], b['y']):.2e} y-f64 "
               f"kernels {rel(a['y'], y64[0]):.2e} plain "
               f"{rel(b['y'], y64[1]):.2e}")
        bwd = " ".join(f"d{n} {rel(ga, gb):.2e}" for n, ga, gb in
                       zip(names, a["grad"], b["grad"]) if ga is not None)
        print(f"  layer {li:2d}: {fwd} | dy {rel(a['dy'], b['dy']):.2e} "
              f"{bwd}")
        del y64

    # the backward rule alone, on one layer's inputs and dy
    last = ck[-1]
    ins = [t.clone().requires_grad_() if t is not None else None
           for t in last["in"]]
    wrt = [t for t in ins if t is not None]
    y, _ = ssd_ops.ssd(*ins, impl=kern)
    rule = torch.autograd.grad(y, wrt, last["dy"])
    ins2 = [t.clone().requires_grad_() if t is not None else None
            for t in last["in"]]
    y2, _ = chunked.ssd_chunked(*ins2)
    plain = torch.autograd.grad(y2, [t for t in ins2 if t is not None],
                                last["dy"])
    print("the SSD backward rule on the last layer's inputs and dy, "
          "kernel's rule vs autograd through the plain chunked version: "
          + " ".join(f"d{n} {rel(a, b):.2e}"
                     for n, a, b in zip(names, rule, plain)))

    gaps = sorted(((rel(gk[n], gp[n]), n) for n in gp), reverse=True)
    print("param grads, largest relative gaps (max |k - p| / max |p|): "
          + ", ".join(f"{n} {g:.2e}" for g, n in gaps[:12]))
    sk = {n: float(g.double().pow(2).sum()) for n, g in gk.items()}
    sp = {n: float(g.double().pow(2).sum()) for n, g in gp.items()}
    nk, np_ = sum(sk.values()), sum(sp.values())
    share = sorted(((sk[n] - sp[n], n) for n in sp),
                   key=lambda t: -abs(t[0]))
    print(f"grad norm kernels {nk ** 0.5:.9f} plain {np_ ** 0.5:.9f} gap "
          f"{abs(nk ** 0.5 - np_ ** 0.5) / np_ ** 0.5:.3e}; squared-norm "
          f"gap {nk - np_:.4e}, largest contributions: "
          + ", ".join(f"{n} {d:.3e} (of {sp[n]:.3e})"
                      for d, n in share[:8]))
    by_kind: dict = {}
    for n, v in sp.items():
        kind = n.split("/")[-1]
        by_kind[kind] = by_kind.get(kind, 0.0) + v
    print("plain grad's squared norm by leaf kind: " + ", ".join(
        f"{k} {v:.3e}" for k, v in sorted(by_kind.items(),
                                          key=lambda t: -t[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
