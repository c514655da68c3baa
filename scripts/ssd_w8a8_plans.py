#!/usr/bin/env python3
"""Time the launch options of the SSD scan and the W8A8 matmul on one
card, each against its default plan.

- ssd_scan (bf16, mamba2-780m's widths: 48 heads of 64, state 128, G=1,
  D given; B in {1, 8}, S=128, the engine's prefill): the tensor-core
  body's P columns per block {16, 32, 64} x chunk stages {1, 2} (one:
  the next chunk's copies wait for the compute; two: they overlap it),
  and the float32 FMA body (one block per head, the first design) on
  the same bf16 inputs.
- matmul_w8a8 (SmolLM-360M's MLP shapes, M in {8, 1024}; K x N in
  {960 x 2560, 2560 x 960}): block tiles 128 x 128, 64 x 128, 32 x 64.

Each plan is held against the plain version at `chip_smoke.py`'s
tolerances (ssd_scan: y atol 2e-2 rtol 8e-3 and the state 2e-4 against
the plain version in float64; W8A8 bit for bit). Prints one line per
plan (device ms per call from torch.profiler with the L2 flushed, as
`chip_smoke.py` times kernels) and the card's name and power limit, and
writes the table as JSON to `--out`.

    python3 scripts/ssd_w8a8_plans.py [--out results/ssd_w8a8_plans.json]

Needs a CUDA card; exits 2 without one."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SSD_SHAPES = ((1, 128), (8, 128))        # (B, S)
H, P, G, N = 48, 64, 1, 128
W8A8_SHAPES = ((8, 960, 2560), (1024, 960, 2560), (8, 2560, 960),
               (1024, 2560, 960))
Y_TOL = dict(atol=2e-2, rtol=8e-3)
STATE_TOL = dict(atol=2e-4, rtol=2e-4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ssd_w8a8_plans: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.matmul_w8a8 import matmul_w8a8 as mm
    from repro_torch.kernels.matmul_w8a8 import ops as wops
    from repro_torch.kernels.ssd_scan import chunked
    from repro_torch.kernels.ssd_scan import ssd_scan as sks

    smi = chip_smoke.smi_line()
    print(f"device: {smi}")
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator("cuda").manual_seed(0)
    F = torch.nn.functional

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    rows = []

    def record(name, label, fn, ok, err, default):
        ms = timer(fn)
        print(f"  {name:12s} {label:44s} ms={ms:.4f} "
              f"event_ms={timer.last_event_ms:.4f} max_abs_err={err:.3e} "
              f"{'ok' if ok else 'FAIL'}"
              f"{' (default plan)' if default else ''}")
        rows.append(dict(kernel=name, plan=label, ms=ms,
                         event_ms=timer.last_event_ms, max_abs_err=err,
                         ok=ok, default=default))

    print(f"ssd_scan: bf16, H={H} P={P} G={G} N={N}, D given")
    for B, S in SSD_SHAPES:
        x = randn(B, S, H, P).to(torch.bfloat16)
        ssd_args = (x, F.softplus(randn(B, S, H)), -torch.exp(randn(H) * 0.5),
                    randn(B, S, G, N).to(torch.bfloat16),
                    randn(B, S, G, N).to(torch.bfloat16), randn(H))
        y64, h64 = chunked.ssd_chunked(*(a.double() for a in ssd_args))
        default = sks.launch_plan(B, H, P, N, torch.bfloat16)
        plans = [sks.launch_plan(B, H, P, N, torch.bfloat16, pb, stages)
                 for pb in sks.MMA_PB for stages in (1, 2)]
        plans.append(sks.SsdPlan("fma", 0, 1, (H, B), 256,
                                 sks.fma_smem(P, N)))
        for plan in plans:
            def fn(plan=plan):
                return sks.ssd_cuda(*ssd_args, plan=plan)

            y, h = fn()
            ey, oky = chip_smoke.max_err(torch, y, y64.to(y.dtype), Y_TOL)
            eh, okh = chip_smoke.max_err(torch, h, h64, STATE_TOL)
            label = (f"B={B} S={S} " + (f"pb={plan.pb} stages={plan.stages}"
                                        if plan.body == "mma" else
                                        "FMA body")
                     + f" grid={plan.grid}")
            record("ssd_scan", label, fn, oky and okh, max(ey, eh),
                   plan == default)

    print("matmul_w8a8: block tiles (bm x bn)")
    for M, K, Nw in W8A8_SHAPES:
        a8, sa = wops.quantize_rows(randn(M, K))
        b8, sb = wops.quantize_rows(randn(K, Nw, scale=0.5), axis=0)
        ref = wops.matmul_w8a8(a8, b8, sa, sb, impl="reference")
        default = mm.launch_plan(M, Nw)
        for tile in mm.TILES:
            plan = mm.launch_plan(M, Nw, tile)

            def fn(plan=plan):
                return mm.matmul_w8a8_cuda(a8, b8, sa, sb, plan=plan)

            out = fn()
            record("matmul_w8a8", f"M={M} K={K} N={Nw} tile={tile} "
                   f"grid={plan.grid}", fn, torch.equal(out, ref),
                   float((out - ref).abs().max()), plan == default)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi, "plans": rows},
                                             indent=1))
    print(smi)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
