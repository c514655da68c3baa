#!/usr/bin/env python3
"""Time the launch options of the flash-attention forward and the split
decode on one card, each against its default plan.

- flash_mha (bf16, causal, 15/5 heads, D=64, SmolLM-360M's bucket
  prefill): row slots per block {16, 32, 64} x key splits {1, 2, 3, 4, 8} at
  Sq = Skv in {64, 128, 512}.
- paged_flash_decode (B=8, int8/page pool, page 16, 16 pages, lengths
  70..257) and flash_decode (B=8, S=256, bf16, lengths 129..160): spans
  of {32, 64, 128, 256} key positions; 256 holds the whole capacity, so
  it is the body without a split (one block per slot and KV head).

Each plan is held against the plain version at the bf16 tolerance of
`chip_smoke.py`. Prints one line per plan (device ms per call from
torch.profiler with the L2 flushed, as `chip_smoke.py` times kernels, and
its split into the main kernel and the rest the op launches) and the
card's name and power limit, and writes the tables as JSON to `--out`.

    python3 scripts/attention_plans.py [--out results/attention_plans.json]

Needs a CUDA card; exits 2 without one."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

H, KV, D = 15, 5, 64
FLASH_SQ = (64, 128, 512)
FLASH_ROWS = (16, 32, 64)
FLASH_SPLITS = (1, 2, 3, 4, 8)
SPANS = (32, 64, 128, 256)
MAIN_KERNELS = ("flash_mma_kernel", "decode_split_kernel")


def kernel_ms(torch, timer, fn) -> dict:
    """Device ms per call of the op's main kernel ('kernel') and of
    everything else it launches ('other'), from torch.profiler with the
    L2 flushed before each call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(timer.reps):
            timer._flush()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                "memcpy" in e.name.lower():
            continue
        key = ("kernel" if any(k in e.name for k in MAIN_KERNELS)
               else "other")
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / timer.reps for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("attention_plans: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import paged as dpaged
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref

    smi = chip_smoke.smi_line()
    print(f"device: {smi}")
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator("cuda").manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    rows = []

    def measure(name, label, fn, ref, default):
        out = fn()
        out = out[0] if isinstance(out, tuple) else out
        err, ok = chip_smoke.max_err(torch, out, ref, chip_smoke.BF16_TOL)
        ms = timer(fn)
        by_kernel = kernel_ms(torch, timer, fn)
        print(f"  {name:18s} {label:34s} ms={ms:.4f} "
              f"event_ms={timer.last_event_ms:.4f} "
              f"kernel={by_kernel.get('kernel', 0):.4f} "
              f"other={by_kernel.get('other', 0):.4f} "
              f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}"
              f"{' (default plan)' if default else ''}")
        rows.append(dict(kernel=name, plan=label, ms=ms,
                         event_ms=timer.last_event_ms, kernel_ms=by_kernel,
                         max_abs_err=err, ok=ok, default=default))

    print("flash_mha: rows x key splits (bf16 causal, B=1, 15/5 heads, "
          "D=64)")
    for Sq in FLASH_SQ:
        q, k = randn(1, Sq, H, D), randn(1, Sq, KV, D)
        v = randn(1, Sq, KV, D, scale=0.5)
        ref = fref.mha(q, k, v)
        default = fa.launch_plan(1, Sq, Sq, H, KV, D, torch.bfloat16)
        seen = set()
        for r in FLASH_ROWS:
            for n in FLASH_SPLITS:
                plan = fa._mma_plan(1, Sq, Sq, H, KV, D, rows=r, n_split=n)
                if (plan.rows, plan.n_split) in seen:
                    continue
                seen.add((plan.rows, plan.n_split))
                measure("flash_mha", f"Sq={Sq} rows={plan.rows} "
                        f"n_split={plan.n_split} grid={plan.grid}",
                        lambda plan=plan: fa.flash_mha_cuda(q, k, v,
                                                            plan=plan),
                        ref, plan == default)

    print("paged_flash_decode: spans (B=8, int8/page, page 16, 16 pages, "
          "lengths 70..257; span 256 = no split)")
    B, page, n_pages = 8, 16, 16
    P = B * n_pages
    qd = randn(B, H, D)
    bt = torch.stack([torch.randperm(P, generator=gen, device="cuda")
                      [:n_pages] for _ in range(B)]).to(torch.int32)
    kp = torch.randint(-127, 128, (P, page, KV, D), generator=gen,
                       device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, (P, page, KV, D), generator=gen,
                       device="cuda", dtype=torch.int8)

    def sz():
        s = torch.rand((P, KV), generator=gen, device="cuda")
        z = torch.rand((P, KV), generator=gen, device="cuda") - 0.5
        return torch.stack([0.005 + 0.015 * s, z], -1)

    ksz, vsz = sz(), sz()
    lens = torch.tensor([70, 100, 129, 160, 200, 240, 256, 257],
                        dtype=torch.int32, device="cuda")
    ref = dops.paged_decode_mha(qd, kp, vp, bt, lens, k_sz=ksz, v_sz=vsz,
                                impl="reference")
    for span in SPANS:
        measure("paged_flash_decode", f"span={span}",
                lambda span=span: dpaged.paged_flash_decode_cuda(
                    qd, kp, vp, bt, lens, k_sz=ksz, v_sz=vsz, span=span),
                ref, span == dpaged.SPAN)

    print("flash_decode: spans (B=8, S=256, bf16, lengths 129..160; span "
          "256 = no split)")
    S = 256
    k, v = randn(B, S, KV, D), randn(B, S, KV, D, scale=0.5)
    lens = torch.tensor([129, 133, 137, 141, 145, 150, 155, 160],
                        dtype=torch.int32, device="cuda")
    ref = dops.decode_mha(qd, k, v, lens, impl="reference")
    for span in SPANS:
        measure("flash_decode", f"span={span}",
                lambda span=span: da.flash_decode_cuda(qd, k, v, lens,
                                                       span=span),
                ref, span == dpaged.SPAN)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi, "plans": rows},
                                             indent=1))
    print(smi)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
