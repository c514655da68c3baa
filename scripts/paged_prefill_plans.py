#!/usr/bin/env python3
"""Time the launch plans of the paged chunked-prefill tensor-core kernel
on one card. At SmolLM-360M's chunk shape (B=1, C=128, c0=384, 15/5
heads, D=64, page 16, bf16 q, a 34-page table): rows per block {32, 64}
x key splits {1, 2, 4, 6, 8, 9, 12, 16} for each of the three entry
points. At the other chunk shapes the serving paths give the kernels
(the chunked cell's earlier chunks, c0 0/128/256; the per-token chunk
cell's four chunks; the speculative int8 engine's one-chunk prompts on
a 16-page table): the default plan against no split. Each plan is held
against the plain version at the bf16 tolerance of `chip_smoke.py`.
Prints one line per plan (device ms per call from torch.profiler with
the L2 flushed, as `chip_smoke.py` times kernels, and its split into the
tensor-core kernel, the combine kernel and the op's other kernels) and
the card's name and power limit, and writes the tables as JSON to
`--out`.

    python3 scripts/paged_prefill_plans.py [--out results/paged_prefill_plans.json]

Needs a CUDA card; exits 2 without one."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ROWS = (32, 64)
SPLITS = (1, 2, 4, 6, 8, 9, 12, 16)
KINDS = (("paged_prefill_insert_flash_q8", "int8/page"),
         ("paged_prefill_insert_flash", "bf16"),
         ("paged_prefill_flash", "int8/token"))
B, C, H, KV, D, PAGE = 1, 128, 15, 5, 64, 16
# (kernel, pool, c0, table pages) of the other serving shapes
SHAPES = tuple((kind, pool, c0, 34) for kind, pool in KINDS
               for c0 in (0, 128, 256)) + (
    ("paged_prefill_flash", "int8/token", 0, 16),)


def inputs(torch, gen, pool, c0=384, n_pages=34):
    """One shape's operands: q, pages scattered through a random table,
    and the chunk's K/V (and (scale, zero) rows)."""
    page = PAGE
    P = B * n_pages

    def sz(shape):
        s = torch.rand(shape, generator=gen, device="cuda")
        z = torch.rand(shape, generator=gen, device="cuda") - 0.5
        return torch.stack([0.005 + 0.015 * s, z], -1)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             device="cuda", dtype=torch.int8)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    x = dict(q=randn(B, C, H, D),
             bt=torch.randperm(P, generator=gen, device="cuda").view(
                 B, n_pages).to(torch.int32),
             c0=torch.tensor([c0], dtype=torch.int32, device="cuda"))
    shape = (P, page, KV, D)
    if pool == "bf16":
        x.update(kp=randn(*shape), vp=randn(*shape, scale=0.5),
                 kn=randn(B, C, KV, D), vn=randn(B, C, KV, D, scale=0.5))
    else:
        sz_shape = (P, KV) if pool == "int8/page" else (P, page, KV)
        x.update(kp=i8(*shape), vp=i8(*shape), ksz=sz(sz_shape),
                 vsz=sz(sz_shape), kn=i8(B, C, KV, D), vn=i8(B, C, KV, D),
                 kszn=sz((B, C // page, KV)), vszn=sz((B, C // page, KV)))
    return x


def call(kind, x, impl, plan=None):
    """One call of `kind` on `x` (in place); the kernel with `plan`, or
    the plain version."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import paged_prefill as pp

    if impl == "reference":
        if kind == "paged_prefill_flash":
            return fops.paged_prefill_mha(
                x["q"], x["kp"], x["vp"], x["bt"], x["c0"], k_sz=x.get("ksz"),
                v_sz=x.get("vsz"), impl="reference")
        if kind == "paged_prefill_insert_flash":
            return fops.paged_prefill_insert_mha(
                x["q"], x["kp"], x["vp"], x["kn"], x["vn"], x["bt"], x["c0"],
                impl="reference")[0]
        return fops.paged_prefill_insert_mha_q8(
            x["q"], x["kp"], x["vp"], x["ksz"], x["vsz"], x["kn"], x["vn"],
            x["kszn"], x["vszn"], x["bt"], x["c0"], impl="reference")[0]
    kw = dict(plan=plan)
    if kind == "paged_prefill_flash":
        kw.update(k_sz=x.get("ksz"), v_sz=x.get("vsz"))
    elif kind == "paged_prefill_insert_flash":
        kw.update(k_new=x["kn"], v_new=x["vn"])
    else:
        kw.update(k_sz=x["ksz"], v_sz=x["vsz"], k_new=x["kn"],
                  v_new=x["vn"], ksz_new=x["kszn"], vsz_new=x["vszn"])
    return pp._launch(kind, x["q"], x["kp"], x["vp"], x["bt"], x["c0"],
                      **kw)


def kernel_ms(torch, timer, fn) -> dict:
    """Device ms per call of the tensor-core kernel ('mma'), the combine
    kernel and everything else the op launches, from torch.profiler with
    the L2 flushed before each call."""
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
        key = ("mma" if "paged_prefill_mma_kernel" in e.name else
               "combine" if "paged_prefill_combine" in e.name else "other")
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / timer.reps for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("paged_prefill_plans: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.flash_attention import paged_prefill as pp

    smi = chip_smoke.smi_line()
    print(f"device: {smi}")
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator("cuda").manual_seed(0)

    def measure(kind, pool, x, ref, plan, c0, n_pages, default):
        a = {k: v.clone() for k, v in x.items()}
        out = call(kind, a, "cuda", plan)
        err, ok = chip_smoke.max_err(torch, out, ref, chip_smoke.BF16_TOL)
        ms = timer(lambda: call(kind, a, "cuda", plan))
        by_kernel = kernel_ms(torch, timer, lambda: call(kind, a, "cuda",
                                                         plan))
        print(f"  {kind:30s} c0={c0} pages={n_pages} rows={plan.rows} "
              f"n_split={plan.n_split} grid={plan.grid} ms={ms:.4f} "
              f"event_ms={timer.last_event_ms:.4f} "
              f"mma={by_kernel.get('mma', 0):.4f} "
              f"combine={by_kernel.get('combine', 0):.4f} "
              f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}"
              f"{' (default plan)' if default else ''}")
        return dict(kernel=kind, pool=pool, c0=c0, n_pages=n_pages,
                    rows=plan.rows, n_split=plan.n_split,
                    grid=list(plan.grid), smem_bytes=plan.smem_bytes,
                    ms=ms, event_ms=timer.last_event_ms,
                    kernel_ms=by_kernel, max_abs_err=err, ok=ok,
                    default=default)

    def plans(x, n_pages, rows, splits):
        """The default plan and the given ones, clamped splits once."""
        args = (B, C, H, KV, D, PAGE, n_pages, x["kp"].dtype)
        default = pp._mma_plan(*args)
        seen = set()
        for r in rows:
            for n in splits:
                plan = pp._mma_plan(*args, rows=r, n_split=n)
                if (plan.rows, plan.n_split) not in seen:
                    seen.add((plan.rows, plan.n_split))
                    yield plan, plan == default

    table = []
    print("main shape (c0=384, 34 pages): rows x key splits")
    for kind, pool in KINDS:
        x = inputs(torch, gen, pool)
        ref = call(kind, {k: v.clone() for k, v in x.items()}, "reference")
        for plan, default in plans(x, 34, ROWS, SPLITS):
            table.append(measure(kind, pool, x, ref, plan, 384, 34,
                                 default))
    shapes = []
    print("other serving shapes: the default plan against no split")
    for kind, pool, c0, n_pages in SHAPES:
        x = inputs(torch, gen, pool, c0=c0, n_pages=n_pages)
        ref = call(kind, {k: v.clone() for k, v in x.items()}, "reference")
        for plan, default in plans(x, n_pages, (pp.ROWS,), (None, 1)):
            shapes.append(measure(kind, pool, x, ref, plan, c0, n_pages,
                                  default))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi, "plans": table, "shapes": shapes}, indent=1))
    print(smi)
    return 0 if all(r["ok"] for r in table + shapes) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
