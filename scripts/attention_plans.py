#!/usr/bin/env python3
"""Time the launch options of the flash-attention forward and the split
decode on one card, each against its default plan.

- flash_mha (bf16, causal, 15/5 heads, D=64, SmolLM-360M's bucket
  prefill): row slots per block {16, 32, 64} x key splits {1, 2, 3, 4, 8} at
  Sq = Skv in {64, 128, 512}; at paligemma-3b's prefix + prompt (B=1,
  S=384, 8/1 heads, D=256) every (rows, key groups) of
  `flash_attention.mma_options` x the same splits.
- paged_flash_decode (B=8, int8/page pool, page 16, 16 pages, lengths
  70..257) and flash_decode (B=8, S=256, bf16, lengths 129..160): spans
  of {32, 64, 128, 256} key positions; 256 holds the whole capacity, so
  it is the body without a split (one block per slot and KV head).
  The same spans at paligemma-3b's paged decode (B=8, int8/page, 8/1
  heads, D=256, lengths 320..400) and, with the lse, at qwen2.5-32b's
  16x16 rank (B=8, 40/8 heads, D=128, S=2048) and a 16384-position
  block (B=1), there also the span caps {8, 16, 32, 64, 128} (spans a
  slot uses at most, `kMaxSpans` in `csrc/decode_body.cuh`): each cap
  but the built one times a copy of the contiguous decode's library
  compiled with that constant, under build/attention_plans/, with the
  launch plan's `MAX_SPANS` set to match.

Each plan is held against the plain version at the bf16 tolerance of
`chip_smoke.py`. Prints one line per plan (device ms per call from
torch.profiler with the L2 flushed, as `chip_smoke.py` times kernels, and
its split into the main kernel and the rest the op launches) and the
card's name and power limit, and writes the tables as JSON to `--out`.

    python3 scripts/attention_plans.py [--only flash|decode]
        [--out results/attention_plans.json]

Needs a CUDA card; exits 2 without one."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

H, KV, D = 15, 5, 64
FLASH_SQ = (64, 128, 512)
FLASH_SPLITS = (1, 2, 3, 4, 8)
SPANS = (32, 64, 128, 256)
MAX_SPANS = (8, 16, 32, 64, 128)
CAP_DIR = ROOT / "build" / "attention_plans"
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


def cap_libraries(build, caps) -> dict:
    """{cap: the contiguous decode's library compiled with kMaxSpans =
    cap}, built in parallel from copies of the sources."""
    procs = {}
    for cap in caps:
        out = CAP_DIR / f"cap{cap}"
        out.mkdir(parents=True, exist_ok=True)
        for f in build.CSRC.glob("*.cuh"):
            text = f.read_text()
            if f.name == "decode_body.cuh":
                text, n = re.subn(r"constexpr int kMaxSpans = \d+;",
                                  f"constexpr int kMaxSpans = {cap};", text)
                assert n == 1, "kMaxSpans not found in decode_body.cuh"
            (out / f.name).write_text(text)
        src = out / "decode_attention.cu"
        src.write_text((build.CSRC / "decode_attention.cu").read_text())
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(out / "libdecode_attention.so"), str(src)]
        procs[cap] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for cap, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the cap {cap} copy:\n{log}")
        libs[cap] = ctypes.CDLL(
            str(CAP_DIR / f"cap{cap}" / "libdecode_attention.so"))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("flash", "decode"), default=None,
                    help="time only the flash_mha or the decode options")
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

    def flash_options(label, Sq, H_, KV_, D_):
        """Every rows x key splits plan the body takes at this shape."""
        print(f"flash_mha: rows x key splits ({label}: bf16 causal, B=1, "
              f"Sq=Skv={Sq}, {H_}/{KV_} heads, D={D_})")
        q, k = randn(1, Sq, H_, D_), randn(1, Sq, KV_, D_)
        v = randn(1, Sq, KV_, D_, scale=0.5)
        ref = fref.mha(q, k, v)
        default = fa.launch_plan(1, Sq, Sq, H_, KV_, D_, torch.bfloat16)
        seen = set()
        for r, kg in fa.mma_options(D_):
            for n in FLASH_SPLITS:
                plan = fa._mma_plan(1, Sq, Sq, H_, KV_, D_, rows=r,
                                    n_split=n, key_groups=kg)
                if plan.smem_bytes > fa.SMEM_LIMIT or plan in seen:
                    continue
                seen.add(plan)
                measure("flash_mha", f"{label} rows={plan.rows} "
                        f"kg={plan.key_groups} n_split={plan.n_split} "
                        f"grid={plan.grid}",
                        lambda plan=plan: fa.flash_mha_cuda(q, k, v,
                                                            plan=plan),
                        ref, plan == default)

    if args.only != "decode":
        for Sq in FLASH_SQ:
            flash_options("smollm", Sq, H, KV, D)
        flash_options("paligemma prefix+prompt", 384, 8, 1, 256)
    if args.only == "flash":
        return finish(args, smi, rows)
    from repro_torch.kernels import build

    build.library("decode_attention")
    cap_libs = cap_libraries(build, [c for c in MAX_SPANS
                                     if c != dpaged.MAX_SPANS])

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
    print("paged_flash_decode: spans (paligemma-3b: B=8, int8/page, 8/1 "
          "heads, D=256, page 16, 26 pages, lengths 320..400)")
    Hg, KVg, Dg, n_pg = 8, 1, 256, 26
    Pg = B * n_pg
    qg = randn(B, Hg, Dg)
    btg = torch.stack([torch.randperm(Pg, generator=gen, device="cuda")
                       [:n_pg] for _ in range(B)]).to(torch.int32)
    kpg, vpg = (torch.randint(-127, 128, (Pg, page, KVg, Dg), generator=gen,
                              device="cuda", dtype=torch.int8)
                for _ in range(2))
    szg = [torch.stack([0.005 + 0.015 * torch.rand((Pg, KVg), generator=gen,
                                                   device="cuda"),
                        torch.rand((Pg, KVg), generator=gen, device="cuda")
                        - 0.5], -1) for _ in range(2)]
    lg = torch.tensor([320, 330, 340, 350, 360, 370, 380, 400],
                      dtype=torch.int32, device="cuda")
    ref = dops.paged_decode_mha(qg, kpg, vpg, btg, lg, k_sz=szg[0],
                                v_sz=szg[1], impl="reference")
    default = dpaged.decode_plan(B, Hg, KVg, Dg, n_pg * page, torch.int8)
    for span in SPANS:
        measure("paged_flash_decode", f"paligemma span={span}",
                lambda span=span: dpaged.paged_flash_decode_cuda(
                    qg, kpg, vpg, btg, lg, k_sz=szg[0], v_sz=szg[1],
                    span=span),
                ref, span == default.span)

    # the lse variant's long shapes: qwen2.5-32b's 16x16 rank (B 8, S_loc
    # 2048) and a 16384-position block (B 1)
    for label, Bl, Hl, KVl, Dl, Sl, lengths in chip_smoke.LSE_SHAPES[1:]:
        print(f"flash_decode lse: spans ({label}: B={Bl}, {Hl}/{KVl} heads, "
              f"D={Dl}, S={Sl}, bf16)")
        ql = randn(Bl, Hl, Dl)
        kl, vl = randn(Bl, Sl, KVl, Dl), randn(Bl, Sl, KVl, Dl, scale=0.5)
        ll = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        ref = dops.decode_mha(ql, kl, vl, ll, impl="reference")
        for span in SPANS:
            measure("flash_decode_lse", f"{label} span={span}",
                    lambda span=span, ql=ql, kl=kl, vl=vl, ll=ll:
                    da.flash_decode_cuda(ql, kl, vl, ll, span=span,
                                         return_lse=True),
                    ref, span == dpaged.SPAN)
        built, lib = dpaged.MAX_SPANS, build._LIBS["decode_attention"]
        for cap in MAX_SPANS:
            dpaged.MAX_SPANS = cap
            build._LIBS["decode_attention"] = cap_libs.get(cap, lib)
            try:
                measure("flash_decode_lse",
                        f"{label} span=64 max_spans={cap}",
                        lambda ql=ql, kl=kl, vl=vl, ll=ll:
                        da.flash_decode_cuda(ql, kl, vl, ll,
                                             return_lse=True),
                        ref, cap == built)
            finally:
                dpaged.MAX_SPANS = built
                build._LIBS["decode_attention"] = lib
    return finish(args, smi, rows)


def finish(args, smi, rows) -> int:
    """Write the JSON, print the card's line; 0 if every plan agreed."""
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi, "plans": rows},
                                             indent=1))
    print(smi)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
