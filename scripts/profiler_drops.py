#!/usr/bin/env python3
"""Does torch.profiler keep every device kernel of a short timing session,
as a process ages and after a large profiled session?

`chip_smoke.py` times each kernel as the sum of the device kernels that
torch.profiler records over 15 calls (`Timer.device_ms`). This probe
runs such sessions on two subjects, a PyTorch kernel
(`torch.cuda._sleep` for 10^6 clock cycles, about 0.5 ms) and
flash_mha's CUDA backward at SmolLM-360M's train shape (bf16, B 8, S
256, 15 / 5 heads, D 64; three kernels launched through ctypes), and
for each session prints:

- the device kernels recorded, by name, against the 15 calls made;
- how many of them the trace links to a launch call on the host, and
  the median and range of (kernel start - launch start) in microseconds;
- the host and device spans of the session relative to its first host
  event;

first in a fresh process, then after one profiled session of 300k tiny
launches (the serving phases' profiled runs record millions of events),
then every 20 seconds until `--seconds` have passed. Each sample runs
the session three times: as is, with the host idle for 50 ms before the
profiler stops ("end"), and idle for as long after it starts, before
the first call ("start").

    python3 scripts/profiler_drops.py [--seconds 150]

Needs a CUDA card; exits 2 without one."""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS = 15
BURST = 300_000     # launches of the large profiled session
EVERY_S = 20.0      # seconds between samples after it
IDLE_MS = 50.0      # host idle time of the "end" and "start" sessions


def short(name: str) -> str:
    return re.split(r"[<(]", name.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0].split("::")[-1].split()[-1]


def session(torch, fn, flush, pad_ms: float = 0.0, where: str = "") -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if where == "start":
            time.sleep(pad_ms / 1e3)
        for _ in range(REPS):
            flush()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        if where == "end":
            time.sleep(pad_ms / 1e3)
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in evs if e.device_type == cuda
           and "memcpy" not in e.name.lower()]
    host = [e for e in evs if e.device_type != cuda]
    launch = {e.id: e for e in host if "launch" in e.name.lower()}
    offs = [d.time_range.start - launch[d.id].time_range.start
            for d in dev if d.id in launch]
    t0 = min(e.time_range.start for e in host)
    out = {"kernels": dict(collections.Counter(short(e.name) for e in dev)),
           "calls": REPS, "linked": len(offs),
           "host_span_us": [0.0, round(max(e.time_range.end for e in host)
                                       - t0, 1)]}
    if dev:
        out["device_span_us"] = [
            round(min(e.time_range.start for e in dev) - t0, 1),
            round(max(e.time_range.end for e in dev) - t0, 1)]
        out["device_ms_per_call"] = round(sum(
            e.time_range.elapsed_us() for e in dev) / REPS / 1e3, 4)
    if offs:
        out["launch_to_start_us"] = [round(min(offs), 1),
                                     round(statistics.median(offs), 1),
                                     round(max(offs), 1)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import chunked
    from repro_torch.kernels.flash_attention import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    src = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)

    def flush():
        dst.copy_(src)

    gen = torch.Generator("cuda").manual_seed(5)
    B, S, H, KV, D = 8, 256, 15, 5, 64
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out, lse4 = chunked._fwd(q, k, v, True, None, 0, 512, 512)
    lse = lse4.reshape(B, H, S).contiguous()
    subjects = {
        "spin": lambda: torch.cuda._sleep(1_000_000),
        "flash_mha_bwd": lambda: fa.flash_mha_bwd_cuda(
            q, k, v, out, lse, do, causal=True),
    }
    start = time.perf_counter()

    def sample(label):
        for name, fn in subjects.items():
            for where in ("", "end", "start"):
                pad = IDLE_MS if where else 0.0
                rec = session(torch, fn, flush, pad, where)
                print(json.dumps(dict(
                    at_s=round(time.perf_counter() - start, 1),
                    when=label, subject=name, idle_ms=pad,
                    idle_at=where or None, **rec)), flush=True)

    sample("fresh process")
    x = torch.zeros(16, device="cuda")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(BURST):
            x.add_(1)
        torch.cuda.synchronize()
    n = len(prof.events())
    print(f"burst: {BURST} launches profiled, {n} events read, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del prof
    sample("after the burst")
    while time.perf_counter() - start < args.seconds:
        time.sleep(EVERY_S - 2.0)
        sample("later")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
