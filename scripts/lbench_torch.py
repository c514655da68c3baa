"""Paper Fig 11 on the H100: the port's counterpart of
`benchmarks/bench_lbench.py` (it imports only `repro_torch`).

Panels, one `name,us,derived` line per point as the reference prints:
  left   — the LBench kernel on the card for nflop in (1, 2, 4, 8, 16, 32)
           over 2^28 float32 elements (1 GiB; 2 GiB moved per call, 20x
           the 50 MB L2, so the times are HBM's), with the measured GB/s
           and GFLOP/s, `lbench_loi` on the H100 topology and
           `kernel_flops`; then the reference's size, 2^16 elements (256
           KiB), which the L2 holds, labelled as such;
  middle — `lbench_intensity_sweep(h100_topology())`: the modelled pool
           link traffic saturates while the IC keeps resolving;
  right  — IC and injected LoI of `analyze(arch, "decode_32k",
           policy="hotness", pool_fraction="auto")` on one H100 for every
           ported arch.

    python3 scripts/lbench_torch.py                         # on the card
    python3 scripts/lbench_torch.py --device cpu --elements 4096

On the card the kernel times are CUDA-event times over `repeats` calls
after a warm-up call; on the CPU the op takes its plain version and the
times are the host clock's (not a device time). `chip_smoke.py` (phase
quantify) and `tests/test_torch_imports.py` call `run`.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.common import hw  # noqa: E402
from repro_torch.common.device import resolve_device  # noqa: E402
from repro_torch.core import interference as itf  # noqa: E402
from repro_torch.core import tiers as tr  # noqa: E402
from repro_torch.core.quantify import analyze  # noqa: E402
from repro_torch.kernels.lbench import ops as lops  # noqa: E402

HBM_ELEMENTS = 1 << 28
L2_ELEMENTS = 1 << 16          # the reference's size
LEFT_NFLOPS = (1, 2, 4, 8, 16, 32)


def timed(fn, device: torch.device, repeats: int = 10):
    """(result, mean microseconds per call) of `fn` after one warm-up
    call: CUDA events around `repeats` back-to-back calls on the card,
    the host clock elsewhere."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) * 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    return out, (time.perf_counter() - t0) * 1e6 / repeats


def emit(name: str, us: float, derived: str) -> str:
    line = f"{name},{us:.1f},{derived}"
    print(line)
    return line


def lbench_point(a: torch.Tensor, nflop: int, repeats: int = 10) -> dict:
    """Time the LBench op over `a` at `nflop`: us per call, GB/s and
    GFLOP/s from the bytes and flops its model counts."""
    out, us = timed(lambda: lops.lbench(a, nflop), a.device, repeats)
    n = a.numel()
    return {"nflop": nflop, "elements": n, "us": us, "out": out,
            "gbps": lops.bytes_moved(n) / us / 1e3,
            "gflops": lops.flops(n, nflop) / us / 1e3}


def run(device=None, n_elements: int = HBM_ELEMENTS,
        l2_elements: int = L2_ELEMENTS, seed: int = 0,
        repeats: int = 10) -> list[dict]:
    """All three panels; returns their rows (the left panel's without
    the output tensors)."""
    device = resolve_device(device)
    topo = tr.h100_topology()
    gen = torch.Generator(device).manual_seed(seed)
    rows = []
    for label, n in (("", n_elements), ("_l2", l2_elements)):
        a = torch.randn(n, generator=gen, device=device)
        where = ("L2-resident" if lops.bytes_moved(n) <= hw.H100.l2_bytes
                 else "HBM-resident") if device.type == "cuda" \
            else f"{device.type}, plain version"
        for nflop in LEFT_NFLOPS:
            p = lbench_point(a, nflop, repeats)
            p.pop("out")
            loi = itf.lbench_loi(nflop, n, topo)
            emit(f"fig11_lbench{label}_nflop{nflop}", p["us"],
                 f"loi={loi:.3f} ai={nflop / 8:.3f}flop/B "
                 f"kernel_flops={lops.flops(n, nflop)} elements={n} "
                 f"gbps={p['gbps']:.1f} gflops={p['gflops']:.1f} "
                 f"[{where}]")
            rows.append({"panel": "left", "loi": loi, **p})
        del a
    for r in itf.lbench_intensity_sweep(topo):
        emit(f"fig11_saturation_nflop{r['nflop']}", 0.0,
             f"pcm_bw={r['pcm_bw'] / 1e9:.1f}GB/s ic={r['ic']:.2f}")
        rows.append({"panel": "middle", **r})
    for arch in configs.list_archs():
        t0 = time.perf_counter()
        an = analyze(arch, "decode_32k", policy="hotness",
                     pool_fraction="auto")
        us = (time.perf_counter() - t0) * 1e6
        ic = an.level3["interference_coefficient"]
        inj = an.level3["injected_loi"]
        emit(f"fig11_ic_{arch}", us, f"ic={ic:.3f} injected_loi={inj:.3f}")
        rows.append({"panel": "right", "arch": arch, "ic": ic,
                     "injected_loi": inj})
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise FloatingPointError(f"non-finite {k} in {r}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--elements", type=int, default=HBM_ELEMENTS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.device, n_elements=args.elements, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
