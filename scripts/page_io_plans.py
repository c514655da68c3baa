#!/usr/bin/env python3
"""Time the page writer of the bucket insert on one card, in this tree or
in another checkout of the repository.

The shape is one SmolLM-360M admission: an int8 pool of 32 levels x 128
pages of (16, 5, 64), its per-page (scale, zero) rows (5, 2) float32 (40
B), k and v, 8 pages written. Timed: four one-leaf `write_pages` calls
(k, k_sz, v, v_sz: the insert as it was before the grouped launch),
`index_copy_` on the four leaves (the library yardstick) and, where the
tree has the grouped page copy, one grouped call. Each is checked bit
for bit against the plain version first. Device ms per call from
torch.profiler with the L2 flushed
(as `chip_smoke.py` times kernels) and CUDA-events ms per call, which
also counts the host time between launches.

    python3 scripts/page_io_plans.py [--src DIR] [--label NAME] [--out FILE]

`--src` is another checkout's `src` directory (e.g. the parent commit
unpacked under `build/`), so two trees can be timed in one call on one
card: run parent, this tree, this tree, parent. Only the page-copy
library is built. Needs a CUDA card; exits 2 without one."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NB, P, PAGE, KV, D, N_WP = 32, 128, 16, 5, 64, 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the `src` directory of the tree to time")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("page_io_plans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))           # chip_smoke's Timer
    import chip_smoke                       # (puts this tree's src first)

    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build
    from repro_torch.kernels.page_io import ops as pops

    build.SOURCES = ("page_io",)            # the other kernels are unused
    smi = chip_smoke.smi_line()
    print(f"device: {smi}; tree {args.label}: "
          f"{Path(pops.__file__).resolve()}")
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator("cuda").manual_seed(0)

    def leaf(n, shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, (NB, n, *shape), generator=gen,
                                 device="cuda", dtype=torch.int8)
        return torch.randn((NB, n, *shape), generator=gen, device="cuda")

    spec = (((PAGE, KV, D), torch.int8), ((KV, 2), torch.float32)) * 2
    pools = [leaf(P, s, dt) for s, dt in spec]
    tiles = [leaf(N_WP, s, dt) for s, dt in spec]
    phys = torch.randperm(P, generator=gen, device="cuda")[:N_WP].to(
        torch.int32)
    phys64 = phys.long()
    want = [p.clone().index_copy_(1, phys64, t) for p, t in zip(pools, tiles)]

    def four_calls(pl):
        for p, t in zip(pl, tiles):
            pops.write_pages(p, t, phys, impl="cuda")

    calls = {"four one-leaf calls": four_calls,
             "index_copy_ x4": lambda pl: [p.index_copy_(1, phys64, t)
                                           for p, t in zip(pl, tiles)]}
    if hasattr(pops, "write_pages_group"):
        from repro_torch.kernels.page_io import page_io as pio

        calls["grouped call"] = (
            lambda pl: pio.write_pages_cuda(pl, tiles, phys))
    moved = sum(2 * t.numel() * t.element_size() for t in tiles)
    bound_us = (moved + phys.numel() * 4) / chip_smoke.HBM_BYTES_PER_S * 1e6
    rows = []
    for name, fn in calls.items():
        work = [p.clone() for p in pools]
        fn(work)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(work, want))
        us = timer(lambda: fn(work)) * 1e3
        ev_us = timer.last_event_ms * 1e3
        rows.append(dict(tree=args.label, call=name, device_us=us,
                         event_us=ev_us, bound_us=bound_us, exact=ok))
        print(f"  {args.label:10s} {name:22s} device {us:8.3f} us, events "
              f"{ev_us:8.3f} us, byte bound {bound_us:.3f} us "
              f"({bound_us / us:.3f} of it); bit-equal to index_copy_: {ok}")
        if not ok:
            return 1
    print(f"  device times from "
          f"{'torch.profiler' if timer.profiled else 'CUDA events'}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(dict(device=smi, rows=rows)) + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
