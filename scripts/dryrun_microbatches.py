#!/usr/bin/env python3
"""The dry-run's train microbatch table (`launch.dryrun.
TRAIN_MICROBATCHES`), from the port's own cost model.

For each arch, traces the train_4k step (remat by block) on meta tensors
at power-of-two microbatch counts and prints the cost mode's peak
intermediate bytes (`temp_bytes`) of each count it tried, then the least
count whose temp bytes stay within the budget (half of one H100's 80 GB
by default). Where no count does (the state-sized intermediates of the
update, the grads and their accumulator, do not shrink with the count),
the least count at which the temp bytes reach their floor, the bytes at
256 microbatches (one sequence each). The temp bytes fall as the count
rises, so the counts are bisected.

    PYTHONPATH=src python scripts/dryrun_microbatches.py \\
        [--arch smollm_360m ...] [--budget-gb 40]

With more than one arch, the archs are fitted in spawned processes, at most
one per core.

Nothing is allocated: the state and the batch are meta tensors.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

COUNTS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def fit(arch: str, budget: float) -> tuple:
    """(arch, {count: temp bytes} of the counts tried, least count within
    the budget)."""
    from repro_torch import configs
    from repro_torch.common.config import SHAPES
    from repro_torch.launch import dryrun

    cfg, shape = configs.get(arch), SHAPES["train_4k"]
    temps: dict = {}

    def temp(k: int) -> int:
        if k not in temps:
            cost, _, _, _ = dryrun.cell_cost(cfg, shape, remat="block",
                                             microbatches=k)
            temps[k] = cost.temp_bytes
        return temps[k]

    def least(limit: float) -> int:
        lo, hi = 0, len(COUNTS) - 1      # COUNTS[hi] is the answer so far
        while lo < hi:
            mid = (lo + hi) // 2
            if temp(COUNTS[mid]) <= limit:
                hi = mid
            else:
                lo = mid + 1
        return COUNTS[hi]

    floor = temp(COUNTS[-1])
    k = least(budget) if floor <= budget else least(floor)
    return arch, temps, k


def main(argv=None) -> None:
    from repro_torch import configs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--budget-gb", type=float, default=40.0)
    args = ap.parse_args(argv)
    archs = args.arch or configs.list_archs()
    budget = args.budget_gb * 1e9
    if len(archs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(len(archs), len(os.sched_getaffinity(0))),
                mp_context=ctx) as pool:
            rows = list(pool.map(fit, archs, [budget] * len(archs)))
    else:
        rows = [fit(a, budget) for a in archs]
    for arch, temps, k in rows:
        tried = ", ".join(f"{c}: {t / 1e9:.2f} GB"
                          for c, t in sorted(temps.items()))
        print(f"{arch}: {k} microbatches (temp bytes by count: {tried})")
    print("TRAIN_MICROBATCHES = {")
    for arch, _, k in rows:
        print(f'    "{arch}": {k},')
    print("}")


if __name__ == "__main__":
    main()
