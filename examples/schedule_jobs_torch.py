"""Interference-aware scheduling example (paper case study 2), rack scale,
on the PyTorch port (`repro_torch`; the twin of `examples/schedule_jobs.py`,
priced on one H100 and its pinned-host pool tier): stream the arch zoo as
jobs into a 2-rack x 2-pool x 3-node cluster, compare FCFS / random /
interference-aware / corridor bin-packing under the event-driven
simulator, then reproduce the Fig 13 Monte-Carlo for the most sensitive
workload. Host numpy only: no card needed.

    python examples/schedule_jobs_torch.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.quantify import profile_for  # noqa: E402
from repro_torch.sched import (  # noqa: E402
    ClusterSpec,
    Job,
    catalog_stream,
    rescale_load,
    run_policies,
    simulate_colocation,
)
from repro_torch.sched.scheduler import five_number_summary  # noqa: E402

# Paper-style emulated R_cap stress: every workload keeps half its working
# set on the pool — with "auto" (pool-by-necessity) only the 1T MoE spills
# and the co-location question disappears.
POOL_FRACTION = 0.5


SHAPES_MIX = ("train_4k", "prefill_32k", "decode_32k")


def main(n_jobs: int = 200, archs=None, out=print) -> dict:
    """Print the zoo's loudest and quietest cells, the policies' slowdown
    table over `n_jobs` catalog jobs and the Fig 13 comparison; returns
    the simulator results by policy."""
    archs = list(archs) if archs is not None else configs.list_archs()
    profiles = {
        (a, s): profile_for(a, s, pool_fraction=POOL_FRACTION)
        for a in archs for s in SHAPES_MIX
    }

    out("workload (loudest and quietest cells)   IC     inj_LoI  sens@50%")
    ranked = sorted(profiles, key=lambda c: -profiles[c].injected_loi())
    for cell in ranked[:4] + ranked[-4:]:
        p = profiles[cell]
        label = f"{cell[0]}:{cell[1]}"
        out(f"{label:38s} {p.interference_coefficient():6.3f} "
            f"{p.injected_loi():8.3f} {p.sensitivity(0.5):8.3f}")

    # --- rack-scale trace: mixed-shape catalog jobs over 4 pools --------
    spec = ClusterSpec(n_racks=2, pools_per_rack=2, nodes_per_pool=3)
    jobs = catalog_stream(n_jobs, seed=0, shapes=SHAPES_MIX, archs=archs,
                          pool_fraction=POOL_FRACTION, work_scale=0.02)
    rescale_load(jobs, spec.total_slots, utilization=0.7)
    results = run_policies(jobs, spec, seed=0)
    out(f"\n{len(jobs)} catalog jobs over {spec.n_pools} pools "
        f"({spec.total_slots} slots):")
    out("policy    mean_slow  var_slow  p95_slow  mean_wait  makespan")
    for name, r in results.items():
        s = r.summary()
        out(f"{name:8s} {s['mean_slowdown']:9.3f} {s['var_slowdown']:9.4f} "
            f"{s['p95_slowdown']:9.3f} {s['mean_wait_s']:9.1f}s "
            f"{s['makespan_s']:8.0f}s")

    # --- paper Fig 13 Monte-Carlo for the most sensitive workload -------
    sensitive = max(profiles, key=lambda c: 1 - profiles[c].sensitivity(0.5))
    job = Job(f"{sensitive[0]}:{sensitive[1]}", profiles[sensitive],
              steps=240)
    base = simulate_colocation(job, 100, loi_range=(0, 0.5), seed=1)
    opt = simulate_colocation(job, 100, loi_range=(0, 0.2), seed=1)
    sb, so = five_number_summary(base), five_number_summary(opt)
    out(f"\nFig13 for most-sensitive workload ({job.name}):")
    out(f"  random: median={sb['median']:.3e}s p75={sb['p75']:.3e}s")
    cut = 100 * (sb["p75"] - so["p75"]) / sb["p75"] if sb["p75"] else 0.0
    out(f"  aware : median={so['median']:.3e}s p75={so['p75']:.3e}s "
        f"({cut:.1f}% p75 cut)")
    return results


if __name__ == "__main__":
    main()
