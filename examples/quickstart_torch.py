"""Quickstart of the PyTorch port: the paper's three-level quantitative
analysis on one arch, priced on H100 cards (the torch twin of
`examples/quickstart.py`; it imports only `repro_torch`).

    PYTHONPATH=src python examples/quickstart_torch.py [arch] [shape]

Level 1 characterizes the workload's intrinsic memory behaviour, Level 2
places its state across HBM/host-pool tiers and checks the R_cap <=
R_access <= R_bw corridor, Level 3 predicts interference sensitivity and
the interference coefficient a scheduler would use. The state is sharded
over 256 cards, each with `core.tiers.h100_topology()`; the
analysis is host arithmetic over the meta parameter and cache trees, so
no card is needed.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.quantify import analyze  # noqa: E402

POLICIES = ("first_touch", "hotness", "balanced_bw")
N_CHIPS = 256


def run(arch: str = "kimi-k2-1t-a32b", shape: str = "decode_32k",
        **analyze_kw) -> dict:
    """Print the three levels of `arch` x `shape` under each placement
    policy at pool fraction 0.5 and return {policy: Analysis};
    `analyze_kw` passes `chip` / `topo` on to `analyze`."""
    out = {}
    for policy in POLICIES:
        a = analyze(arch, shape, policy=policy, pool_fraction=0.5,
                    n_chips=N_CHIPS, **analyze_kw)
        out[policy] = a
        l1, l2, l3 = a.level1, a.level2, a.level3
        print(f"--- policy: {policy} ---")
        print(f"  L1 footprint/chip : {l1['footprint_bytes_per_chip'] / 2**30:8.2f} GiB")
        print(f"  L1 traffic/step   : {l1['traffic_bytes_per_step_per_chip'] / 2**30:8.2f} GiB")
        print(f"  L1 arithmetic int.: {l1['arithmetic_intensity']:8.1f} flop/B")
        print(f"  L1 hot-50% curve  : {l1['hot50'] * 100:8.1f} % of traffic")
        print(f"  L2 R_cap  (pool)  : {l2['r_cap_pool']:8.3f}")
        print(f"  L2 R_access(pool) : {l2['r_access_pool']:8.3f}")
        print(f"  L2 R_bw   (pool)  : {l2['r_bw_pool']:8.3f}")
        print(f"  L2 in corridor    : {l2['in_corridor']}")
        print(f"  L2 mem slowdown   : {l2['slowdown_vs_all_hbm']:8.2f}x vs all-HBM")
        print(f"  L3 sens @ LoI=50% : {l3['sensitivity']['loi_50']:8.3f}")
        print(f"  L3 IC             : {l3['interference_coefficient']:8.3f}")
        print()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="kimi-k2-1t-a32b")
    ap.add_argument("shape", nargs="?", default="decode_32k")
    args = ap.parse_args(argv)
    print(f"=== {args.arch} x {args.shape} on {N_CHIPS}x H100 + host "
          "pool ===\n")
    run(args.arch, args.shape)
    print("reading: hotness should cut R_access vs first_touch; if "
          "R_access >> R_bw the job is pool-link-bound and (per the paper) "
          "should scale out instead of pooling deeper.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
