"""The paper's end-to-end quantitative workflow (Fig 4) as one API (port
of `repro.core.quantify`).

    analyze(arch, shape) ->
      level1: intrinsic — footprint, per-step traffic, arithmetic
              intensity, bandwidth-capacity curve
      level2: multi-tier — placement under a policy/pool_fraction,
              R_cap/R_access/R_bw corridor check, predicted memory time
      level3: pooling — sensitivity(LoI) table, interference coefficient

Byte counts come from the analytic access model (`core.access`) over the
train or serve state's meta tensors, scaled per card by `n_chips`;
compute time comes from the port's dry-run record of the cell when one
is given or found (`launch.dryrun`, its roofline's `t_compute_s`: the
cost model's flops of the port's own step at the H100's bf16 peak),
else from the 6·N·D (train) or 2·N·D (serve) model at the chip's bf16
peak. Unlike the reference, `analyze` prices with the chip and topology
it is given, by default one H100 and `h100_topology(chip)`, and reads
only the port's records (`results/dryrun_torch/`), never the
reference's TPU records. Everything here is
deterministic and cheap: it is the tool a user would run before
requesting a deployment configuration, which is the paper's intent.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

from repro_torch import configs
from repro_torch.common import hw
from repro_torch.common.config import SHAPES
from repro_torch.core import access as acc
from repro_torch.core import interference as itf
from repro_torch.core import placement as plc
from repro_torch.core import roofline as rl
from repro_torch.core import tiers as tr
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime import train as train_rt


@dataclasses.dataclass
class Analysis:
    arch: str
    shape: str
    level1: dict
    level2: dict
    level3: dict
    placement: plc.Placement
    profile: itf.InterferenceProfile


def _profile(cfg, shape, remat: str = "block") -> list[acc.TensorAccess]:
    """Access profile over the meta state of `shape`: the train state
    (params, AdamW moments) for a train shape, else the serve params and,
    for decode, the caches."""
    if shape.kind == "train":
        return acc.train_profile(train_rt.abstract_train_state(cfg), cfg,
                                 shape, remat)
    params = serve_rt.abstract_params(cfg)
    caches = None
    if shape.kind == "decode":
        caches = serve_rt.abstract_caches(
            cfg, shape.global_batch, shape.seq_len,
            enc_len=shape.seq_len if cfg.frontend == "audio_stub" else 0,
        )
    return acc.serve_profile(params, caches, cfg, shape)


def t_compute_for(cfg, shape, n_chips: int, chip: hw.ChipSpec = hw.H100,
                  dryrun_record: Optional[dict] = None) -> float:
    """Seconds of pure compute per step per card: the dry-run record's
    `roofline.t_compute_s` when the record is `ok`, else the chip's bf16
    peak over 6·N·D for a train step over every token, 2·N·D for prefill
    (every prompt token) and decode (one token per sequence)."""
    if dryrun_record and dryrun_record.get("status") == "ok":
        return dryrun_record["roofline"]["t_compute_s"]
    if shape.kind == "train":
        mf = rl.model_flops_train(cfg.active_param_count(), shape.tokens)
    else:
        tokens = (shape.tokens if shape.kind == "prefill"
                  else shape.global_batch)
        mf = rl.model_flops_decode(cfg.active_param_count(), tokens)
    return mf / n_chips / chip.peak_flops_bf16


DRYRUN_DIR = os.path.join("results", "dryrun_torch")


def load_dryrun_record(arch: str, shape: str, mesh: str = "1",
                       outdir: str = DRYRUN_DIR) -> Optional[dict]:
    """The port's dry-run record of a cell (`launch.dryrun`), None when
    there is none."""
    p = os.path.join(outdir, f"{configs.canonical(arch)}_{shape}_{mesh}.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


# the record a number of cards reads by default: one card's, or the
# reference's production meshes (`launch.mesh.production_mesh`)
MESH_OF_CHIPS = {1: "1", 256: "16x16", 512: "2x16x16"}


def mesh_size(mesh: str) -> int:
    """Cards of a record's mesh name: "1", "16x16", "2x16x16", "DxM"."""
    n = 1
    for part in mesh.split("x"):
        n *= int(part)
    return n


def _check_record(rec: Optional[dict], n_chips: int) -> None:
    """A record prices one rank of the cards it was traced on
    (`launch.dryrun`: mesh "1" for one card, "16x16" ... for a mesh), so
    it serves exactly that many cards."""
    if rec and mesh_size(rec.get("mesh", "1")) != n_chips:
        raise ValueError(
            f"a dry-run record over mesh {rec.get('mesh', '1')} "
            f"({mesh_size(rec.get('mesh', '1'))} cards) cannot price "
            f"{n_chips} cards")


HBM_STATE_BUDGET = 0.6  # fraction of HBM available for resident state


def analyze(
    arch: str,
    shape_name: str,
    *,
    policy: str = "hotness",
    pool_fraction="auto",
    chip: hw.ChipSpec = hw.H100,
    topo: Optional[tr.TierTopology] = None,
    n_chips: int = 1,
    dryrun_record: Optional[dict] = None,
    use_dryrun: bool = True,
    mesh: Optional[str] = None,
) -> Analysis:
    """pool_fraction: float = paper-style emulated R_cap stress test;
    "auto" = pool-by-necessity (whatever exceeds the per-card HBM budget
    goes to the pool — the actual adoption scenario). The state is
    sharded over `n_chips` cards of `chip`, each with `topo` (default
    `h100_topology(chip)`). With `use_dryrun` and no `dryrun_record`,
    the port's record of the cell over `mesh` is read when one exists:
    `mesh` defaults to the name of `n_chips` cards (`MESH_OF_CHIPS`: 1
    -> "1", 256 -> "16x16", 512 -> "2x16x16"; no record is read for
    another count), and its size must be `n_chips`. A record's
    `t_compute_s` is one card's."""
    mesh = mesh or MESH_OF_CHIPS.get(n_chips)
    if dryrun_record is None and use_dryrun and mesh is not None:
        dryrun_record = load_dryrun_record(arch, shape_name, mesh)
    _check_record(dryrun_record, n_chips)
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    topo = topo or tr.h100_topology(chip)

    profile = _profile(cfg, shape)
    # per-card scaling: state is sharded across the cards
    profile = [
        dataclasses.replace(a, bytes=max(a.bytes // n_chips, 1))
        for a in profile
    ]

    total_bytes = sum(a.bytes for a in profile)
    if pool_fraction == "auto":
        budget = HBM_STATE_BUDGET * chip.hbm_bytes
        pool_fraction = max(0.0, min(0.95, 1.0 - budget / total_bytes))
        if pool_fraction == 0.0:
            policy = "all_local"
    total_traffic = sum(a.traffic for a in profile)
    t_comp = t_compute_for(cfg, shape, n_chips, chip, dryrun_record)
    flops_per_chip = t_comp * chip.peak_flops_bf16
    ai = flops_per_chip / max(total_traffic, 1)
    xs, ys = acc.bandwidth_capacity_curve(profile)

    level1 = {
        "footprint_bytes_per_chip": total_bytes,
        "traffic_bytes_per_step_per_chip": total_traffic,
        "arithmetic_intensity": ai,
        "bwcap_curve": (xs.tolist(), ys.tolist()),
        "hot50": float(ys[min(range(len(xs)),
                              key=lambda i: abs(xs[i] - 0.5))]),
    }

    topo_e = tr.emulated(pool_fraction, total_bytes, base=topo)
    placement = plc.place(profile, topo_e, policy, pool_fraction)
    level2 = {
        "policy": policy,
        "pool_fraction": pool_fraction,
        **plc.corridor_check(placement),
        "t_memory_s": placement.t_memory,
        "slowdown_vs_all_hbm": placement.slowdown,
        "multi_tier_bw": rl.multi_tier_bandwidth(
            [1 - placement.r_access_pool, placement.r_access_pool],
            [topo_e.local.bandwidth, topo_e.pool.bandwidth],
        ),
    }

    iprof = itf.profile_from_placement(arch, shape_name, placement, t_comp,
                                       topo_e)
    level3 = {
        "sensitivity": {
            f"loi_{int(100 * l)}": iprof.sensitivity(l)
            for l in (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
        },
        "interference_coefficient": iprof.interference_coefficient(),
        "injected_loi": iprof.injected_loi(),
    }
    return Analysis(arch, shape_name, level1, level2, level3, placement,
                    iprof)


@functools.lru_cache(maxsize=None)
def _profile_for_cached(arch, shape_name, policy, pool_fraction, chip, topo,
                        n_chips, use_dryrun) -> itf.InterferenceProfile:
    return analyze(arch, shape_name, policy=policy,
                   pool_fraction=pool_fraction, chip=chip, topo=topo,
                   n_chips=n_chips, use_dryrun=use_dryrun).profile


def profile_for(arch: str, shape_name: str = "decode_32k", *,
                policy: str = "hotness", pool_fraction="auto",
                chip: hw.ChipSpec = hw.H100,
                topo: Optional[tr.TierTopology] = None,
                n_chips: int = 1,
                use_dryrun: bool = False) -> itf.InterferenceProfile:
    """Submission-time interference profile for a catalog workload, priced
    as `analyze` prices it (`n_chips` cards of `chip`, each with `topo`;
    one H100 by default; the cell's dry-run record with `use_dryrun`):
    what the paper's §7.2 SLURM plugin would compute once per (arch,
    shape) when the job template is registered, cached (arguments
    canonicalized here so kwarg spelling at call sites cannot split the
    cache)."""
    return _profile_for_cached(arch, shape_name, policy, pool_fraction,
                               chip, topo, n_chips, use_dryrun)
