"""Serving launcher: continuous-batching engine over tier-aware KV paging
(port of `repro.launch.serve`).

    # scenario mode (the engine's native shape)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --scenario chat --requests 16 --slots 4

    # classic one-shot batch: `--batch` requests of the same prompt
    # length arrive at t=0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 32 --gen 16

    # fleet mode: N engines behind the FleetRouter
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --scenario chat --fleet 2 --roles --prefill-chunk 16

Every mode runs `repro_torch.serving.ServingEngine` (bucketed prefill,
slot-batched greedy decode with per-slot positions, the page-grain
tier-aware KV pager, M/D/1-knee admission control) or N of them behind
`serving.fleet.FleetRouter`. It runs on the card unless `--device`
names another (`--device cpu --reduced` is the CPU smoke configuration).
The reference's flags, plus `--device`; one device, where the
reference's launcher builds a (1, 1) smoke mesh (the engine over a mesh
of ranks: `ServingEngine.build(mesh=...)`, `scripts/dev_serve_torch.py
--mesh`). The
reference's compile-count check does not apply to eager cells: the
launcher says so and prints no stand-in count.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch import configs
from repro_torch.common.device import resolve_device
from repro_torch.serving import (
    EngineConfig,
    Request,
    ServingEngine,
    fleet,
    make_scenario,
)


def burst_requests(n: int, prompt_len: int, gen: int, vocab: int,
                   seed: int) -> list:
    """The old launcher's shape: n identical-length prompts at t=0."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            request_id=i,
            tokens=rng.integers(0, vocab, size=prompt_len).astype(np.int32),
            max_new_tokens=gen,
            arrival=0.0,
        )
        for i in range(n)
    ]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # classic one-shot batch
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    # scenario mode
    ap.add_argument("--scenario", default=None,
                    choices=["chat", "long_context", "bursty",
                             "shared_prefix", "multi_tenant"])
    ap.add_argument("--requests", type=int, default=16)
    # fleet mode
    ap.add_argument("--fleet", type=int, default=0,
                    help="run N engines behind the FleetRouter "
                    "(0 = single-engine path)")
    ap.add_argument("--policy", default="round_robin",
                    choices=list(fleet.POLICIES),
                    help="fleet placement policy")
    ap.add_argument("--roles", action="store_true",
                    help="disaggregated prefill/decode roles (fleet "
                    "mode; needs --prefill-chunk)")
    ap.add_argument("--autoscale-min", type=int, default=0,
                    help="fleet autoscaling: start/min engine count "
                    "(0 = autoscaling off; max is --fleet)")
    # engine knobs
    ap.add_argument("--slots", type=int, default=0,
                    help="0 = match --batch (one-shot) / 4 (scenario)")
    ap.add_argument("--pager", default="hotness",
                    choices=["hotness", "static", "none"])
    ap.add_argument("--contiguous", action="store_true",
                    help="per-slot contiguous caches instead of the "
                    "paged physical page pool")
    ap.add_argument("--pool-dtype", default=None,
                    choices=["int8", "fp"],
                    help="paged pool payload (default: engine default, "
                    "int8; --contiguous forces fp)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="interleave prompt chunks of this many tokens "
                    "with decode steps (paged, attention-only archs; "
                    "0 = serialized whole-prompt prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix radix cache in every engine "
                    "(paged, attention-only archs)")
    ap.add_argument("--local-budget", type=float, default=0.5,
                    help="local-tier budget as a fraction of peak KV bytes")
    ap.add_argument("--admission", default="loi",
                    choices=["loi", "greedy"])
    return ap


@dataclasses.dataclass
class Launch:
    """What `argv` asks for: the model, the engine's (and the fleet's)
    configuration, the request trace and the device."""

    args: Any
    cfg: Any
    ecfg: EngineConfig
    fcfg: Optional[Any]
    reqs: list
    device: Any


def setup(argv=None) -> Launch:
    """Parse `argv` into a `Launch` (the reference's argument checks and
    `ap.error`s included); builds nothing on the device."""
    ap = _parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(
        args.arch)

    if args.scenario:
        n_slots = args.slots or 4
        buckets = {
            "long_context": (128,),
            "shared_prefix": (32,),
            "multi_tenant": (16, 32, 64),
        }.get(args.scenario, (16, 32))
        max_seq = max(buckets) + 64
        # arrival processes scaled to the virtual clock (µs-scale steps on
        # reduced models) so requests actually overlap in flight
        scenario_kw = {
            "chat": dict(prompt_buckets=buckets, arrival_rate=2e4),
            "long_context": dict(prompt_bucket=buckets[0],
                                 arrival_rate=5e3),
            "bursty": dict(prompt_buckets=buckets, burst_size=n_slots + 2,
                           burst_gap=1e-4),
            "shared_prefix": dict(prompt_buckets=buckets,
                                  system_tokens=16, n_systems=2,
                                  arrival_rate=2e4),
            "multi_tenant": dict(interactive_buckets=buckets[:2],
                                 batch_bucket=buckets[-1],
                                 arrival_rate=2e4, batch_gap=1e-4),
        }[args.scenario]
        reqs = make_scenario(
            args.scenario, args.requests, cfg.vocab_size, seed=args.seed,
            **scenario_kw,
        )
    else:
        n_slots = args.slots or args.batch
        buckets = (args.prompt_len,)
        max_seq = args.prompt_len + args.gen
        reqs = burst_requests(
            args.batch, args.prompt_len, args.gen, cfg.vocab_size,
            args.seed,
        )

    page_tokens = max(8, max_seq // 16)
    if args.prefill_chunk and args.contiguous:
        ap.error("--prefill-chunk needs the paged layout; drop "
                 "--contiguous")
    if args.prefill_chunk:
        # chunks scatter whole pages through the block table: pin the
        # page grain to 8 (every bucket is a multiple) and round the
        # chunk up to whole pages
        page_tokens = 8
        args.prefill_chunk = -(-args.prefill_chunk // page_tokens) \
            * page_tokens
        bad = [b for b in buckets if b % args.prefill_chunk]
        if bad:
            ok = sorted({c for c in (8, 16, 32, 64)
                         if not any(b % c for b in buckets)})
            ap.error(
                f"--prefill-chunk {args.prefill_chunk} (page-rounded) "
                f"must divide every prompt bucket {tuple(buckets)}; "
                f"try one of {ok}"
            )
    ecfg = EngineConfig(
        n_slots=n_slots,
        max_seq=max_seq,
        prefill_buckets=buckets,
        paged=not args.contiguous,
        # contiguous caches have no pool to quantize: pin the fp net
        pool_dtype="fp" if args.contiguous else (args.pool_dtype
                                                 or EngineConfig.pool_dtype),
        prefill_chunk=args.prefill_chunk or None,
        page_tokens=page_tokens,
        local_budget_frac=args.local_budget,
        pager_policy=args.pager,
        hot_window=max(16, max_seq // 4),
        admission=args.admission,
        catalog_arch=args.arch if args.admission == "loi" else None,
        prefix_cache=args.prefix_cache,
    )

    fcfg = None
    if args.fleet:
        if args.roles and not args.prefill_chunk:
            ap.error("--roles needs --prefill-chunk (the prefill-role "
                     "engine runs chunked prefill)")
        scale = None
        if args.autoscale_min:
            scale = fleet.AutoscaleConfig(
                min_engines=args.autoscale_min, max_engines=args.fleet)
        fcfg = fleet.FleetConfig(
            n_engines=args.fleet, policy=args.policy, roles=args.roles,
            autoscale=scale,
        )
    return Launch(args, cfg, ecfg, fcfg, reqs, device)


def run(launch: Launch, *, params=None, chip=None, topo=None):
    """Build the engine (or the fleet) of `launch`, serve its trace and
    print the summary; returns the run's stats. The trace's requests
    carry their outputs afterwards."""
    args, cfg, ecfg, reqs = launch.args, launch.cfg, launch.ecfg, \
        launch.reqs
    if launch.fcfg is not None:
        router = fleet.FleetRouter.build(
            cfg, ecfg, launch.fcfg, params=params, seed=args.seed,
            topo=topo, chip=chip, device=launch.device)
        fstats = router.run(reqs)
        s = fstats.summary()
        print(
            f"fleet[{args.fleet} x {args.policy}"
            f"{' roles' if args.roles else ''}]: served {s['requests']} "
            f"requests / {s['tokens']} tokens "
            f"({s['tok_per_s_virtual']:.1f} tok/s virtual) "
            f"routed={s['routed']}"
        )
        print(
            f"latency: ttft_p50={s['ttft_p50']:.2e}s "
            f"ttft_p95={s['ttft_p95']:.2e}s ttft_p99={s['ttft_p99']:.2e}s "
            f"tpot_p50={s['tpot_p50']:.2e}s"
        )
        print(
            f"prefix_hit_rate={s['prefix_hit_rate']:.3f} "
            f"transfers={s['transfers']} "
            f"transfer_bytes={s['transfer_bytes']:.0f} "
            f"cancelled={s['cancelled']} scale_events={s['scale_events']}"
        )
        done = [r for r in reqs if r.output]
        print("sample:", done[0].output[:12] if done else "(no requests)")
        return fstats

    engine = ServingEngine.build(cfg, ecfg, params=params, seed=args.seed,
                                 topo=topo, chip=chip, device=launch.device)
    stats = engine.run(reqs)
    s = stats.summary()
    print(
        f"served {s['n_requests']} requests / {s['tokens']} tokens in "
        f"{stats.steps} steps ({s['tok_per_s_wall']:.1f} tok/s wall, "
        f"{s['tok_per_s_virtual']:.1f} tok/s virtual)"
    )
    print(
        f"latency: ttft_p50={s['ttft_p50_s']:.2e}s "
        f"tpot_p50={s['tpot_p50_s']:.2e}s tpot_p99={s['tpot_p99_s']:.2e}s "
        f"stall_p95={s['stall_p95_s']:.2e}s"
    )
    print(
        f"tiering[{args.pager}]: remote_share={s['remote_share']:.3f} "
        f"evictions={engine.pager.evictions} "
        f"promotions={engine.pager.promotions} "
        f"admission_blocks={s['admission_blocks']} "
        f"max_concurrency={s['max_concurrency']}"
    )
    print("compile counts: does not apply (eager cells compile nothing; "
          "the reference's flat-at-steady-state check has no eager "
          "counterpart)")
    done = [r for r in reqs if r.output]
    print("sample:", done[0].output[:12] if done else "(no requests)")
    return stats


def main(argv=None, *, params=None, chip=None, topo=None):
    """Run the launcher on `argv`; returns the run's stats (`ServeStats`,
    or `FleetStats` in fleet mode). `params` (float32 master weights),
    `chip` and `topo` replace the seeded weights and the H100 pricing of
    the virtual clock and the admission prior."""
    return run(setup(argv), params=params, chip=chip, topo=topo)


if __name__ == "__main__":
    main()
