"""Dev driver for the PyTorch port's serving path (the counterpart of
`scripts/dev_serve.py`; it imports only `repro_torch`).

Gates, on fp pools:

1. the continuous-batching engine emits, token for token, the greedy
   stream of the naive one-shot loop (batched `prefill`, then scalar-t
   `decode_step` on the contiguous caches) in both cache layouts — the
   paged pool and the per-slot contiguous caches;
2. the speculative engine (`--speculative ngram` or `draft`, k = 4)
   emits the plain greedy engine's tokens; the mean acceptance length
   per verify step is reported. Attention-only archs only, as in the
   reference: an SSM arch (mamba2_780m) runs gate 1 alone.

With `--fleet N` it runs the fleet lanes instead (the reference's
`dev_serve.py --fleet` / `--fault-plan` lanes, on the port only):

3. fleet parity: N engines behind the round-robin `FleetRouter` replay
   the single engine's greedy streams on a staggered-arrival trace, with
   every engine routed work; on attention-only archs, a shared-prefix
   stream under prefix-aware placement emits the same tokens as under
   round-robin with a strictly higher aggregate prefix hit rate;
4. with `--fault-plan NAME` (`serving.faults.PLANS`; chaos_smoke = engine
   1 killed at decode step 3 + 10% transfer flaking), chaos parity: the
   same trace served fault-free and under the plan emits the same tokens,
   every pool drains fully free (zero refcounts and pins) and the
   placement gap is 0 on every engine.

    PYTHONPATH=src python scripts/dev_serve_torch.py              # on the card
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu # plain versions
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu \
        --arch mamba2_780m                                        # the SSM arch
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu --fleet 2
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu --fleet 2 \
        --fault-plan chaos_smoke

It serves the reduced config of each `--arch` (repeatable, default
smollm_360m) in float32. `tests/test_torch_contiguous.py`,
`tests/test_torch_speculative.py`, `tests/test_torch_ssm.py` and
`chip_smoke.py` (at published widths) call its functions.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.module import cast_params  # noqa: E402
from repro_torch.runtime import serve as serve_rt  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    Request,
    ServingEngine,
    make_plan,
    shared_prefix_stream,
)
from repro_torch.serving.engine import frontend_extras  # noqa: E402
from repro_torch.serving.fleet import FleetConfig, FleetRouter  # noqa: E402

B, S, GEN = 2, 8, 6
MAXS = S + GEN
PAGE = 4


def frontend_batch(cfg, n_req: int, bucket: int, device=None) -> dict:
    """The frontend embeddings the engine draws for requests 0..n_req-1
    (`serving.engine.frontend_extras`), stacked into one batch; {} for
    token-only archs."""
    rows = [frontend_extras(cfg, i, bucket, device) for i in range(n_req)]
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def naive_greedy(cfg, params, prompts, gen: int, *, max_seq: int,
                 device=None, each: bool = False) -> np.ndarray:
    """The pre-engine serve loop: batched prefill of `prompts` (B, S)
    (with the frontend embeddings the engine draws for requests
    0..B-1), then `gen - 1` scalar-t decode steps on the contiguous
    caches of extent `max_seq` (plus the vision prefix). `each` prefills
    every prompt alone instead, at the engine's batch-1 prefill shapes,
    and stacks the caches: a GEMM library may pick another algorithm,
    and so give other bits, for 8 rows than for 1. `params` are the
    master weights, cast once to cfg.dtype as the engine casts them.
    Returns (B, gen) tokens."""
    p = cast_params(params, cfg.dtype)
    toks = torch.as_tensor(np.asarray(prompts), device=device)
    B, n = toks.shape
    batch = {"tokens": toks, **frontend_batch(cfg, B, n, toks.device)}
    if each:
        runs = [M.prefill(p, {k: v[i:i + 1] for k, v in batch.items()},
                          cfg, max_seq=max_seq) for i in range(B)]
        caches = {pos: {key: torch.cat([r[0][pos][key] for r in runs], 1)
                        for key in c} for pos, c in runs[0][0].items()}
        logits = torch.cat([r[1] for r in runs])
    else:
        caches, logits = M.prefill(p, batch, cfg, max_seq=max_seq)
    n += cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(gen - 1):
        logits, caches = M.decode_step(p, tok, caches, n + i, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy()


def engine_greedy(cfg, params, prompts, gen: int, *, paged: bool,
                  pool_dtype: str = "fp", max_seq: Optional[int] = None,
                  draft_params=None, sz_granularity: Optional[str] = None,
                  device=None, **ecfg_kw):
    """Serve `prompts` (B, S), all arriving at once, through a
    `ServingEngine` with B slots and one prompt bucket S, `gen` tokens
    each. `ecfg_kw` passes further `EngineConfig` fields (page_tokens,
    prefill_chunk, speculative, ...); `draft_params` replaces the draft
    proposer's seeded weights; `sz_granularity="token"` gives a greedy
    engine the per-token int8 pool that speculation selects (the engine
    builds it only under speculation). Returns ((B, gen) tokens, stats,
    engine)."""
    prompts = np.asarray(prompts)
    n_req, n = prompts.shape
    kw = dict(n_slots=n_req, max_seq=max_seq or n + gen,
              prefill_buckets=(n,), page_tokens=PAGE, admission="greedy",
              paged=paged, pool_dtype=pool_dtype)
    kw.update(ecfg_kw)
    ecfg = EngineConfig(**kw)
    if sz_granularity is None:
        eng = ServingEngine.build(cfg, ecfg, params=params, device=device)
    else:
        cells = serve_rt.make_engine_cells(
            cfg, n_slots=ecfg.n_slots, max_seq=ecfg.max_seq,
            buckets=ecfg.prefill_buckets, paged=paged,
            page_tokens=ecfg.page_tokens,
            prefill_chunk=ecfg.prefill_chunk or 0, pool_dtype=pool_dtype,
            sz_granularity=sz_granularity, device=device)
        eng = ServingEngine(cfg, ecfg, params, cells)
    if draft_params is not None:
        eng.cells.draft_params = draft_params
    reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=gen,
                    arrival=0.0) for i in range(n_req)]
    stats = eng.run(reqs)
    return np.stack([np.asarray(r.output) for r in reqs]), stats, eng


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    """Lockstep agreement of two (B, gen) token arrays: the least and
    mean per-request share of equal positions, whether all are equal and
    the first position where any request differs (None if none)."""
    eq = np.asarray(a) == np.asarray(b)
    rows = eq.mean(axis=1)
    diverged = np.nonzero(~eq.all(axis=0))[0]
    return dict(min=float(rows.min()), mean=float(rows.mean()),
                exact=bool(eq.all()),
                first_divergence=int(diverged[0]) if diverged.size else None)


def speculative_parity(cfg, params, prompts, gen: int, mode: str, *,
                       pool_dtype: str = "fp", spec_k: int = 4,
                       draft_params=None, device=None, **ecfg_kw) -> dict:
    """The paged engine with speculation `mode` against the plain greedy
    paged engine of the same pool on the same prompts. Returns the
    comparison (`compare`) plus both runs' tokens and stats and the
    speculative engine."""
    base = dict(paged=True, pool_dtype=pool_dtype, device=device,
                **ecfg_kw)
    ref, ref_stats, _ = engine_greedy(cfg, params, prompts, gen, **base)
    got, stats, eng = engine_greedy(
        cfg, params, prompts, gen, speculative=mode, speculative_k=spec_k,
        draft_params=draft_params, **base)
    return dict(compare(got, ref), greedy=ref, tokens=got,
                greedy_stats=ref_stats, stats=stats, engine=eng)


def pools_drained(router) -> bool:
    """Every engine's page pool fully free: no page referenced, no pin."""
    return all(
        h.engine.pager.counters()["free_pages"] == h.engine.pager.n_phys
        and (h.engine.pager.ref == 0).all() and h.engine.pager.pins == 0
        for h in router.handles)


def placement_gaps(router) -> list:
    """Per engine, the pager's pool footprint minus the substrate ledger's
    placement bytes (0 when they agree; None without a substrate)."""
    return [None if h.engine.substrate is None else
            h.engine.pager.pool_bytes_used()
            - h.engine.substrate.ledger.placement_bytes()
            for h in router.handles]


def _fleet_ecfg(**kw) -> EngineConfig:
    base = dict(n_slots=B, max_seq=MAXS, prefill_buckets=(S,),
                page_tokens=PAGE, hot_window=8, local_budget_frac=0.5,
                admission="greedy", paged=True, pool_dtype="fp")
    base.update(kw)
    return EngineConfig(**base)


def _staggered(cfg, n: int, seed: int, gap: float):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, S))
    return [Request(request_id=i, tokens=toks[i], max_new_tokens=GEN,
                    arrival=gap * i) for i in range(n)]


def fleet_parity(cfg, params, n_engines: int, *, device=None):
    """Round-robin fleet vs single engine, token for token on a
    staggered-arrival trace. Returns (requests that differ, every engine
    routed work, fleet stats)."""
    ecfg = _fleet_ecfg()
    n = 2 * n_engines * B
    ref = _staggered(cfg, n, seed=2, gap=0.2)
    ServingEngine.build(cfg, ecfg, params=params, device=device).run(ref)
    got = _staggered(cfg, n, seed=2, gap=0.2)
    stats = FleetRouter.build(
        cfg, ecfg, FleetConfig(n_engines=n_engines, policy="round_robin"),
        params=params, device=device).run(got)
    mismatch = sum(int(a.output != b.output) for a, b in zip(got, ref))
    return mismatch, min(stats.routed) > 0, stats


def fleet_prefix(cfg, params, n_engines: int, *, device=None):
    """Prefix-aware placement against round-robin on a shared-prefix
    stream. Returns (same tokens, round-robin hit rate, prefix-aware hit
    rate)."""
    sp, genp = 32, 4
    ecfg = _fleet_ecfg(max_seq=sp + genp, prefill_buckets=(sp,),
                       prefix_cache=True)
    outs, hits = {}, {}
    for pol in ("round_robin", "prefix_aware"):
        reqs = shared_prefix_stream(
            6 * n_engines, cfg.vocab_size, seed=3,
            system_tokens=sp - 2 * PAGE, prompt_buckets=(sp,),
            gen_range=(genp, genp), arrival_rate=2.0, n_systems=n_engines)
        stats = FleetRouter.build(
            cfg, ecfg, FleetConfig(n_engines=n_engines, policy=pol),
            params=params, device=device).run(reqs)
        outs[pol] = [r.output for r in reqs]
        hits[pol] = stats.prefix["hit_rate"]
    return (outs["round_robin"] == outs["prefix_aware"],
            hits["round_robin"], hits["prefix_aware"])


def fleet_chaos(cfg, params, n_engines: int, plan_name: str, *,
                device=None):
    """One staggered trace served fault-free and under the named plan.
    Returns (requests that differ, pools drained, placement gap 0 on
    every engine, any engine has a substrate, the plan, fleet stats)."""
    plan = make_plan(plan_name)
    ecfg = _fleet_ecfg()
    n = 3 * n_engines * B
    clean = _staggered(cfg, n, seed=5, gap=0.05)
    FleetRouter.build(
        cfg, ecfg, FleetConfig(n_engines=n_engines, policy="round_robin"),
        params=params, device=device).run(clean)
    router = FleetRouter.build(
        cfg, ecfg, FleetConfig(n_engines=n_engines, policy="round_robin",
                               faults=plan),
        params=params, device=device)
    got = _staggered(cfg, n, seed=5, gap=0.05)
    stats = router.run(got)
    mismatch = sum(int(a.output != b.output) for a, b in zip(got, clean))
    gaps = placement_gaps(router)
    return (mismatch, pools_drained(router),
            all(g is None or g == 0 for g in gaps),
            any(g is not None for g in gaps), plan, stats)


def fleet_lanes(cfg, params, n_engines: int, plan_name: Optional[str],
                device) -> bool:
    """Print the fleet lanes of one arch; True when every gate held."""
    if plan_name:
        mismatch, drained, placement_ok, has_sub, plan, stats = \
            fleet_chaos(cfg, params, n_engines, plan_name, device=device)
        f = stats.faults
        ok = (mismatch == 0 and drained and placement_ok
              and (not (plan.active and has_sub)
                   or f.get("retries", 0) >= 1)
              and (plan.kill_engine is None
                   or f.get("engines_killed", 0) == 1))
        print(f"{cfg.name}: chaos={plan_name} fleet={n_engines} "
              f"mismatch={mismatch} killed={f.get('engines_killed', 0)} "
              f"retries={f.get('retries', 0)} "
              f"refill={f.get('reprefilled_tokens', 0)} drained={drained} "
              f"placement_ok={placement_ok} {'OK' if ok else 'FAIL'}")
        return ok
    mismatch, balanced, _ = fleet_parity(cfg, params, n_engines,
                                         device=device)
    ok = mismatch == 0 and balanced
    note = ""
    if serve_rt.chunked_prefill_supported(cfg):
        parity, rr_hit, pa_hit = fleet_prefix(cfg, params, n_engines,
                                              device=device)
        ok &= parity and pa_hit > rr_hit
        note = (f" prefix_hit rr={rr_hit:.3f} aware={pa_hit:.3f} "
                f"parity={parity}")
    print(f"{cfg.name}: fleet={n_engines} rr_mismatch={mismatch} "
          f"balanced={balanced}{note} {'OK' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", choices=configs.list_archs(),
                    help="arch to serve at reduced size (repeatable; "
                    "default smollm_360m)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--speculative", choices=("ngram", "draft"),
                    action="append")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="run the fleet lanes with N engines instead")
    ap.add_argument("--fault-plan", metavar="NAME",
                    help="with --fleet: the chaos-parity lane under this "
                    "plan (serving.faults.PLANS)")
    args = ap.parse_args(argv)
    if args.fault_plan and not args.fleet:
        ap.error("--fault-plan needs --fleet N")
    failed = []
    for arch in args.arch or ["smollm_360m"]:
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        params = M.init_model(cfg, device=args.device, seed=0)
        if args.fleet:
            if not fleet_lanes(cfg, params, args.fleet, args.fault_plan,
                               args.device):
                failed.append(f"{arch} fleet={args.fleet}")
            continue
        rng = np.random.default_rng(4)
        prompts = rng.integers(0, cfg.vocab_size, (B, S))
        naive = naive_greedy(cfg, params, prompts, GEN, max_seq=S + GEN,
                             device=args.device)
        for paged in (True, False):
            got, _, _ = engine_greedy(cfg, params, prompts, GEN,
                                      paged=paged, device=args.device)
            c = compare(got, naive)
            print(f"{arch}: engine paged={paged} vs naive loop: {c}")
            if not c["exact"]:
                failed.append(f"{arch} paged={paged}")
        if not serve_rt.chunked_prefill_supported(cfg):
            continue        # speculation needs an attention-only stack
        for mode in args.speculative or ("ngram", "draft"):
            r = speculative_parity(cfg, params, prompts, 12, mode,
                                   device=args.device)
            print(f"{arch}: speculative {mode} vs greedy: exact="
                  f"{r['exact']} accept_len_mean="
                  f"{r['stats'].spec['accept_len_mean']:.2f} verify_steps="
                  f"{r['stats'].spec['verify_steps']}")
            if not r["exact"]:
                failed.append(f"{arch} speculative={mode}")
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("all gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
