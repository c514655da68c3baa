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

With `--mesh dpDtpT` it runs the sharded-parity lane instead (the
reference's `dev_serve.py --mesh`, `mesh_parity`): the paged engine over
a D x T mesh of ranks it spawns itself (`launch.mesh.run_ranks`, one
process per rank; KV heads over `model`, slots over `data`), against
the meshless engine on the same weights and prompts: every rank's tokens
equal (fp pools: equal to the meshless engine's, bit for bit; int8:
agreement >= INT8_TOKEN_AGREEMENT), the `data` replicas of each pool
bit-equal, and the substrate's placement contract (`pool_bytes_used()
== placement_bytes()`) on every rank. `--pool-dtype` picks the pool
(fp by default); `--backend gloo` puts several ranks on one card (NCCL
refuses two ranks of one communicator on the same GPU). `--contiguous`
serves the contiguous layout there instead of the paged pool: slots over
`data`, every slot's sequence over `model` (each rank decodes its block
of positions and the ranks merge by their log-sum-exp), fp caches; its
gates are the same but the replica check, as the `data` ranks hold
different slots. Every stack serves there: `--arch mamba2_780m` (SSM),
`jamba_1_5_large_398b` (hybrid) and `seamless_m4t_large_v2` (enc-dec)
too, their slot-resident leaves (SSM state, conv tails, cross-KV) the
rank's shard: each rank holds 1/(D T) of the meshless resident bytes.
`--speculative ngram|draft` with `--mesh` serves the paged engine with
speculation over the mesh against the meshless speculative engine:
tokens equal, and the verify-step counts equal.

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
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu \
        --mesh dp2tp2 [--pool-dtype int8] [--arch granite_3_2b]
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu \
        --mesh dp2tp2 --contiguous
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu \
        --mesh dp2tp2 --arch mamba2_780m [--contiguous]
    PYTHONPATH=src python scripts/dev_serve_torch.py --device cpu \
        --mesh dp2tp2 --speculative ngram [--arch granite_3_2b]

It serves the reduced config of each `--arch` (repeatable, default
smollm_360m) in float32. `tests/test_torch_contiguous.py`,
`tests/test_torch_speculative.py`, `tests/test_torch_ssm.py`,
`tests/test_torch_mesh.py` and `chip_smoke.py` (at published widths)
call its functions.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import re
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.common.pytree import leaf_bytes, tree_leaves  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.module import cast_params  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import serve as serve_rt  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    Request,
    ServingEngine,
    make_plan,
    shared_prefix_stream,
)
from repro_torch.serving.engine import (  # noqa: E402
    INT8_TOKEN_AGREEMENT,
    frontend_extras,
)
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


# ------------------------------------------------------ the mesh lane
def pool_digests(caches) -> dict:
    """sha1 of the bytes of every paged pool leaf, {"pos0/k": hex}."""
    out = {}
    for pos, c in caches.items():
        for key in blk.PAGED_LEAF_NAMES:
            if key in c:
                t = c[key].detach().contiguous().cpu()
                out[f"{pos}/{key}"] = hashlib.sha1(
                    t.view(torch.uint8).numpy().tobytes()).hexdigest()
    return out


def pool_nbytes(caches) -> int:
    return sum(leaf_bytes(c[k]) for c in caches.values()
               for k in blk.PAGED_LEAF_NAMES if k in c)


def resident_leaves(caches) -> dict:
    """The slot-resident leaves of a paged cache tree, or the SSM and
    cross-KV leaves of a contiguous one (everything but the K / V and
    their int8 (scale, zero)), {"pos0/state": tensor}."""
    return {f"{pos}/{k}": x for pos, c in caches.items()
            for k, x in c.items() if k not in blk.PAGED_LEAF_NAMES}


def resident_digests(caches) -> dict:
    """sha1 of the bytes of every `resident_leaves` leaf."""
    return {k: hashlib.sha1(x.detach().contiguous().cpu().view(
        torch.uint8).numpy().tobytes()).hexdigest()
        for k, x in resident_leaves(caches).items()}


def resident_nbytes(caches) -> int:
    return sum(leaf_bytes(x) for x in resident_leaves(caches).values())


def leaf_nbytes(caches) -> dict:
    """{leaf name: bytes of that leaf summed over the layer positions}."""
    out = {}
    for c in caches.values():
        for k, x in c.items():
            out[k] = out.get(k, 0) + leaf_bytes(x)
    return out


def spec_shares(cells, mesh) -> dict:
    """The bytes a rank's shard of an engine's caches holds under its
    specs (`EngineCells.cache_pspecs`: `runtime.sharding.local_shape` of
    each leaf of the global `abstract_caches`), and the global tree's:
    {"pool": (share, global), "resident": (share, global)}, the pool
    being the K / V leaves and their int8 (scale, zero) (the contiguous
    layout's K / V caches), the resident leaves the rest."""
    out = {"pool": [0, 0], "resident": [0, 0]}
    for pos, c in cells.abstract_caches.items():
        for key, x in c.items():
            part = out["pool" if key in blk.PAGED_LEAF_NAMES else "resident"]
            size = x.element_size()
            part[0] += size * int(np.prod(shd.local_shape(
                x.shape, cells.cache_pspecs[pos][key], mesh)))
            part[1] += size * x.numel()
    return {k: tuple(v) for k, v in out.items()}


def mesh_ecfg(n_req: int, n: int, gen: int, **kw) -> EngineConfig:
    """The reference lane's engine: n_req slots, one bucket n, pages of
    PAGE tokens, half the pool local (pages move through the substrate),
    greedy admission."""
    base = dict(n_slots=n_req, max_seq=n + gen, prefill_buckets=(n,),
                page_tokens=PAGE, hot_window=8, local_budget_frac=0.5,
                admission="greedy", paged=True, pool_dtype="fp")
    base.update(kw)
    return EngineConfig(**base)


def mesh_rank(rank: int, world: int, cfg, dp: int, tp: int, params,
              prompts, gen: int, runs, device) -> list:
    """One rank of the mesh lane (run by `launch.mesh.run_ranks` in its
    own process). Builds the (dp, tp) mesh over the process group, then
    serves `prompts` (token arrays, all arriving at once, `gen` new
    tokens each; one bucket of the longest by default) once per entry of
    `runs`, each on an engine of the user's entry point,
    `ServingEngine.build(..., mesh=mesh)`: its default context
    (`ctx_for_mesh(mesh)`) and serving rules, the rank's shard cut by the
    engine from the global float32 master weights `params` (the tree as
    numpy, or as the caller's tensors on the rank's card, shared with the
    rank by CUDA IPC). A run is a dict of `EngineConfig` fields plus
    "dtype" (the model's compute dtype), "name", "gate" and "whole"
    (read by `mesh_gates` only), "logits" (see below), "resident" (True: return
    the rank's slot-resident leaves after the run as numpy), "extras"
    ({request id: {"frames" or "patches": numpy}}: the frontend
    embeddings of each request in place of the engine's own draws) and
    "draft_params" (a numpy tree: the draft proposer's weights in place
    of its seeded ones, replicated on every rank).
    Returns, per run: the tokens, the wall seconds of `build` and of
    `run`, the kernels' launch and plain-call counts of the run, the
    paged pool's digests and bytes (this rank's shard), the resident
    leaves' digests and bytes (and, asked, the leaves), the speculative
    engine's verify steps, the substrate's mode and placement gap, the
    engine context's data / model coordinate and fsdp axis, the bytes of
    the rank's weights; for a float32 run whose dict has "logits" True,
    the last-token logits (float32) of a prompt pass of every prompt
    alone on the engine's weights, in float32 and in bfloat16 ({"float32":
    (n, V), "bfloat16": (n, V)}); for a float32 run whose dict has
    "decode_logits" True, the serve bundle's last decode step's logits on
    the engine's weights in both dtypes (`bundle_logits` over
    DECODE_TOKENS, "decode_logits"); and the seconds this rank took to
    build its mesh ("mesh_s")."""
    import torch.distributed as dist

    dev = torch.device(device)
    t_mesh = time.perf_counter()
    mesh = _rank_mesh(dp, tp, device)
    mesh_s = time.perf_counter() - t_mesh
    prompts = [np.asarray(p) for p in prompts]
    n_req, n = len(prompts), max(len(p) for p in prompts)
    full = (params if isinstance(tree_leaves(params)[0], torch.Tensor)
            else load_numpy_params(params, device=dev))
    out = []
    for run in runs:
        want_logits = run.get("logits", False)
        want_decode = run.get("decode_logits", False)
        want_resident = run.get("resident", False)
        extras, draft = run.get("extras"), run.get("draft_params")
        run = {k: v for k, v in run.items()
               if k not in ("name", "gate", "whole", "logits",
                            "decode_logits", "resident", "extras",
                            "draft_params")}
        rcfg = dataclasses.replace(cfg, dtype=run.pop("dtype", cfg.dtype))
        ecfg = mesh_ecfg(n_req, n, gen, **run)
        t_build = time.perf_counter()
        eng = ServingEngine.build(rcfg, ecfg, params=full, device=dev,
                                  mesh=mesh)
        build_s = time.perf_counter() - t_build
        ctx = eng.cells.ctx
        if extras is not None:
            eng._frontend_extras = fixed_extras(extras, dev)
        if draft is not None:
            eng.cells.draft_params = cast_params(
                load_numpy_params(draft, device=dev),
                eng.cells.draft_cfg.dtype)
        reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=gen,
                        arrival=0.0) for i in range(n_req)]
        dist.barrier()
        kernels.reset_counters()
        t0 = time.perf_counter()
        stats = eng.run(reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        gap, mode = None, "off"
        if eng.substrate is not None:
            mode = eng.substrate.mode
            gap = (eng.pager.pool_bytes_used()
                   - eng.substrate.ledger.placement_bytes())
        logits = dec_logits = None
        if want_logits or want_decode:
            if rcfg.dtype != "float32":
                raise ValueError("prompt logits are taken from a float32 "
                                 f"run's weights, not {rcfg.dtype}")
        if want_logits:
            logits = {dt: prompt_logits(rcfg, cast_params(eng.params, dt),
                                        prompts, dt, dev, ctx)
                      for dt in ("float32", "bfloat16")}
        if want_decode:
            dec_logits = {dt: bundle_logits(rcfg, eng.params, dt, dev, mesh)
                          for dt in ("float32", "bfloat16")}
        out.append(dict(
            tokens=np.stack([np.asarray(r.output) for r in reqs]),
            wall_s=wall, build_s=build_s, launches=launches, plain=plain,
            digests=pool_digests(eng.caches),
            pool_bytes=pool_nbytes(eng.caches),
            resident_digests=resident_digests(eng.caches),
            resident_bytes=resident_nbytes(eng.caches),
            leaf_bytes=leaf_nbytes(eng.caches),
            shares=spec_shares(eng.cells, mesh),
            resident=({k: x.float().cpu().numpy() for k, x in
                       resident_leaves(eng.caches).items()}
                      if want_resident else None),
            spec_steps=eng.spec_verify_steps,
            param_bytes=sum(leaf_bytes(x) for x in tree_leaves(eng.params)),
            substrate=mode, placement_gap=gap,
            coord=(ctx.index("data"), ctx.index("model")),
            fsdp_axis=ctx.fsdp_axis, logits=logits,
            decode_logits=dec_logits, mesh_s=mesh_s,
            summary=stats.summary()))
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def fixed_extras(extras: dict, device):
    """An engine's `_frontend_extras` that hands each request the given
    embeddings ({request id: {name: numpy}})."""
    def fn(req, bucket):
        return {k: torch.tensor(v, device=device)
                for k, v in extras[req.request_id].items()}

    return fn


def prompt_logits(cfg, params, prompts, dtype: str, device,
                  ctx=None) -> np.ndarray:
    """The last-token logits (float32 numpy, one row a prompt) of a
    prompt pass of each prompt alone, in `dtype`, on `params` (the
    meshless tree, or a rank's shard with its `ctx`: a collective, every
    rank of the mesh calls it); prompt i takes the frontend embeddings
    the engine draws for request i (`frontend_extras`)."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    kw = {} if ctx is None else {"ctx": ctx}
    rows = [M.prefill(params, {"tokens": torch.as_tensor(
        np.asarray(p)[None], device=device),
        **frontend_extras(cfg, i, len(p), device)}, cfg, max_seq=len(p),
        **kw)[1][0].float() for i, p in enumerate(prompts)]
    return torch.stack(rows).cpu().numpy()


# the serve bundle's drift probe: 8 sequences of 68 seeded tokens, the
# first 64 prefilled into caches of 128 positions, then 4 decode steps
# (positions 64-67: on a tp 2 mesh the second half of the sequence, so
# every step merges both ranks' blocks)
DECODE_TOKENS = dict(batch=8, prompt=64, total=68, max_seq=128, seed=5)


def bundle_logits(cfg, params, dtype: str, device, mesh=None) -> np.ndarray:
    """The last decode step's logits (float32 numpy, (batch, V)) of the
    serve bundle (`serve.make_bundle`) over DECODE_TOKENS, in `dtype`, on
    `params` (the meshless tree, or a rank's shard over `mesh`: a
    collective, every rank of the mesh calls it, and the logits of every
    row are gathered back)."""
    from repro_torch.common.parallel import all_gather

    d = DECODE_TOKENS
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = cast_params(params, dtype)
    tokens = torch.as_tensor(np.random.default_rng(d["seed"]).integers(
        0, cfg.vocab_size, (d["batch"], d["total"])), device=device)
    kw, ctx = {}, None
    if mesh is not None:
        ctx = mesh_mod.ctx_for_mesh(mesh, remat="none")
        kw = dict(mesh=mesh, ctx=ctx)
    sb = serve_rt.make_bundle(cfg, batch=d["batch"], max_seq=d["max_seq"],
                              **kw)
    caches, logits = sb.prefill_fn(params,
                                   {"tokens": tokens[:, :d["prompt"]]})
    if ctx is not None:
        caches = serve_rt.prefill_cache_shards(
            caches, ctx, cfg.num_kv_heads,
            serve_rt.seq_split_leaves(sb.cache_pspecs))
    for i in range(d["prompt"], d["total"]):
        logits, caches = sb.decode_fn(params, tokens[:, i], caches, i)
    if logits.shape[0] != d["batch"]:
        logits = all_gather(logits, ctx, ctx.dp_axes, 0)
    return logits.float().cpu().numpy()


def _rank_mesh(dp: int, tp: int, device):
    import torch.distributed as dist

    return mesh_mod.make_smoke_mesh((dp, tp), device=torch.device(device),
                                    backend=dist.get_backend())


def mesh_ops_rank(rank: int, world: int, dp: int, tp: int, cases,
                  device) -> list:
    """One rank of the op checks over a (dp, tp) mesh: every case's
    output, gathered whole (numpy), for the caller to hold against the
    meshless op. Cases (dicts, global inputs as numpy):
      {"kind": "mha", "q", "k", "v", "causal"}: `attention.sharded_mha`
        on the rank's heads — the query heads split over tp when H
        divides (as wq's shard gives them), the KV heads when KV does;
      {"kind": "layers", "cfg", "params", "tokens", "x"}: the global
        params cut by the specs of the serve bundle over the mesh
        (`runtime.serve.make_bundle(mesh=)`, the serving rules), then the
        vocab-parallel `embed` of tokens and `unembed` of x, layer 0's
        column/row-parallel `mlp` and `self_attention` of x, and the
        bundle's prefill step over tokens (its last-token logits)."""
    from repro_torch.common.parallel import all_gather
    from repro_torch.models import attention as attn
    from repro_torch.models import layers
    from repro_torch.models.module import layer_slice

    dev = torch.device(device)
    mesh = _rank_mesh(dp, tp, device)
    ctx = mesh_mod.ctx_for_mesh(mesh, fsdp=False, remat="none")
    s = ctx.index("model")
    out = []
    for case in cases:
        if case["kind"] == "mha":
            q, k, v = (torch.as_tensor(case[n], device=dev) for n in "qkv")
            H, KV = q.shape[2], k.shape[2]
            if H % tp == 0:
                q = q[:, :, s * H // tp:(s + 1) * H // tp]
            if KV % tp == 0:
                k = k[:, :, s * KV // tp:(s + 1) * KV // tp]
                v = v[:, :, s * KV // tp:(s + 1) * KV // tp]
            o = attn.sharded_mha(q, k, v, ctx, causal=case["causal"],
                                 heads=(H, KV))
            if H % tp == 0:
                o = all_gather(o, ctx, "model", 2)
            out.append(o.cpu().numpy())
            continue
        cfg = case["cfg"]
        tokens = torch.as_tensor(case["tokens"], device=dev)
        bundle = serve_rt.make_bundle(cfg, batch=tokens.shape[0],
                                      max_seq=tokens.shape[1], mesh=mesh)
        local = shd.shard_tree(load_numpy_params(case["params"], device=dev),
                               bundle.param_pspecs, mesh)
        x = torch.as_tensor(case["x"], device=dev)
        p0 = layer_slice(local["blocks"]["pos0"], 0)
        out.append(dict(
            embed=layers.embed(local["embed"], tokens, cfg, ctx),
            unembed=layers.unembed(local["embed"], x, cfg,
                                   local.get("head"), ctx),
            mlp=layers.mlp(p0["mlp"], x, cfg, ctx),
            attn=attn.self_attention(p0["attn"], x, cfg, ctx=ctx),
            prefill=bundle.prefill_fn(local, {"tokens": tokens})[1]))
        out[-1] = {k: v.cpu().numpy() for k, v in out[-1].items()}
    return out


def mesh_stack_ops_rank(rank: int, world: int, dp: int, tp: int, cases,
                        device) -> list:
    """One rank of the SSM block's and cross-attention's checks over a
    (dp, tp) mesh (the serving rules' shards of layer 0 of a reduced
    arch; its default context). Cases (dicts, global inputs as numpy):
      {"kind": "ssm", "cfg", "params", "x" (B, S, d), "x1" (B, 1, d)}:
        `ssm.ssm_block` of x (every row; the state and conv tails
        returned) on the rank's shard of layer 0's SSM weights, then one
        `ssm_decode_step` of the rank's rows of x1 from the rank's shard
        of that state and those tails (`serve.prefill_cache_shards`, as
        the contiguous caches hold them): the prefill's output, the
        decode output of every row (gathered over dp) and the rank's new
        state and tails;
      {"kind": "cross", "cfg", "params", "x" (B, Sq, d), "enc" (B, Senc,
        d), "x1" (B, 1, d)}: `encode_cross_kv` and `cross_attention` of
        x on layer 0's cross block, then `decode_cross_attention` of the
        rank's rows of x1 against the cross-KV shard of each layout: the
        rank's KV heads at every encoder position (paged) and every KV
        head at its block of them (contiguous, merged over tp): the
        prefill's output and both decodes' outputs of every row.
    Each case's dict also holds the rank's (data, model) "coord"."""
    from repro_torch.common.parallel import all_gather
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.models.module import layer_slice

    dev = torch.device(device)
    mesh = _rank_mesh(dp, tp, device)
    ctx = mesh_mod.ctx_for_mesh(mesh, remat="none")
    out = []
    for case in cases:
        cfg = case["cfg"]
        x, x1 = (torch.as_tensor(case[n], device=dev) for n in ("x", "x1"))
        B = x.shape[0]
        r0, r1 = ctx.batch_rows(B)
        enc_len = case["enc"].shape[1] if "enc" in case else 0
        bundle = serve_rt.make_bundle(cfg, batch=B, max_seq=x.shape[1],
                                      enc_len=enc_len, mesh=mesh, ctx=ctx)
        local = shd.shard_tree(load_numpy_params(case["params"], device=dev),
                               bundle.param_pspecs, mesh)
        p0 = layer_slice(local["blocks"]["pos0"], 0)

        def rows(y):
            return y if y.shape[0] == B else all_gather(y, ctx, ctx.dp_axes,
                                                        0)

        if case["kind"] == "ssm":
            y, (state, tails) = ssm.ssm_block(p0["ssm"], x, cfg,
                                              return_state=True, ctx=ctx)
            leaves = dict(zip(("state", "tail_x", "tail_B", "tail_C"),
                              (state, *tails)))
            shards = serve_rt.prefill_cache_shards(
                {"pos0": {k: v[None] for k, v in leaves.items()}}, ctx,
                cfg.num_kv_heads,
                serve_rt.seq_split_leaves(bundle.cache_pspecs))["pos0"]
            y1, (state1, tails1) = ssm.ssm_decode_step(
                p0["ssm"], x1[r0:r1], cfg, shards["state"][0],
                tuple(shards[k][0] for k in ("tail_x", "tail_B", "tail_C")),
                ctx=ctx)
            got = dict(prefill=y, decode=rows(y1), state=state1,
                       **dict(zip(("tail_x", "tail_B", "tail_C"), tails1)))
        else:
            enc = torch.as_tensor(case["enc"], device=dev)
            ck, cv = attn.encode_cross_kv(p0["cross"], enc, cfg, ctx)
            y = attn.cross_attention(p0["cross"], x, (ck, cv), cfg, ctx)
            paged = attn.decode_cross_attention(
                p0["cross"], x1[r0:r1], (ck[r0:r1], cv[r0:r1]), cfg, ctx)
            split = serve_rt.seq_split_leaves(bundle.cache_pspecs)
            blocks = serve_rt.prefill_cache_shards(
                {"pos0": {"cross_k": ck[None], "cross_v": cv[None]}}, ctx,
                cfg.num_kv_heads, split)["pos0"]
            contig = attn.decode_cross_attention(
                p0["cross"], x1[r0:r1],
                (blocks["cross_k"][0], blocks["cross_v"][0]), cfg, ctx,
                seq_split=split["cross_k"])
            got = dict(prefill=y, paged=rows(paged), contiguous=rows(contig))
        out.append({k: v.float().cpu().numpy() for k, v in got.items()})
        out[-1]["coord"] = (ctx.index("data"), ctx.index("model"))
    return out


def mesh_moe_rank(rank: int, world: int, dp: int, tp: int, params, x,
                  cases, device) -> list:
    """One rank of `moe.moe_ep` over a (dp, tp) mesh (EP over `model`):
    the MoE layer's global params (numpy) cut by the serving rules —
    experts over `model`, with an fsdp axis each expert's ff dim over it
    — then, per case (cfg, fsdp_axis, moe_fsdp_mode), y (gathered whole) and
    aux, and the (token, choice) pairs this rank's dispatch dropped past
    its capacity (every token sits on one rank when x's batch splits over
    `data` and its sequence over `model`)."""
    from repro_torch.common.parallel import ParallelCtx, local_slice
    from repro_torch.models import moe

    dev = torch.device(device)
    mesh = _rank_mesh(dp, tp, device)
    full = load_numpy_params(params, device=dev)
    x = torch.as_tensor(x, device=dev)
    axes = {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "moe_ff"),
            "w_up": ("experts", "embed", "moe_ff"),
            "w_down": ("experts", "moe_ff", "embed")}
    out = []
    for cfg, fsdp, mode in cases:
        ctx = ParallelCtx(mesh=mesh, dp_axes=("data",), fsdp_axis=fsdp,
                          tp_axis="model", moe_fsdp_mode=mode)
        rules = shd.ShardingRules.for_serving(fsdp, "model")
        local = shd.shard_tree(full, shd.pspecs_for_tree(
            full, {k: axes[k] for k in full}, rules, mesh), mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_ep(local, x, cfg, ctx)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mine = x
        if x.shape[0] % dp == 0:
            mine = local_slice(mine, ctx, "data", 0)
        if x.shape[1] % tp == 0 and x.shape[1] >= tp:
            mine = local_slice(mine, ctx, "model", 1)
        T = mine.shape[0] * mine.shape[1]
        _, idx, _ = moe._route(full, mine.reshape(T, -1).float(), cfg)
        hits = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        dropped = int((hits - moe._capacity(T, cfg)).clamp_min(0).sum())
        out.append(dict(y=y.cpu().numpy(), aux=float(aux), dropped=dropped,
                        wall_s=wall))
    return out


def mesh_bundle_rank(rank: int, world: int, cfg, dp: int, tp: int, params,
                     prompts, steps, max_seq: int, device,
                     frames=None) -> dict:
    """One rank of the serve bundle over a (dp, tp) mesh
    (`runtime.serve.make_bundle(mesh=)`, its default context and the
    serving rules): the global params (numpy) cut into the rank's shard,
    the prefill step over `prompts` (B, S0) (and, for an encoder-decoder
    arch, `frames` (B, S_enc, d), which set the cross-KV's extent), its
    caches turned into the decode step's shards
    (`serve.prefill_cache_shards`), then one decode step per row of
    `steps` (n, B) at positions S0, S0 + 1, ... (scalar t). Returns the prefill's logits and each decode step's (every row,
    gathered over the dp axes; float32 numpy), the rank's cache shards
    after the last step ({"pos0/k": numpy}), its (data, model)
    coordinate and the kernels' launch and plain-call counts."""
    from repro_torch.common.parallel import all_gather

    dev = torch.device(device)
    mesh = _rank_mesh(dp, tp, device)
    ctx = mesh_mod.ctx_for_mesh(mesh, remat="none")
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    B, S0 = prompts.shape
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = torch.as_tensor(np.asarray(frames), device=dev)
    bundle = serve_rt.make_bundle(
        cfg, batch=B, max_seq=max_seq, mesh=mesh, ctx=ctx,
        enc_len=0 if frames is None else batch["frames"].shape[1])
    local = shd.shard_tree(load_numpy_params(params, device=dev),
                           bundle.param_pspecs, mesh)
    kernels.reset_counters()
    caches, logits = bundle.prefill_fn(local, batch)
    caches = serve_rt.prefill_cache_shards(
        caches, ctx, cfg.num_kv_heads,
        serve_rt.seq_split_leaves(bundle.cache_pspecs))
    out = [logits]
    for i, tok in enumerate(np.asarray(steps)):
        logits, caches = bundle.decode_fn(
            local, torch.as_tensor(tok, device=dev), caches, S0 + i)
        if logits.shape[0] != B:
            logits = all_gather(logits, ctx, ctx.dp_axes, 0)
        out.append(logits)
    return dict(
        logits=[x.float().cpu().numpy() for x in out],
        caches={f"{pos}/{k}": x.float().cpu().numpy()
                for pos, c in caches.items() for k, x in c.items()},
        coord=(ctx.index("data"), ctx.index("model")),
        launches={k: v for k, v in kernels.LAUNCHES.items() if v},
        plain={k: v for k, v in kernels.REFERENCE_CALLS.items() if v})


def mesh_collectives_rank(rank: int, world: int, cfg, dp: int, tp: int,
                          decode, train, device) -> dict:
    """The collectives one rank of a (dp, tp) mesh issues
    (`common.parallel.log_collectives`: kind, input shape, axis) in a
    decode step of the serve bundle and in a train step, on real tensors
    over the process group: `decode` (batch, max_seq) for
    `serve.make_bundle(mesh=)` (its params seeded, its caches zeroed
    shards, the rank's tokens, t max_seq // 2), `train` (batch, seq,
    microbatches) for `train.make_bundle(mesh=)` (remat by block, the
    seed-0 state's shard, the rank's rows of a seeded batch).
    {"decode": [...], "train": [...]} as lists of (kind, shape, axis)."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.parallel import log_collectives
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.runtime import train as train_rt

    dev = torch.device(device)
    mesh = _rank_mesh(dp, tp, device)
    Bd, Sd = decode
    sb = serve_rt.make_bundle(cfg, batch=Bd, max_seq=Sd, mesh=mesh)
    ctx = mesh_mod.ctx_for_mesh(mesh, remat="none")
    params = shd.shard_tree(M.init_model(cfg, device=dev, seed=0),
                            sb.param_pspecs, mesh)
    caches = shd.zeros_for_shards(sb.abstract_caches, sb.cache_pspecs, mesh,
                                  dev)
    r0, r1 = ctx.batch_rows(Bd)
    token = torch.arange(Bd, dtype=torch.int32, device=dev)[r0:r1]
    with log_collectives() as dec:
        sb.decode_fn(params, token, caches,
                     torch.tensor(Sd // 2, dtype=torch.int32, device=dev))
    Bt, St, k = train
    tcfg = TrainConfig(microbatches=k, remat="block")
    bundle = train_rt.make_bundle(cfg, tcfg, mesh=mesh)
    batch = train_rt.rank_batch(make_batch_for(cfg, St, Bt, 0), bundle.ctx,
                                k)
    state = bundle.shard(train_rt.init_train_state(cfg, device=dev))
    with log_collectives() as tr:
        bundle.step_fn(state, batch)
    return {"decode": dec, "train": tr}


def mesh_calls(rank: int, world: int, calls) -> list:
    """Several rank functions in one set of ranks: `fn(rank, world,
    *args)` for each (fn, args) of `calls`, in order (each builds its own
    mesh over the same process group)."""
    return [fn(rank, world, *args) for fn, args in calls]


def mesh_gates(results: list, ref_tokens: dict, ref_pool_bytes: dict,
               tp: int, runs, kv_split: bool,
               ref_resident_bytes: Optional[dict] = None) -> list:
    """The lane's gates over every rank's results of `mesh_rank` (rank
    order) against the meshless engine's tokens and pool bytes per run
    index: every rank's tokens equal rank 0's; fp pools equal the
    meshless tokens, int8 agree >= INT8_TOKEN_AGREEMENT (a run's "gate"
    False: printed only); the data replicas of each pool (ranks of one
    model coordinate) bit-equal; each rank's pool 1/tp of the meshless
    pool's bytes when its KV heads split over tp (`kv_split`), all of
    them when they do not; placement gap 0 on every rank. A contiguous
    run (`paged` False) holds slots over `data` and positions over
    `model`: no replicas, and each rank holds 1/(dp tp) of the caches.
    Where `ref_resident_bytes` gives the meshless engine's slot-resident
    bytes of a run (SSM state, conv tails, cross-KV), each rank holds
    1/(dp tp) of them (slots over `data`, heads or channels or encoder
    positions over `model`). A run's "whole" names the leaves it expects
    whole over `model` (1/dp a rank: K / V whose extent does not divide
    over tp, an SSM state whose heads a rank cuts). The global cache
    tree's bytes (`spec_shares`) equal the meshless engine's. Returns
    the failures (empty: every gate held)."""
    failed = []
    for i, run in enumerate(runs):
        per = [r[i] for r in results]
        name = run.get("name", f"run {i}")
        fraction = _fractions(run.get("whole", ()), len(per) // tp, tp)
        ref_res = (ref_resident_bytes or {}).get(i)
        if ref_res:
            failed += _bytes_gates(per, "resident", ref_res, fraction, name)
        if not run.get("paged", True):
            failed += _contiguous_gates(per, ref_tokens[i],
                                        ref_pool_bytes.get(i), name,
                                        run.get("gate", True), fraction)
            continue
        if any(not np.array_equal(p["tokens"], per[0]["tokens"])
               for p in per):
            failed.append(f"{name}: the ranks' tokens differ")
        agree = compare(per[0]["tokens"], ref_tokens[i])
        exact = run.get("pool_dtype", "fp") != "int8"
        if run.get("gate", True):
            if exact and not agree["exact"]:
                failed.append(f"{name}: tokens differ from the meshless "
                              f"engine's {agree}")
            if not exact and agree["min"] < INT8_TOKEN_AGREEMENT:
                failed.append(f"{name}: agreement {agree} below "
                              f"{INT8_TOKEN_AGREEMENT}")
        for m in range(tp):
            reps = [p["digests"] for p in per if p["coord"][1] == m]
            if any(d != reps[0] for d in reps):
                failed.append(f"{name}: the data replicas of model "
                              f"shard {m} differ")
        if any(p["placement_gap"] not in (None, 0) for p in per):
            failed.append(f"{name}: placement gaps "
                          f"{[p['placement_gap'] for p in per]}")
        shards = tp if kv_split else 1
        if ref_pool_bytes.get(i) and any(
                p["pool_bytes"] * shards != ref_pool_bytes[i] for p in per):
            failed.append(f"{name}: pool bytes {[p['pool_bytes'] for p in per]}"
                          f" vs {ref_pool_bytes[i]} / {shards}")
    return failed


def _fractions(whole, dp: int, tp: int):
    """leaf name -> the number of ranks that split it: dp for a leaf of
    `whole` (whole over `model`), dp tp for every other."""
    return lambda key: dp if key in whole else dp * tp


def _bytes_gates(per, part: str, ref_bytes: int, fraction, name) -> list:
    """Each rank's bytes of `part` ("pool": the K / V leaves and their
    int8 (scale, zero); "resident": the rest) are the meshless engine's
    `ref_bytes` cut by the expected `fraction` of every leaf, and the
    global tree's (`spec_shares`) are `ref_bytes`."""
    failed = []
    scaled = [sum(n * fraction(k) for k, n in p["leaf_bytes"].items()
                  if (k in blk.PAGED_LEAF_NAMES) == (part == "pool"))
              for p in per]
    if any(s != ref_bytes for s in scaled):
        failed.append(f"{name}: {part} bytes a rank "
                      f"{[p[part + '_bytes'] for p in per]}, scaled by the "
                      f"ranks that split each leaf {scaled}, vs {ref_bytes}")
    if any(p["shares"][part][1] != ref_bytes for p in per):
        failed.append(f"{name}: the global {part} tree's bytes "
                      f"{[p['shares'][part][1] for p in per]} vs {ref_bytes}")
    return failed


def _contiguous_gates(per, ref_tokens, ref_bytes, name, gate: bool,
                      fraction) -> list:
    """`mesh_gates` of a contiguous run: every rank's tokens equal rank
    0's and (`gate`) the meshless engine's; each rank holds the caches'
    bytes cut by the expected `fraction` of each leaf (`_bytes_gates`)."""
    failed = []
    if any(not np.array_equal(p["tokens"], per[0]["tokens"]) for p in per):
        failed.append(f"{name}: the ranks' tokens differ")
    agree = compare(per[0]["tokens"], ref_tokens)
    if gate and not agree["exact"]:
        failed.append(f"{name}: tokens differ from the meshless engine's "
                      f"{agree}")
    if ref_bytes:
        failed += _bytes_gates(per, "pool", ref_bytes, fraction, name)
    return failed


def mesh_parity(cfg, params, dp: int, tp: int, pool_dtype: str, *, device,
                backend=None, threads: int = 0, paged: bool = True,
                speculative: Optional[str] = None):
    """The sharded-parity lane of one arch: the meshless engine, then the
    mesh engine on dp x tp spawned ranks, on the same float32 weights
    and prompts (`paged` False: the contiguous layout, fp; `speculative`
    "ngram" or "draft": the paged engine with speculation, whose
    verify-step counts must equal the meshless engine's too). Returns
    (the gates' failures, the meshless tokens, every rank's results)."""
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    spec = dict(speculative=speculative) if speculative else {}
    ecfg = mesh_ecfg(B, S, GEN, pool_dtype=pool_dtype, paged=paged, **spec)
    ref = ServingEngine.build(cfg, ecfg, params=params, device=device)
    reqs = [Request(request_id=i, tokens=prompts[i], max_new_tokens=GEN,
                    arrival=0.0) for i in range(B)]
    ref.run(reqs)
    ref_tokens = np.stack([np.asarray(r.output) for r in reqs])
    np_params = _to_numpy(params)
    layout = "pool" if paged else "contiguous"
    runs = [dict(pool_dtype=pool_dtype, paged=paged, **spec,
                 name=f"{layout} {pool_dtype}"
                 + (f" {speculative}" if speculative else ""))]
    results = mesh_mod.run_ranks(
        mesh_rank, dp * tp,
        (cfg, dp, tp, np_params, prompts, GEN, runs, device),
        device=device, backend=backend, threads=threads)
    failed = mesh_gates(results, {0: ref_tokens},
                        {0: pool_nbytes(ref.caches)}, tp, runs,
                        cfg.num_kv_heads % tp == 0,
                        {0: resident_nbytes(ref.caches)})
    steps = [r[0]["spec_steps"] for r in results]
    if any(n != ref.spec_verify_steps for n in steps):
        failed.append(f"verify steps {steps} vs meshless "
                      f"{ref.spec_verify_steps}")
    return failed, ref_tokens, results


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


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
    ap.add_argument("--mesh", metavar="dpDtpT",
                    help="run the sharded-parity lane on a D x T mesh of "
                    "spawned ranks instead (e.g. dp2tp2)")
    ap.add_argument("--pool-dtype", default="fp", choices=("fp", "int8"),
                    help="with --mesh: the paged pool's dtype")
    ap.add_argument("--contiguous", action="store_true",
                    help="with --mesh: serve the contiguous layout (fp) "
                    "instead of the paged pool")
    ap.add_argument("--backend", choices=("gloo", "nccl"),
                    help="with --mesh: the process group's backend (the "
                    "device's own by default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if args.fault_plan and not args.fleet:
        ap.error("--fault-plan needs --fleet N")
    if args.contiguous and (not args.mesh or args.pool_dtype != "fp"):
        ap.error("--contiguous needs --mesh and an fp pool")
    if args.mesh and args.speculative and (args.contiguous
                                           or len(args.speculative) > 1):
        ap.error("--mesh takes one --speculative mode, on the paged pool")
    mesh = None
    if args.mesh:
        m = re.fullmatch(r"dp(\d+)tp(\d+)", args.mesh)
        if not m:
            ap.error(f"--mesh wants dpDtpT (e.g. dp2tp2), got {args.mesh!r}")
        mesh = int(m.group(1)), int(m.group(2))
    failed = []
    for arch in args.arch or ["smollm_360m"]:
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        params = M.init_model(cfg, device=args.device, seed=0)
        if mesh:
            dp, tp = mesh
            mode = args.speculative[0] if args.speculative else None
            bad, _, results = mesh_parity(
                cfg, params, dp, tp, args.pool_dtype, device=args.device,
                backend=args.backend,
                threads=1 if args.device == "cpu" else 0,
                paged=not args.contiguous, speculative=mode)
            r0 = results[0][0]
            layout = "contiguous" if args.contiguous else "paged"
            print(f"{arch}: mesh=dp{dp}tp{tp} {layout} "
                  f"pool={args.pool_dtype} speculative={mode} "
                  f"substrate={r0['substrate']} pool_bytes/rank="
                  f"{r0['pool_bytes']} resident_bytes/rank="
                  f"{r0['resident_bytes']} verify_steps={r0['spec_steps']} "
                  f"launches={r0['launches']} "
                  f"{'OK' if not bad else 'FAIL ' + '; '.join(bad)}")
            failed += [f"{arch}: {b}" for b in bad]
            continue
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
