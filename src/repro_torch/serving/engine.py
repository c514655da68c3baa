"""Tier-aware continuous-batching serving engine over the physical paged
KV runtime (port of the main path of `repro.serving.engine`).

The engine is an event loop over the cells of `runtime.serve.
make_engine_cells`:

  admit   — pop arrived requests while slots are free AND the admission
            controller projects the pool link below the M/D/1 knee; run
            the bucketed prefill cell, land the request's K/V in the page
            pool through the insert cell, emit its first greedy token
            (or, with `prefill_chunk` set, park the request in a
            prefilling slot);
  chunk   — with chunked prefill, at most one page-aligned prompt chunk
            advances between decode steps, so a long prompt never stalls
            in-flight decode for more than one chunk;
  decode  — one step of the whole slot batch with per-slot positions
            (inactive and prefilling slots are masked by parked write
            cursors); with `speculative` set, one verify step that scores
            k candidate tokens per slot and commits the greedy-matching
            prefix (`serving.speculative`);
  retire  — completed requests free their slot and their KV pages.

With `prefix_cache` on, a radix trie over page-aligned prompt blocks
(`serving.prefix_cache`) maps a request's cached prefix pages into its
block table, shared and refcounted: the bucket path dedupes after its
insert (a shared partial tail page splits copy-on-write on its first
decode write), the chunked path starts at the first divergent chunk.

By default the KV cache IS a physical page pool: the `KVPager` is the
single allocator, its `block_table()` is what the decode and insert cells
read and write through, and its tier tags price every byte. `paged=False`
keeps per-slot contiguous caches instead (the pager still prices them). The clock is dual:
wall time measures what the host and the card actually do; virtual time
prices each step on the target tier topology (compute from the decode
roofline at the chip's data-sheet peak, local/pool bytes from the pager).

With the paged layout, a physical memory substrate (`serving.substrate`)
mirrors the pool-tiered pages into a pinned host twin once per decode
step, on a side stream ("auto": physical on the card, emulated on the
CPU); the device pool stays authoritative, so tokens do not change.

Faults and recovery (`serving.faults`, driven by `serving.fleet`): a slot
can be preempted (`freeze_slot`: pinned, its pages held and tiered to
the pool, or spilled, its pages released) and restored (`thaw_slot`, or
`adopt`'s teacher-forced refill of prompt + emitted history, which also
moves a dead engine's in-flight requests onto a live one). Under
pool exhaustion a bucket admission spill-freezes a strictly
lower-priority slot. `evacuate` strips an engine for recovery and leaves
its pool fully free; `degrade_pool` falls back to local-only paging.
A prefill-role engine (`handoff_role`) parks each completed chunked
prefill as a `HandoffRecord` for the fleet router's pool transfer.

Ported configuration: `EngineConfig()` means the same main path as in the
reference — paged, int8 per-page pools, 16-token pages, bucketed prefill,
LoI admission, the substrate on "auto"; chunked prefill, the prefix
cache, the contiguous layout and speculative decoding are its options.
It serves every arch of the catalog: dense and MoE decoders, the SSM arch
mamba2-780m and the hybrid jamba (whose slot-resident state the pager
prices; chunked prefill, the prefix cache and speculation refuse them as
the reference does), the vision-prefix decoder paligemma (its patch
embeddings take the first `n_prefix` cache rows of a slot) and the
enc-dec seamless (its cross-KV slot-resident). A frontend arch's
embeddings are drawn per request from a generator seeded from (17,
request_id) (`_frontend_extras`); they are not the reference's
`fold_in(PRNGKey(17), id)` numbers, which torch cannot reproduce.
`prefetch` switches the pager's cold-prefix page-in to prediction-driven
staging (accounting; the virtual clock serializes demand page-ins), and
`measured_profile` hands the engine's per-step traffic to the rack
scheduler (`sched.workload.serving_stream`). The reference's
`compile_counts` (jit's executable caches) has no eager counterpart.

Over a mesh (`build(..., mesh=...)`, one process per rank) every rank
runs this same host loop — queue, batcher, pager, admission — on the
same replicated tokens, holds its shard of the weights and of the page
pool, or with `paged=False` of the contiguous caches (its slots over the
dp axes, its block of every slot's positions over `model`;
`runtime.serve.make_engine_cells`), and each decode step hands every
rank the tokens of all slots, so every rank's pager takes the same
decisions. The pager and the substrate price global bytes; each rank's
pinned twin holds its shard of the pool. Every stack serves so: an SSM
or hybrid stack's state and conv tails and an enc-dec stack's cross-KV
are slot-resident shards of the rank. With speculation every rank runs
the same proposer (the draft model replicated, whole on every rank) and
the same acceptance on the verify cell's gathered picks, so the host
loops stay identical.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.common import hw
from repro_torch.common.config import SHAPES, ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import leaf_bytes
from repro_torch.core import interference as itf
from repro_torch.core import roofline as rl
from repro_torch.core import tiers as tr
from repro_torch.models import blocks as blk
from repro_torch.models import model as M
from repro_torch.models.frontends import synthetic_frontend_embeds
from repro_torch.models.module import cast_params
from repro_torch.runtime import capability
from repro_torch.runtime import serve as serve_rt
from repro_torch.runtime import sharding as shd
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.kv_pager import LOCAL, KVPager, PagerConfig
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving import speculative as spec
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.substrate import TierSubstrate

# Minimum per-request greedy-token agreement an int8 pool must keep vs the
# fp reference (lockstep positions): per-page block quantization bounds
# logit drift, but a near-tie can flip a token and diverge the suffix.
INT8_TOKEN_AGREEMENT = 0.5


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 8
    max_seq: int = 128              # prompt+gen per slot
    prefill_buckets: tuple = (32,)
    # --- paged-KV runtime ---
    paged: bool = True              # cache = physical page pool + block
    # tables end-to-end (False: per-slot contiguous caches, fp only)
    pool_dtype: str = "int8"        # "int8" per-page block quantization
    # (quantize-on-insert, dequantize-in-kernel), "fp" stores cfg.dtype
    # exactly, "bf16" a 2-byte cast
    prefill_chunk: Optional[int] = None   # tokens per prefill chunk:
    # interleave prompt chunks with decode steps instead of serializing
    # whole prompts against the batch
    # --- pager ---
    page_tokens: int = 16
    local_budget_frac: Optional[float] = 0.5   # of peak KV bytes; None=all
    local_budget_bytes: Optional[float] = None  # absolute local budget,
    # overriding the fraction
    pager_policy: str = "hotness"              # hotness | static | none
    hot_window: int = 32
    cold_touch: float = 0.05
    prefetch: Optional[str] = None   # prediction-driven page-in: a
    # predictor of `prefetch.predictors` (see `serving.kv_pager`)
    prefetch_degree: int = 8
    # --- shared-prefix radix cache (serving.prefix_cache) ---
    prefix_cache: bool = False      # dedup page-aligned shared prompt
    # prefixes across requests (refcounted pages, COW tail splits)
    prefix_cache_pages: Optional[int] = None   # trie capacity cap (pages)
    # --- physical memory substrate ---
    substrate: str = "auto"         # off | emulated | physical | auto —
    # mirror pool-tiered pages into a pinned host twin (serving.substrate);
    # "auto" is physical where the card can map pinned memory
    # --- admission ---
    admission: str = "loi"                     # loi | greedy
    knee_excess: float = 0.75
    catalog_arch: Optional[str] = None         # profile_for prior (paper
    catalog_shape: str = "decode_32k"          # §7.2, core.quantify)
    # --- speculative decoding (serving.speculative) ---
    speculative: str = "off"        # off | ngram | draft — propose
    # speculative_k-1 draft tokens per slot and score all k candidates in
    # ONE paged verify call; bit-identical tokens to greedy on fp pools
    speculative_k: int = 4          # candidates per verify call (>= 2)
    draft_arch: Optional[str] = None   # draft model for "draft": None =
    # self-draft (the target drafts for itself), else the reduced config
    # of that arch in the target's dtype
    # --- virtual clock ---
    step_overhead_s: float = 5e-6              # host dispatch/launch floor


def check_config(cfg: ModelConfig, ecfg: EngineConfig) -> None:
    """The reference's `ValueError`s for chunking or sharing without the
    paged layout (a bad `prefetch` name raises in `PagerConfig`)."""
    if not ecfg.paged and ecfg.prefill_chunk:
        raise ValueError("chunked prefill requires the paged layout")
    if not ecfg.paged and ecfg.prefix_cache:
        raise ValueError(
            "prefix_cache needs paged=True: sharing happens by aliasing "
            "block-table rows onto one physical page")


def frontend_extras(cfg: ModelConfig, request_id: int, bucket: int,
                    device) -> dict:
    """A request's frontend embeddings for its prefill batch: "patches"
    (vision) or "frames" (audio, `bucket` rows), drawn on `device` from a
    generator seeded from (17, request_id); {} for token-only archs."""
    if cfg.frontend not in ("vision_stub", "audio_stub"):
        return {}
    gen = torch.Generator(device).manual_seed((17 << 32) + request_id)
    name = "patches" if cfg.frontend == "vision_stub" else "frames"
    return {name: synthetic_frontend_embeds(cfg, 1, bucket, gen)}


class AdmissionController:
    """Throttle slot admissions at the projected pool-link LoI knee.

    Per-slot LoI is seeded from a prior and refined online with an EMA of
    the pager's measured pool time per step. Admitting slot n+1 is allowed
    while (n+1) * per_slot_loi plus the measured prefetch-excess LoI stays
    under the corridor budget (`core.interference.corridor_budget`)."""

    EMA = 0.5

    def __init__(self, topo: tr.TierTopology, *, mode: str = "loi",
                 knee_excess: float = 0.75, prior_loi: float = 0.0):
        if mode not in ("loi", "greedy"):
            raise ValueError(f"unknown admission mode {mode!r}")
        self.mode = mode
        self.budget = itf.corridor_budget(topo, knee_excess)
        self.per_slot_loi = float(prior_loi)
        self.excess_loi = 0.0
        self.blocks = 0

    @classmethod
    def from_catalog(cls, topo, arch: Optional[str], shape_name: str, *,
                     chip: Optional[hw.ChipSpec] = None, n_chips: int = 1,
                     **kw) -> "AdmissionController":
        """Seed the per-slot LoI with a catalog workload's prior: its
        injected LoI (`core.quantify.profile_for`, priced on `n_chips`
        cards of `chip` with `topo`) over the shape's global batch; 0
        without `arch`."""
        prior = 0.0
        if arch is not None:
            from repro_torch.core.quantify import profile_for

            prof = profile_for(arch, shape_name, chip=chip or hw.H100,
                               topo=topo, n_chips=n_chips)
            prior = prof.injected_loi() / SHAPES[shape_name].global_batch
        return cls(topo, prior_loi=prior, **kw)

    def observe(self, n_active: int, t_pool: float, dt: float,
                t_excess: float = 0.0) -> None:
        if n_active < 1 or dt <= 0.0:
            return
        measured = min(1.0, t_pool / dt) / n_active
        self.per_slot_loi = (
            (1 - self.EMA) * self.per_slot_loi + self.EMA * measured
        )
        self.excess_loi = (
            (1 - self.EMA) * self.excess_loi
            + self.EMA * min(1.0, max(t_excess, 0.0) / dt)
        )

    def projected_loi(self, n_slots: int) -> float:
        return min(1.0, n_slots * self.per_slot_loi)

    def admit(self, n_active: int) -> bool:
        if self.mode == "greedy" or n_active == 0:
            return True     # never deadlock an idle engine
        ok = (self.projected_loi(n_active + 1) + self.excess_loi
              <= self.budget)
        if not ok:
            self.blocks += 1
        return ok


@dataclasses.dataclass
class ServeStats:
    n_requests: int
    tokens: int
    steps: int
    wall_s: float
    virtual_s: float
    ttft: np.ndarray               # per request, virtual seconds
    tpot: np.ndarray               # per generated token (after the first)
    decode_stall: np.ndarray       # virtual gap between decode steps
    pager: dict
    admission_blocks: int
    max_concurrency: int
    prefix: dict = dataclasses.field(default_factory=dict)   # prefix-cache
    # counter deltas for this run (empty when the cache is off)
    substrate: dict = dataclasses.field(default_factory=dict)  # transfer-
    # ledger deltas (serving.substrate) for this run; placement_bytes /
    # resident_pages are end-of-run levels (empty when the substrate is
    # off)
    spec: dict = dataclasses.field(default_factory=dict)   # speculative-
    # decoding deltas: verify_steps / emitted / draft_calls /
    # accept_len_mean (tokens each slot commits per verify step). Empty
    # when speculation is off; `tokens` already counts every accepted token
    faults: dict = dataclasses.field(default_factory=dict)  # fault-
    # recovery deltas (serving.faults): preempts / restores / spills /
    # migrations_in / reprefilled_tokens (recovery overhead: prompt +
    # history tokens recomputed by teacher-forced refill) / retries /
    # retry_bytes (failed substrate transfer attempts) / backoff_s
    # (virtual seconds the clock charged for retry backoff). Empty on
    # fault-free runs

    def summary(self) -> Dict[str, float]:
        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else float("nan")

        out = {
            "n_requests": self.n_requests,
            "tokens": self.tokens,
            "steps": self.steps,
            "tok_per_s_wall": self.tokens / max(self.wall_s, 1e-9),
            "tok_per_s_virtual": self.tokens / max(self.virtual_s, 1e-12),
            "ttft_p50_s": pct(self.ttft, 50),
            "tpot_p50_s": pct(self.tpot, 50),
            "tpot_p99_s": pct(self.tpot, 99),
            "stall_p95_s": pct(self.decode_stall, 95),
            "remote_share": self.pager["remote_share"],
            "demand_share": self.pager.get("demand_share", 0.0),
            "admission_blocks": self.admission_blocks,
            "max_concurrency": self.max_concurrency,
        }
        if self.prefix:
            out["prefix_hit_rate"] = self.prefix["hit_rate"]
            out["cow_splits"] = self.pager.get("cow_splits", 0)
        if self.substrate:
            # MEASURED physical tier traffic (real tensor nbytes on the
            # transfer streams)
            out["substrate_transfer_bytes"] = (
                self.substrate["page_out_bytes"]
                + self.substrate["page_in_bytes"]
                + self.substrate["handoff_bytes"]
            )
            out["substrate_placement_bytes"] = \
                self.substrate["placement_bytes"]
        if self.spec:
            out["accept_len_mean"] = self.spec["accept_len_mean"]
            out["verify_steps"] = self.spec["verify_steps"]
        if self.faults:
            out["fault_preempts"] = self.faults["preempts"]
            out["fault_restores"] = self.faults["restores"]
            out["fault_retries"] = self.faults["retries"]
            out["fault_retry_bytes"] = self.faults["retry_bytes"]
            out["recovery_overhead_tokens"] = \
                self.faults["reprefilled_tokens"]
        return out


@dataclasses.dataclass
class HandoffRecord:
    """A completed prefill awaiting pool transfer to a decode-role engine
    (disaggregated prefill/decode, `serving.fleet.roles`). The prefill
    engine emitted the first token and parked the slot in the `handoff`
    phase; `pages` are the slot's physical prompt pages, guard-pinned so
    nothing (COW splits, prefix-cache reclaim) can recycle them before
    the transfer copies their payload out. `complete_handoff` drops the
    pin and releases the slot."""

    slot: int
    request: object               # serving.queue.Request
    first_token: int
    n_tokens: int                 # cached prompt tokens to transfer
    pages: List[int]              # physical page ids, logical order
    t_emit: float                 # prefill engine's clock at completion


@dataclasses.dataclass
class FrozenSlot:
    """A preempted in-flight request (see `freeze_slot`). Two flavors: a
    PINNED freeze keeps the slot's physical pages alive under a freeze
    pin (tagged pool tier, so the substrate pages their payload out to
    the host twin on the next drain) and `thaw_slot` remaps them
    wholesale; a SPILLED freeze (`pages is None`) released the pages
    entirely — restore runs the teacher-forced refill of prompt +
    emitted history (`adopt`), which is also how a dead engine's
    in-flight requests migrate to a live one."""

    request: object               # serving.queue.Request
    length: int                   # cached tokens at freeze (== slot.t)
    emitted: int                  # tokens generated before the freeze
    last_token: int               # next decode step's feed token
    pages: Optional[np.ndarray]   # physical page ids; None = spilled
    t_frozen: float               # engine clock at preemption


def _kv_bytes_per_token(acaches) -> float:
    """Self-attention K/V bytes per cached token per slot from the cache
    tree, dtype-aware (int8 payload plus the float32 (scale, zero) rows
    amortized over the page's tokens)."""
    total = 0.0
    for c in acaches.values():
        if "k" not in c:
            continue
        k = c["k"]
        tokens = k.shape[1] * k.shape[2]   # paged: P_phys * page_tokens;
        # contiguous: n_slots * max_seq
        for key in blk.PAGED_LEAF_NAMES:
            if key in c:
                total += leaf_bytes(c[key]) / tokens
    return total


def _resident_bytes_per_slot(acaches) -> float:
    """Per-slot bytes of the non-paged decode state (SSM state and conv
    tails): pinned local, streamed every step."""
    total = 0.0
    for c in acaches.values():
        for key, leaf in c.items():
            if key not in blk.PAGED_LEAF_NAMES:
                total += leaf_bytes(leaf) / leaf.shape[1]
    return total


class ServingEngine:
    """Continuous-batching serve loop over fixed-shape cells."""

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, params,
                 cells: serve_rt.EngineCells,
                 topo: Optional[tr.TierTopology] = None,
                 chip: Optional[hw.ChipSpec] = None):
        """`topo`/`chip` price the virtual clock and the catalog admission
        prior (one H100 by default). Over a mesh (`cells.ctx.mesh`)
        `params` is the rank's shard (`build` cuts it)."""
        check_config(cfg, ecfg)
        self.cfg = cfg
        self.ecfg = ecfg
        self.cells = cells
        self.device = cells.device
        # serving copy of the master weights, cast once to cfg.dtype
        self.params = cast_params(params, cfg.dtype)
        self.topo = topo or tr.h100_topology()
        self.chip = chip or hw.H100

        self.npfx = cells.n_prefix
        # paged mode parks PAST the pool's page-aligned position space: a
        # parked position inside the last partial logical page would pass
        # the page-range guard and scribble into physical page 0 through
        # the slot's zeroed block-table row; contiguous caches drop any
        # write at or past their extent
        park = (cells.n_pages * cells.page_tokens if cells.paged
                else cells.max_seq_total)
        self.batcher = ContinuousBatcher(
            ecfg.n_slots, ecfg.prefill_buckets, park_pos=park,
        )
        kv_tok = _kv_bytes_per_token(cells.abstract_caches)
        resident = _resident_bytes_per_slot(cells.abstract_caches)
        budget = None
        if ecfg.local_budget_bytes is not None:
            budget = float(ecfg.local_budget_bytes)
        elif ecfg.local_budget_frac is not None:
            peak = kv_tok * cells.max_seq_total * ecfg.n_slots
            budget = ecfg.local_budget_frac * peak
        self.pager = KVPager(
            ecfg.n_slots, cells.max_seq_total, kv_tok, resident,
            PagerConfig(
                page_tokens=ecfg.page_tokens,
                local_budget_bytes=budget,
                policy=ecfg.pager_policy,
                hot_window=ecfg.hot_window,
                cold_touch=ecfg.cold_touch,
                prefetch=ecfg.prefetch,
                prefetch_degree=ecfg.prefetch_degree,
            ),
            topo=self.topo,
        )
        self.prefix_cache: Optional[PrefixCache] = None
        if ecfg.prefix_cache:
            if cfg.frontend or cfg.num_encoder_layers:
                raise ValueError(
                    "prefix_cache requires token-only decoder archs: "
                    "frontend embeds and encoder cross-KV are per-request "
                    "state, so identical prompt tokens do not imply "
                    "identical cached KV"
                )
            if not serve_rt.chunked_prefill_supported(cfg):
                raise ValueError(
                    f"{cfg.name}: prefix_cache needs an attention-only "
                    "decoder stack — SSM/conv state is a per-slot "
                    "recurrence, not page-addressable KV, so aliasing "
                    "block-table rows shares nothing there"
                )
            self.prefix_cache = PrefixCache(
                ecfg.page_tokens, capacity_pages=ecfg.prefix_cache_pages,
            )
            # the allocator evicts LRU trie leaves before declaring the
            # pool exhausted
            self.pager.prefix_cache = self.prefix_cache
        self.admission = AdmissionController.from_catalog(
            self.topo, ecfg.catalog_arch, ecfg.catalog_shape, chip=self.chip,
            mode=ecfg.admission, knee_excess=ecfg.knee_excess,
        )
        if cells.cache_pspecs is not None:
            self.caches = shd.zeros_for_shards(
                cells.abstract_caches, cells.cache_pspecs,
                cells.ctx.mesh, self.device)
        elif cells.paged:
            self.caches = M.make_paged_decode_caches(
                cfg, ecfg.n_slots, cells.max_seq_total, cells.page_tokens,
                self._enc_len(), pool_dtype=cells.pool_dtype,
                sz_granularity=cells.sz_granularity, device=self.device,
            )
        else:
            self.caches = M.make_decode_caches(
                cfg, ecfg.n_slots, cells.max_seq_total, self._enc_len(),
                device=self.device)
        # physical memory substrate: host-resident pool twin reconciled
        # against the pager's tier map once per decode step. Disabled
        # when requested off, on the contiguous layout, and on cache
        # trees with no paged leaves (SSM-only stacks).
        self.substrate: Optional[TierSubstrate] = None
        if cells.paged and ecfg.substrate != "off":
            mode = capability.substrate_mode(ecfg.substrate, self.device)
            sub = TierSubstrate(
                self.caches, mode,
                host_memory_kind=(self.topo.pool.memory_kind
                                  or "pinned_host"),
                mesh=cells.ctx.mesh, pool_pspec=cells.cache_pspecs)
            if sub.enabled:
                self.substrate = sub
        self.tokens = np.zeros(ecfg.n_slots, dtype=np.int32)
        # --- speculative decoding (serving.speculative) ---
        self.spec_verify_steps = 0     # verify calls (speculative steps)
        self.spec_slot_steps = 0       # per-slot verify rows (sum active)
        self.spec_emitted = 0          # tokens committed by verify steps
        self.spec_draft_calls = 0      # draft-cell invocations
        self.draft_caches = None
        self._draft_fed = np.zeros(ecfg.n_slots, dtype=np.int64)
        self._draft_park = 0
        self._draft_tok_bytes = 0.0
        self._draft_params_n = 0
        if cells.draft_fn is not None:
            # contiguous scratch caches for the draft model, sized so the
            # k-1 self-fed proposal positions fit past max_seq_total
            dseq = cells.max_seq_total + cells.spec_k
            self.draft_caches = M.make_decode_caches(
                cells.draft_cfg, ecfg.n_slots, dseq, device=self.device)
            self._draft_park = dseq
            total_b = sum(leaf_bytes(leaf)
                          for c in self.draft_caches.values()
                          for leaf in c.values())
            self._draft_tok_bytes = total_b / (ecfg.n_slots * dseq)
            self._draft_params_n = cells.draft_cfg.active_param_count()
        self._active_params = cfg.active_param_count()
        self.steps = 0
        self.virtual_s = 0.0
        self._t_compute_s = 0.0
        self._prev_excess_b = 0.0      # pager excess fed to admission
        self._decode_gaps: List[float] = []
        self._last_decode_end: Optional[float] = None
        self._bt_host = None           # block-table upload cache: the
        self._bt_dev = None            # pager returns the SAME array
        # object until the mapping changes, so steady-state decode skips
        # the per-step host->device copy by identity
        self._max_conc = 0
        self.cancelled = 0             # in-flight cancellations swept
        # --- disaggregated prefill/decode (serving.fleet.roles) ---
        self.handoff_role = False      # True: completed chunked prefills
        # park in the `handoff` phase and queue a HandoffRecord instead of
        # joining this engine's decode batch
        self.handoff_outbox: List[HandoffRecord] = []
        # --- fault tolerance (serving.faults) ---
        self.faults = None             # FaultInjector; the fleet router
        # wires it (and engine_id) after build — unset, every fault site
        # is dormant
        self.engine_id = 0
        self.frozen: List[FrozenSlot] = []   # preempted slots, FIFO
        self._dead = False
        self._stall_until = 0.0
        self._degraded = False         # pool tier lost -> local-only
        self._fault_counters: Dict[str, float] = {
            "preempts": 0, "restores": 0, "spills": 0,
            "migrations_in": 0, "reprefilled_tokens": 0,
            "budget_shrinks": 0, "degraded": 0, "backoff_s": 0.0,
        }

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, cfg: ModelConfig, ecfg: EngineConfig, *, params=None,
              seed: int = 0, topo=None, chip=None, device=None, ctx=None,
              mesh=None, rules=None) -> "ServingEngine":
        """Engine on `device` (the card by default; raises without one).
        Without `params`, float32 master weights are drawn from `seed`.
        With `mesh` (a `DeviceMesh` this process is a rank of; `ctx`
        defaults to `launch.mesh.ctx_for_mesh(mesh)`, `rules` to the
        serving rules) `params` is the global tree, cut here into the
        rank's shard."""
        check_config(cfg, ecfg)
        device = resolve_device(device)
        draft_cfg = None
        if ecfg.speculative == "draft":
            if ecfg.draft_arch is None:
                draft_cfg = cfg      # self-draft: the target drafts for
                # itself (perfect-proposer ceiling; parity testing)
            else:
                draft_cfg = dataclasses.replace(
                    configs.reduced(ecfg.draft_arch), dtype=cfg.dtype)
        # int8 pools flip to per-token sub-scales under speculation: the
        # verify cell's k candidate rows land in one tail page, which the
        # per-page requantize round trip cannot do collision-free
        sz_gran = ("token" if ecfg.speculative != "off"
                   and ecfg.pool_dtype == "int8" else "page")
        enc_len = max(ecfg.prefill_buckets) if cfg.num_encoder_layers else 0
        cells = serve_rt.make_engine_cells(
            cfg, n_slots=ecfg.n_slots, max_seq=ecfg.max_seq,
            buckets=ecfg.prefill_buckets, enc_len=enc_len, paged=ecfg.paged,
            page_tokens=ecfg.page_tokens,
            prefill_chunk=ecfg.prefill_chunk or 0,
            pool_dtype=ecfg.pool_dtype, sz_granularity=sz_gran,
            speculative=ecfg.speculative, spec_k=ecfg.speculative_k,
            draft_cfg=draft_cfg, device=device, ctx=ctx, mesh=mesh,
            rules=rules,
        )
        if params is None:
            params = M.init_model(
                cfg, torch.Generator(device).manual_seed(seed))
        if cells.param_pspecs is not None:
            params = shd.shard_tree(params, cells.param_pspecs,
                                    cells.ctx.mesh)
        return cls(cfg, ecfg, params, cells, topo=topo, chip=chip)

    def _enc_len(self) -> int:
        return (max(self.ecfg.prefill_buckets)
                if self.cfg.num_encoder_layers else 0)

    # ------------------------------------------------------------ admit
    def _frontend_extras(self, req: Request, bucket: int) -> dict:
        return frontend_extras(self.cfg, req.request_id, bucket,
                               self.device)

    def _admit(self, req: Request, now: float) -> None:
        if req.output:
            raise ValueError(
                f"request {req.request_id} was already served — build a "
                "fresh trace per run (Request objects are consumed)"
            )
        if req.prompt_len + req.max_new_tokens > self.ecfg.max_seq:
            raise ValueError(
                f"request {req.request_id}: prompt+gen exceeds max_seq "
                f"{self.ecfg.max_seq}"
            )
        if self.cells.chunk_fn is not None:
            self._admit_chunked(req, now)
            return
        bucket = self.batcher.bucket_for(req.prompt_len)
        # shared-prefix match BEFORE any allocation, guard-pinned so the
        # admission's own page allocation cannot reclaim the matched trie
        # pages out from under the hit
        hit = None
        if self.prefix_cache is not None:
            hit = self.prefix_cache.match(req.tokens)
            if hit is not None:
                self.pager.pin(hit.all_pages)
        batch = {"tokens": torch.tensor(req.tokens[None, :],
                                        device=self.device),
                 **self._frontend_extras(req, bucket)}
        slot_caches, tok = self.cells.prefill_fns[bucket](self.params, batch)
        start = self.npfx + req.prompt_len
        slot = self.batcher.admit(req, start_pos=start)
        # the pager allocates BEFORE the insert: in paged mode the insert
        # cell writes through the block table, so the slot's pages must be
        # owned (in contiguous mode the order is irrelevant)
        self.pager.admit(slot.index, start)
        if self.cells.paged:
            self._fence()
            self.caches = self.cells.insert_fns[bucket](
                self.caches, slot_caches, slot.index,
                self._block_table_dev(),
            )
        else:
            self.caches = self.cells.insert_fns[bucket](
                self.caches, slot_caches, slot.index)
        n_matched = 0
        if self.prefix_cache is not None:
            if hit is not None:
                # insert-then-dedupe: the insert wrote the full prompt into
                # private pages; the matched prefix now remaps onto the
                # trie's identical pages and the duplicates free, so the
                # matched pages cost no pool capacity and no prefill time
                self.pager.remap_shared(slot.index, hit.all_pages)
                self.pager.unpin(hit.all_pages)
                n_matched = hit.n_tokens
            self.prefix_cache.insert(
                req.tokens, self.pager.phys[slot.index], self.pager,
                include_partial=True,
            )
        self.virtual_s += self._prefill_dt(start - n_matched)
        first = int(tok[0])
        self.tokens[slot.index] = first
        req.admitted = now
        req.output.append(first)
        req.token_times.append(self.virtual_s)
        if req.done:                      # max_new_tokens == 1
            req.finished = self.virtual_s
            self._retire(slot)

    def _admit_chunked(self, req: Request, now: float) -> None:
        """Chunked admission: the request only claims a slot; its prompt
        advances chunk by chunk in `_prefill_tick`, interleaved with
        decode steps."""
        C = self.cells.chunk
        if req.prompt_len <= 0 or req.prompt_len % C:
            raise ValueError(
                f"request {req.request_id}: prompt_len {req.prompt_len} "
                f"must be a positive multiple of prefill_chunk {C}"
            )
        # prefix-cache hit: map the matched full pages shared and start
        # chunking at the first divergent CHUNK — those chunks never tick,
        # so their compute and virtual prefill time are skipped. The final
        # chunk always runs (its logits emit the first token), so the
        # chunk write never lands in a shared page
        n_share = 0
        shared_pages: List[int] = []
        if self.prefix_cache is not None:
            hit = self.prefix_cache.match(req.tokens)
            if hit is not None:
                n_share = (min(hit.n_full_tokens, req.prompt_len - C)
                           // C) * C
                if n_share > 0:
                    shared_pages = hit.pages[
                        :n_share // self.ecfg.page_tokens]
                    self.pager.pin(shared_pages)   # guard pin
                else:
                    n_share = 0
        slot = self.batcher.admit(req, start_pos=0, phase="prefill",
                                  prefill_pos=n_share)
        if n_share:
            self.pager.map_shared(slot.index, shared_pages, n_share)
            self.pager.unpin(shared_pages)
        req.admitted = now

    def _prefill_tick(self) -> bool:
        """Advance the oldest mid-prefill request by ONE chunk (chunked
        mode only). Returns True if a chunk ran — at most one per engine
        loop iteration, so prefill interleaves with decode instead of
        serializing a whole prompt against the batch."""
        if self.cells.chunk_fn is None:
            return False
        slots = self.batcher.prefilling_slots()
        if not slots:
            return False
        slot = slots[0]
        req = slot.request
        C = self.cells.chunk
        end = slot.prefill_pos + C
        # own the chunk's pages first: the cell writes through the table
        # it is handed, so the block-table upload must follow the extend
        self.pager.extend(slot.index, end)
        toks = torch.tensor(req.tokens[None, slot.prefill_pos:end],
                            device=self.device)
        self._fence()
        tok, self.caches = self.cells.chunk_fn(
            self.params, toks, self.caches, slot.index,
            slot.prefill_pos // C, self._block_table_dev(),
        )
        self.virtual_s += self._prefill_dt(C, final=(end == req.prompt_len))
        slot.prefill_pos = end
        if end == req.prompt_len:
            if self.prefix_cache is not None:
                # chunked prompts are page multiples: full blocks only
                self.prefix_cache.insert(
                    req.tokens, self.pager.phys[slot.index], self.pager,
                    include_partial=False,
                )
            first = int(tok[0])
            req.output.append(first)
            req.token_times.append(self.virtual_s)
            if req.done:                  # max_new_tokens == 1
                self.batcher.begin_decode(slot, start_pos=req.prompt_len)
                req.finished = self.virtual_s
                self._retire(slot)
            elif self.handoff_role:
                # disaggregated prefill role: do NOT join this engine's
                # decode batch — park the slot (its write cursor stays
                # masked), guard-pin the prompt pages, and queue the
                # handoff for the fleet router's pool transfer
                pages = [int(p) for p in self.pager.phys[
                    slot.index, :self._pages_needed(req.prompt_len)]]
                self.pager.pin(pages)
                slot.phase = "handoff"
                self.handoff_outbox.append(HandoffRecord(
                    slot=slot.index, request=req, first_token=first,
                    n_tokens=req.prompt_len, pages=pages,
                    t_emit=self.virtual_s,
                ))
            else:
                self.batcher.begin_decode(slot, start_pos=req.prompt_len)
                self.tokens[slot.index] = first
        return True

    def complete_handoff(self, rec: HandoffRecord) -> None:
        """The transfer copied `rec`'s pages into the decode engine's
        pool: drop the guard pin and release the prefill slot (its pages
        return to this engine's free list unless the prefix trie still
        holds them). The copy is already queued on the stream every
        later write of these pages goes to, so a page freed here cannot
        be overwritten before the copy has read it."""
        slot = self.batcher.slots[rec.slot]
        if slot.request is not rec.request:
            raise RuntimeError(
                f"handoff slot {rec.slot} no longer owns request "
                f"{rec.request.request_id}"
            )
        self.pager.unpin(rec.pages)
        self._retire(slot)

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.ecfg.page_tokens)

    def _reclaimable(self, need: int) -> bool:
        """Can `need` pages be produced without preempting anyone? Free
        pages plus trie-cached pages (LRU-reclaimable clean copies). This
        over-estimates — trie pages aliased by live slots survive
        reclaim — exactly as the reference does."""
        free = self.pager.counters()["free_pages"]
        cached = (self.prefix_cache.counters()["cached_pages"]
                  if self.prefix_cache is not None else 0)
        return free + cached >= need

    def _preempt_victim(self, priority: int):
        """The active decode slot to freeze for an incoming request of
        `priority`: strictly LOWER class only (higher priority number),
        youngest admission within the lowest class — preempting equals
        or betters never happens, so thaw cannot cycle."""
        victims = [s for s in self.batcher.slots
                   if s.active and s.request.priority > priority]
        if not victims:
            return None
        return max(victims, key=lambda s: (s.request.priority, s.seq))

    def _ensure_pages_for(self, req: Request) -> bool:
        """Make room for `req`'s prompt pages, spill-freezing strictly
        lower-priority decode slots if the pool cannot otherwise supply
        them. Returns False (leave `req` queued) when no victim exists.
        Bucket-path paged mode only: the chunked path allocates per chunk
        and the contiguous layout has no shared pool to exhaust."""
        if not self.cells.paged or self.cells.chunk_fn is not None:
            return True
        need = self._pages_needed(self.npfx + req.prompt_len)
        while not self._reclaimable(need):
            victim = self._preempt_victim(req.priority)
            if victim is None:
                return False
            self.freeze_slot(victim, spill=True)
        return True

    def freeze_slot(self, slot, *, spill: bool = False) -> FrozenSlot:
        """Preempt an active decode slot: snapshot (emitted count, cached
        length, feed token), evict its pages wholesale and release the
        slot. Pinned mode keeps the pages alive under a freeze pin,
        retagged pool tier (the substrate's next drain pages their
        payload out to the host twin); spill mode releases them outright
        — restore then teacher-force-refills from the request's own
        history."""
        if not slot.active:
            raise RuntimeError(
                f"freeze needs an active decode slot, got {slot.index} "
                f"in phase {slot.phase!r}")
        if not spill and not self.cells.paged:
            raise RuntimeError(
                "pinned freeze is paged-only: contiguous caches key KV by "
                "slot index, so remapping pages moves nothing")
        fs = FrozenSlot(
            request=slot.request,
            length=int(slot.t),
            emitted=int(slot.emitted),
            last_token=int(self.tokens[slot.index]),
            pages=None,
            t_frozen=self.virtual_s,
        )
        snap = self.pager.freeze(slot.index, spill=spill)
        fs.pages = snap["pages"]
        if snap["length"] != fs.length:
            raise RuntimeError(
                f"freeze: pager length {snap['length']} != slot cursor "
                f"{fs.length} for slot {slot.index}")
        self.batcher.release(slot)
        self._draft_fed[slot.index] = 0
        self.frozen.append(fs)
        self._fault_counters["preempts"] += 1
        if spill:
            self._fault_counters["spills"] += 1
        return fs

    def thaw_slot(self, fs: FrozenSlot) -> bool:
        """Resume a frozen request on THIS engine. A pinned snapshot
        remaps its pages wholesale into a fresh slot (no recompute); a
        spilled one re-runs prompt + emitted history through `adopt`'s
        teacher-forced refill. Returns False if no slot/pages are
        available right now."""
        if self.batcher.n_free == 0:
            return False
        if fs.pages is None:
            return self.adopt(fs.request, self.virtual_s, migrated=False)
        slot = self.batcher.admit(fs.request, start_pos=fs.length,
                                  emitted=fs.emitted)
        self.pager.thaw(slot.index,
                        {"pages": fs.pages, "length": fs.length})
        self.tokens[slot.index] = fs.last_token
        self._fault_counters["restores"] += 1
        return True

    def adopt(self, req: Request, now: float, *,
              migrated: bool = True) -> bool:
        """Resume a request that already emitted tokens elsewhere (a dead
        engine's in-flight slot, or a spilled freeze): re-prefill the
        prompt through the bucket cell, then teacher-force the emitted
        history through the plain decode cell one token at a time —
        every other slot's write cursor stays parked, so their KV and
        cursors are untouched. Greedy decode is deterministic per request
        and the decode cell computes each row from that row's own inputs,
        so the recomputed KV matches what the recovered continuation
        would have attended to and the token stream stays the same (fp
        pools). Returns False when no slot or pages are available yet
        (the caller retries on a later tick)."""
        if not req.output:
            raise ValueError(
                f"request {req.request_id} has no emitted history — "
                "requeue it through the router instead of adopting")
        if self.cells.chunk_fn is not None:
            raise RuntimeError(
                "adopt needs the bucketed prefill cell; chunked-prefill "
                "engines cannot replay a migrated request")
        if self.batcher.n_free == 0:
            return False
        emitted = [int(t) for t in req.output]
        start = self.npfx + req.prompt_len
        if self.cells.paged and not self._reclaimable(
                self._pages_needed(start + len(emitted))):
            return False
        bucket = self.batcher.bucket_for(req.prompt_len)
        batch = {"tokens": torch.tensor(req.tokens[None, :],
                                        device=self.device),
                 **self._frontend_extras(req, bucket)}
        slot_caches, _ = self.cells.prefill_fns[bucket](self.params, batch)
        slot = self.batcher.admit(req, start_pos=start,
                                  emitted=len(emitted))
        self.pager.admit(slot.index, start)
        if self.cells.paged:
            self._fence()
            self.caches = self.cells.insert_fns[bucket](
                self.caches, slot_caches, slot.index,
                self._block_table_dev(),
            )
        else:
            self.caches = self.cells.insert_fns[bucket](
                self.caches, slot_caches, slot.index)
        self.virtual_s += self._prefill_dt(start)
        self._force_feed(slot, start, emitted[:-1])
        self.tokens[slot.index] = emitted[-1]
        slot.t = start + len(emitted) - 1
        self._fault_counters["restores"] += 1
        if migrated:
            self._fault_counters["migrations_in"] += 1
        self._fault_counters["reprefilled_tokens"] += (
            start + max(0, len(emitted) - 1))
        return True

    def _force_feed(self, slot, start: int, toks: List[int]) -> None:
        """Teacher-forced replay: feed each already-emitted token at its
        original position through the full-batch decode cell. The
        returned tokens are DISCARDED — determinism guarantees they equal
        the history being fed — only the KV writes matter. Other slots
        ride along parked (masked writes, garbage logits ignored), so
        interleaving a replay between fleet steps perturbs nothing. One
        decode launch per layer per replayed token."""
        if not toks:
            return
        n = self.ecfg.n_slots
        mask = np.zeros(n, dtype=bool)
        mask[slot.index] = True
        park = self.batcher.park_pos
        for j, tok in enumerate(toks):
            t_vec = np.full(n, park, dtype=np.int32)
            t_vec[slot.index] = start + j
            feed = self.tokens.copy()
            feed[slot.index] = np.int32(tok)
            feed_dev = torch.tensor(feed, device=self.device)
            t_dev = torch.tensor(t_vec, device=self.device)
            if self.cells.paged:
                self._fence()
                for old, new in self.pager.ensure_tail_pages(mask):
                    self.caches = self.cells.copy_fn(self.caches, old, new)
                _, _, self.caches = self.cells.decode_fn(
                    self.params, feed_dev, self.caches, t_dev,
                    self._block_table_dev(),
                )
            else:
                _, _, self.caches = self.cells.decode_fn(
                    self.params, feed_dev, self.caches, t_dev)
            self.pager.step(mask)
        # priced as recovery recompute: decode-shaped flops over the
        # replayed tokens, KV writes to the local tier, no per-step
        # launch floor (the replay rides one recovery event)
        self.virtual_s += self._prefill_dt(len(toks), final=False)

    def _thaw_tick(self, q: RequestQueue) -> bool:
        """Restore frozen slots (oldest first) while capacity allows. A
        frozen request yields to an ARRIVED strictly-higher-class request
        (which would just re-preempt it); preemption only ever picks
        strictly lower classes, so yield + preempt cannot cycle."""
        progressed = False
        while self.frozen and self.batcher.n_free:
            fs = self.frozen[0]
            if fs.request.is_cancelled(self.virtual_s):
                self.frozen.pop(0)
                self.pager.drop_frozen({"pages": fs.pages})
                fs.request.finished = self.virtual_s
                self.cancelled += 1
                progressed = True
                continue
            nxt = q.peek(self.virtual_s)
            if nxt is not None and nxt.priority < fs.request.priority:
                break
            if not self.thaw_slot(fs):
                break
            self.frozen.pop(0)
            progressed = True
        return progressed

    def _shrink_budget(self, frac: float) -> None:
        """Pool-pressure spike: the local page budget shrinks to `frac`
        of itself; the hotness rebalancer demotes to fit immediately."""
        pg = self.pager
        if not np.isfinite(pg.budget):
            return
        pg.cfg = dataclasses.replace(
            pg.cfg, local_budget_bytes=pg.budget * frac)
        self._fault_counters["budget_shrinks"] += 1
        if pg.cfg.policy == "hotness":
            pg.rebalance()

    def degrade_pool(self) -> None:
        """The pool tier dropped out: fall back to LOCAL-ONLY paging.
        Every live page retags local (the substrate's next drain pages
        the twin's content back in and empties host placement), the
        pager stops evicting (policy "none"), and admission tightens —
        halving the corridor budget models the local tier absorbing
        traffic the corridor priced for the pool link."""
        if self._degraded:
            return
        self._degraded = True
        self._fault_counters["degraded"] = 1
        pg = self.pager
        pg.tier_phys[:] = LOCAL
        pg.cfg = dataclasses.replace(
            pg.cfg, policy="none", local_budget_bytes=None)
        self.admission.budget *= 0.5

    def _fault_tick(self) -> Optional[str]:
        """Consult the injector before any engine work. Returns "dead" /
        "stalled" when this engine cannot make progress (the router's
        watchdog takes it from there), None to proceed normally."""
        if self._dead:
            return "dead"
        f = self.faults
        if f is None:
            return None
        if f.kill_now(self.engine_id, self.steps):
            self._dead = True
            return "dead"
        stall = f.stall_now(self.engine_id, self.steps)
        if stall is not None:
            self._stall_until = self.virtual_s + stall
        if self.virtual_s < self._stall_until:
            return "stalled"
        frac = f.shrink_now(self.engine_id, self.steps)
        if frac is not None:
            self._shrink_budget(frac)
        if f.pool_lost_now(self.engine_id, self.steps):
            self.degrade_pool()
        return None

    def evacuate(self) -> List[Request]:
        """Strip the engine for recovery or drain: every occupied slot,
        frozen snapshot and handoff pin releases WITHOUT finishing its
        request (the router re-routes or adopts them), the prefix trie
        gives back every cached page, and the substrate reconciles to an
        empty pool and completes its streams. Afterward the page pool is
        fully free with zero refcounts. Returns the displaced requests in
        slot order (decode slots first carry emitted history for
        adoption; prefill-phase ones are clean requeues)."""
        displaced: List[Request] = []
        for rec in self.handoff_outbox:
            self.pager.unpin(rec.pages)
        self.handoff_outbox = []
        for slot in self.batcher.slots:
            if slot.occupied:
                displaced.append(slot.request)
                self._retire(slot)
        for fs in self.frozen:
            self.pager.drop_frozen({"pages": fs.pages})
            displaced.append(fs.request)
        self.frozen = []
        if self.prefix_cache is not None:
            self.prefix_cache.reclaim(self.pager, self.pager.n_phys)
        if self.substrate is not None:
            self.substrate.drain(self.pager, self.caches, step=self.steps)
            self.substrate.sync()
            self.virtual_s += self.substrate.take_backoff()
        return displaced

    def _prefill_dt(self, n_tokens: int, final: bool = True) -> float:
        """Virtual cost of prefilling `n_tokens` on the target topology:
        prefill compute at the chip's peak + writing the new KV into the
        local tier. The resident-state write and the host dispatch floor
        are charged once per prompt (on the final/only chunk):
        interleaved chunks ride the engine's running step cadence."""
        t_comp = (
            rl.model_flops_decode(self._active_params, n_tokens)
            / self.chip.peak_flops_bf16
        )
        write = (
            self.pager.bytes_per_token * n_tokens
            + (self.pager.resident_bytes if final else 0.0)
        ) / self.topo.local.bandwidth
        return max(t_comp, write) + (
            self.ecfg.step_overhead_s if final else 0.0)

    def _retire(self, slot) -> Request:
        req = self.batcher.release(slot)
        self.pager.release(slot.index)
        self._draft_fed[slot.index] = 0
        return req

    def _fence(self) -> None:
        """Before a cell writes the pool in place: the main stream waits
        for the substrate's last page_out, which reads the pool."""
        if self.substrate is not None:
            self.substrate.fence()

    def _block_table_dev(self) -> torch.Tensor:
        bt = self.pager.block_table()
        if bt is not self._bt_host:
            self._bt_host = bt
            self._bt_dev = torch.tensor(bt, device=self.device)
        return self._bt_dev

    # ------------------------------------------------------------- step
    def _step_decode(self) -> None:
        """One fixed-shape decode step over all slots + accounting."""
        if self._last_decode_end is not None:
            self._decode_gaps.append(
                self.virtual_s - self._last_decode_end
            )
        active = self.batcher.active_mask()
        n_active = int(active.sum())
        t_vec = self.batcher.t_vector()
        tok = torch.tensor(self.tokens, device=self.device)
        t_dev = torch.tensor(t_vec, device=self.device)
        if self.cells.paged:
            # the write-position page must be live AND private BEFORE the
            # cell runs: the block table it receives is the layout it
            # writes through (a shared tail page splits here and the copy
            # cell materializes the private duplicate)
            self._fence()
            for old, new in self.pager.ensure_tail_pages(active):
                self.caches = self.cells.copy_fn(self.caches, old, new)
            next_tok, finite, self.caches = self.cells.decode_fn(
                self.params, tok, self.caches, t_dev,
                self._block_table_dev(),
            )
        else:
            next_tok, finite, self.caches = self.cells.decode_fn(
                self.params, tok, self.caches, t_dev)
        next_np = next_tok.cpu().numpy()
        if not bool(finite.cpu().numpy()[active].all()):
            raise FloatingPointError(
                f"non-finite decode logits at step {self.steps} "
                f"(active slots: {n_active})"
            )

        traffic = self.pager.step(active)
        t_backoff = self._drain()
        t_compute = (
            rl.model_flops_decode(self._active_params, n_active)
            / self.chip.peak_flops_bf16
        )
        t_local = traffic.local_bytes / self.topo.local.bandwidth
        # staged pool transfers overlap compute (all pool traffic is
        # assumed prefetchable) -> roofline max; demand page-ins serialize
        t_staged = traffic.prefetch_pool_bytes / self.topo.pool.bandwidth
        t_demand = traffic.demand_pool_bytes / self.topo.pool.bandwidth
        t_pool = t_staged + t_demand
        # retry backoff (fault injection) serializes like a demand stall
        dt = float(
            itf.step_time_vec(t_staged, t_local, t_compute, 0.0)
        ) + t_demand + self.ecfg.step_overhead_s + t_backoff
        self.virtual_s += dt
        self._last_decode_end = self.virtual_s
        self.steps += 1
        self._t_compute_s += t_compute
        excess_b = (
            (self.pager.prefetch_issued - self.pager.prefetch_useful)
            * self.pager.page_bytes
        )
        t_excess = max(0.0, excess_b - self._prev_excess_b) \
            / self.topo.pool.bandwidth
        self._prev_excess_b = excess_b
        self.admission.observe(n_active, t_pool, dt, t_excess=t_excess)

        self.batcher.advance()
        for slot in self.batcher.slots:
            if not slot.active:
                continue
            req = slot.request
            tok = int(next_np[slot.index])
            self.tokens[slot.index] = tok
            req.output.append(tok)
            req.token_times.append(self.virtual_s)
            if req.done:
                req.finished = self.virtual_s
                self._retire(slot)

    def _drain(self) -> float:
        """Reconcile physical placement with the step's tier flips (async:
        the streams complete under sync()/capture_stats); returns the
        retry backoff to charge to the step."""
        if self.substrate is None:
            return 0.0
        self.substrate.drain(self.pager, self.caches, step=self.steps)
        t_backoff = self.substrate.take_backoff()
        self._fault_counters["backoff_s"] += t_backoff
        return t_backoff

    # ------------------------------------------------------- speculative
    def _history(self, slot) -> np.ndarray:
        """The slot's committed token history: prompt + everything
        emitted (the last element is the token the next step feeds)."""
        req = slot.request
        return np.concatenate([
            np.asarray(req.tokens, dtype=np.int64),
            np.asarray(req.output, dtype=np.int64),
        ])

    def _propose(self, cand: np.ndarray, active: np.ndarray) -> float:
        """Fill `cand[:, 1:]` with draft tokens for active slots; returns
        the proposal's virtual-time cost (0 for the host-side n-gram
        proposer)."""
        k = self.cells.spec_k
        if self.ecfg.speculative == "ngram":
            for slot in self.batcher.slots:
                if slot.active:
                    cand[slot.index, 1:] = spec.ngram_propose(
                        self._history(slot), k - 1)
            return 0.0
        return self._propose_draft(cand, active)

    def _propose_draft(self, cand: np.ndarray,
                       active: np.ndarray) -> float:
        """Draft-model proposal: catch the draft's contiguous caches up to
        each active slot's committed history (the refeed overwrites any
        rejected speculation; garbage past the frontier is masked by the
        per-slot lengths), then feed the last committed token and
        self-feed k-2 more times. `_draft_fed[s]` counts committed tokens
        already in the draft cache."""
        k = self.cells.spec_k
        n_slots = self.ecfg.n_slots
        idxs = np.nonzero(active)[0]
        hists = {int(i): self._history(self.batcher.slots[i])
                 for i in idxs}
        calls = 0
        park = self._draft_park

        def draft(tok, t):
            nxt, self.draft_caches = self.cells.draft_fn(
                self.cells.draft_params,
                torch.tensor(tok, device=self.device), self.draft_caches,
                torch.tensor(t, device=self.device))
            return nxt

        # catch-up: one committed token per call, all slots in parallel,
        # until every active slot holds all but its last token
        while True:
            tok = np.zeros(n_slots, dtype=np.int32)
            t = np.full(n_slots, park, dtype=np.int32)
            any_feed = False
            for i in idxs:
                h, f = hists[int(i)], int(self._draft_fed[i])
                if f < len(h) - 1:
                    tok[i] = h[f]
                    t[i] = f
                    self._draft_fed[i] = f + 1
                    any_feed = True
            if not any_feed:
                break
            draft(tok, t)
            calls += 1
        # proposal: feed the last committed token, then self-feed
        cur = np.zeros(n_slots, dtype=np.int32)
        t = np.full(n_slots, park, dtype=np.int32)
        for i in idxs:
            cur[i] = hists[int(i)][-1]
            t[i] = len(hists[int(i)]) - 1
        for j in range(1, k):
            nxt = draft(cur, t).cpu().numpy()
            calls += 1
            for i in idxs:
                cand[i, j] = nxt[i]
            cur = np.where(active, nxt, cur).astype(np.int32)
            t = np.where(active, t + 1, t).astype(np.int32)
        for i in idxs:
            # the proposal's first feed (the last committed token) counts
            # as fed; the self-fed drafts do not — they refeed above if
            # accepted, and are overwritten in place if not
            self._draft_fed[i] = len(hists[int(i)])
        self.spec_draft_calls += calls
        # virtual cost: the draft runs serially before verify — its flops
        # plus its contiguous-cache reads from the LOCAL tier (draft
        # caches are slot-local scratch, never pooled)
        n_active = int(active.sum())
        lengths = float(sum(len(hists[int(i)]) for i in idxs))
        t_comp = calls * (
            rl.model_flops_decode(self._draft_params_n, n_active)
            / self.chip.peak_flops_bf16
        )
        t_read = (calls * lengths * self._draft_tok_bytes
                  / self.topo.local.bandwidth)
        return t_comp + t_read

    def _step_speculative(self) -> None:
        """One speculative verify step: propose k-1 drafts per slot, score
        all k candidates in ONE paged verify call, commit the
        greedy-matching prefix, roll the page accounting back over the
        rejected tail. Emits 1..k tokens per active slot against one pool
        sweep, which `KVPager.step(tokens=...)` prices."""
        k = self.cells.spec_k
        if self._last_decode_end is not None:
            self._decode_gaps.append(self.virtual_s - self._last_decode_end)
        active = self.batcher.active_mask()
        n_active = int(active.sum())
        t_vec = self.batcher.t_vector()
        cand = np.zeros((self.ecfg.n_slots, k), dtype=np.int32)
        cand[:, 0] = self.tokens
        t_draft = self._propose(cand, active)
        # all k candidate rows write KV: their pages must be live and
        # private BEFORE the verify cell runs (rejected tails roll back
        # through truncate below)
        self._fence()
        for old, new in self.pager.ensure_tail_pages(active, lookahead=k):
            self.caches = self.cells.copy_fn(self.caches, old, new)
        greedy, finite, self.caches = self.cells.verify_fn(
            self.params, torch.tensor(cand, device=self.device), self.caches,
            torch.tensor(t_vec, device=self.device), self._block_table_dev(),
        )
        greedy_np = greedy.cpu().numpy()
        if not bool(finite.cpu().numpy()[active].all()):
            raise FloatingPointError(
                f"non-finite verify logits at step {self.steps} "
                f"(active slots: {n_active})"
            )

        # greedy acceptance per slot, capped by the request's remaining
        # decode budget (the verify row may overshoot max_new_tokens)
        counts = np.zeros(self.ecfg.n_slots, dtype=np.int64)
        emits: Dict[int, List[int]] = {}
        for slot in self.batcher.slots:
            if not slot.active:
                continue
            i = slot.index
            _, emit = spec.accept_greedy(cand[i], greedy_np[i])
            budget = slot.request.max_new_tokens - len(slot.request.output)
            emit = emit[:max(1, min(len(emit), budget))]
            counts[i] = len(emit)
            emits[i] = emit

        traffic = self.pager.step(active, tokens=counts)
        t_backoff = self._drain()
        # ONE pool sweep (the reads in `traffic`) scored k tokens per
        # slot: compute scales with k, memory does not
        t_compute = (
            rl.model_flops_decode(self._active_params, k * n_active)
            / self.chip.peak_flops_bf16
        )
        t_local = traffic.local_bytes / self.topo.local.bandwidth
        t_staged = traffic.prefetch_pool_bytes / self.topo.pool.bandwidth
        t_demand = traffic.demand_pool_bytes / self.topo.pool.bandwidth
        t_pool = t_staged + t_demand
        dt = float(
            itf.step_time_vec(t_staged, t_local, t_compute, 0.0)
        ) + t_demand + self.ecfg.step_overhead_s + t_draft + t_backoff
        self.virtual_s += dt
        self._last_decode_end = self.virtual_s
        self.steps += 1
        self.spec_verify_steps += 1
        self.spec_slot_steps += n_active
        self.spec_emitted += int(counts.sum())
        self._t_compute_s += t_compute
        excess_b = (
            (self.pager.prefetch_issued - self.pager.prefetch_useful)
            * self.pager.page_bytes
        )
        t_excess = max(0.0, excess_b - self._prev_excess_b) \
            / self.topo.pool.bandwidth
        self._prev_excess_b = excess_b
        self.admission.observe(n_active, t_pool, dt, t_excess=t_excess)

        self.batcher.advance(counts)
        for slot in self.batcher.slots:
            if not slot.active:
                continue
            req = slot.request
            emit = emits[slot.index]
            self.tokens[slot.index] = emit[-1]
            for tok in emit:
                req.output.append(int(tok))
                req.token_times.append(self.virtual_s)
            if req.done:
                req.finished = self.virtual_s
                self._retire(slot)     # releases every page incl. lookahead
            else:
                # partial acceptance: free the lookahead pages past the
                # committed frontier so the pool footprint tracks accepted
                # tokens (the rejected KV is masked and overwritten)
                self.pager.truncate(slot.index)

    # ----------------------------------------------- admission <-> sched
    def measured_profile(self) -> itf.InterferenceProfile:
        """The engine's MEASURED interference profile (paper §7.2 closed
        loop): per-step pool/local traffic from the pager's exact byte
        accounting plus the decode roofline compute time (at the engine's
        chip peak), as an `InterferenceProfile` on the engine's topology
        that the rack simulator prices like any other submitted job. Feed
        it to `sched.workload.serving_stream` so co-located serving
        instances throttle each other by their OBSERVED injected LoI
        rather than a catalog prior."""
        if self.steps == 0:
            raise RuntimeError(
                "measured_profile needs at least one decode step — run a "
                "trace first (the catalog prior covers cold starts)"
            )
        c = self.pager.counters()
        return itf.InterferenceProfile(
            arch=self.cfg.name,
            shape="serve_measured",
            pool_traffic=c["pool_bytes"] / self.steps,
            local_traffic=c["local_bytes"] / self.steps,
            t_compute=self._t_compute_s / self.steps,
            topo=self.topo,
        )

    # -------------------------------------------------------- tick layer
    # The engine loop as re-entrant primitives, so the fleet router
    # (`serving.fleet.router`) can drive N engines step by step on
    # interleaved virtual clocks; `run()` composes the same primitives.
    @property
    def pending_work(self) -> bool:
        """True while a tick could make local progress: any occupied slot
        that is not parked awaiting a fleet handoff, or a frozen request
        a free slot could thaw."""
        return any(s.occupied and s.phase != "handoff"
                   for s in self.batcher.slots) \
            or (bool(self.frozen) and self.batcher.n_free > 0)

    def advance_to(self, t: float) -> None:
        """Advance the virtual clock to `t` (idle wait, never backwards);
        the decode-gap origin moves past the wait."""
        if t > self.virtual_s:
            self.virtual_s = t
            if self._last_decode_end is not None:
                self._last_decode_end = self.virtual_s

    def sweep_cancelled(self) -> int:
        """Retire every occupied slot whose request is cancelled,
        releasing its KV pages. Handoff-parked slots are skipped (the
        router owns them mid-transfer)."""
        n = 0
        for slot in self.batcher.slots:
            if (slot.occupied and slot.phase != "handoff"
                    and slot.request.is_cancelled(self.virtual_s)):
                slot.request.finished = self.virtual_s
                self._retire(slot)
                n += 1
        self.cancelled += n
        return n

    def pump(self, q: RequestQueue) -> str:
        """One engine-loop iteration against `q`: consult the fault
        injector, sweep cancellations, restore frozen slots, admit while
        slots/admission allow, advance at most one prefill chunk, then
        one decode step if any slot is live. Returns "decode" | "chunk" |
        "admit" | "idle" (nothing possible — the caller owns clock
        advancement) | "dead" / "stalled" (fault injection: the engine
        cannot make progress; the fleet router's watchdog recovers it)."""
        act = self._fault_tick()
        if act is not None:
            return act
        self.sweep_cancelled()
        restored = self._thaw_tick(q) if self.frozen else False
        admitted = False
        while self.batcher.n_free:
            req = q.peek(self.virtual_s)
            if req is None or not self.admission.admit(self.batcher.n_busy):
                break
            if not self._ensure_pages_for(req):
                break       # stays queued; no victim to preempt
            self._admit(q.pop(self.virtual_s), self.virtual_s)
            admitted = True
        chunk_ran = self._prefill_tick()
        if self.batcher.n_active == 0:
            if chunk_ran:
                return "chunk"
            return "admit" if admitted or restored else "idle"
        self._max_conc = max(self._max_conc, self.batcher.n_active)
        if self.cells.verify_fn is not None:
            self._step_speculative()
        else:
            self._step_decode()
        return "decode"

    def begin_capture(self) -> dict:
        """Snapshot every per-run counter (`run()`'s stats are deltas, so
        the engine object stays reusable across traces)."""
        self._max_conc = 0
        return {
            "now0": self.virtual_s,
            "steps0": self.steps,
            "blocks0": self.admission.blocks,
            "gaps0": len(self._decode_gaps),
            "pager0": self.pager.counters(),
            "prefix0": (self.prefix_cache.counters()
                        if self.prefix_cache is not None else None),
            "substrate0": (self.substrate.counters()
                           if self.substrate is not None else None),
            "spec0": (self.spec_verify_steps, self.spec_slot_steps,
                      self.spec_emitted, self.spec_draft_calls),
            "faults0": dict(self._fault_counters),
            "sub_retries0": ((self.substrate.retries,
                              self.substrate.retry_bytes)
                             if self.substrate is not None else (0, 0.0)),
            "wall0": time.perf_counter(),
        }

    # -------------------------------------------------------------- run
    def run(self, requests: List[Request],
            max_steps: Optional[int] = None) -> ServeStats:
        """Serve a request trace to completion (deterministic for a fixed
        trace). Per-request outputs/latencies are left on the `Request`
        objects."""
        q = RequestQueue(requests)
        cap = self.begin_capture()
        while len(q) or self.batcher.n_busy or self.frozen:
            act = self.pump(q)
            if act == "decode":
                if max_steps is not None and self.steps >= max_steps:
                    break
            elif act == "dead":
                break       # single engine: nowhere to recover to
            elif act == "stalled":
                self.advance_to(self._stall_until)
            elif act == "idle":
                nxt = q.next_arrival()
                if not np.isfinite(nxt):
                    if self.frozen:
                        raise RuntimeError(
                            "engine wedged: frozen request cannot thaw "
                            "and nothing is running to free pages")
                    break
                if nxt <= self.virtual_s:
                    raise RuntimeError(
                        "engine starved: an arrived request cannot be "
                        "admitted (prompt exceeds the reclaimable pool "
                        "and no lower-priority victim to preempt)")
                self.advance_to(nxt)
        return self.capture_stats(cap, requests)

    def capture_stats(self, cap: dict, requests: List[Request],
                      ) -> ServeStats:
        """Aggregate stats since `cap = begin_capture()` over `requests`."""
        substrate_delta: dict = {}
        if self.substrate is not None:
            # final reconcile (retired slots freed pages after the last
            # decode drain) + completion barrier, so the captured ledger
            # reflects finished transfers and current placement
            self.substrate.drain(self.pager, self.caches, step=self.steps)
            self.substrate.sync()
            t_backoff = self.substrate.take_backoff()
            self.virtual_s += t_backoff
            self._fault_counters["backoff_s"] += t_backoff
            s0, s1 = cap["substrate0"], self.substrate.counters()
            substrate_delta = {
                k: (s1[k] - s0[k]) if isinstance(s1[k], (int, float))
                else s1[k]
                for k in s1
            }
            # placement is a level, not a flow — report the current one
            substrate_delta["resident_pages"] = s1["resident_pages"]
            substrate_delta["placement_bytes"] = s1["placement_bytes"]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - cap["wall0"]
        done = [r for r in requests if r.output]
        ttft = np.array([r.token_times[0] - r.arrival for r in done])
        tpot = np.concatenate(
            [np.diff(r.token_times) for r in done if len(r.token_times) > 1]
            or [np.zeros(0)]
        )
        pager0, pager1 = cap["pager0"], self.pager.counters()
        dlocal = pager1["local_bytes"] - pager0["local_bytes"]
        dpool = pager1["pool_bytes"] - pager0["pool_bytes"]
        ddemand = (pager1["demand_pool_bytes"]
                   - pager0["demand_pool_bytes"])
        pager_delta = {
            "steps": pager1["steps"] - pager0["steps"],
            "local_bytes": dlocal,
            "pool_bytes": dpool,
            "demand_pool_bytes": ddemand,
            "prefetch_pool_bytes": (pager1["prefetch_pool_bytes"]
                                    - pager0["prefetch_pool_bytes"]),
            "remote_share": dpool / (dlocal + dpool) if dlocal + dpool
            else 0.0,
            "demand_share": ddemand / (dlocal + dpool) if dlocal + dpool
            else 0.0,
            "evictions": pager1["evictions"] - pager0["evictions"],
            "promotions": pager1["promotions"] - pager0["promotions"],
            "prefetch_issued": (pager1["prefetch_issued"]
                                - pager0["prefetch_issued"]),
            "prefetch_useful": (pager1["prefetch_useful"]
                                - pager0["prefetch_useful"]),
            "local_used": pager1["local_used"],
            "pool_used": pager1["pool_used"],
            "cow_splits": pager1["cow_splits"] - pager0["cow_splits"],
            "shared_mapped_pages": (pager1["shared_mapped_pages"]
                                    - pager0["shared_mapped_pages"]),
        }
        prefix_delta: dict = {}
        if cap["prefix0"] is not None:
            prefix0, prefix1 = cap["prefix0"], self.prefix_cache.counters()
            prefix_delta = {
                k: prefix1[k] - prefix0[k]
                for k in ("hits", "misses", "hit_tokens", "hit_pages",
                          "inserted_pages", "evicted_pages")
            }
            n = prefix_delta["hits"] + prefix_delta["misses"]
            prefix_delta["hit_rate"] = (
                prefix_delta["hits"] / n if n else 0.0)
            prefix_delta["cached_pages"] = prefix1["cached_pages"]
        spec_delta: dict = {}
        if self.cells.verify_fn is not None:
            v0, s0, e0, d0 = cap["spec0"]
            slot_steps = self.spec_slot_steps - s0
            emitted = self.spec_emitted - e0
            spec_delta = {
                "verify_steps": self.spec_verify_steps - v0,
                "emitted": emitted,
                "draft_calls": self.spec_draft_calls - d0,
                # tokens each slot commits per verify step it takes part
                # in (1 = no draft ever accepted, k = perfect proposer)
                "accept_len_mean": (emitted / slot_steps
                                    if slot_steps else 0.0),
            }
        f0, f1 = cap["faults0"], self._fault_counters
        delta = {k: f1[k] - f0[k] for k in f1}
        r0, rb0 = cap["sub_retries0"]
        sub = self.substrate
        delta["retries"] = sub.retries - r0 if sub is not None else 0
        delta["retry_bytes"] = (sub.retry_bytes - rb0 if sub is not None
                                else 0.0)
        # fault-free runs keep faults == {}
        faults_delta = (delta if self.faults is not None
                        or any(delta.values()) else {})
        return ServeStats(
            n_requests=len(done),
            tokens=sum(len(r.output) for r in done),
            steps=self.steps - cap["steps0"],
            wall_s=wall,
            virtual_s=self.virtual_s - cap["now0"],
            ttft=ttft,
            tpot=tpot,
            decode_stall=np.array(self._decode_gaps[cap["gaps0"]:]),
            pager=pager_delta,
            admission_blocks=self.admission.blocks - cap["blocks0"],
            max_concurrency=self._max_conc,
            prefix=prefix_delta,
            substrate=substrate_delta,
            spec=spec_delta,
            faults=faults_delta,
        )
