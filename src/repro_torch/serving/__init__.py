"""Tier-aware continuous-batching serving on the card (port of
`repro.serving`).

By default the KV cache is a PHYSICAL page pool end to end:
self-attention K/V lives as (stack, n_slots * n_pages, page_tokens,
heads, head_dim) tensors on the device, and every cell — bucket prefill
insert, decode — reads and writes it through the live (n_slots, n_pages)
block table the `KVPager` emits; with `prefill_chunk` set, prompts advance
one page-aligned chunk at a time between decode steps, and `prefix_cache`
shares the pages of a common prompt prefix across requests
(`PrefixCache`). The default pool is int8 with one float32 (scale, zero)
pair per (page, KV head), quantized on insert and dequantized inside the
paged decode kernel. `paged=False` keeps per-slot contiguous caches
instead, decoded through the flash-decode kernel.

PHYSICAL SUBSTRATE (`EngineConfig.substrate`, `serving/substrate/`): the
pool tier made physical — pages the pager tiers POOL are mirrored into a
pinned host twin by the grouped page-copy kernel once per decode step,
on a side stream; the device pool stays authoritative.

SPECULATIVE DECODING (`EngineConfig.speculative`, `serving/speculative.py`):
a proposer guesses `speculative_k - 1` draft tokens per slot ("ngram":
suffix matching over the slot's own history; "draft": a draft model on
contiguous scratch caches), one paged verify call scores all k
candidates, and `accept_greedy` commits the longest prefix greedy decode
would have produced, so the tokens equal greedy's on fp pools.

FAULTS AND THE FLEET (`serving/faults.py`, `serving/fleet/`): N engines
share one parameter tree and one set of cells behind a placement router
(round-robin, KV-load-aware, prefix-aware), with queue-depth autoscaling
and an optional prefill/decode role split whose handoff copies KV pages
between the engines' pools on the page-copy kernel. A deterministic
`FaultPlan` kills, stalls, shrinks or strips the pool tier of an engine
and flakes transfers; the router's watchdog recovers a dead engine's
queued and in-flight requests onto the survivors (teacher-forced refill),
and a bucket admission under pool exhaustion preempts a lower-priority
slot.
"""

from repro_torch.serving.batcher import ContinuousBatcher, Slot
from repro_torch.serving.engine import (
    INT8_TOKEN_AGREEMENT,
    AdmissionController,
    EngineConfig,
    ServeStats,
    ServingEngine,
)
from repro_torch.serving.faults import PLANS, FaultInjector, FaultPlan, \
    make_plan
from repro_torch.serving.kv_pager import KVPager, PagerConfig, StepTraffic
from repro_torch.serving.prefix_cache import PrefixCache, PrefixHit
from repro_torch.serving.queue import (
    SCENARIOS,
    Request,
    RequestQueue,
    bursty_stream,
    chat_stream,
    long_context_stream,
    make_scenario,
    multi_tenant_stream,
    shared_prefix_stream,
)
from repro_torch.serving.speculative import accept_greedy, ngram_propose
from repro_torch.serving.substrate import SubstrateLedger, TierSubstrate
from repro_torch.serving import fleet

__all__ = [
    "AdmissionController",
    "ContinuousBatcher",
    "EngineConfig",
    "FaultInjector",
    "FaultPlan",
    "INT8_TOKEN_AGREEMENT",
    "KVPager",
    "PLANS",
    "PagerConfig",
    "PrefixCache",
    "PrefixHit",
    "Request",
    "RequestQueue",
    "SCENARIOS",
    "ServeStats",
    "ServingEngine",
    "Slot",
    "StepTraffic",
    "SubstrateLedger",
    "TierSubstrate",
    "accept_greedy",
    "bursty_stream",
    "chat_stream",
    "fleet",
    "long_context_stream",
    "make_plan",
    "make_scenario",
    "multi_tenant_stream",
    "ngram_propose",
    "shared_prefix_stream",
]
