"""Request queue and arrival-process generators for the serving engine.

A `Request` is one user call: a prompt (already tokenized; its length must
be one of the engine's prefill buckets — serving systems quantize prompt
lengths so the fixed-shape prefill cells never recompile) plus a decode
budget, a PRIORITY CLASS (0 = most urgent; ties broken by arrival, so a
single-class trace is plain FIFO — bit-identical to the pre-priority
queue) and an optional tenant tag. A request can be CANCELLED: either
eagerly (`cancel()`) or at a virtual-time deadline (`cancel_at`, which
makes cancellation deterministic in replayed traces). The queue drops
cancelled requests at pop time; the engine sweeps cancelled in-flight
requests out of their slots, releasing their KV pages back through the
pager (`ServingEngine.sweep_cancelled`).

`RequestQueue` orders by (priority, arrival): `pop(now)` only releases
arrived requests, and among the arrived set the lowest priority class
goes first, FIFO within a class — so open-loop traces replay
deterministically.

Scenario generators mirror the benchmark matrix of the brief:

* `chat_stream`      — short prompts, short generations, steady Poisson
                       arrivals (the latency-sensitive interactive lane);
* `long_context_stream` — few requests, long prompts (the 32k-class lane
                       whose KV cache spills the local tier — the cell the
                       tier-aware pager exists for);
* `bursty_stream`    — mixed prompt lengths arriving in bursts separated
                       by idle gaps (slot churn + admission stress);
* `shared_prefix_stream` — chat traffic behind fixed system prompts
                       (the prefix-cache dedup lane: every request opens
                       with one of `n_systems` shared prefixes);
* `multi_tenant_stream` — an interactive tenant (short prompts, priority
                       0, steady Poisson) interleaved with a batch tenant
                       (long prompts, priority 1, bursty) — the fleet
                       router's priority-class stress lane.

All generators are deterministic in `seed`.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request plus its per-request accounting."""

    request_id: int
    tokens: np.ndarray            # (prompt_len,) int32 prompt
    max_new_tokens: int
    arrival: float = 0.0          # seconds since trace start
    priority: int = 0             # class: 0 most urgent; FIFO within class
    tenant: str = "default"       # multi-tenant stream tag (accounting)
    cancel_at: Optional[float] = None   # virtual-time cancellation
    # deadline — deterministic in replayed traces (None = never)
    cancelled: bool = False       # eager cancellation flag (router.cancel)
    # --- filled in by the engine ---
    admitted: float = float("nan")
    finished: float = float("nan")
    output: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    def cancel(self) -> None:
        self.cancelled = True

    def is_cancelled(self, now: float) -> bool:
        return self.cancelled or (
            self.cancel_at is not None and now >= self.cancel_at
        )


class RequestQueue:
    """Priority queue over (priority class, arrival). `pop(now)` only
    releases arrived requests; among the arrived set the lowest priority
    class pops first, FIFO (arrival-stable) within a class — with a
    single class this is exactly the old FIFO. Cancelled requests are
    dropped at peek/pop (never handed to the engine); `drop_cancelled`
    counts them."""

    def __init__(self, requests: Sequence[Request] = ()):
        # arrival-sorted feed list (stable for ties) + a ready-heap of
        # arrived requests keyed (priority, ORIGINAL arrival, absorb
        # order). Keying on the original arrival — not absorb time —
        # makes REQUEUED requests (fault recovery re-routing a dead
        # engine's queue) re-admit in the same deterministic
        # (priority, original_arrival) order the fault-free run used;
        # the absorb-order seq only breaks exact (priority, arrival)
        # ties, so a single-class trace stays plain FIFO.
        self._items: List[Request] = sorted(requests, key=lambda r: r.arrival)
        self._head = 0
        self._ready: List[tuple] = []
        self._seq = 0
        self.drop_cancelled = 0

    def push(self, req: Request) -> None:
        # insert into the *unconsumed* suffix only — re-sorting the whole
        # list would shuffle already-popped items back past _head
        pos = bisect.bisect(
            [r.arrival for r in self._items[self._head:]], req.arrival
        )
        self._items.insert(self._head + pos, req)

    def __len__(self) -> int:
        return len(self._items) - self._head + len(self._ready)

    def _absorb(self, now: float) -> None:
        """Move arrived feed items into the ready heap (dropping the
        already-cancelled) and purge cancelled heap entries."""
        while (self._head < len(self._items)
               and self._items[self._head].arrival <= now):
            r = self._items[self._head]
            self._head += 1
            if r.is_cancelled(now):
                self.drop_cancelled += 1
                continue
            heapq.heappush(self._ready,
                           (r.priority, r.arrival, self._seq, r))
            self._seq += 1
        while self._ready and self._ready[0][-1].is_cancelled(now):
            heapq.heappop(self._ready)
            self.drop_cancelled += 1

    def peek(self, now: float) -> Optional[Request]:
        self._absorb(now)
        return self._ready[0][-1] if self._ready else None

    def pop(self, now: float) -> Optional[Request]:
        r = self.peek(now)
        if r is not None:
            heapq.heappop(self._ready)
        return r

    def drain(self) -> List[Request]:
        """Remove and return EVERY remaining request — ready ones in
        (priority, original arrival) order, then the not-yet-arrived
        feed in arrival order. The fault-recovery path: a dead engine's
        queue drains back through the fleet placement policies, and the
        original-arrival heap key on the destination makes re-admission
        order-stable."""
        out = [item[-1] for item in sorted(self._ready)]
        out += self._items[self._head:]
        self._items, self._head, self._ready = [], 0, []
        return out

    def next_arrival(self) -> float:
        """Earliest event time among queued requests: ready requests have
        already arrived (their arrival), otherwise the feed head's arrival
        (inf when drained)."""
        if self._ready:
            return min(item[-1].arrival for item in self._ready)
        if self._head < len(self._items):
            return self._items[self._head].arrival
        return float("inf")


# ------------------------------------------------------------- scenarios
def _mk_requests(rng, vocab: int, prompt_lens, gens, arrivals) -> list:
    out = []
    for i, (pl, g, at) in enumerate(zip(prompt_lens, gens, arrivals)):
        toks = rng.integers(0, vocab, size=int(pl)).astype(np.int32)
        out.append(Request(
            request_id=i, tokens=toks, max_new_tokens=int(g),
            arrival=float(at),
        ))
    return out


def chat_stream(n: int, vocab: int, *, seed: int = 0,
                prompt_buckets: Sequence[int] = (16, 32),
                gen_range: tuple = (8, 24),
                arrival_rate: float = 2.0) -> List[Request]:
    """Short-prompt interactive chat: Poisson arrivals, bucketed prompts."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n))
    lens = rng.choice(list(prompt_buckets), size=n)
    gens = rng.integers(gen_range[0], gen_range[1] + 1, size=n)
    return _mk_requests(rng, vocab, lens, gens, arrivals)


def long_context_stream(n: int, vocab: int, *, seed: int = 0,
                        prompt_bucket: int = 256,
                        gen_range: tuple = (16, 48),
                        arrival_rate: float = 0.5) -> List[Request]:
    """Long-context lane: every prompt at the largest bucket, so per-slot
    KV exceeds the local-tier budget and the pager must evict."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n))
    lens = np.full(n, prompt_bucket)
    gens = rng.integers(gen_range[0], gen_range[1] + 1, size=n)
    return _mk_requests(rng, vocab, lens, gens, arrivals)


def bursty_stream(n: int, vocab: int, *, seed: int = 0,
                  prompt_buckets: Sequence[int] = (16, 32, 64),
                  gen_range: tuple = (8, 32),
                  burst_size: int = 6,
                  burst_gap: float = 4.0) -> List[Request]:
    """Mixed bursty arrivals: `burst_size` requests land together, then the
    line goes quiet for ~`burst_gap` seconds (slot churn + admission
    throttle stress)."""
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    jitter = 0.01 * burst_gap     # in-burst spread << the idle gap
    while len(arrivals) < n:
        k = min(burst_size, n - len(arrivals))
        arrivals.extend([t + float(rng.uniform(0, jitter))
                         for _ in range(k)])
        t += float(rng.exponential(burst_gap))
    arrivals = np.sort(np.asarray(arrivals))
    lens = rng.choice(list(prompt_buckets), size=n)
    gens = rng.integers(gen_range[0], gen_range[1] + 1, size=n)
    return _mk_requests(rng, vocab, lens, gens, arrivals)


def shared_prefix_stream(n: int, vocab: int, *, seed: int = 0,
                         system_tokens: int = 24,
                         prompt_buckets: Sequence[int] = (32,),
                         gen_range: tuple = (8, 24),
                         arrival_rate: float = 2.0,
                         n_systems: int = 1) -> List[Request]:
    """Chat traffic behind `n_systems` fixed system prompts: every request
    opens with one of the shared `system_tokens`-long prefixes and fills
    the rest of its bucket with a random user tail — the workload the
    prefix radix cache (`serving.prefix_cache`) deduplicates. Same
    Poisson arrival process as `chat_stream`; deterministic in `seed`
    (the system prefixes themselves derive from `seed`, so two streams
    with the same seed share byte-identical prefixes)."""
    if any(b <= system_tokens for b in prompt_buckets):
        raise ValueError(
            f"prompt_buckets {tuple(prompt_buckets)} must exceed "
            f"system_tokens {system_tokens} (requests need a user tail)"
        )
    if n_systems < 1:
        raise ValueError("n_systems must be >= 1")
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, vocab, size=system_tokens).astype(np.int32)
               for _ in range(n_systems)]
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=n))
    lens = rng.choice(list(prompt_buckets), size=n)
    gens = rng.integers(gen_range[0], gen_range[1] + 1, size=n)
    which = rng.integers(0, n_systems, size=n)
    out = []
    for i in range(n):
        tail = rng.integers(
            0, vocab, size=int(lens[i]) - system_tokens
        ).astype(np.int32)
        out.append(Request(
            request_id=i,
            tokens=np.concatenate([systems[int(which[i])], tail]),
            max_new_tokens=int(gens[i]),
            arrival=float(arrivals[i]),
        ))
    return out


def multi_tenant_stream(n: int, vocab: int, *, seed: int = 0,
                        interactive_buckets: Sequence[int] = (16, 32),
                        batch_bucket: int = 64,
                        batch_fraction: float = 0.4,
                        gen_interactive: tuple = (8, 16),
                        gen_batch: tuple = (16, 32),
                        arrival_rate: float = 2.0,
                        batch_burst: int = 4,
                        batch_gap: float = 6.0) -> List[Request]:
    """Two tenants sharing one fleet: an `interactive` tenant (short
    prompts, priority 0, steady Poisson arrivals) and a `batch` tenant
    (long prompts, priority 1, arriving in bursts) — the priority-class
    lane: under contention the queue must serve interactive requests
    ahead of co-arrived batch work. Deterministic in `seed`."""
    if not 0.0 <= batch_fraction <= 1.0:
        raise ValueError("batch_fraction must be in [0, 1]")
    rng = np.random.default_rng(seed)
    n_batch = int(round(n * batch_fraction))
    n_inter = n - n_batch
    inter = _mk_requests(
        rng, vocab,
        rng.choice(list(interactive_buckets), size=n_inter),
        rng.integers(gen_interactive[0], gen_interactive[1] + 1,
                     size=n_inter),
        np.cumsum(rng.exponential(1.0 / arrival_rate, size=n_inter)),
    )
    for r in inter:
        r.tenant = "interactive"
        r.priority = 0
    arrivals, t = [], 0.0
    while len(arrivals) < n_batch:
        k = min(batch_burst, n_batch - len(arrivals))
        arrivals.extend(t + rng.uniform(0, 0.01 * batch_gap, size=k))
        t += float(rng.exponential(batch_gap))
    batch = _mk_requests(
        rng, vocab,
        np.full(n_batch, batch_bucket),
        rng.integers(gen_batch[0], gen_batch[1] + 1, size=n_batch),
        np.sort(np.asarray(arrivals)),
    )
    for i, r in enumerate(batch):
        r.request_id = n_inter + i      # unique across tenants
        r.tenant = "batch"
        r.priority = 1
    return sorted(inter + batch, key=lambda r: (r.arrival, r.request_id))


SCENARIOS = {
    "chat": chat_stream,
    "long_context": long_context_stream,
    "bursty": bursty_stream,
    "shared_prefix": shared_prefix_stream,
    "multi_tenant": multi_tenant_stream,
}


def make_scenario(name: str, n: int, vocab: int, *, seed: int = 0,
                  **kwargs) -> List[Request]:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; one of "
                         f"{sorted(SCENARIOS)}")
    return SCENARIOS[name](n, vocab, seed=seed, **kwargs)
