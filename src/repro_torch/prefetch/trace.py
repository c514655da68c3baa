"""Demand-trace capture (copy of `repro.prefetch.trace`, numpy only):
page-touch streams from the three dynamic
sources the paper profiles (§4.2) — the serving KV pager, the rack
simulator's pool traffic, and the BFS graph workload
(`prefetch/workloads.py`).

An `AccessTrace` is the common currency of the subsystem: per engine step,
the ordered list of (global) page ids demanded, plus the optional
application-directed hint stream (`hints[i]` = pages the app forecasts
for step i+1 — only the BFS workload fills it). The static layer stream
of `prefetch/static.py` emits the same shape, so one `PrefetchEngine`
scores every source against one predictor protocol.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass
class AccessTrace:
    """A page-touch stream: `steps[i]` is the demand-ordered page ids
    touched at step i over an `n_pages` address space of `page_bytes`
    pages. `hints[i]`, when present, is the application's forecast of
    step i+1's touches (consumed by the `frontier` predictor)."""

    name: str
    source: str                      # serving | sched | bfs | layer
    page_bytes: float
    n_pages: int
    steps: List[List[int]]
    hints: Optional[List[List[int]]] = None

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def touches(self) -> int:
        return sum(len(s) for s in self.steps)

    def validate(self) -> "AccessTrace":
        for s in self.steps:
            for p in s:
                if not 0 <= p < self.n_pages:
                    raise ValueError(f"page {p} outside [0, {self.n_pages})")
        if self.hints is not None and len(self.hints) != len(self.steps):
            raise ValueError("hints must be per-step (same length as steps)")
        return self


class TraceRecorder:
    """Capture hook: `KVPager` (and anything else) calls `record(pages)`
    once per step; `to_trace` freezes the stream."""

    def __init__(self):
        self.steps: List[List[int]] = []

    def record(self, pages: Sequence[int]) -> None:
        self.steps.append([int(p) for p in pages])

    def to_trace(self, name: str, source: str, page_bytes: float,
                 n_pages: int) -> AccessTrace:
        return AccessTrace(name, source, page_bytes, n_pages,
                           [list(s) for s in self.steps]).validate()


# ------------------------------------------------- serving (KV pager)
def kv_pager_trace(n_slots: int = 2, max_seq: int = 256,
                   page_tokens: int = 8, hot_window: int = 32,
                   cold_touch: float = 0.1, prompt_len: int = 192,
                   steps: int = 96, bytes_per_token: float = 256.0,
                   budget_frac: float = 0.4) -> AccessTrace:
    """Record the page-touch stream of a long-context decode under the
    tier-aware KV pager (pure numpy — the pager is a logical manager).
    Global page ids are slot-major (`slot * n_pages + page`), so the
    stream interleaves one hot-tail run plus one cold round-robin per
    active slot — the serving shape a stream predictor must untangle."""
    import numpy as np

    from repro_torch.serving.kv_pager import KVPager, PagerConfig

    page_bytes = bytes_per_token * page_tokens
    n_pages = -(-max_seq // page_tokens)
    budget = budget_frac * n_slots * n_pages * page_bytes
    pager = KVPager(
        n_slots, max_seq, bytes_per_token, 0.0,
        PagerConfig(page_tokens=page_tokens, local_budget_bytes=budget,
                    policy="hotness", hot_window=hot_window,
                    cold_touch=cold_touch),
    )
    rec = TraceRecorder()
    pager.recorder = rec
    for s in range(n_slots):
        pager.admit(s, prompt_len)
    active = np.ones(n_slots, dtype=bool)
    for _ in range(steps):
        pager.step(active)
    return rec.to_trace(
        f"kv_pager_s{n_slots}x{max_seq}", "serving", page_bytes,
        n_slots * n_pages,
    )


# --------------------------------------------- sched (pool traffic)
def sched_pool_trace(n_jobs: int = 4, steps: int = 200,
                     pages_per_job: int = 512, page_bytes: float = 4096.0,
                     seed: int = 0) -> AccessTrace:
    """Pool-link traffic of co-resident simulator jobs as a page stream:
    each job streams sequentially through its own pool-resident region at
    a rate proportional to its injected LoI (`sched.workload` synthetic
    profiles), wrapping at the region end. The interleaving of per-job
    sequential scans is the multi-tenant pattern the stream predictor's
    region table exists for."""
    import numpy as np

    from repro_torch.sched.workload import synthetic_stream

    jobs = synthetic_stream(n_jobs, seed=seed)
    rates = [max(1, int(round(1 + 4 * j.injected_loi))) for j in jobs]
    cursors = [0] * n_jobs
    out: List[List[int]] = []
    rng = np.random.default_rng(seed + 1)
    for _ in range(steps):
        step: List[int] = []
        order = rng.permutation(n_jobs)            # arrival interleaving
        for j in order:
            base = j * pages_per_job
            for _ in range(rates[j]):
                step.append(base + cursors[j])
                cursors[j] = (cursors[j] + 1) % pages_per_job
        out.append(step)
    return AccessTrace(
        f"sched_pool_{n_jobs}j", "sched", page_bytes,
        n_jobs * pages_per_job, out,
    ).validate()
