"""Pluggable request-placement policies for the fleet router (copy of
`repro.serving.fleet.placement`).

One protocol, three policies:

* ``RoundRobinPlacement`` — the baseline: a counter modulo the eligible
  engine set.  With greedy decoding (tokens depend only on the prompt)
  it replays single-engine token streams bit-for-bit, which is what the
  CI fleet-parity lane asserts.
* ``KVLoadAwarePlacement`` — scores each engine by outstanding-token
  load (queued prompt+gen tokens plus the remaining tokens of busy
  slots, per slot of capacity; plain queue depth when the view carries
  no costs) plus pool pressure (fraction of physical pages in use),
  picking the minimum with engine-id tie-break.  Everything it reads
  is in the router-built :class:`EngineView` snapshot, so scoring is
  deterministic and unit-testable without engines.
* ``PrefixAwarePlacement`` — a router-side radix index over
  page-granular token blocks: each placed prompt registers its full
  pages against the chosen engine, and a later prompt sharing a block
  prefix is steered to the engine whose ``prefix_cache`` already holds
  those pages.  Falls back to KV-load-aware scoring on a cold miss.

Policies see only :class:`EngineView` snapshots (never live engines),
so a placement decision is a pure function of (views, request,
policy-internal state) — the property the determinism tests pin down.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

__all__ = [
    "EngineView",
    "PlacementPolicy",
    "RoundRobinPlacement",
    "KVLoadAwarePlacement",
    "PrefixAwarePlacement",
    "make_policy",
    "POLICIES",
]


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Immutable snapshot of one engine's load, built by the router per
    placement decision. `queued` counts requests already routed to the
    engine but not yet admitted; `busy` counts occupied slots."""
    engine_id: int
    n_slots: int
    busy: int
    queued: int
    free_pages: int
    total_pages: int
    role: str = "unified"          # "unified" | "prefill" | "decode"
    accepting: bool = True         # False while draining for scale-down
    # outstanding-token costs (None = not supplied; scoring falls back
    # to plain queue depth): queued = prompt+gen tokens of routed-but-
    # unadmitted requests, busy = remaining prefill+gen of live slots
    queued_cost: Optional[float] = None
    busy_cost: Optional[float] = None

    @property
    def queue_depth(self) -> int:
        return self.queued + self.busy

    @property
    def load_cost(self) -> float:
        """Outstanding tokens when the router supplied costs, else the
        request/slot count — either way, 'how much work is ahead of a
        request placed here'."""
        if self.queued_cost is None or self.busy_cost is None:
            return float(self.queue_depth)
        return self.queued_cost + self.busy_cost

    @property
    def free_frac(self) -> float:
        return self.free_pages / self.total_pages if self.total_pages else 0.0


class PlacementPolicy(Protocol):
    """A policy maps (eligible engine views, prompt tokens) -> engine_id.

    ``place`` must return the ``engine_id`` of one of the supplied
    views; the router filters views to eligible engines (accepting,
    prefill-capable for the request) before calling. ``record`` is
    invoked by the router after the decision is final so stateful
    policies (round-robin counter, prefix index) advance exactly once
    per placed request.
    """

    name: str

    def place(self, views: Sequence[EngineView],
              tokens: Sequence[int]) -> int: ...

    def record(self, engine_id: int, tokens: Sequence[int]) -> None: ...


class RoundRobinPlacement:
    """Counter mod the eligible set — order-stable, load-blind."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def place(self, views: Sequence[EngineView],
              tokens: Sequence[int]) -> int:
        if not views:
            raise ValueError("no eligible engines")
        return views[self._next % len(views)].engine_id

    def record(self, engine_id: int, tokens: Sequence[int]) -> None:
        self._next += 1


def kv_load_score(view: EngineView) -> float:
    """Lower is better: outstanding load + half-weighted pool pressure.
    Load is normalised by slot capacity so heterogeneous fleets compare
    fairly; pool pressure is (1 - free page fraction) — it decides
    between equally loaded engines (an empty fleet places on the engine
    with the most free pages)."""
    lp = view.load_cost / view.n_slots if view.n_slots else float("inf")
    return lp + 0.5 * (1.0 - view.free_frac)


class KVLoadAwarePlacement:
    """Pick the engine with the lowest :func:`kv_load_score`; ties break
    on the lowest engine id, so the decision is a deterministic function
    of the views alone."""

    name = "kv_aware"

    def place(self, views: Sequence[EngineView],
              tokens: Sequence[int]) -> int:
        if not views:
            raise ValueError("no eligible engines")
        return min(views, key=lambda v: (kv_load_score(v), v.engine_id)
                   ).engine_id

    def record(self, engine_id: int, tokens: Sequence[int]) -> None:
        pass


class PrefixAwarePlacement:
    """Router-side radix index over page-granular token blocks.

    The index maps a tuple of full-page token blocks (the same
    granularity as each engine's ``PrefixCache``) to the engine that
    last served a prompt with that block path.  ``place`` walks the
    longest indexed prefix of the request's blocks; if the owning
    engine is still eligible, the request is steered there — its radix
    trie holds those exact pages, so admission turns into
    ``map_shared`` hits instead of cold prefill.  Cold prompts (or an
    owner that is draining/full) fall back to KV-load-aware scoring.
    """

    name = "prefix_aware"

    def __init__(self, page_tokens: int) -> None:
        if page_tokens <= 0:
            raise ValueError("page_tokens must be positive")
        self.page_tokens = page_tokens
        self._index: Dict[Tuple[Tuple[int, ...], ...], int] = {}
        self._fallback = KVLoadAwarePlacement()
        self.steered = 0
        self.cold = 0

    def _blocks(self, tokens: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
        p = self.page_tokens
        toks = tuple(int(t) for t in tokens)
        return tuple(toks[i:i + p] for i in range(0, len(toks) - p + 1, p))

    def lookup(self, tokens: Sequence[int]) -> Tuple[Optional[int], int]:
        """(owning engine_id, matched block count) for the longest
        indexed block prefix, or (None, 0) on a cold miss."""
        blocks = self._blocks(tokens)
        for k in range(len(blocks), 0, -1):
            eng = self._index.get(blocks[:k])
            if eng is not None:
                return eng, k
        return None, 0

    def place(self, views: Sequence[EngineView],
              tokens: Sequence[int]) -> int:
        if not views:
            raise ValueError("no eligible engines")
        eng, matched = self.lookup(tokens)
        if eng is not None and any(v.engine_id == eng for v in views):
            self.steered += 1
            return eng
        self.cold += 1
        return self._fallback.place(views, tokens)

    def record(self, engine_id: int, tokens: Sequence[int]) -> None:
        blocks = self._blocks(tokens)
        for k in range(1, len(blocks) + 1):
            self._index[blocks[:k]] = engine_id


POLICIES = ("round_robin", "kv_aware", "prefix_aware")


def make_policy(name: str, *, page_tokens: int = 16) -> PlacementPolicy:
    """Factory used by the launcher / benchmarks (`--policy NAME`)."""
    if name == "round_robin":
        return RoundRobinPlacement()
    if name == "kv_aware":
        return KVLoadAwarePlacement()
    if name == "prefix_aware":
        return PrefixAwarePlacement(page_tokens)
    raise ValueError(f"unknown placement policy {name!r}; "
                     f"choose from {', '.join(POLICIES)}")
