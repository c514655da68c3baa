"""FleetRouter: N `ServingEngine`s behind one placement policy (port of
`repro.serving.fleet.router`).

The router is pure-Python orchestration over the engines' re-entrant
tick primitives (`pump` / `advance_to` / `begin_capture` /
`capture_stats`): no new cells, so the whole fleet layer runs on the CPU
with the plain versions and on the card with the kernels. All engines
share one set of cells and one parameter tree (`FleetRouter.build`
builds once), so an N-engine fleet on one card costs N page pools (and,
with the substrate physical, N pinned host twins and side streams), not
N copies of the weights.

Event loop (deterministic for a fixed trace + policy):

1. *route* — every request whose arrival is <= the router clock is
   placed once, via the policy, over the eligible engine views
   (accepting + prefill-capable under role split); routed requests sit
   in per-engine `RequestQueue`s (priority + cancellation semantics
   included);
2. *transfer* — pending prefill->decode handoffs are drained to the
   least-loaded decode engine with capacity (`roles.execute_handoff`);
3. *tick* — the ready engine with the smallest virtual clock pumps one
   engine-loop iteration; the router clock is the min over ready
   engines' next-event times, else the next unrouted arrival.

Each engine keeps its own virtual clock; fleet makespan is the max
engine clock at drain.  With one engine this loop replays
`ServingEngine.run` bit-for-bit (same pump/advance sequence), and with
greedy decoding the *token streams* are placement-invariant — the
property the CI fleet-parity lane pins down.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import ServeStats, ServingEngine
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.fleet.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.serving.fleet.placement import (
    EngineView, PlacementPolicy, make_policy)
from repro_torch.serving.fleet.roles import (
    TransferLedger, can_accept_handoff, execute_handoff)

__all__ = ["FleetConfig", "FleetStats", "EngineHandle", "FleetRouter"]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_engines: int = 2
    policy: str = "round_robin"
    roles: bool = False          # True: engine 0 prefill-role, rest decode
    autoscale: Optional[AutoscaleConfig] = None
    # --- fault injection + recovery (serving.faults) ---
    faults: Optional[FaultPlan] = None   # chaos schedule; None/no-op plan
    # leaves every engine on the byte-identical fault-free path
    watchdog_s: float = 5e-3     # virtual seconds an engine may fail to
    # make progress before the router declares it dead and recovers its
    # queued + in-flight requests onto the survivors

    def __post_init__(self) -> None:
        if self.n_engines < 1:
            raise ValueError("n_engines must be >= 1")
        if self.roles and self.n_engines < 2:
            raise ValueError("role split needs >= 2 engines")
        if self.roles and self.autoscale is not None:
            raise ValueError("autoscale is unified-role only")
        if self.autoscale is not None \
                and self.autoscale.max_engines > self.n_engines:
            raise ValueError("autoscale.max_engines exceeds built engines")
        if self.watchdog_s <= 0:
            raise ValueError("watchdog_s must be > 0")
        if self.roles and self.faults is not None and (
                self.faults.kill_engine is not None
                or self.faults.stall_engine is not None):
            raise ValueError(
                "engine kill/stall under a role split is unsupported: "
                "recovery migrates by teacher-forced refill through the "
                "bucketed prefill cell, which chunked prefill-role "
                "engines do not expose (transfer flaking is fine)")


class EngineHandle:
    """One engine + its router-side state (queue, role, accepting)."""

    def __init__(self, engine_id: int, engine: ServingEngine,
                 role: str = "unified", accepting: bool = True):
        self.engine_id = engine_id
        self.engine = engine
        self.role = role
        self.accepting = accepting
        self.queue = RequestQueue()
        self.routed: List[Request] = []
        self.stalled = False      # pump made no progress on arrived work;
        # cleared when routing/handoff/clock events change its inputs
        self.dead = False         # watchdog-recovered: permanently fenced
        self.recover_at: Optional[float] = None   # suspect since pump
        # returned "dead"/an over-watchdog stall; recovery fires when the
        # router clock reaches this

    def view(self) -> EngineView:
        eng = self.engine
        # outstanding-token costs: what the kv-aware score actually
        # weighs — a queued 64-token batch prompt with a 32-token budget
        # is far more load than a queued 16-token chat turn
        queued_cost = sum(
            r.prompt_len + r.max_new_tokens for r in self.routed
            if not r.output and np.isnan(r.admitted))
        busy_cost = 0.0
        for s in eng.batcher.slots:
            if s.occupied:
                req = s.request
                if s.phase == "prefill":
                    busy_cost += req.prompt_len - s.prefill_pos
                busy_cost += max(req.max_new_tokens - len(req.output), 0)
        return EngineView(
            engine_id=self.engine_id,
            n_slots=eng.ecfg.n_slots,
            busy=eng.batcher.n_busy,
            queued=len(self.queue),
            free_pages=eng.pager.counters()["free_pages"],
            total_pages=eng.pager.n_phys,
            role=self.role,
            accepting=self.accepting,
            queued_cost=queued_cost,
            busy_cost=busy_cost,
        )

    def ready_time(self) -> float:
        """Virtual time at which pumping this engine can make progress:
        its own clock while it holds live work, else the earliest queued
        arrival (never earlier than its clock), else never. A dead
        engine is never ready; a suspect one becomes the router's
        business again exactly at its watchdog deadline; an injected
        stall pushes readiness to the stall's end."""
        if self.dead:
            return float("inf")
        if self.recover_at is not None:
            return self.recover_at
        eng = self.engine
        if eng.pending_work:
            return max(eng.virtual_s, eng._stall_until)
        if self.stalled or not len(self.queue):
            return float("inf")
        return max(eng.virtual_s, eng._stall_until,
                   self.queue.next_arrival())


@dataclasses.dataclass
class FleetStats:
    n_requests: int
    tokens: int
    virtual_s: float              # fleet makespan (max engine clock delta)
    wall_s: float
    ttft: np.ndarray              # per finished request, fleet-wide
    tpot: np.ndarray
    per_engine: List[ServeStats]
    routed: List[int]             # requests placed per engine
    prefix: dict                  # aggregate prefix-cache deltas
    transfers: dict               # TransferLedger counters (roles mode)
    cancelled: int                # in-flight sweeps + queue drops
    scale_events: List[tuple]     # (virtual_t, delta, n_accepting)
    policy: dict                  # policy-internal counters
    faults: dict = dataclasses.field(default_factory=dict)  # fleet-wide
    # fault-recovery accounting: per-engine ServeStats.faults summed,
    # plus engines_killed / recoveries / handoff retry traffic. Empty on
    # fault-free runs

    def summary(self) -> dict:
        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else 0.0
        out = {
            "requests": self.n_requests,
            "tokens": self.tokens,
            "virtual_s": self.virtual_s,
            "tok_per_s_virtual": self.tokens / max(self.virtual_s, 1e-12),
            "ttft_p50": pct(self.ttft, 50),
            "ttft_p95": pct(self.ttft, 95),
            "ttft_p99": pct(self.ttft, 99),
            "tpot_p50": pct(self.tpot, 50),
            "prefix_hit_rate": self.prefix.get("hit_rate", 0.0),
            "transfers": self.transfers.get("transfers", 0),
            "transfer_bytes": self.transfers.get("bytes", 0.0),
            "cancelled": self.cancelled,
            "scale_events": len(self.scale_events),
            "routed": list(self.routed),
        }
        if self.faults:
            out["engines_killed"] = self.faults.get("engines_killed", 0)
            out["fault_retries"] = self.faults.get("retries", 0)
            out["fault_retry_bytes"] = self.faults.get("retry_bytes", 0.0)
            out["recovery_overhead_tokens"] = \
                self.faults.get("reprefilled_tokens", 0)
        return out


class FleetRouter:
    """Route a request trace across N engines; see module docstring."""

    def __init__(self, engines: Sequence[ServingEngine], fcfg: FleetConfig,
                 policy: Optional[PlacementPolicy] = None):
        if len(engines) != fcfg.n_engines:
            raise ValueError("engine count != fcfg.n_engines")
        self.fcfg = fcfg
        page_tokens = engines[0].ecfg.page_tokens
        self.policy = policy or make_policy(
            fcfg.policy, page_tokens=page_tokens)
        # ONE injector shared by every engine + substrate: per-site
        # Philox streams make the chaos schedule a pure function of the
        # plan, however engine events interleave
        self.faults: Optional[FaultInjector] = None
        if fcfg.faults is not None and fcfg.faults.active:
            self.faults = FaultInjector(fcfg.faults)
        self.handles: List[EngineHandle] = []
        n_start = (fcfg.autoscale.min_engines if fcfg.autoscale
                   else fcfg.n_engines)
        for i, eng in enumerate(engines):
            role = "unified"
            if fcfg.roles:
                role = "prefill" if i == 0 else "decode"
                eng.handoff_role = role == "prefill"
                if eng.cells.chunk_fn is None and role == "prefill":
                    raise ValueError(
                        "prefill role needs chunked prefill cells "
                        "(EngineConfig.prefill_chunk)"
                    )
            if self.faults is not None:
                eng.faults = self.faults
                eng.engine_id = i
                if eng.substrate is not None:
                    eng.substrate.faults = self.faults
                    eng.substrate.engine_id = i
            self.handles.append(EngineHandle(
                i, eng, role=role, accepting=(i < n_start)))
        self.autoscaler = (Autoscaler(fcfg.autoscale)
                           if fcfg.autoscale else None)
        self.ledger = TransferLedger()
        self.scale_events: List[tuple] = []
        self._pending_handoffs: List[tuple] = []   # (src_handle, record)
        self._pending_adoptions: List[Request] = []   # displaced in-
        # flight requests (emitted history) awaiting a live engine slot
        self.recoveries = 0

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, cfg, ecfg, fcfg: FleetConfig, *, params=None,
              seed: int = 0, topo=None, chip=None,
              device=None) -> "FleetRouter":
        """Build ONE set of engine cells + one param tree on `device` (the
        card by default; raises without one), then stand up
        `fcfg.n_engines` engines over them (per-engine page pools)."""
        first = ServingEngine.build(
            cfg, ecfg, params=params, seed=seed, topo=topo, chip=chip,
            device=device)
        engines = [first] + [
            ServingEngine(cfg, ecfg, first.params, first.cells,
                          topo=topo, chip=chip)
            for _ in range(fcfg.n_engines - 1)
        ]
        return cls(engines, fcfg)

    # ----------------------------------------------------------- routing
    def _eligible_views(self) -> List[EngineView]:
        views = []
        for h in self.handles:
            if not h.accepting:
                continue
            if self.fcfg.roles and h.role != "prefill":
                continue
            views.append(h.view())
        return views

    def _route(self, req: Request) -> None:
        views = self._eligible_views()
        eng = self.policy.place(views, req.tokens)
        self.policy.record(eng, req.tokens)
        h = self.handles[eng]
        h.queue.push(req)
        h.routed.append(req)
        h.stalled = False

    def _autoscale_tick(self, t: float) -> None:
        if self.autoscaler is None:
            return
        acc = [h for h in self.handles if h.accepting]
        slots = sum(h.engine.ecfg.n_slots for h in acc)
        load = sum(len(h.queue) + h.engine.batcher.n_busy for h in acc)
        delta = self.autoscaler.observe(load / max(slots, 1), len(acc))
        if delta > 0:
            parked = [h for h in self.handles if not h.accepting]
            if parked:
                parked[0].accepting = True
                self.scale_events.append(
                    (t, +1, sum(h.accepting for h in self.handles)))
        elif delta < 0:
            # drain the highest-id accepting engine IMMEDIATELY through
            # the migration path: queued work re-routes, in-flight slots
            # freeze and adopt onto the survivors, and the engine's page
            # pool is verified fully free — the engine parks empty
            # instead of tapering off for its slowest slot's tail
            self._evacuate_handle(acc[-1])
            self.scale_events.append(
                (t, -1, sum(h.accepting for h in self.handles)))

    # ------------------------------------------------------ fault recovery
    def _evacuate_handle(self, h: EngineHandle, *,
                         dead: bool = False) -> None:
        """Strip `h` of every queued and in-flight request and verify its
        pools drained clean. Queued requests re-route through placement
        with their ORIGINAL arrivals (the queue orders re-admissions by
        (priority, original arrival), so recovered work is deterministic
        and never jumps the line); in-flight requests with emitted
        history await adoption (teacher-forced refill) on a live engine;
        prefill-phase ones are clean requeues. `dead` fences the engine
        permanently (watchdog recovery); otherwise it parks empty and an
        autoscale-up may re-admit to it later."""
        h.accepting = False
        if dead:
            h.dead = True
            h.engine._dead = True
        moved = list(h.queue.drain())
        displaced = h.engine.evacuate()
        gone = set(map(id, moved)) | set(map(id, displaced))
        h.routed[:] = [r for r in h.routed if id(r) not in gone]
        for req in moved:
            self._route(req)
        for req in displaced:
            if req.output:
                self._pending_adoptions.append(req)
            else:
                self._route(req)
        c = h.engine.pager.counters()
        if c["free_pages"] != h.engine.pager.n_phys or c["pins"] != 0:
            raise RuntimeError(
                f"evacuation leaked pages on engine {h.engine_id}: "
                f"free {c['free_pages']}/{h.engine.pager.n_phys}, "
                f"pins {c['pins']}")

    def _recover_engine(self, h: EngineHandle, now: float) -> None:
        """The watchdog expired on a suspect engine: declare it dead and
        move everything it owned onto the survivors."""
        h.recover_at = None
        self.recoveries += 1
        self._evacuate_handle(h, dead=True)

    def _drain_adoptions(self) -> None:
        """Place displaced in-flight requests onto live engines: the
        least-busy decode-capable engine with a free slot replays prompt
        + emitted history (teacher-forced) and continues the stream
        bit-identically. Requests that do not fit yet stay pending."""
        if not self._pending_adoptions:
            return
        still = []
        for req in self._pending_adoptions:
            dsts = [d for d in self.handles
                    if not d.dead and d.recover_at is None
                    and d.role != "prefill"
                    and d.engine.batcher.n_free > 0]
            placed = None
            for d in sorted(dsts, key=lambda d: (d.engine.batcher.n_busy,
                                                 d.engine_id)):
                if d.engine.adopt(req, d.engine.virtual_s):
                    placed = d
                    break
            if placed is None:
                still.append(req)
                continue
            placed.routed.append(req)
            placed.stalled = False
        self._pending_adoptions = still

    # ---------------------------------------------------------- handoffs
    def _drain_handoffs(self) -> None:
        for h in self.handles:
            while h.engine.handoff_outbox:
                self._pending_handoffs.append(
                    (h, h.engine.handoff_outbox.pop(0)))
        if not self._pending_handoffs:
            return
        still = []
        for src_h, rec in self._pending_handoffs:
            dsts = [d for d in self.handles
                    if d.role == "decode" and can_accept_handoff(
                        d.engine, rec)]
            if not dsts:
                still.append((src_h, rec))
                continue
            dst = min(dsts, key=lambda d: (d.engine.batcher.n_busy,
                                           d.engine_id))
            execute_handoff(rec, src_h.engine, dst.engine,
                            src_id=src_h.engine_id, dst_id=dst.engine_id,
                            ledger=self.ledger, faults=self.faults)
            src_h.stalled = False     # a parked slot freed
            dst.stalled = False       # new live work landed
        self._pending_handoffs = still

    # --------------------------------------------------------------- run
    def run(self, requests: Sequence[Request],
            max_iters: int = 2_000_000) -> FleetStats:
        pending = sorted(requests, key=lambda r: (r.arrival, r.request_id))
        i = 0
        caps = [h.engine.begin_capture() for h in self.handles]
        wall0 = time.perf_counter()
        clocks0 = [h.engine.virtual_s for h in self.handles]
        iters = 0
        while True:
            iters += 1
            if iters > max_iters:
                raise RuntimeError("fleet router exceeded max_iters — "
                                   "stuck trace?")
            self._drain_handoffs()
            self._drain_adoptions()
            t_engines = min((h.ready_time() for h in self.handles),
                            default=float("inf"))
            t_arrival = pending[i].arrival if i < len(pending) \
                else float("inf")
            now = min(t_engines, t_arrival)
            if not np.isfinite(now):
                if self._pending_handoffs:
                    raise RuntimeError(
                        "handoffs pending but no decode engine can ever "
                        "accept them (capacity too small for one prompt)"
                    )
                if self._pending_adoptions:
                    raise RuntimeError(
                        "displaced requests pending adoption but no live "
                        "engine can ever take them (fleet capacity lost)"
                    )
                break
            # watchdog: suspects whose deadline the clock just reached
            # are recovered before anything else happens at `now`
            recovered = False
            for h in self.handles:
                if h.recover_at is not None and now >= h.recover_at:
                    self._recover_engine(h, now)
                    recovered = True
            if recovered:
                continue      # re-routes changed queues + ready times
            routed_any = False
            while i < len(pending) and pending[i].arrival <= now:
                self._route(pending[i])
                i += 1
                routed_any = True
            if routed_any:
                self._autoscale_tick(now)
                continue      # recompute ready times with the new queues
            ready = [h for h in self.handles
                     if h.ready_time() <= now]
            if not ready:
                continue      # a handoff drained; re-evaluate
            h = min(ready, key=lambda x: (x.ready_time(), x.engine_id))
            h.engine.advance_to(now)
            act = h.engine.pump(h.queue)
            if act == "dead":
                if h.recover_at is None and not h.dead:
                    # first silence: suspect now, dead at the deadline
                    h.recover_at = (h.engine.virtual_s
                                    + self.fcfg.watchdog_s)
            elif act == "stalled":
                stall_left = h.engine._stall_until - h.engine.virtual_s
                if stall_left > self.fcfg.watchdog_s \
                        and h.recover_at is None:
                    # a stall past the watchdog is indistinguishable
                    # from a kill: fence and recover the same way
                    h.recover_at = (h.engine.virtual_s
                                    + self.fcfg.watchdog_s)
            elif act == "idle" and len(h.queue) \
                    and h.queue.next_arrival() <= h.engine.virtual_s:
                # arrived work it cannot start (slots full of parked
                # handoffs / admission floor): wait for an external event
                h.stalled = True
        return self._stats(caps, clocks0, wall0)

    # ------------------------------------------------------------- stats
    def _stats(self, caps, clocks0, wall0) -> FleetStats:
        per = [h.engine.capture_stats(cap, h.routed)
               for h, cap in zip(self.handles, caps)]
        done = [r for h in self.handles for r in h.routed if r.output]
        ttft = np.array([r.token_times[0] - r.arrival for r in done])
        tpot = np.concatenate(
            [np.diff(r.token_times) for r in done
             if len(r.token_times) > 1] or [np.zeros(0)]
        )
        prefix: Dict[str, float] = {}
        for s in per:
            for k, v in s.prefix.items():
                if k not in ("hit_rate", "cached_pages"):
                    prefix[k] = prefix.get(k, 0) + v
        if prefix:
            n = prefix.get("hits", 0) + prefix.get("misses", 0)
            prefix["hit_rate"] = prefix.get("hits", 0) / n if n else 0.0
        cancelled = (
            sum(h.engine.cancelled for h in self.handles)
            + sum(h.queue.drop_cancelled for h in self.handles)
        )
        makespan = max(
            (h.engine.virtual_s - c0
             for h, c0 in zip(self.handles, clocks0)),
            default=0.0,
        )
        policy_counters = {}
        for key in ("steered", "cold"):
            if hasattr(self.policy, key):
                policy_counters[key] = getattr(self.policy, key)
        faults_agg: Dict[str, float] = {}
        if self.faults is not None:
            for s in per:
                for k, v in s.faults.items():
                    faults_agg[k] = faults_agg.get(k, 0) + v
            tc = self.ledger.counters()
            faults_agg["retries"] = (
                faults_agg.get("retries", 0) + tc["retries"])
            faults_agg["retry_bytes"] = (
                faults_agg.get("retry_bytes", 0.0) + tc["retry_bytes"])
            faults_agg["engines_killed"] = \
                sum(1 for h in self.handles if h.dead)
            faults_agg["recoveries"] = self.recoveries
            faults_agg["injected"] = self.faults.counters()
        return FleetStats(
            n_requests=len(done),
            tokens=sum(len(r.output) for r in done),
            virtual_s=makespan,
            wall_s=time.perf_counter() - wall0,
            ttft=ttft,
            tpot=tpot,
            per_engine=per,
            routed=[len(h.routed) for h in self.handles],
            prefix=prefix,
            transfers=self.ledger.counters(),
            cancelled=cancelled,
            scale_events=self.scale_events,
            policy=policy_counters,
            faults=faults_agg,
        )
