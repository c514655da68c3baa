"""The shared `PrefetchEngine` (copy of `repro.prefetch.engine`): replay an `AccessTrace` against a local
page cache + pool link, let one predictor issue pool->local page copies,
and score it with the paper's Fig 7/8 metrics.

Tier model (one engine step = one unit of workload compute):

* the local tier holds `local_pages` pages (LRU, touched-this-step pages
  are never victims);
* the pool link moves at most `bw_pages_per_step` pages per step —
  demand fetches have priority, prefetches get the leftover (matched
  pool bandwidth: every predictor, including the demand baseline, sees
  the same link);
* a prefetch issued at step i arrives at step i + `latency_steps`. At
  the default latency of 1 every correct prediction is in time (one
  step of compute hides the transfer — the layer-ahead regime of
  `prefetch/static.py`); with a slower pool (`latency_steps >= 2`) a
  correct-but-shallow prediction is LATE: the touch still stalls, the
  transfer is not re-issued, and only predictors that run far enough
  ahead (deep stride/stream depth, multi-step schedules) keep their
  coverage — timeliness is a first-class metric, not an accuracy
  footnote;
* step time = t_compute + stalls * t_fetch; demand misses and late
  prefetches stall, in-time prefetched copies overlap compute.

Metrics (paper Fig 7/8 vocabulary):

  accuracy   — (useful + late) / issued: was the prediction right?
  coverage   — useful / (useful + late + demand): misses removed.
  timeliness — useful / (useful + late): right AND on time.
  excess     — never-used issued transfers / issued: wasted pool-link
               bytes, fed back into `core.access` profiles via
               `with_prefetch_excess` (a speculative prefetcher is an
               interference injector — the paper's SuperLU 37% case).

`remote_accesses` (demand + late stalls) is the §7.1 acceptance number:
frontier-directed prefetch must cut it >= 40% vs the demand baseline.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.prefetch.predictors import Predictor, make_predictor
from repro_torch.prefetch.trace import AccessTrace


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    local_pages: int                 # local-tier page budget
    bw_pages_per_step: int           # pool-link pages/step (matched)
    degree: int = 8                  # max prefetches issued per step
    t_compute: float = 1.0           # seconds of compute per step
    t_fetch: float = 0.05            # stall per demand/late page
    latency_steps: int = 1           # steps before an issued page lands

    def __post_init__(self):
        if self.local_pages < 1 or self.bw_pages_per_step < 1:
            raise ValueError("local_pages and bw_pages_per_step must be >=1")
        if self.latency_steps < 1:
            raise ValueError("latency_steps must be >= 1")


@dataclasses.dataclass
class PrefetchReport:
    predictor: str
    trace: str
    source: str
    page_bytes: float
    steps: int
    touches: int
    local_hits: int
    demand_misses: int
    issued: int
    useful: int                      # prefetched, arrived in time, touched
    late: int                        # prefetched, touched while in flight
    total_time: float

    @property
    def accuracy(self) -> float:
        return (self.useful + self.late) / self.issued if self.issued else 0.0

    @property
    def coverage(self) -> float:
        misses = self.useful + self.late + self.demand_misses
        return self.useful / misses if misses else 0.0

    @property
    def timeliness(self) -> float:
        right = self.useful + self.late
        return self.useful / right if right else 0.0

    @property
    def excess(self) -> float:
        return ((self.issued - self.useful - self.late) / self.issued
                if self.issued else 0.0)

    @property
    def excess_bytes(self) -> float:
        return (self.issued - self.useful - self.late) * self.page_bytes

    @property
    def remote_accesses(self) -> int:
        """Accesses that stall on the pool tier (the §7.1 number)."""
        return self.demand_misses + self.late

    @property
    def remote_bytes(self) -> float:
        return self.remote_accesses * self.page_bytes

    def summary(self) -> Dict[str, float]:
        return {
            "predictor": self.predictor,
            "trace": self.trace,
            "source": self.source,
            "accuracy": self.accuracy,
            "coverage": self.coverage,
            "timeliness": self.timeliness,
            "excess": self.excess,
            "remote_accesses": self.remote_accesses,
            "issued": self.issued,
            "total_time": self.total_time,
        }


class PrefetchEngine:
    """Deterministic replay of one trace under one predictor."""

    def __init__(self, cfg: PrefetchConfig):
        self.cfg = cfg

    def run(self, trace: AccessTrace, predictor: Predictor
            ) -> PrefetchReport:
        cfg = self.cfg
        local: "collections.OrderedDict[int, bool]" = collections.OrderedDict()
        # page -> arrival step; issued-but-not-yet-arrived transfers
        inflight: Dict[int, int] = {}
        # issued-by-prefetch pages not yet touched (accuracy bookkeeping)
        pending: set = set()

        hits = demand = issued = useful = late = 0
        total_time = 0.0

        def touch_lru(p: int) -> None:
            local.pop(p, None)
            local[p] = True                      # most-recent position

        def evict(protect: set) -> None:
            while len(local) > cfg.local_pages:
                for cand in local:               # oldest first
                    if cand not in protect:
                        local.pop(cand)
                        pending.discard(cand)
                        break
                else:
                    break                        # everything is protected

        for i, step_pages in enumerate(trace.steps):
            # arrivals from the previous step's issues
            for p in [p for p, t in inflight.items() if t <= i]:
                del inflight[p]
                local[p] = True
            hint = trace.hints[i] if trace.hints is not None else None
            predictor.start_step(hint)

            bw = cfg.bw_pages_per_step
            stalls = 0
            protect = set(step_pages)
            for p in step_pages:
                if p in local:
                    hits += 1
                    if p in pending:
                        pending.discard(p)
                        useful += 1
                elif p in inflight:
                    late += 1                    # right page, too late
                    stalls += 1
                    del inflight[p]
                    pending.discard(p)
                    local[p] = True
                else:
                    demand += 1
                    stalls += 1
                    bw -= 1                      # demand takes link share
                    local[p] = True
                touch_lru(p)
                predictor.observe(p)
            evict(protect)

            # leftover link bandwidth goes to prediction
            for p in predictor.predict(cfg.degree):
                if bw <= 0:
                    break
                if 0 <= p < trace.n_pages and p not in local \
                        and p not in inflight:
                    inflight[p] = i + cfg.latency_steps
                    pending.add(p)
                    issued += 1
                    bw -= 1
            total_time += cfg.t_compute + stalls * cfg.t_fetch

        return PrefetchReport(
            predictor=predictor.name,
            trace=trace.name,
            source=trace.source,
            page_bytes=trace.page_bytes,
            steps=trace.n_steps,
            touches=trace.touches,
            local_hits=hits,
            demand_misses=demand,
            issued=issued,
            useful=useful,
            late=late,
            total_time=total_time,
        )


class AdaptiveSwitcher(Predictor):
    """Accuracy-tracked per-phase predictor switching.

    No single stream predictor wins every phase of a real trace — a
    sequential prefill phase wants `next_line`, a strided re-read wants
    `stride`, interleaved slots want `stream`. The switcher runs every
    candidate in SHADOW: all of them observe the full demand stream and
    predict every step, but only the active candidate's predictions are
    returned (and thus charged against the pool link). Each candidate's
    shadow predictions are scored against the touches that follow — a
    prediction that is touched within `ttl` steps counts as a hit, one
    that expires counts as a miss — into a rolling window of the last
    `window` outcomes. Every `phase_steps` steps the switcher moves the
    active role to the candidate with the best windowed accuracy (ties
    keep the incumbent, so a phase of equals never thrashes).

    Shadow scoring is free by construction: predictions are lists of
    page ids, only the ACTIVE list turns into transfers, so the
    switcher's excess-traffic profile is exactly its active history.
    """

    name = "adaptive"

    #: default candidate set: the stream-learnable zoo (no schedules or
    #: hints required — same constraint the KV pager puts on predictors)
    CANDIDATES = ("next_line", "stride", "stream", "markov", "ghb")

    def __init__(self, candidates: Optional[List[Predictor]] = None,
                 window: int = 64, ttl: int = 4, phase_steps: int = 16):
        if candidates is None:
            candidates = [make_predictor(n) for n in self.CANDIDATES]
        if not candidates:
            raise ValueError("adaptive switcher needs >= 1 candidate")
        if window < 1 or ttl < 1 or phase_steps < 1:
            raise ValueError("window, ttl and phase_steps must be >= 1")
        self.candidates = list(candidates)
        self.window = int(window)
        self.ttl = int(ttl)
        self.phase_steps = int(phase_steps)
        self.active = 0
        self.switches = 0
        self._step = 0
        # per-candidate shadow state: page -> expiry step / outcome window
        self._outstanding: List[Dict[int, int]] = [
            {} for _ in self.candidates]
        self._scores = [collections.deque(maxlen=self.window)
                        for _ in self.candidates]

    def _accuracy(self, i: int) -> float:
        s = self._scores[i]
        # unscored candidates rank below any scored one: a predictor
        # that never commits (empty predictions) must not hold the
        # active role against one with a real record
        return sum(s) / len(s) if s else -1.0

    def accuracies(self) -> List[float]:
        """Windowed shadow accuracy per candidate (diagnostics)."""
        return [self._accuracy(i) for i in range(len(self.candidates))]

    def start_step(self, hint: Optional[Sequence[int]] = None) -> None:
        self._step += 1
        for i, out in enumerate(self._outstanding):
            for p in [p for p, t in out.items() if t <= self._step]:
                del out[p]
                self._scores[i].append(0)        # expired unused: miss
        if self._step % self.phase_steps == 0:
            best = max(
                range(len(self.candidates)),
                key=lambda i: (self._accuracy(i), i == self.active),
            )
            if best != self.active:
                self.active = best
                self.switches += 1
        for c in self.candidates:
            c.start_step(hint)

    def observe(self, page: int) -> None:
        for i, (c, out) in enumerate(
                zip(self.candidates, self._outstanding)):
            if page in out:
                del out[page]
                self._scores[i].append(1)        # touched in time: hit
            c.observe(page)

    def predict(self, degree: int) -> List[int]:
        chosen: List[int] = []
        for i, c in enumerate(self.candidates):
            preds = c.predict(degree)
            shadow = self._outstanding[i]
            for p in preds:
                if p not in shadow:
                    shadow[p] = self._step + self.ttl
            if i == self.active:
                chosen = preds
        return chosen


def evaluate_zoo(trace: AccessTrace, cfg: PrefetchConfig,
                 predictors: Optional[List[str]] = None
                 ) -> List[PrefetchReport]:
    """Score the predictor zoo (plus the demand baseline first) on one
    trace under one matched-bandwidth engine config. `static` is built
    with the trace's own schedule (the accuracy=1 upper bound);
    `frontier` only moves when the trace carries hints."""
    names = predictors or ["demand", "next_line", "stride", "stream",
                           "markov", "ghb", "static", "frontier"]
    out = []
    for name in names:
        if name == "static":
            p = make_predictor("static", schedule=trace.steps)
        elif name == "stream":
            # size regions to the trace's address space so distinct
            # streams (slots/jobs) land in distinct table entries
            p = make_predictor(
                "stream", region_pages=max(16, trace.n_pages // 8)
            )
        else:
            p = make_predictor(name)
        out.append(PrefetchEngine(cfg).run(trace, p))
    return out


def remote_reduction(reports: List[PrefetchReport],
                     predictor: str) -> float:
    """Remote-access reduction of `predictor` vs the demand baseline in
    the same report set (1.0 = all remote stalls eliminated)."""
    base = next(r for r in reports if r.predictor == "demand")
    pred = next(r for r in reports if r.predictor == predictor)
    if base.remote_accesses == 0:
        return 0.0
    return 1.0 - pred.remote_accesses / base.remote_accesses
