"""The predictor zoo — one protocol, seven predictors (paper §4.2, Fig 7/8;
copy of `repro.prefetch.predictors`).

Every predictor sees the same thing a hardware or runtime prefetcher sees:
the demand page-touch stream, one page id at a time (`observe`), plus an
optional per-step application hint (`start_step`). `predict(degree)`
returns the pages to fetch ahead, best-first; the shared `PrefetchEngine`
charges the issued transfers against the pool-link budget and scores the
outcome with the paper's metrics (accuracy / coverage / timeliness /
excess traffic).

The zoo spans the paper's taxonomy:

  next_line — fetch the next `degree` sequential pages after the last
              touch (the L2 adjacent-line prefetcher).
  stride    — confirm a constant stride over the last touches, then run
              it ahead (the classic IP-stride HW prefetcher).
  stream    — a table of concurrent region streams (direction + last
              page per region), round-robin ahead of each confirmed
              stream (the LLC streamer; survives interleaved slots/jobs).
  markov    — first-order page-transition history, walk the most
              frequent successors (correlation prefetcher).
  ghb       — Global History Buffer, delta-correlation: SECOND-order
              history keyed on the last two touch DELTAS, so it learns
              repeating delta patterns (+1,+3,+1,+3 ...) that defeat
              both the single-stride confirmer and first-order page
              correlation (Nesbit & Smith's GHB/DC organization).
  static    — the full access SCHEDULE is known (the subsumed
              `prefetch/static.py` layer stream: accuracy is
              structurally 1); predicts exactly the next step's pages.
  frontier  — application-directed: the workload hands the next
              frontier's pages via `start_step` (the paper's BFS §7.1
              fix — software knows the future that hardware cannot).

`demand` (the null predictor) is the no-prefetch baseline every report is
normalized against.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence


class Predictor:
    """Base: a demand-paging null predictor (never prefetches)."""

    name = "demand"

    def start_step(self, hint: Optional[Sequence[int]] = None) -> None:
        """Called once per engine step, before that step's touches.
        `hint` is the application-directed forecast of upcoming touches
        (only the `frontier` predictor uses it)."""

    def observe(self, page: int) -> None:
        """One demand touch of `page` (in demand order)."""

    def predict(self, degree: int) -> List[int]:
        """Up to `degree` pages to fetch ahead, best-first."""
        return []


class NextLinePredictor(Predictor):
    name = "next_line"

    def __init__(self):
        self.last: Optional[int] = None

    def observe(self, page: int) -> None:
        self.last = page

    def predict(self, degree: int) -> List[int]:
        if self.last is None:
            return []
        return [self.last + i for i in range(1, degree + 1)]


class StridePredictor(Predictor):
    """Confirm a constant stride twice before running ahead."""

    name = "stride"

    def __init__(self):
        self.last: Optional[int] = None
        self.stride = 0
        self.confidence = 0

    def observe(self, page: int) -> None:
        if self.last is not None:
            s = page - self.last
            if s != 0:
                if s == self.stride:
                    self.confidence = min(self.confidence + 1, 4)
                else:
                    self.stride = s
                    self.confidence = 1
        self.last = page

    def predict(self, degree: int) -> List[int]:
        if self.last is None or self.confidence < 2 or self.stride == 0:
            return []
        return [self.last + self.stride * i for i in range(1, degree + 1)]


class StreamPredictor(Predictor):
    """Per-region stream table: tolerates interleaved sequential streams
    (multiple serving slots / co-resident jobs sharing one trace)."""

    name = "stream"

    def __init__(self, region_pages: int = 256, max_streams: int = 16):
        self.region_pages = region_pages
        self.max_streams = max_streams
        # region -> [last_page, stride, confidence]; insertion order = LRU
        self.table: Dict[int, list] = collections.OrderedDict()

    def observe(self, page: int) -> None:
        region = page // self.region_pages
        ent = self.table.pop(region, None)
        if ent is None:
            ent = [page, 0, 0]
        else:
            s = page - ent[0]
            if s != 0:
                if s == ent[1]:
                    ent[2] = min(ent[2] + 1, 4)
                else:
                    ent[1], ent[2] = s, 1
            ent[0] = page
        self.table[region] = ent
        while len(self.table) > self.max_streams:
            self.table.popitem(last=False)

    def predict(self, degree: int) -> List[int]:
        live = [e for e in reversed(self.table.values()) if e[2] >= 2]
        out: List[int] = []
        depth = 1
        while live and len(out) < degree:
            for last, stride, _ in live:          # round-robin the streams
                out.append(last + stride * depth)
                if len(out) >= degree:
                    break
            depth += 1
        return out


class MarkovPredictor(Predictor):
    """First-order page-transition table; prediction walks the chain of
    most-frequent successors from the current page."""

    name = "markov"

    def __init__(self, max_pages: int = 1 << 16):
        self.table: Dict[int, collections.Counter] = {}
        self.last: Optional[int] = None
        self.max_pages = max_pages

    def observe(self, page: int) -> None:
        if self.last is not None and len(self.table) < self.max_pages:
            self.table.setdefault(self.last, collections.Counter())[page] += 1
        self.last = page

    def predict(self, degree: int) -> List[int]:
        out: List[int] = []
        seen = set()
        cur = self.last
        while cur is not None and len(out) < degree:
            succ = self.table.get(cur)
            if not succ:
                break
            ranked = [p for p, _ in succ.most_common(degree)
                      if p not in seen]
            if not ranked:
                break
            for p in ranked[: degree - len(out)]:
                out.append(p)
                seen.add(p)
            cur = ranked[0]                        # walk the likeliest chain
        return out


class GHBPredictor(Predictor):
    """Global History Buffer, delta-correlation (second-order history).

    The index is the pair of the last two non-zero touch deltas; the
    table records which delta followed that pair. Prediction replays the
    likeliest delta chain from the current context — so a repeating
    delta pattern of any period <= 2 (strides, alternating strides,
    interleaved +a/+b walks) is learned exactly, where `stride` needs a
    single confirmed constant and `markov` must see every absolute page
    twice. Pages are unbounded; the table is capacity-capped like a
    hardware GHB."""

    name = "ghb"

    def __init__(self, max_entries: int = 1 << 12):
        self.last: Optional[int] = None
        self.key = (None, None)            # last two deltas
        self.table: Dict[tuple, collections.Counter] = {}
        self.max_entries = max_entries

    def observe(self, page: int) -> None:
        if self.last is None:
            self.last = page
            return
        d = page - self.last
        self.last = page
        if d == 0:
            return
        a, b = self.key
        if a is not None and (
                self.key in self.table or len(self.table) < self.max_entries):
            self.table.setdefault(self.key, collections.Counter())[d] += 1
        self.key = (b, d)

    def predict(self, degree: int) -> List[int]:
        a, _ = self.key
        if self.last is None or a is None:
            return []
        out: List[int] = []
        key, page = self.key, self.last
        for _ in range(degree):
            succ = self.table.get(key)
            if not succ:
                break
            d = succ.most_common(1)[0][0]
            page = page + d
            out.append(page)
            key = (key[1], d)
        return out


class StaticSchedulePredictor(Predictor):
    """The access schedule is fully known ahead of time — the subsumed
    `prefetch/static.py` case (a loop over stacked layers has a
    static layer stream), generalized to any recorded schedule. Accuracy
    is structurally 1: everything predicted IS the next step's touch set.
    """

    name = "static"

    def __init__(self, schedule: Sequence[Sequence[int]]):
        self.schedule = [list(s) for s in schedule]
        self.step = -1

    def start_step(self, hint: Optional[Sequence[int]] = None) -> None:
        self.step += 1

    def predict(self, degree: int) -> List[int]:
        nxt = self.step + 1
        if nxt >= len(self.schedule):
            return []
        return list(self.schedule[nxt])[:degree]


class FrontierPredictor(Predictor):
    """Application-directed (paper §7.1 BFS case study): the workload
    computes its next frontier and hands the adjacency pages via
    `start_step(hint)`; prediction is exactly that hint."""

    name = "frontier"

    def __init__(self):
        self.hint: List[int] = []

    def start_step(self, hint: Optional[Sequence[int]] = None) -> None:
        self.hint = list(hint) if hint else []

    def predict(self, degree: int) -> List[int]:
        return self.hint[:degree]


_ZOO = {
    "demand": Predictor,
    "next_line": NextLinePredictor,
    "stride": StridePredictor,
    "stream": StreamPredictor,
    "markov": MarkovPredictor,
    "ghb": GHBPredictor,
    "frontier": FrontierPredictor,
}


def make_predictor(name: str, **kwargs) -> Predictor:
    """Factory over the zoo. `static` needs the schedule:
    `make_predictor("static", schedule=trace.steps)`."""
    if name == "static":
        return StaticSchedulePredictor(kwargs.pop("schedule"))
    if name == "adaptive":
        # lazy: AdaptiveSwitcher lives with the engine (it composes zoo
        # members), and engine.py imports this module at the top
        from repro_torch.prefetch.engine import AdaptiveSwitcher
        return AdaptiveSwitcher(**kwargs)
    try:
        cls = _ZOO[name]
    except KeyError:
        raise ValueError(
            f"unknown predictor {name!r} "
            f"(know {sorted(_ZOO)} + 'static' + 'adaptive')"
        ) from None
    return cls(**kwargs)


def zoo_names(include_static: bool = True) -> List[str]:
    names = [n for n in _ZOO if n != "demand"]
    return names + ["static"] if include_static else names
