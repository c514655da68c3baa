"""Predictive prefetch subsystem (port of `repro.prefetch`) — the paper's
§4.2 finding (prefetch traffic dominates tiered-memory profiles; its
accuracy/coverage/excess decide whether a pooled tier helps or hurts)
as a subsystem for DYNAMIC access streams.

Three-level mapping (each level one module, composable across sources):

  1. capture  (`trace.py`, `workloads.py`, `static.py`) — demand
     page-touch streams as `AccessTrace`: the serving KV pager's
     hot-tail/cold-prefix stream (`kv_pager_trace` or a live
     `TraceRecorder` on a `KVPager`), the rack simulator's co-resident
     pool traffic (`sched_pool_trace`), the BFS-on-CSR frontier
     expansion over a pool-resident adjacency array (`bfs_trace`, with
     application hints), and the static layer stream
     (`layer_stream_trace`).
  2. predict  (`predictors.py`) — one protocol
     (observe/start_step/predict), seven predictors: next_line, stride,
     stream, markov, ghb (second-order delta-correlation history),
     static (accuracy=1 schedule), and the application-directed frontier
     predictor.
  3. score    (`engine.py`) — the shared `PrefetchEngine` replays any
     trace under any predictor against a local page budget and a
     matched pool link, charges issued pool->local copies, and reports
     the paper's Fig 7/8 metrics (accuracy, coverage, timeliness,
     excess) plus remote stalls; fetched-but-unused bytes feed back
     into `core.access` profiles via `with_prefetch_excess`.

The one physical transfer is `static.scan_with_prefetch`: on the card a
loop over layers whose pool-resident leaves (pinned host tensors) are
copied one layer ahead by the page-copy kernel on a side stream (the
`layer_in` stream of `kernels.page_io`).

Serving integration: `serving.kv_pager.PagerConfig(prefetch=<name>)`
switches the pager's cold-prefix page-in from demand paging to
prediction-driven staging (discrete touch schedule, demand vs prefetched
pool bytes split). Staging is accounting, as in the reference: the
substrate still moves pages by tier changes.
"""

from repro_torch.prefetch.engine import (
    AdaptiveSwitcher,
    PrefetchConfig,
    PrefetchEngine,
    PrefetchReport,
    evaluate_zoo,
    remote_reduction,
)
from repro_torch.prefetch.predictors import (
    FrontierPredictor,
    GHBPredictor,
    MarkovPredictor,
    NextLinePredictor,
    Predictor,
    StaticSchedulePredictor,
    StreamPredictor,
    StridePredictor,
    make_predictor,
    zoo_names,
)
from repro_torch.prefetch.trace import (
    AccessTrace,
    TraceRecorder,
    kv_pager_trace,
    sched_pool_trace,
)
from repro_torch.prefetch.workloads import BFSTrace, bfs_levels, bfs_trace, \
    random_csr

__all__ = [
    "AccessTrace",
    "AdaptiveSwitcher",
    "BFSTrace",
    "FrontierPredictor",
    "GHBPredictor",
    "MarkovPredictor",
    "NextLinePredictor",
    "Predictor",
    "PrefetchConfig",
    "PrefetchEngine",
    "PrefetchReport",
    "StaticSchedulePredictor",
    "StreamPredictor",
    "StridePredictor",
    "TraceRecorder",
    "bfs_levels",
    "bfs_trace",
    "evaluate_zoo",
    "kv_pager_trace",
    "make_predictor",
    "random_csr",
    "remote_reduction",
    "sched_pool_trace",
    "zoo_names",
]
