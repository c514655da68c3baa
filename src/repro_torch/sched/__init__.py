"""Interference-aware scheduling (paper §7.2), from toy to rack scale (port
of `repro.sched`, numpy only; profiles priced on the port's H100
topology unless a base topology is given).

Two layers:

* `scheduler` — the original single-pool Fig 13 reproduction: `Job`,
  `RandomScheduler` / `InterferenceAwareScheduler` one-shot placement and
  the `simulate_colocation` Monte-Carlo with an *assumed* background LoI
  range. Kept as the minimal, didactic model.

* the rack-scale subsystem — `cluster` (racks × pools × node slots, each
  pool one shared-link contention domain), `workload` (job streams whose
  profiles are computed at submission, per the paper's SLURM proposal),
  `policies` (FCFS / random / interference-aware / corridor bin-packing
  behind the `Policy` protocol) and `simulator` (event-driven engine whose
  background LoI is *derived* from actual co-residents via
  `core.interference` instead of assumed). See `simulator`'s module
  docstring for the event model.
"""

from repro_torch.sched.scheduler import (  # noqa: F401
    Job,
    InterferenceAwareScheduler,
    RandomScheduler,
    simulate_colocation,
)
from repro_torch.sched.cluster import (  # noqa: F401
    Cluster,
    ClusterSpec,
    Pool,
    Rack,
    build_cluster,
)
from repro_torch.sched.policies import (  # noqa: F401
    DEFAULT_POLICIES,
    CorridorBinPackPolicy,
    FCFSPolicy,
    InterferenceAwarePolicy,
    Policy,
    RandomPolicy,
    make_policy,
)
from repro_torch.sched.simulator import SimResult, run_policies, simulate  # noqa: F401
from repro_torch.sched.workload import (  # noqa: F401
    TraceJob,
    catalog_stream,
    profile_with_injected_loi,
    rescale_load,
    synthetic_profile,
    synthetic_stream,
)
