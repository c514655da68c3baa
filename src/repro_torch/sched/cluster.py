"""Rack-scale cluster topology for the co-location simulator (paper §7.2;
copy of `repro.sched.cluster`).

The hierarchy is Cluster -> Rack -> Pool -> node slots. A `Pool` is one
shared-link contention domain: a disaggregated memory pool (host DRAM
behind PCIe here; CXL in the paper and in the rack-scale topologies of
arXiv:2211.02682) shared by `capacity` node slots. Every job resident in a
pool injects traffic on the pool link; the pool's instantaneous LoI seen by
a victim is the (saturation-capped) sum of everyone else's injected LoI,
exactly the `core.interference` model.

Racks only group pools — inter-rack traffic is out of scope (jobs never
span pools) — but keeping the level explicit lets policies prefer intra-rack
spreading and lets traces describe heterogeneous racks later.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

from repro_torch.core.interference import background_lois


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Regular rack x pool x node topology (the common case)."""

    n_racks: int = 2
    pools_per_rack: int = 2
    nodes_per_pool: int = 4

    def __post_init__(self):
        for field in ("n_racks", "pools_per_rack", "nodes_per_pool"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1")

    @property
    def n_pools(self) -> int:
        return self.n_racks * self.pools_per_rack

    @property
    def total_slots(self) -> int:
        return self.n_pools * self.nodes_per_pool


@dataclasses.dataclass
class Pool:
    """One contention domain: `capacity` node slots behind a shared link.

    `jobs` holds the resident jobs — any object exposing `injected_loi`
    (the submission-time metric from `core.interference`).
    """

    pool_id: int
    rack_id: int
    capacity: int
    jobs: List = dataclasses.field(default_factory=list)

    @property
    def free_slots(self) -> int:
        return self.capacity - len(self.jobs)

    @property
    def is_open(self) -> bool:
        return self.free_slots > 0

    def total_injected_loi(self) -> float:
        return min(1.0, sum(j.injected_loi for j in self.jobs))

    def background_loi_for(self, job) -> float:
        """LoI the given (resident or candidate) job would see from the
        other residents."""
        return min(
            1.0,
            sum(j.injected_loi for j in self.jobs if j is not job),
        )

    def background_lois(self):
        """Vectorized per-resident background LoI (see
        `core.interference.background_lois`)."""
        return background_lois([j.injected_loi for j in self.jobs])

    def add(self, job) -> None:
        if not self.is_open:
            raise RuntimeError(f"pool {self.pool_id} is full")
        self.jobs.append(job)

    def remove(self, job) -> None:
        self.jobs.remove(job)


@dataclasses.dataclass
class Rack:
    rack_id: int
    pools: List[Pool]


@dataclasses.dataclass
class Cluster:
    spec: ClusterSpec
    racks: List[Rack]

    @classmethod
    def build(cls, spec: ClusterSpec) -> "Cluster":
        racks, pid = [], 0
        for r in range(spec.n_racks):
            pools = []
            for _ in range(spec.pools_per_rack):
                pools.append(Pool(pool_id=pid, rack_id=r,
                                  capacity=spec.nodes_per_pool))
                pid += 1
            racks.append(Rack(rack_id=r, pools=pools))
        return cls(spec=spec, racks=racks)

    @property
    def pools(self) -> List[Pool]:
        return [p for r in self.racks for p in r.pools]

    def pool(self, pool_id: int) -> Pool:
        p = self.pools[pool_id]
        assert p.pool_id == pool_id, "pool ids must be dense in build order"
        return p

    def open_pools(self) -> List[Pool]:
        return [p for p in self.pools if p.is_open]

    @property
    def total_capacity(self) -> int:
        return sum(p.capacity for p in self.pools)

    @property
    def occupancy(self) -> int:
        return sum(len(p.jobs) for p in self.pools)

    def iter_jobs(self) -> Iterator:
        for p in self.pools:
            yield from p.jobs

    def reset(self) -> None:
        """Evict every resident job (fresh run of the same topology)."""
        for p in self.pools:
            p.jobs.clear()


def build_cluster(n_racks: int = 2, pools_per_rack: int = 2,
                  nodes_per_pool: int = 4,
                  spec: Optional[ClusterSpec] = None) -> Cluster:
    """Convenience constructor used by examples/benchmarks/tests."""
    return Cluster.build(
        spec or ClusterSpec(n_racks, pools_per_rack, nodes_per_pool)
    )
