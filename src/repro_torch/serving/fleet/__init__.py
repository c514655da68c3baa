"""Fleet layer: N serving engines behind a placement-policy router (port
of `repro.serving.fleet`).

Public surface:

* :class:`FleetRouter` / :class:`FleetConfig` / :class:`FleetStats` —
  the router and its run loop (`router.py`);
* :class:`EngineView`, :func:`make_policy`, the three placement
  policies (`placement.py`);
* :class:`Autoscaler` / :class:`AutoscaleConfig` — queue-depth
  hysteresis scaling (`autoscale.py`);
* :class:`TransferLedger`, :func:`execute_handoff` — the disaggregated
  prefill/decode pool-transfer machinery (`roles.py`).
"""
from repro_torch.serving.fleet.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.serving.fleet.placement import (
    POLICIES, EngineView, KVLoadAwarePlacement, PlacementPolicy,
    PrefixAwarePlacement, RoundRobinPlacement, kv_load_score, make_policy)
from repro_torch.serving.fleet.roles import (
    TransferLedger, can_accept_handoff, copy_pages, execute_handoff)
from repro_torch.serving.fleet.router import (
    EngineHandle, FleetConfig, FleetRouter, FleetStats)

__all__ = [
    "AutoscaleConfig", "Autoscaler",
    "POLICIES", "EngineView", "KVLoadAwarePlacement", "PlacementPolicy",
    "PrefixAwarePlacement", "RoundRobinPlacement", "kv_load_score",
    "make_policy",
    "TransferLedger", "can_accept_handoff", "copy_pages",
    "execute_handoff",
    "EngineHandle", "FleetConfig", "FleetRouter", "FleetStats",
]
