"""Serving fleet: a router in front of N engine replicas (counterpart of
``mxnet_tpu/serving/fleet``).

:class:`~mxnet_tpu_torch.serving.ServingEngine` answers "how do I serve
this model"; this package answers "how do I keep serving when a replica
dies".  A router (no tensor library, no device work) fronts N engine
replicas, in this process (local mode, their weights shared on one card
through ``ServingEngine.join_replica``) or in their own processes
(process mode, over HTTP), and owns:

- **health** (health.py): the per-replica HEALTHY -> SUSPECT -> EJECTED ->
  PROBING state machine fed by heartbeats, load gauges and dispatch
  outcomes, with a circuit breaker and half-open re-admission;
- **reliable dispatch** (router.py, transport.py): request ids, absolute
  deadlines, retries under the fault plane's budget, one hedged duplicate
  with first-winner dedup, prompt-prefix rendezvous affinity;
- **failure recovery**: a dead replica is seen at the monitor's first
  sweep after its death, its in-flight requests are resubmitted to the
  survivors exactly once (the idempotency ledger: no completion is
  delivered twice), and the manager (manager.py) reaps it and spawns a
  replacement;
- **graceful degradation** (policy.py): deficit-round-robin fair share
  per tenant, deadline-aware shedding (429 + Retry-After), debounced
  scale-up/down hooks.

Chaos enters through four fault seams: ``router.dispatch``,
``router.health_probe``, ``fleet.spawn``, ``replica.crash``.
"""
from __future__ import annotations

from .health import (EJECTED, HEALTHY, PROBING, SUSPECT, HealthMonitor,
                     ReplicaHealth)
from .manager import FleetManager, ProcessReplica, serve_fleet
from .policy import (Autoscaler, FairShareQueue, HedgePolicy,
                     SheddingPolicy, prefix_key, rendezvous_order)
from .router import (FleetBusyError, FleetRequest, IdempotencyLedger,
                     LocalReplica, ReplicaHandle, Router)
from .transport import (ReplicaHTTPError, TransportError, call_local,
                        get_json, post_json, remaining_s)

__all__ = [
    "HEALTHY", "SUSPECT", "EJECTED", "PROBING", "ReplicaHealth",
    "HealthMonitor",
    "FairShareQueue", "HedgePolicy", "SheddingPolicy", "Autoscaler",
    "prefix_key", "rendezvous_order",
    "Router", "FleetRequest", "FleetBusyError", "IdempotencyLedger",
    "ReplicaHandle", "LocalReplica",
    "FleetManager", "ProcessReplica", "serve_fleet",
    "TransportError", "ReplicaHTTPError", "post_json", "get_json",
    "call_local", "remaining_s",
]
