"""Guard-as-a-service: the fleet control plane over many concurrent
jobs sharing one node inventory; the port's own copy of the JAX
package's ``repro.fleet``.

``FleetController`` multiplexes N ``GuardSession``s: a global
home-tagged spare pool with lease/grant arbitration (urgency ladder +
job priority + fair-share floor + hard starvation bound), one shared
sweep bench all qualification campaigns queue on, a healthscan-style
background re-qualification orchestrator, and a cursor-replayable
streaming event log aggregating every session's bus.
"""
from repro_torch.fleet.controller import FleetController, FleetJob
from repro_torch.fleet.events import (FLEET_EVENT_TYPES, CampaignScheduled,
                                SpareLeased, SpareReclaimed)
from repro_torch.fleet.healthscan import HealthScanOrchestrator
from repro_torch.fleet.pool import (GlobalSparePool, Lease, LeaseKind,
                              LeaseRequest, PoolStats, SpareRecord)
from repro_torch.fleet.stream import (FleetEventLog, FleetRecord,
                                JsonlStreamSink, SSEStreamSink)

__all__ = [
    "CampaignScheduled", "FLEET_EVENT_TYPES", "FleetController",
    "FleetEventLog", "FleetJob", "FleetRecord", "GlobalSparePool",
    "HealthScanOrchestrator", "JsonlStreamSink", "Lease", "LeaseKind",
    "LeaseRequest", "PoolStats", "SSEStreamSink", "SpareLeased",
    "SpareRecord", "SpareReclaimed",
]
