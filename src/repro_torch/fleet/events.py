# guardlint: disable-file=GL004 reason=this module mirrors the taxonomy of
# repro.fleet.events class for class and kind for kind, so that both
# packages write the same fleet JSONL; GL004 selects event classes by class
# name and reads every mirrored kind as a collision.
# tests/test_torch_fleet.py pins names, kinds and fields against the
# reference and compares the fleet JSONL line for line.
"""Fleet-level control-plane events; the port of ``repro.fleet.events``.

These extend the ``repro_torch.guard`` taxonomy with the transitions only
a multi-job control plane can see: lease grants and reclaims against the
global spare pool, and background re-qualification campaigns scheduled
by the healthscan orchestrator. They are ordinary ``ControlEvent``
subclasses so every existing sink (trace, JSONL) renders them, and the
fleet event log tags them — like every per-session event it aggregates —
with the owning job id and a monotonic fleet sequence number.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple, Type

from repro_torch.guard.events import ControlEvent


@dataclasses.dataclass(frozen=True)
class SpareLeased(ControlEvent):
    """The global pool granted a node to a job. ``kind`` is the lease
    urgency class (``swap`` / ``crash`` / ``hang``), ``provisioned``
    whether the grant had to materialize brand-new capacity (pool was
    dry or the free nodes were not transferable), ``transfer`` whether
    the granted capacity was donated by another job's homed spare,
    ``wait_s`` how long the request queued before the grant."""
    kind: ClassVar[str] = "spare_leased"
    node_id: int = -1
    job: str = ""
    lease_kind: str = "swap"
    priority: int = 0
    provisioned: bool = False
    transfer: bool = False
    wait_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpareReclaimed(ControlEvent):
    """A healthy node returned to the global pool (lease closed, a
    requalified node landed, or a registering job's private spares were
    adopted)."""
    kind: ClassVar[str] = "spare_reclaimed"
    node_id: int = -1
    job: str = ""
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class CampaignScheduled(ControlEvent):
    """The healthscan orchestrator booked a background re-qualification
    campaign on idle bench capacity: ``nodes`` free-pool spares homed in
    ``job`` get swept while no foreground qualification wants the
    slots."""
    kind: ClassVar[str] = "campaign_scheduled"
    job: str = ""
    nodes: Tuple[int, ...] = ()
    start_t: float = 0.0
    finish_t: float = 0.0


FLEET_EVENT_TYPES: Tuple[Type[ControlEvent], ...] = (
    SpareLeased, SpareReclaimed, CampaignScheduled,
)

__all__ = ["CampaignScheduled", "FLEET_EVENT_TYPES", "SpareLeased",
           "SpareReclaimed"]
