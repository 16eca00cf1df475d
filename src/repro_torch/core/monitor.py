"""Online node-health monitoring loop (§4).

``OnlineMonitor`` consumes telemetry Frames (from any Collector), runs the
peer-relative detector and the tiered policy, and emits ``HealthEvent``s for
the health manager to act on. It is deliberately thin: all intelligence lives
in the detector/policy so this loop stays lightweight and non-intrusive —
the paper's requirement for running it against production jobs. The whole
window is processed on the detector's ``FleetAssessment`` arrays; per-node
records are materialized only for the nodes that generated decisions.

An optional ``Diagnoser`` (``repro_torch.diagnose``) sits BETWEEN the
detector and the policy: it attributes each flagged node to a root cause
via what-if counterfactual replay, and mitigation decisions against nodes
it holds (cascade victims stalled behind a culprit, transient congestion)
are downgraded to pending-verification — watched, not evicted.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.detector import (DetectorConfig, FleetAssessment,
                                       NodeAssessment, StragglerDetector)
from repro_torch.core.policy import Action, Decision, PolicyConfig, TieredPolicy
from repro_torch.core.telemetry import Frame


@dataclasses.dataclass
class HealthEvent:
    t: float
    step: int
    decision: Decision
    assessment: NodeAssessment


class OnlineMonitor:
    def __init__(self,
                 detector_cfg: Optional[DetectorConfig] = None,
                 policy_cfg: Optional[PolicyConfig] = None,
                 on_event: Optional[Callable[[HealthEvent], None]] = None,
                 diagnoser=None):
        self.detector = StragglerDetector(detector_cfg)
        self.policy = TieredPolicy(policy_cfg)
        self.on_event = on_event
        # optional repro_torch.diagnose.Diagnoser (duck-typed so
        # repro_torch.core keeps zero dependency on the diagnosis package)
        self.diagnoser = diagnoser
        self.events: List[HealthEvent] = []
        # nodes currently marked pending-verification (watched closely)
        self.pending: Dict[int, float] = {}
        self.last_assessment: Optional[FleetAssessment] = None
        self.last_diagnosis = None

    def observe(self, frame: Frame) -> List[HealthEvent]:
        """Process one evaluation window; returns new events."""
        fleet = self.detector.update(frame)
        self.last_assessment = fleet
        diag = None
        if self.diagnoser is not None:
            diag = self.diagnoser.diagnose(frame, fleet)
        self.last_diagnosis = diag
        new: List[HealthEvent] = []
        for d in self.policy.decide(fleet):
            if diag is not None:
                d = diag.reroute(d)
            if d.action == Action.PENDING_VERIFICATION:
                # record once; re-emit only on escalation
                if d.node_id in self.pending:
                    continue
                self.pending[d.node_id] = frame.t
            else:
                self.pending.pop(d.node_id, None)
            idx = fleet.index_of(d.node_id)
            ev = HealthEvent(frame.t, frame.step, d, fleet.node(idx))
            new.append(ev)
            self.events.append(ev)
            if self.on_event:
                self.on_event(ev)
        # drop pending marks for nodes that cleared
        for nid in list(self.pending):
            cleared = fleet.flagged_of(nid)
            if cleared is False:          # None = node left the frame
                del self.pending[nid]
        return new

    def node_replaced(self, node_id: int) -> None:
        self.detector.reset_node(node_id)
        self.pending.pop(node_id, None)
        if self.diagnoser is not None:
            self.diagnoser.node_replaced(node_id)
