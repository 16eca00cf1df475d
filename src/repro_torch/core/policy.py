"""Tiered response policy (§4.2).

Training step time — the user-visible signal — decides the response tier;
hardware metrics only ever *support* a verdict. The tiers trade mitigation
urgency against operational disruption:

  PENDING      no observable step impact (hardware signals only): keep the
               node in the job, mark pending-verification, watch closely.
  DEFER        moderate sustained slowdown (~10%): actionable, not urgent —
               mitigate at the NEXT CHECKPOINT to confirm the diagnosis
               without an extra restart.
  IMMEDIATE    severe (>=20%) degradation or a stall: restart now with a
               healthy replacement; the node leaves service for remediation.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Union

from repro_torch.core.detector import FleetAssessment, NodeAssessment


class Action(enum.Enum):
    NONE = "none"
    PENDING_VERIFICATION = "pending_verification"
    DEFER_TO_CHECKPOINT = "defer_to_checkpoint"
    IMMEDIATE_RESTART = "immediate_restart"


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    moderate_slowdown: float = 0.10   # §4.2 "~10%"
    severe_slowdown: float = 0.20     # §4.2 ">=20%"


@dataclasses.dataclass
class Decision:
    node_id: int
    action: Action
    reason: str
    slowdown: float


class TieredPolicy:
    def __init__(self, cfg: Optional[PolicyConfig] = None):
        self.cfg = cfg or PolicyConfig()

    def decide(self, assessments: Union[FleetAssessment,
                                        Sequence[NodeAssessment]]
               ) -> List[Decision]:
        if isinstance(assessments, FleetAssessment):
            return self._decide_fleet(assessments)
        return [self._decide_one(a.node_id, a.slowdown, a.stalled, a.support)
                for a in assessments if a.flagged]

    def _decide_fleet(self, fleet: FleetAssessment) -> List[Decision]:
        """Vectorized tier classification over the flagged rows, which
        the assessment brings to the host in one transfer; only they ever
        become Python objects."""
        idx = fleet.flagged_indices()
        if not idx.size:
            return []
        slowdown = fleet.flagged_slowdown()       # host float32, as in
        stalled = fleet.flagged_stalled()         # the reference
        # tier codes for all flagged rows in one pass
        immediate = stalled | (slowdown >= self.cfg.severe_slowdown)
        deferred = ~immediate & (slowdown >= self.cfg.moderate_slowdown)
        out = []
        for j, i in enumerate(idx):
            support = None if immediate[j] or deferred[j] \
                else fleet.support_of(int(i))
            out.append(self._decide_one(
                int(fleet.node_ids[i]), float(slowdown[j]),
                bool(stalled[j]), support))
        return out

    def _decide_one(self, node_id: int, slowdown: float, stalled: bool,
                    support) -> Decision:
        if stalled or slowdown >= self.cfg.severe_slowdown:
            act = Action.IMMEDIATE_RESTART
            why = "stall" if stalled else f"severe slowdown {slowdown:.0%}"
        elif slowdown >= self.cfg.moderate_slowdown:
            act = Action.DEFER_TO_CHECKPOINT
            why = f"moderate sustained slowdown {slowdown:.0%}"
        else:
            act = Action.PENDING_VERIFICATION
            why = ("hardware signals: " + ",".join(support)
                   if support else "marginal step deviation")
        return Decision(node_id, act, why, slowdown)
