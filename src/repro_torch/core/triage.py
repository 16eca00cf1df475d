"""Tiered grey-node triage workflow (§6, Fig. 8).

Remediation is staged from cheap/reversible to invasive, with a health
re-check gate after every stage:

  cascade-victim attribution   ->  RETURN TO SWEEP, no strike, no stages
                                   (the node was stalled behind a degraded
                                   peer — it is not the problem)
  no actionable error signals  ->  EARLY TERMINATION (don't burn remediation
                                   effort on an undiagnosable node)
  GPU errors                   ->  device reset -> reboot -> re-image
  network errors               ->  NIC reset    -> reboot -> re-image
  host/data errors             ->  reboot -> re-image

A node that passes the post-stage health check returns to the sweep pipeline
(NOT directly to production — §5.4's conservative rule). A node that
exhausts its stages is terminated and replaced. Independently, the
3-strikes rule (§6): a node entering triage >= ``strike_limit`` times within
``strike_window`` seconds is terminally bad — terminate without triage.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Callable, Dict, List, Optional


class TriageOutcome(enum.Enum):
    RETURNED_TO_SWEEP = "returned_to_sweep"
    TERMINATED = "terminated"


@dataclasses.dataclass(frozen=True)
class ErrorSignals:
    """Actionable error evidence gathered by online monitoring and (when
    a diagnoser runs) by blame attribution.

    The booleans pick the remediation lane; ``root_cause`` carries the
    attribution taxonomy value (a root-cause string) so triage
    can recognize verdicts — notably ``cascade_victim``, which must
    neither consume a 3-strikes strike nor burn remediation stages."""
    gpu_errors: bool = False       # XID-equivalent device errors, throttle
    nic_errors: bool = False       # link flaps, retx storms, adapter down
    host_errors: bool = False      # host/data-pipeline evidence (CPU cfg)
    root_cause: str = ""           # attribution taxonomy value, if known
    detail: str = ""               # human-readable evidence summary

    @property
    def actionable(self) -> bool:
        return self.gpu_errors or self.nic_errors or self.host_errors

    def merged(self, other: "ErrorSignals") -> "ErrorSignals":
        """Union of two evidence sources (diagnosis + substrate counters);
        this object's attribution fields win when both are set."""
        return ErrorSignals(
            gpu_errors=self.gpu_errors or other.gpu_errors,
            nic_errors=self.nic_errors or other.nic_errors,
            host_errors=self.host_errors or other.host_errors,
            root_cause=self.root_cause or other.root_cause,
            detail=self.detail or other.detail)


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    duration_s: float              # node-down time
    human_s: float                 # operator attention consumed


@dataclasses.dataclass(frozen=True)
class TriageConfig:
    strike_limit: int = 3
    strike_window_s: float = 7 * 86_400.0       # one week
    gpu_stages: tuple = (
        Stage("gpu_reset", 600.0, 120.0),
        Stage("reboot", 1_200.0, 120.0),
        Stage("reimage", 7_200.0, 600.0),
    )
    nic_stages: tuple = (
        Stage("nic_reset", 600.0, 120.0),
        Stage("reboot", 1_200.0, 120.0),
        Stage("reimage", 7_200.0, 600.0),
    )
    host_stages: tuple = (
        Stage("reboot", 1_200.0, 120.0),
        Stage("reimage", 7_200.0, 600.0),
    )
    terminate_human_s: float = 300.0


@dataclasses.dataclass
class TriageResult:
    node_id: int
    outcome: TriageOutcome
    stages_run: List[str]
    elapsed_s: float
    human_s: float
    reason: str


class TriageWorkflow:
    """Drives remediation through substrate callbacks so the same FSM runs
    against simulation and against real fleet tooling.

      remediate(node_id, stage_name) -> None   apply the action
      verify(node_id) -> bool                  post-stage health check
    """

    def __init__(self, cfg: Optional[TriageConfig] = None):
        self.cfg = cfg or TriageConfig()
        self._strikes: Dict[int, List[float]] = defaultdict(list)
        self.results: List[TriageResult] = []

    def strike_count(self, node_id: int, now: float) -> int:
        w = [t for t in self._strikes[node_id]
             if now - t <= self.cfg.strike_window_s]
        self._strikes[node_id] = w
        return len(w)

    def run(self, node_id: int, signals: ErrorSignals, now: float,
            remediate: Callable[[int, str], None],
            verify: Callable[[int], bool]) -> TriageResult:
        cfg = self.cfg

        # attribution says the node is a victim — stalled behind a
        # degraded peer (cascade_victim) or blocked on the barrier of a
        # hung collective (hang_victim) — not degraded itself. Return it
        # to the sweep pipeline WITHOUT a strike (a strike here would
        # ratchet a healthy node toward 3-strikes termination) and
        # without burning remediation stages on it.
        if signals.root_cause in ("cascade_victim", "hang_victim"):
            res = TriageResult(node_id, TriageOutcome.RETURNED_TO_SWEEP,
                               [], 0.0, 0.0,
                               "cascade victim: no strike, no remediation"
                               if signals.root_cause == "cascade_victim"
                               else "hang victim: no strike, "
                                    "no remediation")
            self.results.append(res)
            return res

        self._strikes[node_id].append(now)

        # 3-strikes: terminally bad, skip the workflow
        if self.strike_count(node_id, now) >= cfg.strike_limit:
            res = TriageResult(node_id, TriageOutcome.TERMINATED, [],
                               0.0, cfg.terminate_human_s,
                               f"{cfg.strike_limit} strikes in window")
            self.results.append(res)
            return res

        # no actionable errors: early termination
        if not signals.actionable:
            res = TriageResult(node_id, TriageOutcome.TERMINATED, [],
                               0.0, cfg.terminate_human_s,
                               "no actionable error signals")
            self.results.append(res)
            return res

        if signals.gpu_errors:
            stages = cfg.gpu_stages
        elif signals.nic_errors:
            stages = cfg.nic_stages
        else:
            stages = cfg.host_stages
        elapsed = human = 0.0
        run: List[str] = []
        for st in stages:
            remediate(node_id, st.name)
            run.append(st.name)
            elapsed += st.duration_s
            human += st.human_s
            if verify(node_id):
                res = TriageResult(node_id, TriageOutcome.RETURNED_TO_SWEEP,
                                   run, elapsed, human,
                                   f"healthy after {st.name}")
                self.results.append(res)
                return res
        res = TriageResult(node_id, TriageOutcome.TERMINATED, run,
                           elapsed, human + cfg.terminate_human_s,
                           "remediation exhausted")
        self.results.append(res)
        return res
