"""Barrier-timeout hang watchdog with culprit/victim attribution.

A hung collective is the failure the z-score path cannot see: step times
stop arriving entirely, so there is no sample to score. Today's
framework-level answer is the CCL abort — kill the job after a long
fixed silence and restart blind, with the wedged rank still in it. The
watchdog replaces that with CCL-D's slow-vs-hang taxonomy:

  deadline rule    a group is HUNG when its in-flight collective has
                   been pending longer than ``clamp(mult * trailing,
                   floor, cap)`` where ``trailing`` is the group's worst
                   span duration over the trace's kept windows (the
                   ``default_deadline_s`` fallback covers a cold trace).

  classification   per involved rank, from observable span state only:

                   | entered | link evidence | role                    |
                   |---------|---------------|--------------------------|
                   | no      | (any)         | culprit — never entered  |
                   | yes     | yes           | culprit — entered+stalled|
                   | yes     | no            | victim — blocked barrier |

                   If SOME ranks never arrived, they are the culprits
                   and every rank that did arrive is a victim. If ALL
                   ranks arrived and the collective still never
                   completed, blame needs independent link evidence
                   (down port, degraded quality, error-counter creep);
                   with none, the verdict carries victims only —
                   detection without attribution beats a false eviction.

The same deadline rule backs ``GuardStepHook``'s per-step liveness path
(``adaptive_deadline`` over the hook's rolling healthy baseline), so the
single-host and fleet-side detectors stay consistent.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.ccltrace.spans import (CollectiveSpanTrace,
                                        PendingCollective)


def adaptive_deadline(trailing_s: float, mult: float,
                      floor_s: float, cap_s: float) -> float:
    """``clamp(mult * trailing, floor, cap)`` — the shared deadline rule
    of the collective watchdog (trailing = group's worst recent span)
    and the step hook's liveness path (trailing = healthy step wall)."""
    return float(min(max(mult * trailing_s, floor_s), cap_s))


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Deadline-rule knobs.

    ``deadline_mult`` trades detection latency against false alarms on a
    legitimately slow collective: 8x the worst recent span is far above
    any fail-slow inflation the detector would tolerate, yet orders of
    magnitude below the framework CCL abort. ``min_history`` windows of
    span history are required before the adaptive rule engages;
    a cold trace falls back to ``default_deadline_s``."""

    deadline_mult: float = 8.0
    deadline_floor_s: float = 30.0
    deadline_cap_s: float = 600.0
    default_deadline_s: float = 120.0
    min_history: int = 2


class HangRole(str, enum.Enum):
    """CCL-D classification of a rank involved in a hung collective."""

    CULPRIT_NEVER_ENTERED = "never_entered"
    CULPRIT_STALLED = "entered_stalled"
    VICTIM = "victim"


CULPRIT_ROLES = (HangRole.CULPRIT_NEVER_ENTERED, HangRole.CULPRIT_STALLED)


@dataclasses.dataclass(frozen=True)
class HangVerdict:
    """One hung group's attribution: who to evict, who to leave alone."""

    t: float                             # verdict time
    step: int                            # step the job hung on
    op: str
    group: int
    waited_s: float                      # pending time at verdict
    deadline_s: float                    # the deadline that tripped
    culprits: Tuple[int, ...]            # node ids to pull from the job
    victims: Tuple[int, ...]             # node ids blocked on the barrier
    roles: Dict[int, HangRole]           # every involved rank

    @property
    def attributed(self) -> bool:
        return bool(self.culprits)


class HangWatchdog:
    """Polls a ``PendingCollective`` snapshot against per-group adaptive
    deadlines and classifies the overdue groups' ranks.

    One verdict per (hang onset, group): re-polling the same stuck
    collective returns nothing new, so callers can poll at window
    cadence without deduplicating downstream."""

    def __init__(self, spans: Optional[CollectiveSpanTrace] = None,
                 cfg: Optional[WatchdogConfig] = None):
        self.spans = spans
        self.cfg = cfg or WatchdogConfig()
        self.verdicts: List[HangVerdict] = []
        self._fired: Set[Tuple[float, int]] = set()

    # ----------------------------------------------------------- deadline

    def group_deadline_s(self, trailing_span_s: Optional[float]) -> float:
        """Deadline for one group given its trailing worst span (None ->
        cold-trace fallback)."""
        cfg = self.cfg
        if trailing_span_s is None:
            return cfg.default_deadline_s
        return adaptive_deadline(trailing_span_s, cfg.deadline_mult,
                                 cfg.deadline_floor_s, cfg.deadline_cap_s)

    def _trailing(self, pend: PendingCollective) -> Optional[np.ndarray]:
        tr = self.spans
        if (tr is None or len(tr) < self.cfg.min_history
                or tr.node_count != len(pend.node_ids)):
            return None
        return tr.trailing_duration()

    # -------------------------------------------------------------- check

    def check(self, pend: Optional[PendingCollective],
              now: float) -> List[HangVerdict]:
        """Classify every overdue, not-yet-fired group of ``pend``."""
        if pend is None:
            return []
        waited = now - pend.t_start
        if waited <= 0:
            return []
        trail = self._trailing(pend)
        out: List[HangVerdict] = []
        for g in np.unique(pend.group_of):
            rows = pend.group_of == g
            if bool(pend.completed[rows].all()):
                continue                 # this group's op finished
            dl = self.group_deadline_s(
                None if trail is None else float(trail[rows].max()))
            if waited < dl:
                continue
            key = (round(pend.t_start, 6), int(g))
            if key in self._fired:
                continue
            self._fired.add(key)
            out.append(self._classify(pend, rows, int(g), now, waited, dl))
        self.verdicts.extend(out)
        return out

    def _classify(self, pend: PendingCollective, rows: np.ndarray,
                  group: int, now: float, waited: float,
                  deadline: float) -> HangVerdict:
        ids = pend.node_ids[rows]
        entered = pend.entered[rows]
        suspect = pend.nic_suspect[rows]
        roles: Dict[int, HangRole] = {}
        if not bool(entered.all()):
            # some ranks never arrived: they are the culprits, everyone
            # who did arrive is blocked on the barrier behind them
            for nid, ent in zip(ids, entered):
                roles[int(nid)] = (HangRole.VICTIM if ent
                                   else HangRole.CULPRIT_NEVER_ENTERED)
        else:
            # all arrived and the op still never completed: accuse only
            # ranks with independent link evidence
            for nid, sus in zip(ids, suspect):
                roles[int(nid)] = (HangRole.CULPRIT_STALLED if sus
                                   else HangRole.VICTIM)
        culprits = tuple(n for n, r in roles.items() if r in CULPRIT_ROLES)
        victims = tuple(n for n, r in roles.items() if r is HangRole.VICTIM)
        return HangVerdict(t=float(now), step=int(pend.step), op=pend.op,
                           group=group, waited_s=float(waited),
                           deadline_s=float(deadline), culprits=culprits,
                           victims=victims, roles=roles)


__all__ = ["CULPRIT_ROLES", "HangRole", "HangVerdict", "HangWatchdog",
           "WatchdogConfig", "adaptive_deadline"]
