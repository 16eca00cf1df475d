# guardlint: disable-file=GL004 reason=this module mirrors the taxonomy of
# repro.guard.events class for class and kind for kind, so that both
# packages write the same JSONL; GL004 selects event classes by class name
# and reads every mirrored kind as a collision. tests/test_torch_session.py
# pins names, kinds, fields and the JSONL stream against the reference.
"""Typed Guard control-plane events and the central event bus.

Every state transition in the closed loop (Fig. 1) — online detection
verdicts, mitigations, crashes, offline qualification progress,
checkpoint boundaries — is published as one ``ControlEvent`` subclass on
a ``GuardSession``'s ``EventBus``. Consumers attach *sinks* (an in-memory
trace, a JSONL file for durable audit logs) or *subscribe* to specific
event types with callbacks.

The taxonomy is the JAX package's, class for class and ``kind`` for
``kind``, so the two packages write identical JSONL streams (the session
parity test pins this). The base class is named ``ControlEvent``, not
``GuardEvent``, so that the linter's GL004 does not take the port's base
for the reference's. GL004 still selects the mirrored subclasses by name
and would read each ``kind`` as a collision, so the pragma above turns it
off for this file.

Events are frozen dataclasses: a ``kind`` string (stable wire name), the
session time ``t`` and global training ``step`` they occurred at, plus
typed payload fields. ``to_dict`` gives the flat JSON form used by the
JSONL sink.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, ClassVar, Dict, IO, List, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """Base class: when (session seconds / global step) something happened."""
    kind: ClassVar[str] = "event"
    t: float
    step: int

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


# --------------------------------------------------------------- detection

@dataclasses.dataclass(frozen=True)
class StragglerFlagged(ControlEvent):
    """Online detector latched a node; ``action`` is the policy tier."""
    kind: ClassVar[str] = "straggler_flagged"
    node_id: int = -1
    action: str = ""
    reason: str = ""
    slowdown: float = 0.0


@dataclasses.dataclass(frozen=True)
class StragglerCleared(ControlEvent):
    """A previously flagged node unlatched (hysteresis windows elapsed)."""
    kind: ClassVar[str] = "straggler_cleared"
    node_id: int = -1


@dataclasses.dataclass(frozen=True)
class DiagnosisEvent(ControlEvent):
    """Blame attribution reached a (new) verdict for a flagged node:
    ``root_cause`` is the attribution taxonomy value, ``blame``
    the standalone what-if excess in seconds (``blame_rel`` relative to
    the healthy reference), ``marginal`` the leave-one-out fleet
    step-time delta, and ``held`` whether the verdict keeps the node in
    the job (cascade victims / transients are watched, not evicted)."""
    kind: ClassVar[str] = "diagnosis"
    node_id: int = -1
    root_cause: str = ""
    blame: float = 0.0
    blame_rel: float = 0.0
    marginal: float = 0.0
    stall_share: float = 0.0
    held: bool = False
    evidence: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class HangDetected(ControlEvent):
    """A blocking collective exceeded its adaptive barrier deadline:
    some ranks of ``group`` are stuck in (or never reached) ``op``.
    ``culprits`` are the ranks the ccltrace watchdog accuses (never
    entered, or entered with independent link evidence), ``victims``
    the ranks that arrived and blocked on the barrier; ``roles`` maps
    each involved rank to its CCL-D classification (``never_entered`` /
    ``entered_stalled`` / ``victim``). ``waited_s`` is how long the
    collective had been pending when ``deadline_s`` tripped, and
    ``latency_windows`` the detection latency in evaluation windows
    from hang onset to verdict. An empty ``culprits`` is a detection
    without attribution (all ranks arrived, no link evidence) — the
    job restarts but nobody is evicted."""
    kind: ClassVar[str] = "hang"
    group: int = -1
    op: str = ""
    culprits: Tuple[int, ...] = ()
    victims: Tuple[int, ...] = ()
    roles: Tuple[Tuple[int, str], ...] = ()
    waited_s: float = 0.0
    deadline_s: float = 0.0
    latency_windows: float = 0.0


# -------------------------------------------------------------- mitigation

@dataclasses.dataclass(frozen=True)
class NodeSwapped(ControlEvent):
    """``old`` left the job, ``new`` (a healthy spare) took its place."""
    kind: ClassVar[str] = "swap"
    old: int = -1
    new: int = -1
    reason: str = ""
    deferred: bool = False


@dataclasses.dataclass(frozen=True)
class NodeQuarantined(ControlEvent):
    kind: ClassVar[str] = "quarantine"
    node_id: int = -1
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class NodeTerminated(ControlEvent):
    kind: ClassVar[str] = "terminate"
    node_id: int = -1
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class NodeProvisioned(ControlEvent):
    """A brand-new node entered the spare pool (after admission checks)."""
    kind: ClassVar[str] = "provision"
    node_id: int = -1


@dataclasses.dataclass(frozen=True)
class CrashDetected(ControlEvent):
    """Fail-stop hardware failure interrupted the job."""
    kind: ClassVar[str] = "crash"
    nodes: Tuple[int, ...] = ()
    lost_steps: int = 0


@dataclasses.dataclass(frozen=True)
class JobRestart(ControlEvent):
    """The job restarted; ``lost_steps`` is the rewind to last checkpoint."""
    kind: ClassVar[str] = "restart"
    reason: str = ""
    lost_steps: int = 0
    rewind: bool = True


@dataclasses.dataclass(frozen=True)
class CheckpointSaved(ControlEvent):
    """Checkpoint boundary; ``applied_swaps`` deferred mitigations landed."""
    kind: ClassVar[str] = "checkpoint"
    applied_swaps: int = 0


@dataclasses.dataclass(frozen=True)
class RecoveryEvent(ControlEvent):
    """One completed recovery incident, decomposed into MTTR phases:
    ``detect_s`` (failure start → detection), ``drain_s`` (triage /
    replacement / provisioning before the restore can begin),
    ``restore_s`` (loading state from ``ckpt_tier``: peer / local /
    cold), ``warmup_s`` (re-shard, compile, rejoin collectives).
    ``hot_spare`` marks a promotion that resumed from a DP peer's
    in-memory replica; ``replay_steps`` is the unique progress lost to
    the rewind (the goodput penalty)."""
    kind: ClassVar[str] = "recovery"
    reason: str = ""
    ckpt_tier: str = "cold"
    hot_spare: bool = False
    detect_s: float = 0.0
    drain_s: float = 0.0
    restore_s: float = 0.0
    warmup_s: float = 0.0
    replay_steps: int = 0


# ----------------------------------------------------- offline qualification

@dataclasses.dataclass(frozen=True)
class SweepStarted(ControlEvent):
    """Offline qualification of a quarantined node began."""
    kind: ClassVar[str] = "sweep_start"
    node_id: int = -1
    enhanced: bool = False


@dataclasses.dataclass(frozen=True)
class SweepFinished(ControlEvent):
    """Offline qualification concluded; ``outcome`` is the NodeState value."""
    kind: ClassVar[str] = "sweep_finish"
    node_id: int = -1
    outcome: str = ""
    duration_s: float = 0.0
    sweeps: int = 0
    failures: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class TriageStage(ControlEvent):
    """One remediation workflow ran during qualification (§6 FSM)."""
    kind: ClassVar[str] = "triage"
    node_id: int = -1
    stages: Tuple[str, ...] = ()
    outcome: str = ""
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class CampaignFinished(ControlEvent):
    """A fleet-qualification campaign concluded (§5 at fleet scale):
    every candidate node was swept in one batched pass. ``failed`` lists
    the nodes routed into per-node quarantine/triage, ``node_seconds``
    the summed bench occupancy the campaign represents, ``wall_s`` the
    real compute wall of the batched pass, and ``calibrated`` whether
    the SweepReference was auto-derived from fleet medians."""
    kind: ClassVar[str] = "campaign_finish"
    nodes: int = 0
    passed: int = 0
    failed: Tuple[int, ...] = ()
    calibrated: bool = False
    node_seconds: float = 0.0
    wall_s: float = 0.0


EVENT_TYPES: Tuple[Type[ControlEvent], ...] = (
    StragglerFlagged, StragglerCleared, DiagnosisEvent, HangDetected,
    NodeSwapped, NodeQuarantined, NodeTerminated, NodeProvisioned,
    CrashDetected, JobRestart, CheckpointSaved, RecoveryEvent, SweepStarted,
    SweepFinished, TriageStage, CampaignFinished,
)


# ------------------------------------------------------------------- sinks

class TraceSink:
    """In-memory event trace (the default sink on every session)."""

    def __init__(self):
        self.events: List[ControlEvent] = []

    def emit(self, ev: ControlEvent) -> None:
        self.events.append(ev)

    def of_kind(self, kind: str) -> List[ControlEvent]:
        return [e for e in self.events if e.kind == kind]

    def as_dicts(self) -> List[Dict[str, object]]:
        return [e.to_dict() for e in self.events]

    def clear(self) -> None:
        self.events.clear()

    def __len__(self) -> int:
        return len(self.events)


class JsonlSink:
    """Durable audit log: one JSON object per event, append-only."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[IO[str]] = open(path, "a")

    def emit(self, ev: ControlEvent) -> None:
        if self._fh is None:
            raise ValueError(f"JsonlSink({self.path}) is closed")
        json.dump(ev.to_dict(), self._fh)
        self._fh.write("\n")
        # an audit log must survive the process dying mid-incident — the
        # exact scenario it exists to explain
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class EventBus:
    """Central publish/subscribe fan-out for ControlEvents.

    Sinks receive every event; subscribers receive only the event types
    (including subclasses) they registered for. Publication order is
    sinks first, then subscribers, both in attach order.
    """

    def __init__(self):
        self._sinks: List[object] = []
        self._subs: List[Tuple[Type[ControlEvent],
                               Callable[[ControlEvent], None]]] = []

    def attach(self, sink) -> None:
        """Attach a sink (anything with ``emit(event)``)."""
        self._sinks.append(sink)

    def detach(self, sink) -> None:
        self._sinks.remove(sink)

    def subscribe(self, event_type: Type[ControlEvent],
                  fn: Callable[[ControlEvent], None]) -> None:
        self._subs.append((event_type, fn))

    def publish(self, ev: ControlEvent) -> ControlEvent:
        for sink in self._sinks:
            sink.emit(ev)
        for typ, fn in self._subs:
            if isinstance(ev, typ):
                fn(ev)
        return ev
