"""The Guard control plane behind one facade: ``GuardSession``.

A session owns the whole closed loop of Fig. 1 — detector + tiered
policy (via ``OnlineMonitor``), the pool-owning ``HealthManager``, the
non-blocking ``SweepScheduler`` — and a typed ``EventBus`` every state
transition is published on. Substrates plug in underneath through the
two narrow protocols (``ClusterControl``, ``SweepBackend``); the
simulated fleet implements both, and so does a real control plane.

Construction mirrors the §7 ablation ladder (Table 4)::

    session = GuardSession.from_tier(Tier.ENHANCED, control, backend)
    # or the named builders: .burnin() .node_sweep() .online() .enhanced()

Lifecycle::

    session.register_active(job_nodes); session.register_spares(spares)
    outcome = session.observe(frame)          # one evaluation window
    for reason in outcome.restarts: ...       # job must restart now
    ck = session.on_checkpoint()              # deferred swaps + sweep queue
    session.advance(now)                      # qualification overlaps job
    session.handle_crash(dead_nodes)          # fail-stop batch replacement

The detector runs on ``device`` (default ``"cuda"``; only tests pass
``"cpu"``).

Telemetry: ``session.trace`` is the in-memory event trace;
``session.add_sink(JsonlSink(path))`` streams the same events to disk.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.detector import DetectorConfig
from repro_torch.core.health_manager import (ClusterControl, HealthManager,
                                             ManagerStats, NodeState)
from repro_torch.core.monitor import HealthEvent, OnlineMonitor
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.sweep import (CampaignResult, SweepBackend,
                                    SweepCampaign, SweepConfig,
                                    SweepReference, fleet_qualification)
from repro_torch.core.telemetry import Frame
from repro_torch.core.triage import TriageConfig
from repro_torch.device import DeviceLike
from repro_torch.guard.events import (CampaignFinished, CheckpointSaved,
                                      ControlEvent, CrashDetected,
                                      DiagnosisEvent, EventBus, HangDetected,
                                      NodeProvisioned, NodeQuarantined,
                                      NodeSwapped, NodeTerminated,
                                      StragglerCleared, StragglerFlagged,
                                      TraceSink)
from repro_torch.guard.goodput import MTTFEstimator
from repro_torch.guard.scheduler import SweepScheduler


class Tier(enum.IntEnum):
    """The §7 ablation ladder (Table 4), cumulative."""
    BURNIN = 1        # burn-in admission only; greys handled by humans
    NODE_SWEEP = 2    # + offline single-node sweep tooling
    ONLINE = 3        # + Guard online monitoring and tiered mitigation
    ENHANCED = 4      # + enhanced sweep (multi-node stage, long burns)


@dataclasses.dataclass
class WindowOutcome:
    """What one evaluation window changed."""
    events: List[HealthEvent]         # raw monitor events this window
    flagged: List[int]                # nodes newly decided on
    cleared: List[int]                # nodes whose latch released
    restarts: List[str]               # reasons for immediate restarts
    diagnoses: List = dataclasses.field(default_factory=list)
    # ^ new/changed Diagnosis records this window (Diagnoser tiers only)


@dataclasses.dataclass
class CheckpointOutcome:
    applied_swaps: int                # deferred mitigations landed
    submitted: int                    # nodes newly queued for sweeps


class GuardSession:
    """Facade over the full Guard closed loop for one training job."""

    def __init__(self, control: ClusterControl, sweep_backend: SweepBackend,
                 tier: Tier = Tier.ENHANCED,
                 detector_cfg: Optional[DetectorConfig] = None,
                 policy_cfg: Optional[PolicyConfig] = None,
                 sweep_cfg: Optional[SweepConfig] = None,
                 triage_cfg: Optional[TriageConfig] = None,
                 pending_patience_s: float = 1800.0,
                 sweep_concurrency: int = 2,
                 on_provision: Optional[Callable[[int], None]] = None,
                 bus: Optional[EventBus] = None,
                 diagnoser=None,
                 device: Optional[DeviceLike] = None):
        # ``device`` places the detector's state and scoring; None keeps
        # the detector config's own (default "cuda")
        if device is not None:
            detector_cfg = dataclasses.replace(
                detector_cfg or DetectorConfig(), device=str(device))
        self.tier = Tier(tier)
        self.control = control
        self.bus = bus or EventBus()
        self.trace = TraceSink()
        self.bus.attach(self.trace)

        # optional diagnoser (duck-typed): the attribution stage
        # between detector and policy (victims watched, not evicted;
        # triage signals enriched with root causes)
        self.diagnoser = diagnoser
        self.monitor = OnlineMonitor(detector_cfg, policy_cfg,
                                     diagnoser=diagnoser)
        self.manager = HealthManager(
            control, sweep_backend, self.monitor,
            sweep_cfg=sweep_cfg, triage_cfg=triage_cfg,
            enhanced_sweep=self.tier == Tier.ENHANCED,
            pending_patience_s=pending_patience_s,
            on_provision=on_provision,
            notify=self._on_manager_notify)
        if diagnoser is not None:
            self.manager.hold_check = diagnoser.should_hold
            self.manager.signals_for = diagnoser.signals_for
        self.scheduler = SweepScheduler(self.manager, self.bus,
                                        concurrency=sweep_concurrency)
        self._step = 0
        self._flagged: Set[int] = set()
        # live mean-time-between-job-interrupts: tunes the fast-tier
        # snapshot cadence (Young-Daly) of the tiered checkpoint manager
        self.mttf = MTTFEstimator(t0=control.now())

    # ------------------------------------------------------------ builders

    @classmethod
    def from_tier(cls, tier: Tier, control: ClusterControl,
                  sweep_backend: SweepBackend, **kw) -> "GuardSession":
        """Build the session for one Table-4 ablation tier."""
        return cls(control, sweep_backend, tier=Tier(tier), **kw)

    @classmethod
    def burnin(cls, control, sweep_backend, **kw) -> "GuardSession":
        return cls.from_tier(Tier.BURNIN, control, sweep_backend, **kw)

    @classmethod
    def node_sweep(cls, control, sweep_backend, **kw) -> "GuardSession":
        return cls.from_tier(Tier.NODE_SWEEP, control, sweep_backend, **kw)

    @classmethod
    def online(cls, control, sweep_backend, **kw) -> "GuardSession":
        return cls.from_tier(Tier.ONLINE, control, sweep_backend, **kw)

    @classmethod
    def enhanced(cls, control, sweep_backend, **kw) -> "GuardSession":
        return cls.from_tier(Tier.ENHANCED, control, sweep_backend, **kw)

    # ----------------------------------------------------------- properties

    @property
    def online_monitoring(self) -> bool:
        """Tiers 3-4 run the online detection loop."""
        return self.tier >= Tier.ONLINE

    @property
    def sweep_tooling(self) -> bool:
        """Tiers 2-4 have offline sweep tooling available."""
        return self.tier >= Tier.NODE_SWEEP

    @property
    def stats(self) -> ManagerStats:
        return self.manager.stats

    @property
    def spares_free(self) -> int:
        return self.manager.spare_count

    def spare_ids(self) -> List[int]:
        """Current healthy-spare ids (copy; e.g. sweep-buddy candidates).
        Under a fleet pool this is the shared pool's view, not a private
        list."""
        return self.manager.spare_pool_ids()

    def node_state(self, node_id: int) -> Optional[NodeState]:
        return self.manager.state.get(node_id)

    def events(self) -> List[ControlEvent]:
        return list(self.trace.events)

    def add_sink(self, sink) -> None:
        self.bus.attach(sink)

    def drain_human_hours(self) -> float:
        """Hand the operator-attention accumulated since the last call to
        the caller's accounting (sweeps/triage consume human time)."""
        h = self.manager.stats.human_seconds / 3600.0
        self.manager.stats.human_seconds = 0.0
        return h

    # --------------------------------------------------------- registration

    def register_active(self, node_ids: Sequence[int]) -> None:
        for nid in node_ids:
            self.manager.register(int(nid), NodeState.ACTIVE)

    def register_spares(self, node_ids: Sequence[int]) -> None:
        for nid in node_ids:
            self.manager.register(int(nid), NodeState.HEALTHY_SPARE)

    # ----------------------------------------------------------- the loop

    def observe(self, frame: Frame) -> WindowOutcome:
        """Feed one telemetry window through detector → policy → manager.

        Publishes StragglerFlagged / StragglerCleared events and reports
        any immediate restarts the tiered policy demanded (the caller owns
        job-time accounting for those)."""
        self._step = frame.step
        out = WindowOutcome([], [], [], [])
        if not self.online_monitoring:
            return out
        events = self.monitor.observe(frame)
        diag = self.monitor.last_diagnosis
        if diag is not None:
            # attribution verdicts first: the flag/mitigation events that
            # follow are explained by them
            for rec in diag.new_records:
                out.diagnoses.append(rec)
                self.bus.publish(DiagnosisEvent(
                    t=frame.t, step=frame.step, node_id=rec.node_id,
                    root_cause=rec.root_cause.value, blame=rec.blame,
                    blame_rel=rec.blame_rel, marginal=rec.marginal,
                    stall_share=rec.stall_share, held=rec.held,
                    evidence=rec.evidence))
        for ev in events:
            out.events.append(ev)
            out.flagged.append(ev.decision.node_id)
            self._flagged.add(ev.decision.node_id)
            self.bus.publish(StragglerFlagged(
                t=frame.t, step=frame.step, node_id=ev.decision.node_id,
                action=ev.decision.action.value, reason=ev.decision.reason,
                slowdown=ev.decision.slowdown))
            pre = self.manager.stats.immediate_restarts
            self.manager.handle(ev)
            if self.manager.stats.immediate_restarts > pre:
                out.restarts.append(ev.decision.reason)
                self.mttf.observe_failure(frame.t)
        # hysteresis released: report clears for nodes still in the job
        # (one vectorized latch query instead of a fleet scan per id)
        if self._flagged:
            ids = sorted(self._flagged)
            still = self.monitor.detector.latched_many(
                np.asarray(ids, dtype=np.int64))
            for nid, latched in zip(ids, still):
                if latched:
                    continue
                self._flagged.discard(nid)
                if self.manager.state.get(nid) in (NodeState.ACTIVE,
                                                   NodeState.PENDING):
                    out.cleared.append(nid)
                    self.bus.publish(StragglerCleared(
                        t=frame.t, step=frame.step, node_id=nid))
        self.advance(frame.t)
        return out

    def on_checkpoint(self, now: Optional[float] = None,
                      step: Optional[int] = None) -> CheckpointOutcome:
        """Checkpoint boundary: land deferred mitigations (online tiers),
        queue quarantined nodes for offline qualification, and let the
        sweep bench make progress."""
        t = self.control.now() if now is None else now
        self._note_step(step)
        applied = self.manager.on_checkpoint() if self.online_monitoring \
            else 0
        self.bus.publish(CheckpointSaved(t=t, step=self._step,
                                         applied_swaps=applied))
        submitted = 0
        if self.sweep_tooling:
            submitted = self.scheduler.submit_quarantined(now=t)
        self.advance(t)
        return CheckpointOutcome(applied, submitted)

    def advance(self, now: float, step: Optional[int] = None) -> None:
        """Clock input: overlapped offline qualification catches up to
        job time ``now`` (starts queued sweeps, lands finished ones).
        Pass the global training ``step`` when known so published events
        carry it even in tiers without online monitoring."""
        self._note_step(step)
        if self.sweep_tooling:
            self.scheduler.advance(now, step=self._step)

    def handle_crash(self, dead: Sequence[int], lost_steps: int = 0,
                     step: Optional[int] = None) -> List[int]:
        """Fail-stop batch replacement: every dead node is swapped for a
        healthy spare in the same restart; the hardware leaves with the
        node. Returns the replacement ids."""
        now = self.control.now()
        self._note_step(step)
        self.mttf.observe_failure(now)
        self.bus.publish(CrashDetected(t=now, step=self._step,
                                       nodes=tuple(int(n) for n in dead),
                                       lost_steps=lost_steps))
        new_ids: List[int] = []
        for bad in dead:
            bad = int(bad)
            spare = self.manager.take_spare(kind="crash")
            self.control.swap_node(bad, spare)
            self.manager.retire(bad, reason="fail-stop crash", crashed=True)
            self.monitor.node_replaced(bad)
            self.bus.publish(NodeSwapped(t=now, step=self._step, old=bad,
                                         new=spare,
                                         reason="fail-stop crash"))
            new_ids.append(spare)
        return new_ids

    def handle_hang(self, verdict, step: Optional[int] = None,
                    latency_windows: float = 0.0) -> List[int]:
        """Route one ccltrace watchdog ``HangVerdict`` through the loop:
        publish the ``HangDetected`` event, record culprit/victim
        diagnoses (triage lanes + the manager's hold-check), and evict
        the culprit ranks' nodes — victims are watched, never evicted.
        A verdict with no culprits only records/publishes: the caller
        restarts the job blind. Returns the replacement node ids."""
        now = self.control.now()
        self._note_step(step)
        roles = tuple(sorted((int(n), getattr(r, "value", str(r)))
                             for n, r in verdict.roles.items()))
        self.bus.publish(HangDetected(
            t=now, step=self._step, group=int(verdict.group),
            op=verdict.op,
            culprits=tuple(int(c) for c in verdict.culprits),
            victims=tuple(int(v) for v in verdict.victims),
            roles=roles, waited_s=float(verdict.waited_s),
            deadline_s=float(verdict.deadline_s),
            latency_windows=float(latency_windows)))
        if self.diagnoser is not None:
            self.diagnoser.record_hang(verdict, t=now, step=self._step)
        self.mttf.observe_failure(now)
        new_ids: List[int] = []
        role_of = dict(roles)
        for bad in verdict.culprits:
            bad = int(bad)
            if self.manager.state.get(bad) in (NodeState.ACTIVE,
                                               NodeState.PENDING):
                new_ids.append(self.replace_node(
                    bad,
                    reason=f"hang culprit ({role_of.get(bad, 'culprit')})",
                    step=self._step, kind="hang"))
        return new_ids

    def replace_node(self, bad: int, reason: str,
                     quarantine: bool = True,
                     step: Optional[int] = None,
                     kind: str = "swap") -> int:
        """Pull ``bad`` out of the job for a healthy spare (manual-hunt /
        operator path). ``quarantine=True`` routes it to the offline
        qualification queue; ``False`` retires it outright (no tooling to
        verify with — the burn-in-only tier). ``kind`` is the lease
        urgency a fleet pool arbitrates on ("swap" | "crash" | "hang")."""
        now = self.control.now()
        self._note_step(step)
        spare = self.manager.take_spare(kind=kind)
        self.control.swap_node(bad, spare)
        self.monitor.node_replaced(bad)
        self.bus.publish(NodeSwapped(t=now, step=self._step, old=bad,
                                     new=spare, reason=reason))
        if quarantine and self.sweep_tooling:
            self.manager.state[bad] = NodeState.QUARANTINED
            self.bus.publish(NodeQuarantined(t=now, step=self._step,
                                             node_id=bad, reason=reason))
            self.scheduler.submit(bad, now=now)
        else:
            self.manager.retire(bad, reason=reason)
        return spare

    def prequalify_fleet(self, node_ids: Optional[Sequence[int]] = None,
                         reference_pool: Optional[Sequence[int]] = None,
                         enhanced: Optional[bool] = None,
                         reference: Optional[SweepReference] = None,
                         replace: bool = True,
                         step: Optional[int] = None) -> CampaignResult:
        """Offline fleet-qualification phase (§5 at fleet scale): sweep
        every candidate node in one batched campaign BEFORE it serves
        the job, so early-run failures are caught on the bench, not in
        the first thousand steps.

        Defaults: all ACTIVE nodes are candidates and the current
        healthy spares form the known-good reference pool for the
        multi-node buddy stage (round-robin — suspects are never each
        other's buddies). ``reference=None`` auto-calibrates the
        SweepReference from fleet medians. Nodes that fail are pulled:
        active failures are swapped for spares (``replace=True``) and
        every failure is quarantined and routed into the event-driven
        per-node sweep→triage loop. Publishes one ``CampaignFinished``
        summary event (plus the usual swap/quarantine events per
        failing node)."""
        if not self.sweep_tooling:
            raise RuntimeError(
                "fleet qualification needs sweep tooling "
                "(tier >= NODE_SWEEP)")
        self._note_step(step)
        now = self.control.now()
        if node_ids is None:
            node_ids = sorted(n for n, st in self.manager.state.items()
                              if st == NodeState.ACTIVE)
        if reference_pool is None:
            reference_pool = tuple(self.manager.spare_pool_ids())
        campaign = SweepCampaign(
            node_ids=tuple(int(n) for n in node_ids),
            reference_pool=tuple(int(n) for n in reference_pool),
            enhanced=(self.tier == Tier.ENHANCED) if enhanced is None
            else enhanced,
            reference=reference)
        res = fleet_qualification(self.manager.backend, campaign,
                                  self.manager.sweep_cfg)
        self.manager.stats.sweeps_run += res.sweeps
        self.manager.stats.sweeps_failed += len(res.failed)
        for rep in res.reports:
            if rep.passed:
                continue
            nid = rep.node_id
            if replace and self.manager.state.get(nid) == NodeState.ACTIVE:
                self.replace_node(nid, reason="fleet prequalification",
                                  step=self._step)
            else:
                self.manager.state[nid] = NodeState.QUARANTINED
                self.manager.spares = [s for s in self.manager.spares
                                       if s != nid]
                self.bus.publish(NodeQuarantined(
                    t=now, step=self._step, node_id=nid,
                    reason="fleet prequalification"))
                self.scheduler.submit(nid, now=now)
        self.bus.publish(CampaignFinished(
            t=now, step=self._step, nodes=len(res.reports),
            passed=len(res.passed), failed=tuple(res.failed),
            calibrated=res.calibrated, node_seconds=res.node_seconds,
            wall_s=res.wall_s))
        return res

    def take_spare(self, kind: str = "swap") -> int:
        return self.manager.take_spare(kind=kind)

    def return_spare(self, node_id: int) -> None:
        self.manager.return_spare(node_id)

    def top_up_spares(self, target: int) -> int:
        """Background warm-pool maintenance: provision (and admit) new
        nodes until ``target`` healthy spares are available."""
        n = 0
        while self.manager.spare_count < target:
            self.manager.provision_spare()
            n += 1
        return n

    def publish(self, ev: ControlEvent) -> ControlEvent:
        return self.bus.publish(ev)

    # ----------------------------------------------------------- internals

    def _note_step(self, step: Optional[int]) -> None:
        if step is not None:
            self._step = step

    def _on_manager_notify(self, topic: str, payload: dict) -> None:
        """Translate manager-level notifications into typed events."""
        t = self.control.now()
        if topic == "swap":
            self.bus.publish(NodeSwapped(
                t=t, step=self._step, old=payload["old"],
                new=payload["new"], reason=payload.get("reason", ""),
                deferred=payload.get("deferred", False)))
            self.bus.publish(NodeQuarantined(
                t=t, step=self._step, node_id=payload["old"],
                reason=payload.get("reason", "")))
            if self.sweep_tooling:      # event-driven qualification (§5)
                self.scheduler.submit(payload["old"], now=t)
        elif topic == "provision":
            self.bus.publish(NodeProvisioned(
                t=t, step=self._step, node_id=payload["node_id"]))
        elif topic == "terminate":
            self.bus.publish(NodeTerminated(
                t=t, step=self._step, node_id=payload["node_id"],
                reason=payload.get("reason", "")))


__all__ = ["CheckpointOutcome", "GuardSession", "Tier", "WindowOutcome"]
