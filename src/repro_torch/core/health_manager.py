"""Closed-loop node health management (Fig. 1).

Glues the pieces together: online monitoring emits HealthEvents; the manager
applies the tiered policy's action against the cluster (swap now / swap at
checkpoint / watch), quarantines suspects, drives the event-driven offline
qualification (sweep -> triage -> sweep ...) and returns qualified nodes to
the healthy pool. All substrate access goes through ``ClusterControl`` so
the loop is identical over the simulator and a real fleet control plane.

The manager is the **single source of truth for node pools**: callers take
replacement capacity through ``take_spare`` and hand recovered nodes back
through ``return_spare`` — nothing above this layer keeps its own spare
list. Offline qualification is split into ``begin_qualification`` (runs the
sweep→triage loop and returns a ticket with the outcome and its simulated
duration) and ``complete_qualification`` (applies the outcome to the
pools), so a scheduler can overlap qualification with the running job
instead of blocking on it; ``qualify`` composes the two for the
synchronous path.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from repro_torch.core.monitor import HealthEvent, OnlineMonitor
from repro_torch.core.policy import Action
from repro_torch.core.sweep import (SweepBackend, SweepConfig, SweepReport,
                                    multi_node_sweep, single_node_sweep)
from repro_torch.core.triage import (ErrorSignals, TriageConfig, TriageOutcome,
                                     TriageResult, TriageWorkflow)


class NodeState(enum.Enum):
    ACTIVE = "active"              # serving the training job
    PENDING = "pending"            # in job, flagged pending-verification
    QUARANTINED = "quarantined"    # out of job, awaiting qualification
    HEALTHY_SPARE = "healthy_spare"
    TERMINATED = "terminated"


class ClusterControl(Protocol):
    """Fleet actions the manager can take."""

    def swap_node(self, old: int, new: int) -> None:
        """Replace ``old`` with ``new`` in the job (at a restart boundary)."""
        ...

    def restart_job(self, reason: str) -> None:
        """Restart from the last checkpoint (costs recovery time)."""
        ...

    def provision_node(self) -> int:
        """Bring a brand-new node into the spare pool; returns its id."""
        ...

    def error_signals(self, node_id: int) -> ErrorSignals: ...

    def remediate(self, node_id: int, stage: str) -> None: ...

    def now(self) -> float: ...


@dataclasses.dataclass
class ManagerStats:
    immediate_restarts: int = 0
    deferred_swaps: int = 0
    sweeps_run: int = 0
    sweeps_failed: int = 0
    triages_run: int = 0
    nodes_terminated: int = 0     # pulled by Guard (triage / 3-strikes)
    nodes_lost: int = 0           # died fail-stop (hardware left with them)
    nodes_requalified: int = 0
    nodes_provisioned: int = 0
    human_seconds: float = 0.0
    downtime_seconds: float = 0.0


@dataclasses.dataclass
class QualificationTicket:
    """Outcome of one offline qualification, not yet applied to the pools.

    ``duration_s`` is the node-down time the sweep→triage loop consumed —
    a scheduler uses it to decide *when* (in job time) the outcome lands.
    ``records`` interleaves the sweep reports and triage results in the
    order they ran, for event emission and audit. ``buddy_exhausted``
    marks a qualification that could not disambiguate the node from a
    (possibly contaminated) buddy for lack of a DISJOINT second buddy —
    the outcome is then ``QUARANTINED`` (parked until buddy capacity
    exists), never a silent pass."""
    node_id: int
    outcome: NodeState
    duration_s: float
    sweeps: int
    records: List[Tuple[str, object]]
    applied: bool = False
    buddy_exhausted: bool = False


# Manager-level notification callback: (topic, payload). Kept as a plain
# callable so ``repro_torch.core`` stays free of any event-bus dependency;
# the ``repro_torch.guard`` session translates these into typed GuardEvents.
Notify = Callable[[str, Dict[str, object]], None]


class SparePool(Protocol):
    """Fleet-level replacement-capacity provider (lease/grant protocol).

    When attached (``HealthManager.attach_pool``) the manager stops
    keeping a private ``spares`` list: replacement capacity is leased
    from a shared pool that multiplexes many concurrent jobs (see
    a fleet controller), and requalified nodes are granted
    back to it. ``kind`` is the urgency class of the lease — plain
    strings here so ``repro_torch.core`` stays dependency-free: ``"swap"``
    (straggler eviction), ``"crash"`` (fail-stop replacement),
    ``"hang"`` (hang-culprit eviction, the most urgent)."""

    def take(self, kind: str = "swap") -> int:
        """Lease one healthy node (may provision; always returns)."""
        ...

    def give(self, node_id: int) -> None:
        """Return a healthy node to the shared pool (lease closed)."""
        ...

    def count(self) -> int:
        """Healthy nodes available for lease right now."""
        ...

    def buddies(self, n: int, skip: int = 0) -> List[int]:
        """Known-good sweep-buddy candidates co-located with this job
        (free pool nodes this job's sweep bench can physically pair
        with), skipping the first ``skip``."""
        ...


class HealthManager:
    def __init__(self, control: ClusterControl, sweep_backend: SweepBackend,
                 monitor: OnlineMonitor,
                 sweep_cfg: Optional[SweepConfig] = None,
                 triage_cfg: Optional[TriageConfig] = None,
                 enhanced_sweep: bool = True,
                 max_qualification_rounds: int = 3,
                 pending_patience_s: float = 1800.0,
                 on_provision: Optional[Callable[[int], None]] = None,
                 notify: Optional[Notify] = None):
        self.control = control
        self.backend = sweep_backend
        self.monitor = monitor
        self.sweep_cfg = sweep_cfg or SweepConfig()
        self.triage = TriageWorkflow(triage_cfg)
        self.enhanced_sweep = enhanced_sweep
        self.max_rounds = max_qualification_rounds
        self.pending_patience_s = pending_patience_s
        self.on_provision = on_provision
        # multi-subscriber notification list: the session hook AND a
        # fleet controller can both observe pool transitions without
        # clobbering each other (``add_listener``); the constructor arg
        # registers the first subscriber
        self._listeners: List[Notify] = []
        if notify is not None:
            self._listeners.append(notify)
        # optional fleet-level spare provider (lease/grant): when set,
        # the private ``spares`` list stays empty and every take/return
        # goes through the shared pool
        self.pool: Optional[SparePool] = None
        self.state: Dict[int, NodeState] = {}
        self.spares: List[int] = []
        self.deferred: List[int] = []     # swap at next checkpoint
        self.pending_since: Dict[int, float] = {}
        self.stats = ManagerStats()
        # optional attribution hooks (wired by GuardSession when a
        # diagnoser runs):
        #   hold_check(nid) -> True  = the latest diagnosis says the node
        #   is a victim/transient — keep it in the job, do not evict
        self.hold_check: Optional[Callable[[int], bool]] = None
        #   signals_for(nid) -> rich ErrorSignals from attribution (or
        #   None); merged over the substrate's error counters for triage
        self.signals_for: \
            Optional[Callable[[int], Optional[ErrorSignals]]] = None

    def _notify(self, topic: str, **payload) -> None:
        for fn in self._listeners:
            fn(topic, dict(payload))     # each listener gets its own copy

    def add_listener(self, fn: Notify) -> None:
        """Subscribe one more (topic, payload) observer of pool
        transitions; listeners are invoked in attach order."""
        self._listeners.append(fn)

    # --------------------------------------------------------- pools

    def attach_pool(self, pool: SparePool) -> None:
        """Switch replacement capacity to a fleet-level shared pool
        (lease/grant). Caller (the fleet controller) is responsible for
        adopting any privately-held spares first — see
        ``release_private_spares``."""
        self.pool = pool

    def release_private_spares(self) -> List[int]:
        """Hand every privately-held healthy spare to the caller (the
        fleet controller adopts them into the global pool); they leave
        this manager's census entirely."""
        out = list(self.spares)
        self.spares.clear()
        for nid in out:
            self.state.pop(nid, None)
        return out

    def register(self, node_id: int, state: NodeState) -> None:
        self.state[node_id] = state
        if state == NodeState.HEALTHY_SPARE and node_id not in self.spares:
            self.spares.append(node_id)

    @property
    def spare_count(self) -> int:
        """Healthy spares available right now (public pool query)."""
        if self.pool is not None:
            return self.pool.count()
        return len(self.spares)

    def provision_spare(self) -> int:
        """Bring one brand-new node through admission into the spare pool."""
        nid = self.deliver_node()
        if self.pool is not None:
            self.pool.give(nid)          # lands in the shared pool
        else:
            self.register(nid, NodeState.HEALTHY_SPARE)
        return nid

    def deliver_node(self) -> int:
        """Provision one node through the control plane + admission and
        hand it straight to the caller (no pool membership) — the fleet
        controller's materialization path for lease grants."""
        nid = self.control.provision_node()
        self.stats.nodes_provisioned += 1
        if self.on_provision is not None:
            self.on_provision(nid)       # tier-dependent admission check
        self._notify("provision", node_id=nid)
        return nid

    def take_spare(self, kind: str = "swap") -> int:
        """Remove one healthy spare from the pool and mark it ACTIVE.

        Provisions fresh capacity through the control plane if the pool is
        dry. The returned node is in exactly one place afterwards: the job.
        ``kind`` is the lease urgency class when a fleet-level pool is
        attached (``"swap"`` / ``"crash"`` / ``"hang"``)."""
        if self.pool is not None:
            nid = self.pool.take(kind)
        else:
            while not self.spares:
                self.provision_spare()
            nid = self.spares.pop(0)
        self.state[nid] = NodeState.ACTIVE
        return nid

    def return_spare(self, node_id: int) -> None:
        """Hand a healthy node back to the spare pool."""
        if self.pool is not None:
            # the node leaves this job's census: the shared pool owns it
            self.state.pop(node_id, None)
            self.pool.give(node_id)
            return
        self.state[node_id] = NodeState.HEALTHY_SPARE
        if node_id not in self.spares:
            self.spares.append(node_id)

    def spare_pool_ids(self) -> List[int]:
        """Healthy-spare ids visible to this job (buddy candidates):
        the private list, or the co-located slice of the shared pool."""
        if self.pool is not None:
            return self.pool.buddies(len(self.state) + 8)
        return list(self.spares)

    def quarantined(self) -> List[int]:
        """Node ids currently awaiting offline qualification."""
        return sorted(n for n, s in self.state.items()
                      if s == NodeState.QUARANTINED)

    def retire(self, node_id: int, reason: str = "",
               crashed: bool = False) -> None:
        """Terminate a node (leaves the fleet; replacement hw arrives via
        provisioning). ``crashed`` keeps fail-stop deaths out of the
        Guard-driven ``nodes_terminated`` count."""
        self.state[node_id] = NodeState.TERMINATED
        self.spares = [s for s in self.spares if s != node_id]
        if crashed:
            self.stats.nodes_lost += 1
        else:
            self.stats.nodes_terminated += 1
        self._notify("terminate", node_id=node_id, reason=reason)

    # --------------------------------------------------- event handling

    def handle(self, ev: HealthEvent) -> None:
        nid = ev.decision.node_id
        st = self.state.get(nid)
        if st not in (NodeState.ACTIVE, NodeState.PENDING):
            return                       # already out of the job
        act = ev.decision.action
        if act == Action.PENDING_VERIFICATION:
            self.state[nid] = NodeState.PENDING
            self.pending_since.setdefault(nid, self.control.now())
        elif act == Action.DEFER_TO_CHECKPOINT:
            if nid not in self.deferred:
                self.deferred.append(nid)
                self.stats.deferred_swaps += 1
        elif act == Action.IMMEDIATE_RESTART:
            self.deferred = [d for d in self.deferred if d != nid]
            self._swap_out(nid, reason=ev.decision.reason)
            self.control.restart_job(ev.decision.reason)
            self.stats.immediate_restarts += 1

    def on_checkpoint(self) -> int:
        """Apply deferred mitigations at a checkpoint boundary. Nodes that
        stayed flagged at the pending tier past the patience window are
        pulled for offline verification too (§4.2: a flagged node leaves
        the healthy pool and is scheduled for verification)."""
        now = self.control.now()
        for nid, since in list(self.pending_since.items()):
            still_pending = self.state.get(nid) == NodeState.PENDING
            if not still_pending or nid not in self.monitor.pending:
                self.pending_since.pop(nid, None)
                if still_pending:
                    self.state[nid] = NodeState.ACTIVE   # cleared itself
                continue
            if now - since >= self.pending_patience_s and \
                    nid not in self.deferred:
                # attribution hold: a cascade victim stays latched as
                # long as its culprit is in the job — patience must not
                # convert "watched" into an eviction
                if self.hold_check is not None and self.hold_check(nid):
                    continue
                self.deferred.append(nid)
                self.stats.deferred_swaps += 1
        n = 0
        for nid in self.deferred:
            if self.state.get(nid) not in (NodeState.ACTIVE,
                                           NodeState.PENDING):
                continue
            # §4.2: deferral exists to CONFIRM the diagnosis — only nodes
            # still latched by the detector are swapped; transients that
            # cleared themselves stay in the job
            if not self.monitor.detector.is_latched(nid):
                continue
            # attribution may have re-classified the node as a victim /
            # transient since the deferral was queued: hold it
            if self.hold_check is not None and self.hold_check(nid):
                continue
            self._swap_out(nid, reason="deferred replacement", deferred=True)
            self.pending_since.pop(nid, None)
            n += 1
        self.deferred.clear()
        if n:
            self.control.restart_job(f"{n} deferred replacement(s)")
        return n

    def _swap_out(self, nid: int, reason: str = "",
                  deferred: bool = False) -> int:
        new = self.take_spare()
        self.control.swap_node(nid, new)
        self.state[nid] = NodeState.QUARANTINED
        self.monitor.node_replaced(nid)
        self._notify("swap", old=nid, new=new, reason=reason,
                     deferred=deferred)
        return new

    # ------------------------------------------------- qualification

    def _error_signals(self, node_id: int) -> ErrorSignals:
        """Triage evidence: the substrate's error counters, enriched by
        the latest blame-attribution diagnosis when a Diagnoser runs
        (the diagnosis picks the lane; counters fill in what it missed).

        A stale cascade-victim verdict loses to actionable counters: the
        diagnosis was made while the node sat behind a degraded peer,
        but the substrate now reports real errors — honoring the old
        verdict would short-circuit triage (no strike, no stages) and
        leave a remediable fault untreated."""
        sig = self.control.error_signals(node_id)
        if self.signals_for is not None:
            diag = self.signals_for(node_id)
            if diag is not None and not (
                    diag.root_cause == "cascade_victim" and sig.actionable):
                sig = diag.merged(sig)
        return sig

    def begin_qualification(self, node_id: int) -> QualificationTicket:
        """Run the event-driven offline qualification of a quarantined
        node — sweep; on failure triage; loop until requalified or
        terminated — and return the outcome WITHOUT applying it to the
        pools. The node stays QUARANTINED until
        ``complete_qualification`` lands the ticket, which lets a
        scheduler overlap the sweep's ``duration_s`` with the job.

        The 2-node stage needs a known-good buddy: a failure is re-tried
        against a DISJOINT second buddy before it counts (disambiguates
        a contaminated buddy from a genuinely bad node). When there is
        no buddy at all, or no disjoint retry buddy after a group
        failure, the node is parked with ``buddy_exhausted`` set and a
        QUARANTINED outcome — it is neither passed unverified nor
        condemned on one ambiguous measurement."""
        nb = max(self.sweep_cfg.group_size - 1, 1)
        duration = 0.0
        sweeps = 0
        records: List[Tuple[str, object]] = []

        def run(rep: SweepReport) -> SweepReport:
            nonlocal duration, sweeps
            self.stats.sweeps_run += 1
            sweeps += 1
            self.stats.downtime_seconds += rep.duration_s
            duration += rep.duration_s
            records.append(("sweep", rep))
            return rep

        def ticket(outcome: NodeState,
                   exhausted: bool = False) -> QualificationTicket:
            return QualificationTicket(node_id, outcome, duration, sweeps,
                                       records, buddy_exhausted=exhausted)

        for _ in range(self.max_rounds):
            rep = run(single_node_sweep(self.backend, node_id,
                                        self.sweep_cfg,
                                        enhanced=self.enhanced_sweep))
            passed = rep.passed
            if passed and self.enhanced_sweep:
                avail = self.spare_pool_ids()
                buddies = avail[:nb]
                if not buddies:
                    # no known-good buddy: the multi-node stage cannot
                    # run — park the node instead of passing it blind
                    return ticket(NodeState.QUARANTINED, exhausted=True)
                multi = run(multi_node_sweep(self.backend, node_id,
                                             buddies, self.sweep_cfg))
                if not multi.passed:
                    retry = [s for s in avail[nb:]
                             if s not in buddies][:nb]
                    if not retry:
                        # the only buddy may itself be contaminated —
                        # one ambiguous failure condemns nobody
                        return ticket(NodeState.QUARANTINED,
                                      exhausted=True)
                    multi = run(multi_node_sweep(self.backend, node_id,
                                                 retry, self.sweep_cfg))
                passed = multi.passed
            if passed:
                return ticket(NodeState.HEALTHY_SPARE)
            self.stats.sweeps_failed += 1
            res: TriageResult = self.triage.run(
                node_id, self._error_signals(node_id),
                self.control.now(), self.control.remediate,
                lambda nid: single_pass(self.backend, nid, self.sweep_cfg))
            self.stats.triages_run += 1
            self.stats.human_seconds += res.human_s
            self.stats.downtime_seconds += res.elapsed_s
            duration += res.elapsed_s
            records.append(("triage", res))
            if res.outcome == TriageOutcome.TERMINATED:
                return ticket(NodeState.TERMINATED)
            # else: returned to sweep — loop re-sweeps
        return ticket(NodeState.TERMINATED)

    def complete_qualification(self, ticket: QualificationTicket
                               ) -> NodeState:
        """Apply a qualification outcome to the pools (idempotent)."""
        if ticket.applied:
            return ticket.outcome
        ticket.applied = True
        if ticket.outcome == NodeState.HEALTHY_SPARE:
            self.return_spare(ticket.node_id)
            self.stats.nodes_requalified += 1
        elif ticket.outcome == NodeState.QUARANTINED:
            # unresolved (buddy exhaustion): the node stays parked and a
            # later submission retries once buddy capacity exists
            self.state[ticket.node_id] = NodeState.QUARANTINED
        else:
            self.state[ticket.node_id] = NodeState.TERMINATED
            self.stats.nodes_terminated += 1
        return ticket.outcome

    def qualify(self, node_id: int) -> NodeState:
        """Synchronous qualification: begin + complete in one call."""
        return self.complete_qualification(self.begin_qualification(node_id))

    def qualify_all_quarantined(self) -> None:
        for nid in self.quarantined():
            self.qualify(nid)


def single_pass(backend: SweepBackend, node_id: int,
                cfg: SweepConfig) -> bool:
    """Cheap post-remediation health check (short single-node sweep)."""
    from repro_torch.core.sweep import single_node_sweep
    short = dataclasses.replace(cfg, burn_seconds=min(cfg.burn_seconds, 60.0))
    return single_node_sweep(backend, node_id, short, enhanced=False).passed
