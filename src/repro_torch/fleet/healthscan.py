"""Background re-qualification campaigns on idle bench capacity; the
port of ``repro.fleet.healthscan``.

Modeled on the ``healthrunner`` orchestration of Google's
cluster-health-scanner: health checking is a *periodic fleet service*,
not something a job does inline. Every ``period_s`` of fleet time the
orchestrator walks the global pool's free spares (grouped by home job,
since sweeps run on the home fleet's bench backend), books a batched
``fleet_qualification`` campaign on a sweep-bench slot **only if one is
idle** — foreground qualification always outranks background scans —
and feeds the verdicts back: passers stay in the pool with a refreshed
timestamp, failures are pulled out, quarantined in their home session
and routed into its event-driven sweep→triage loop.

This is what catches nodes that slipped through admission (the sim
seeds admission greys on provisioning): in fleet mode spares sit in the
shared pool instead of being inline-checked by each job, so the
periodic scan is the line of defense the paper's always-on service
provides.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List

from repro_torch.core.health_manager import NodeState
from repro_torch.core.sweep import SweepCampaign, fleet_qualification
from repro_torch.fleet.events import CampaignScheduled

if TYPE_CHECKING:
    from repro_torch.fleet.controller import FleetController


class HealthScanOrchestrator:
    """Periodic scanner over the global pool's free spares."""

    def __init__(self, controller: "FleetController",
                 period_s: float = 6 * 3600.0, batch: int = 16):
        self.controller = controller
        self.period_s = float(period_s)
        self.batch = int(batch)
        self._next_due = self.period_s
        # rotate the starting job so one tenant's spares don't hog the
        # idle capacity every cycle
        self._rr = 0
        self.campaigns = 0
        self.scanned = 0
        self.failed: List[int] = []
        # host wall spent inside the batched sweep computation itself:
        # that is BENCH work (it would run on the qualification
        # hardware), not control-plane overhead — the controller
        # subtracts it from its self-time
        self.sweep_wall_s = 0.0

    def tick(self, now: float) -> int:
        """Run due campaigns at fleet time ``now``; returns how many
        were scheduled this call."""
        now = float(now)
        if now < self._next_due:
            return 0
        self._next_due = now + self.period_s
        ctl = self.controller
        jobs = list(ctl.jobs.values())
        if not jobs:
            return 0
        ran = 0
        order = jobs[self._rr % len(jobs):] + jobs[:self._rr % len(jobs)]
        self._rr += 1
        for job in order:
            if not ctl.bench.idle_at(now):
                break               # foreground work owns the bench
            ids = ctl.pool.free_ids(home=job.job_id)[:self.batch]
            if not ids:
                continue
            mgr = job.session.manager
            res = fleet_qualification(
                mgr.backend,
                SweepCampaign(node_ids=tuple(ids), reference_pool=(),
                              enhanced=False),
                mgr.sweep_cfg)
            self.sweep_wall_s += res.wall_s
            mgr.stats.sweeps_run += res.sweeps
            mgr.stats.sweeps_failed += len(res.failed)
            start, finish = ctl.bench.occupy(now, res.node_seconds
                                             / max(ctl.bench.slots, 1))
            for nid in res.failed:
                # out of the pool, into the home session's offline loop
                ctl.pool.remove(nid, home=job.job_id)
                mgr.state[nid] = NodeState.QUARANTINED
                job.session.scheduler.submit(nid, now=finish)
                self.failed.append(nid)
            for rec in (ctl.pool.record(nid, home=job.job_id)
                        for nid in res.passed):
                if rec is not None:
                    rec.since_t = now   # freshly re-certified
            ctl.log.append(job.job_id, CampaignScheduled(
                t=now, step=-1, job=job.job_id, nodes=tuple(ids),
                start_t=start, finish_t=finish))
            self.campaigns += 1
            self.scanned += len(ids)
            ran += 1
        return ran


__all__ = ["HealthScanOrchestrator"]
