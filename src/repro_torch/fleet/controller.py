"""``FleetController``: one Guard control plane over many concurrent
jobs sharing a node inventory; the port of ``repro.fleet.controller``.
The plane is host Python, as in the reference; each session's detector
runs on the device its session was built for.

The paper deploys Guard as a *cluster service* — one health-management
plane qualifying nodes, allocating spares and running background sweeps
for every production workload on the fleet. This module is that plane
for N ``GuardSession``s at once:

* **Global spare pool** (``repro_torch.fleet.pool``): at ``register_job`` the
  session's private spares are adopted into one shared, home-tagged
  pool and the session's ``HealthManager`` is re-pointed at it through
  the ``SparePool`` lease/grant seam — ``take_spare`` becomes a lease
  arbitrated by urgency (hang > crash > swap), job priority and a
  fair-share floor. Grants to a node's home job hand the node over
  directly; cross-job grants are *transfers*: the controller
  materializes equivalent capacity in the destination fleet
  (``deliver_node``) and retires the donor into the ghost ledger, so
  per-fleet physical inventories stay consistent and the fleet-wide
  census is conserved exactly.

* **Shared sweep bench**: every session's ``SweepScheduler`` is rebound
  to one fleet ``BenchSlots``, so concurrent qualification campaigns
  queue on the same physical slots; the healthscan orchestrator books
  background re-qualification on whatever capacity is left idle.

* **Streaming event log** (``repro_torch.fleet.stream``): each session's bus
  is tapped into one cursor-replayable fleet log; controller-level
  transitions (``SpareLeased`` / ``SpareReclaimed`` /
  ``CampaignScheduled``) land in the same stream.

Every controller entry point self-times into ``overhead_s`` so a fleet
driver can report control-plane overhead as a fraction of sim wall time
(the bench gates it below 5%).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.health_manager import NodeState
from repro_torch.fleet.events import SpareLeased, SpareReclaimed
from repro_torch.fleet.pool import GlobalSparePool, LeaseKind
from repro_torch.fleet.stream import FleetEventLog
from repro_torch.guard.scheduler import BenchSlots
from repro_torch.guard.session import GuardSession


@dataclasses.dataclass
class FleetJob:
    """One registered tenant of the control plane."""
    job_id: str
    session: GuardSession
    priority: int                 # higher outranks (defaults to the tier)
    registered_t: float
    inventory: int = 0            # nodes counted at registration
    provisions_base: int = 0      # manager provision count at registration
    leases: int = 0               # grants this job received
    provision_grants: int = 0     # grants that materialized new capacity
    transfer_grants: int = 0      # grants donated by another job's spare

    @property
    def provisions(self) -> int:
        return (self.session.manager.stats.nodes_provisioned
                - self.provisions_base)


class _JobPool:
    """The ``SparePool`` protocol adapter one ``HealthManager`` sees:
    every take/give routes through the controller under this job's
    identity."""

    def __init__(self, controller: "FleetController", job_id: str):
        self.controller = controller
        self.job_id = job_id

    def take(self, kind: str = "swap") -> int:
        return self.controller.acquire(self.job_id, kind)

    def give(self, node_id: int) -> None:
        self.controller.release(self.job_id, node_id)

    def count(self) -> int:
        return self.controller.pool.free_count()

    def buddies(self, n: int, skip: int = 0) -> List[int]:
        # only home-co-located free nodes can physically pair with this
        # job's sweep bench
        ids = self.controller.pool.free_ids(home=self.job_id)
        return ids[skip:skip + n]


class FleetController:
    """The fleet control plane: pool + bench + healthscan + event log."""

    def __init__(self, bench_slots: int = 4,
                 starvation_age_s: float = 3600.0,
                 floor_frac: float = 0.5,
                 log_capacity: int = 65536,
                 healthscan_period_s: Optional[float] = None,
                 healthscan_batch: int = 16,
                 clock: Optional[Callable[[], float]] = None):
        self.bench = BenchSlots(bench_slots)
        self.pool = GlobalSparePool(starvation_age_s=starvation_age_s,
                                    floor_frac=floor_frac)
        self.log = FleetEventLog(capacity=log_capacity)
        self.jobs: Dict[str, FleetJob] = {}
        # transfer donors, as (home_job, node_id): physically idle
        # hardware retired from the pool when its capacity was
        # re-materialized in another fleet
        self.ghosts: List[tuple] = []
        # external clock (fleet sim time); falls back to the max of the
        # registered sessions' control clocks
        self._clock = clock
        self.overhead_s = 0.0
        from repro_torch.fleet.healthscan import HealthScanOrchestrator
        self.healthscan: Optional[HealthScanOrchestrator] = None
        if healthscan_period_s is not None:
            self.healthscan = HealthScanOrchestrator(
                self, period_s=healthscan_period_s, batch=healthscan_batch)

    # -------------------------------------------------------------- clock

    def now(self) -> float:
        if self._clock is not None:
            return self._clock()
        if not self.jobs:
            return 0.0
        return max(j.session.control.now() for j in self.jobs.values())

    # -------------------------------------------------------------- census

    def _assert_census(self, in_flight: int = 0) -> None:
        """The conservation law the fleet bench gates, asserted by every
        pool-mutating entry point (guardlint GL005): each node ever
        registered or provisioned is in exactly one place — some job's
        census, the free pool, or the ghost ledger. ``in_flight`` is the
        number of nodes legitimately between places at the call site
        (a synchronous grant is handed to the caller, who registers it
        into the job census only after ``acquire`` returns)."""
        live = sum(len(j.session.manager.state) for j in self.jobs.values())
        expected = sum(j.inventory + j.provisions
                       for j in self.jobs.values())
        accounted = live + self.pool.free_count() + len(self.ghosts)
        assert accounted + in_flight == expected, (
            f"fleet census drift: live {live} + free "
            f"{self.pool.free_count()} + ghosts {len(self.ghosts)} + "
            f"in-flight {in_flight} != expected {expected}")

    # -------------------------------------------------------- registration

    def register_job(self, job_id: str, session: GuardSession,
                     priority: Optional[int] = None) -> FleetJob:
        """Adopt one session into the control plane: its private spares
        join the global pool (home-tagged), its manager leases through
        the pool from now on, its scheduler queues on the shared bench,
        and its event bus streams into the fleet log."""
        t0 = time.perf_counter()
        assert job_id not in self.jobs, f"job {job_id!r} already registered"
        now = self.now()
        mgr = session.manager
        job = FleetJob(job_id, session,
                       priority=int(session.tier) if priority is None
                       else int(priority),
                       registered_t=now,
                       inventory=len(mgr.state),
                       provisions_base=mgr.stats.nodes_provisioned)
        self.jobs[job_id] = job
        self.pool.register_job(job_id)
        for nid in mgr.release_private_spares():
            self.pool.add(nid, home=job_id, now=now)
            self.log.append(job_id, SpareReclaimed(
                t=now, step=-1, node_id=nid, job=job_id,
                reason="adopted at registration"))
        mgr.attach_pool(_JobPool(self, job_id))
        session.scheduler.rebind_bench(self.bench)
        session.add_sink(self.log.session_sink(job_id))
        self._assert_census()
        self.overhead_s += time.perf_counter() - t0
        return job

    # ------------------------------------------------------------- leases

    def acquire(self, job_id: str, kind: str = "swap") -> int:
        """Synchronous lease (a session's ``take_spare``): grant a free
        node — home spare first, foreign spare as a transfer — or
        materialize fresh capacity when the pool is dry. Always returns
        a node usable in ``job_id``'s fleet."""
        t0 = time.perf_counter()
        substrate_s = 0.0
        job = self.jobs[job_id]
        now = self.now()
        lk = LeaseKind.from_str(kind)
        lease = self.pool.grant(job_id, lk, now)
        if lease is None:
            # dry pool: bring brand-new capacity through this job's
            # admission path and record it as a provisioned grant
            s0 = time.perf_counter()
            nid = job.session.manager.deliver_node()
            substrate_s = time.perf_counter() - s0
            lease = self.pool.note_provisioned(nid, job_id, lk, now)
            job.provision_grants += 1
        elif lease.transfer:
            # donor lives in another fleet: materialize equivalent
            # capacity here, retire the donor into the ghost ledger
            s0 = time.perf_counter()
            nid = job.session.manager.deliver_node()
            substrate_s = time.perf_counter() - s0
            self.ghosts.append((lease.home, lease.node_id))
            lease = dataclasses.replace(lease, node_id=nid)
            job.transfer_grants += 1
        else:
            nid = lease.node_id
        job.leases += 1
        self.log.append(job_id, SpareLeased(
            t=now, step=-1, node_id=nid, job=job_id, lease_kind=kind,
            priority=job.priority, provisioned=lease.provisioned,
            transfer=lease.transfer, wait_s=lease.wait_s))
        # the granted node is between places until the caller's
        # take_spare registers it into the job census
        self._assert_census(in_flight=1)
        # materializing capacity is substrate (datacenter) work, not
        # control-plane arbitration — keep it out of the overhead gate
        self.overhead_s += max(time.perf_counter() - t0 - substrate_s, 0.0)
        return nid

    def release(self, job_id: str, node_id: int) -> None:
        """A healthy node returns to the global pool (requalified spare
        or closed lease), homed where it physically lives."""
        t0 = time.perf_counter()
        now = self.now()
        self.pool.add(node_id, home=job_id, now=now)
        self.log.append(job_id, SpareReclaimed(
            t=now, step=-1, node_id=node_id, job=job_id,
            reason="returned to pool"))
        self._assert_census()
        self.overhead_s += time.perf_counter() - t0

    def request_spare(self, job_id: str, kind: str = "swap"):
        """Queued (async) lease path: enqueue an ask the next ``tick``
        arbitrates. Used for planned top-ups and by the contention
        tests; urgent replacement goes through ``acquire``."""
        job = self.jobs[job_id]
        req = self.pool.request(job_id, LeaseKind.from_str(kind),
                                job.priority, self.now())
        self._assert_census()
        return req

    # -------------------------------------------------------- maintenance

    def top_up(self, global_target: int, home_min: int = 2) -> int:
        """Warm-pool maintenance across the whole fleet: keep at least
        ``home_min`` free spares homed per job (sweep-buddy capacity)
        and ``global_target`` free fleet-wide. Returns nodes added."""
        t0 = time.perf_counter()
        substrate_s = 0.0
        added = 0
        for job in self.jobs.values():
            while self.pool.free_count(home=job.job_id) < home_min:
                s0 = time.perf_counter()
                job.session.manager.provision_spare()
                substrate_s += time.perf_counter() - s0
                added += 1
        # spread the remainder round-robin so no fleet hoards the pool
        while self.pool.free_count() < global_target:
            job = min(self.jobs.values(),
                      key=lambda j: self.pool.free_count(home=j.job_id))
            s0 = time.perf_counter()
            job.session.manager.provision_spare()
            substrate_s += time.perf_counter() - s0
            added += 1
        # provisioning itself is substrate work; only the placement
        # decisions above count as control plane
        self.overhead_s += max(time.perf_counter() - t0 - substrate_s, 0.0)
        return added

    def tick(self, now: Optional[float] = None) -> int:
        """Periodic control-plane work: arbitrate the queued lease
        requests and let the healthscan orchestrator book background
        re-qualification on idle bench capacity. Returns requests
        served."""
        t0 = time.perf_counter()
        now = self.now() if now is None else float(now)

        def materialize(job_id: str) -> Optional[int]:
            job = self.jobs.get(job_id)
            if job is None:
                return None
            job.provision_grants += 1
            return job.session.manager.deliver_node()

        served = self.pool.serve(now, materialize=materialize)
        for req in served:
            lease = req.lease
            nid = lease.node_id
            job = self.jobs[req.job]
            if lease.transfer:
                nid = job.session.manager.deliver_node()
                self.ghosts.append((lease.home, lease.node_id))
                req.lease = dataclasses.replace(lease, node_id=nid)
                job.transfer_grants += 1
            job.leases += 1
            # queued grants land as healthy spares homed to the
            # requester (planned capacity, not an in-flight swap)
            job.session.manager.register(nid, NodeState.ACTIVE)
            self.log.append(req.job, SpareLeased(
                t=now, step=-1, node_id=nid, job=req.job,
                lease_kind={LeaseKind.SLOW_SWAP: "swap",
                            LeaseKind.CRASH: "crash",
                            LeaseKind.HANG_EVICT: "hang"}[req.kind],
                priority=req.priority, provisioned=lease.provisioned,
                transfer=req.lease.transfer, wait_s=lease.wait_s))
        self._assert_census()
        sweep0 = 0.0
        if self.healthscan is not None:
            sweep0 = self.healthscan.sweep_wall_s
            self.healthscan.tick(now)
        elapsed = time.perf_counter() - t0
        if self.healthscan is not None:
            # the batched sweep compute runs on the bench hardware, not
            # the control plane: only the orchestration counts here
            elapsed -= self.healthscan.sweep_wall_s - sweep0
        self.overhead_s += max(elapsed, 0.0)
        return len(served)

    # -------------------------------------------------------------- census

    def census(self) -> Dict[str, object]:
        """Fleet-wide node accounting. ``conserved`` is the invariant
        the bench gates bit-consistent: every node registered or
        provisioned is in exactly one place — some job's census, the
        free pool, or the ghost ledger."""
        per_job: Dict[str, Dict[str, int]] = {}
        live = 0
        inventory = 0
        provisions = 0
        for job in self.jobs.values():
            counts: Dict[str, int] = {}
            for st in job.session.manager.state.values():
                counts[st.value] = counts.get(st.value, 0) + 1
            per_job[job.job_id] = counts
            live += len(job.session.manager.state)
            inventory += job.inventory
            provisions += job.provisions
        free = self.pool.free_count()
        ghosts = len(self.ghosts)
        return {
            "jobs": per_job,
            "live": live,
            "pool_free": free,
            "ghosts": ghosts,
            "inventory": inventory,
            "provisions": provisions,
            "accounted": live + free + ghosts,
            "expected": inventory + provisions,
            "conserved": (live + free + ghosts) == (inventory + provisions),
        }

    def starvation_events(self) -> int:
        return self.pool.stats.starvation_events


__all__ = ["FleetController", "FleetJob"]
