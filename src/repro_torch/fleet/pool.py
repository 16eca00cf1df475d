"""The fleet's global spare pool: lease/grant arbitration over one
shared node inventory; the port of ``repro.fleet.pool`` (host Python, as
there: the pool holds no tensor).

One pool replaces N private ``HealthManager.spares`` lists. Every free
node carries a *home* job — the fleet whose physical inventory (racks,
NICs, sim ids) it lives in — because grants to the home job are plain
handoffs while cross-job grants are *transfers* (the controller
materializes equivalent capacity in the destination fleet and retires
the donor node; see ``FleetController``).

Arbitration (the paper's cluster-service allocation policy):

1. **Starvation bound first.** A request that has waited past
   ``starvation_age_s`` outranks everything — the no-starvation
   guarantee is absolute, not best-effort. Crossing the bound is ALSO
   counted as a starvation event (the bench gates on zero, i.e. the
   ladder below must keep every wait under the bound on its own).
2. **Fair-share floor.** A job whose granted share has fallen below
   ``floor_frac`` of the per-job mean outranks kind and priority: a
   fleet of ENHANCED tenants cannot structurally starve an ONLINE one.
3. **Lease kind.** Hang-culprit evictions > fail-stop crashes >
   slow-node swaps: a wedged collective idles the whole job, a crash
   idles the job until replacement, a straggler merely degrades it.
4. **Job priority.** ENHANCED-tier jobs outrank ONLINE within a kind.
5. **FIFO** within all of the above.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Tuple


class LeaseKind(enum.IntEnum):
    """Urgency ladder for spare leases (higher = more urgent)."""
    SLOW_SWAP = 1     # straggler eviction: the job still makes progress
    CRASH = 2         # fail-stop replacement: the job is down until served
    HANG_EVICT = 3    # hang-culprit eviction: the job is wedged, hot path

    @classmethod
    def from_str(cls, kind: str) -> "LeaseKind":
        return _KIND_FROM_STR.get(kind, cls.SLOW_SWAP)


_KIND_FROM_STR = {"swap": LeaseKind.SLOW_SWAP, "crash": LeaseKind.CRASH,
                  "hang": LeaseKind.HANG_EVICT}


@dataclasses.dataclass
class SpareRecord:
    """One free node in the global pool."""
    node_id: int
    home: str               # job whose physical fleet the node lives in
    since_t: float          # when it became free


@dataclasses.dataclass
class Lease:
    """A closed grant: ``node_id`` left the pool for ``job``.

    ``home`` is the fleet the granted record physically lives in; node
    ids are only unique *within* a home fleet (each job's substrate
    numbers its own inventory), so the pool keys everything by
    ``(home, node_id)``. ``home != job`` marks a transfer — the
    controller materializes fresh capacity in ``job``'s fleet and the
    recorded node becomes a ghost."""
    node_id: int
    job: str
    kind: LeaseKind
    granted_t: float
    home: str = ""
    wait_s: float = 0.0
    transfer: bool = False       # donated by another job's homed spare
    provisioned: bool = False    # materialized brand-new (pool was dry)


@dataclasses.dataclass
class LeaseRequest:
    """A queued ask for replacement capacity (async path)."""
    job: str
    kind: LeaseKind
    priority: int
    enqueue_t: float
    seq: int
    lease: Optional[Lease] = None     # set when served

    @property
    def served(self) -> bool:
        return self.lease is not None


@dataclasses.dataclass
class PoolStats:
    grants: int = 0
    transfers: int = 0
    provisions: int = 0
    starvation_events: int = 0
    max_wait_s: float = 0.0


class GlobalSparePool:
    """Home-tagged free list + the lease arbitration queue.

    ``grant`` is the synchronous path (a session's ``take_spare`` cannot
    block); ``request``/``serve`` is the queued path the controller and
    the property tests drive. Both feed the same free list, the same
    per-job grant accounting, and the same starvation bound.
    """

    def __init__(self, starvation_age_s: float = 3600.0,
                 floor_frac: float = 0.5):
        # node ids are only unique within a home fleet — key by both
        self._free: Dict[Tuple[str, int], SpareRecord] = {}
        self._free_by_home: Dict[str, int] = {}   # O(1) per-home census
        self._leased: Dict[Tuple[str, int], Lease] = {}  # open leases
        self._queue: List[LeaseRequest] = []
        self._seq = 0
        self.jobs: List[str] = []
        self.granted_to: Dict[str, int] = {}   # per-job grant counts
        self.starvation_age_s = float(starvation_age_s)
        self.floor_frac = float(floor_frac)
        self.stats = PoolStats()

    # ------------------------------------------------------------ census

    def _assert_census(self) -> None:
        """Pool conservation, asserted by every mutating entry point
        (guardlint GL005): the O(1) per-home counter matches the free
        list exactly, no node is simultaneously free and leased, and
        every job with grants is registered."""
        by_home: Dict[str, int] = {}
        for (home, _nid) in self._free:
            by_home[home] = by_home.get(home, 0) + 1
        recorded = {h: n for h, n in self._free_by_home.items() if n}
        assert recorded == by_home, \
            f"pool census drift: counter {recorded} != free list {by_home}"
        overlap = self._free.keys() & self._leased.keys()
        assert not overlap, \
            f"nodes both free and leased: {sorted(overlap)}"
        assert set(self.granted_to) == set(self.jobs), \
            "grant accounting for unregistered job"

    def register_job(self, job: str) -> None:
        if job not in self.granted_to:
            self.jobs.append(job)
            self.granted_to[job] = 0
        self._assert_census()

    def free_count(self, home: Optional[str] = None) -> int:
        if home is None:
            return len(self._free)
        return self._free_by_home.get(home, 0)

    def free_ids(self, home: Optional[str] = None) -> List[int]:
        """Free node ids; without ``home`` the ids may collide across
        fleets — use only for counting/inspection then."""
        if home is None:
            return sorted(n for (_, n) in self._free)
        return sorted(n for (h, n) in self._free if h == home)

    def record(self, node_id: int, home: str) -> Optional[SpareRecord]:
        return self._free.get((home, node_id))

    def pending(self, job: Optional[str] = None) -> List[LeaseRequest]:
        if job is None:
            return list(self._queue)
        return [r for r in self._queue if r.job == job]

    # ------------------------------------------------------------- intake

    def add(self, node_id: int, home: str, now: float) -> None:
        """A healthy node enters (or re-enters) the free pool. Closes
        any open lease on it; double-adding is an accounting bug."""
        key = (home, node_id)
        assert key not in self._free, \
            f"node {key} already free (double give)"
        self._leased.pop(key, None)
        self._free[key] = SpareRecord(node_id, home, float(now))
        self._free_by_home[home] = self._free_by_home.get(home, 0) + 1
        self._assert_census()

    def remove(self, node_id: int, home: str) -> Optional[SpareRecord]:
        """Pull a free node out of the pool without granting it (the
        healthscan pulls failures into quarantine this way)."""
        rec = self._free.pop((home, node_id), None)
        if rec is not None:
            self._free_by_home[home] -= 1
        self._assert_census()
        return rec

    # ------------------------------------------------------------- grants

    def grant(self, job: str, kind: LeaseKind, now: float,
              wait_s: float = 0.0) -> Optional[Lease]:
        """Synchronously lease one free node to ``job``: oldest home
        spare first, else the oldest foreign spare (a transfer). Returns
        None when the pool is dry — the caller provisions."""
        pick: Optional[SpareRecord] = None
        if self._free_by_home.get(job, 0):
            for rec in self._free.values():
                if rec.home != job:
                    continue
                if pick is None or rec.since_t < pick.since_t:
                    pick = rec
        transfer = False
        if pick is None:
            for rec in self._free.values():
                if pick is None or rec.since_t < pick.since_t:
                    pick = rec
            transfer = pick is not None
        if pick is None:
            return None
        del self._free[(pick.home, pick.node_id)]
        self._free_by_home[pick.home] -= 1
        lease = Lease(pick.node_id, job, kind, float(now), home=pick.home,
                      wait_s=float(wait_s), transfer=transfer)
        self._note_grant(lease)
        self._assert_census()
        return lease

    def note_provisioned(self, node_id: int, job: str, kind: LeaseKind,
                         now: float, wait_s: float = 0.0) -> Lease:
        """Record a grant that had to materialize brand-new capacity
        (pool dry). The node never touched the free list."""
        lease = Lease(int(node_id), job, kind, float(now), home=job,
                      wait_s=float(wait_s), provisioned=True)
        self.stats.provisions += 1
        self._note_grant(lease)
        return lease

    def _note_grant(self, lease: Lease) -> None:
        key = (lease.home, lease.node_id)
        assert key not in self._leased, f"node {key} double-granted"
        self._leased[key] = lease
        self.register_job(lease.job)
        self.granted_to[lease.job] += 1
        self.stats.grants += 1
        if lease.transfer:
            self.stats.transfers += 1
        self.stats.max_wait_s = max(self.stats.max_wait_s, lease.wait_s)
        if lease.wait_s > self.starvation_age_s:
            self.stats.starvation_events += 1
        self._assert_census()

    # -------------------------------------------------------- async queue

    def request(self, job: str, kind: LeaseKind, priority: int,
                now: float) -> LeaseRequest:
        """Queue an ask; ``serve`` arbitrates."""
        self.register_job(job)
        self._seq += 1
        req = LeaseRequest(job, kind, int(priority), float(now), self._seq)
        self._queue.append(req)
        self._assert_census()
        return req

    def _below_floor(self, job: str) -> bool:
        """Fair-share floor: has ``job`` received less than
        ``floor_frac`` of the per-job mean grant count?"""
        n = len(self.jobs)
        if n <= 1:
            return False
        mean = self.stats.grants / n
        return self.granted_to.get(job, 0) < self.floor_frac * mean

    def _rank(self, req: LeaseRequest, now: float) -> Tuple:
        starving = (now - req.enqueue_t) >= self.starvation_age_s
        return (starving, self._below_floor(req.job), int(req.kind),
                req.priority, -req.seq)

    def serve(self, now: float,
              materialize: Optional[Callable[[str], Optional[int]]] = None
              ) -> List[LeaseRequest]:
        """Arbitrate the queue at time ``now``: grant free nodes to the
        highest-ranked requests; when the pool runs dry, ``materialize``
        (controller-provided provisioning, may return None to decline)
        keeps serving. Returns the requests served this round."""
        now = float(now)
        served: List[LeaseRequest] = []
        while self._queue:
            best = max(self._queue, key=lambda r: self._rank(r, now))
            wait = max(0.0, now - best.enqueue_t)
            lease = self.grant(best.job, best.kind, now, wait_s=wait)
            if lease is None and materialize is not None:
                nid = materialize(best.job)
                if nid is not None:
                    lease = self.note_provisioned(nid, best.job, best.kind,
                                                  now, wait_s=wait)
            if lease is None:
                break                      # dry and not provisionable
            best.lease = lease
            self._queue.remove(best)
            served.append(best)
        self._assert_census()
        return served

    # ------------------------------------------------------------ queries

    def open_leases(self) -> Dict[Tuple[str, int], Lease]:
        return dict(self._leased)

    def census(self) -> Dict[str, int]:
        return {"free": len(self._free), "leased": len(self._leased),
                "queued": len(self._queue)}


__all__ = ["GlobalSparePool", "Lease", "LeaseKind", "LeaseRequest",
           "PoolStats", "SpareRecord"]
