"""Non-blocking offline-qualification scheduler with sweep-bench
capacity modeling.

The paper's qualification pipeline (§5) is *event-driven and offline*: a
quarantined node is swept/triaged on the side while the job keeps
training, and only re-enters the healthy pool once it passes. The
pre-session code instead called ``qualify_all_quarantined()`` inline at
checkpoint boundaries — instantaneous in simulated time and serialized
with the job.

``SweepScheduler`` restores the real semantics: quarantined nodes queue
up, at most ``concurrency`` qualifications are in flight, and each one
occupies a sweep-bench slot for the simulated ``duration_s`` its
sweep→triage loop consumed. The bench is modeled as ``concurrency``
slots with explicit free times: dequeued work starts at
``max(slot_free_t, enqueue_t)`` — the moment the freeing slot's
previous occupant actually finished, NOT the next time ``advance()``
happened to be called — so bench occupancy and qualification landing
times are exact regardless of how coarsely the caller drives the clock.
``advance(now)`` is the only clock input — call it whenever job time
moves (the simulator does so every window) and it chains starts and
landings in event order up to ``now``, publishing ``SweepStarted`` /
``TriageStage`` / ``SweepFinished`` events on the session bus at their
TRUE times. ``drain(now, step)`` runs the bench to completion for
end-of-run accounting (event times may lie beyond ``now``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.health_manager import HealthManager, QualificationTicket
from repro_torch.guard.events import (EventBus, SweepFinished, SweepStarted,
                                      TriageStage)


@dataclasses.dataclass
class InFlight:
    ticket: QualificationTicket
    started_t: float
    finish_t: float


class BenchSlots:
    """Sweep-bench capacity as explicit slot free times.

    Extracted from the scheduler so the SAME bench can back several
    schedulers at once: a fleet controller hands one ``BenchSlots`` to
    every concurrent job's ``SweepScheduler`` and their qualification
    campaigns queue on the shared slots (the paper's cluster-service
    deployment — one offline bench, many tenants). Slot accounting is a
    min-heap of free times; ``occupy`` is the direct-occupancy path for
    batched background campaigns (healthscan) that bypass the per-node
    queue."""

    def __init__(self, slots: int):
        assert slots >= 1
        self._free_at: List[float] = [0.0] * slots
        heapq.heapify(self._free_at)

    @property
    def slots(self) -> int:
        return len(self._free_at)

    def earliest(self) -> Optional[float]:
        """Free time of the earliest-available slot, or None while every
        slot token is claimed by in-flight work."""
        return self._free_at[0] if self._free_at else None

    def pop(self) -> float:
        """Claim the earliest slot (caller pushes back its new free time)."""
        return heapq.heappop(self._free_at)

    def push(self, free_t: float) -> None:
        heapq.heappush(self._free_at, free_t)

    def occupy(self, now: float, duration_s: float) -> Tuple[float, float]:
        """Occupy one slot for ``duration_s`` starting no earlier than
        ``now``; returns the (start, finish) times actually booked."""
        free_t = self.pop()
        start = max(free_t, float(now))
        finish = start + float(duration_s)
        self.push(finish)
        return start, finish

    def idle_at(self, now: float) -> bool:
        """True when at least one slot is free at time ``now``."""
        return bool(self._free_at) and self._free_at[0] <= float(now)


class SweepScheduler:
    """Queues quarantined nodes and overlaps qualification with the job."""

    def __init__(self, manager: HealthManager,
                 bus: Optional[EventBus] = None,
                 concurrency: int = 2,
                 bench: Optional[BenchSlots] = None):
        self.manager = manager
        self.bus = bus
        # the bench may be private (default: ``concurrency`` slots) or a
        # shared fleet-level BenchSlots arbitrated across many sessions
        self.bench = bench or BenchSlots(concurrency)
        self.concurrency = self.bench.slots
        self.queue: List[Tuple[int, float]] = []    # (node_id, enqueued_t)
        self.in_flight: List[InFlight] = []
        self._tracked: Set[int] = set()
        # nodes whose last qualification ended buddy_exhausted, keyed to
        # the spare count they exhausted it at: re-running the identical
        # ambiguous sweep against the identical buddy pool would burn
        # the bench for the identical parked verdict, so the periodic
        # quarantine scan skips them until the pool has GROWN (an
        # explicit submit() still overrides)
        self._parked: Dict[int, int] = {}
        self.completed: List[QualificationTicket] = []
        self._step = 0               # last known global step, for events
        self._now = 0.0              # last clock input (submit default)

    def rebind_bench(self, bench: BenchSlots) -> None:
        """Point this scheduler at a (shared) bench. Only legal while no
        qualification is in flight — in-flight work booked slots on the
        old bench and landing it against a different heap would corrupt
        both."""
        assert not self.in_flight, "cannot rebind with work in flight"
        self.bench = bench
        self.concurrency = bench.slots

    # ------------------------------------------------------------- intake

    def submit(self, node_id: int, now: Optional[float] = None) -> bool:
        """Enqueue one quarantined node; no-op if already queued/running.
        ``now`` is the time the node became available for the bench
        (defaults to the last clock input)."""
        if node_id in self._tracked:
            return False
        self._tracked.add(node_id)
        self._parked.pop(node_id, None)
        self.queue.append((node_id, self._now if now is None else
                           float(now)))
        return True

    def submit_quarantined(self, now: Optional[float] = None) -> int:
        """Scan the manager for quarantined nodes and enqueue the new
        ones — except buddy-exhausted parked nodes whose spare pool has
        not grown since they parked (re-sweeping them would repeat the
        same ambiguous verdict)."""
        spares = self.manager.spare_count
        return sum(self.submit(nid, now=now)
                   for nid in self.manager.quarantined()
                   if spares > self._parked.get(nid, -1))

    # ------------------------------------------------------------- clock

    @property
    def busy(self) -> int:
        return len(self.in_flight)

    @property
    def backlog(self) -> int:
        return len(self.queue)

    def next_finish_t(self) -> Optional[float]:
        if not self.in_flight:
            return None
        return min(f.finish_t for f in self.in_flight)

    def next_event_t(self) -> Optional[float]:
        """Earliest pending event (a landing or a possible start) —
        lets a fleet controller interleave several schedulers sharing
        one bench in global event order."""
        nf = self.next_finish_t()
        ns = self._next_start_t()
        if nf is None:
            return ns
        if ns is None:
            return nf
        return min(nf, ns)

    def advance(self, now: float, step: int = -1
                ) -> List[QualificationTicket]:
        """Chain starts and landings in event order up to ``now``;
        returns the tickets that completed at or before ``now``."""
        if step >= 0:
            self._step = step
        now = float(now)
        self._now = max(self._now, now)
        return self._run_until(now)

    def drain(self, now: float, step: Optional[int] = None
              ) -> List[QualificationTicket]:
        """Force-run the bench to completion (end of run). Events are
        stamped at their true start/finish times — which may lie beyond
        ``now`` — and carry ``step`` when given (the caller's final
        global step, so end-of-run events aren't stamped with whatever
        step the last mid-run ``advance`` happened to see)."""
        if step is not None:
            self._step = step
        self._now = max(self._now, float(now))
        return self._run_until(math.inf)

    # ----------------------------------------------------------- internal

    def _next_start_t(self) -> Optional[float]:
        """Earliest moment the queue head could occupy a bench slot."""
        if not self.queue:
            return None
        free_t = self.bench.earliest()
        if free_t is None:          # every slot claimed by in-flight work
            return None
        return max(free_t, self.queue[0][1])

    def _run_until(self, horizon: float) -> List[QualificationTicket]:
        done: List[QualificationTicket] = []
        while True:
            nf = self.next_finish_t()
            ns = self._next_start_t()
            # process the earliest event not beyond the horizon; landings
            # first on ties — a freed slot may let queued work start at
            # that same instant
            if nf is not None and nf <= horizon and \
                    (ns is None or nf <= ns):
                i = min(range(len(self.in_flight)),
                        key=lambda j: self.in_flight[j].finish_t)
                f = self.in_flight.pop(i)
                self._finish(f, f.finish_t)
                self.bench.push(f.finish_t)
                done.append(f.ticket)
                continue
            if ns is not None and ns <= horizon:
                free_t = self.bench.pop()
                nid, enq_t = self.queue.pop(0)
                start = max(free_t, enq_t)
                ticket = self.manager.begin_qualification(nid)
                self._publish(SweepStarted(
                    t=start, step=self._step, node_id=nid,
                    enhanced=self.manager.enhanced_sweep))
                self.in_flight.append(
                    InFlight(ticket, start, start + ticket.duration_s))
                continue
            break
        return done

    def _finish(self, f: InFlight, at: float) -> None:
        ticket = f.ticket
        outcome = self.manager.complete_qualification(ticket)
        self._tracked.discard(ticket.node_id)
        if ticket.buddy_exhausted:
            self._parked[ticket.node_id] = self.manager.spare_count
        self.completed.append(ticket)
        failures: List[str] = []
        for kind, rec in ticket.records:
            if kind == "triage":
                self._publish(TriageStage(
                    t=at, step=self._step, node_id=ticket.node_id,
                    stages=tuple(rec.stages_run), outcome=rec.outcome.value,
                    reason=rec.reason))
            else:
                failures.extend(rec.failures)
        self._publish(SweepFinished(
            t=at, step=self._step, node_id=ticket.node_id,
            outcome=outcome.value, duration_s=ticket.duration_s,
            sweeps=ticket.sweeps, failures=tuple(failures)))

    def _publish(self, ev) -> None:
        if self.bus is not None:
            self.bus.publish(ev)
