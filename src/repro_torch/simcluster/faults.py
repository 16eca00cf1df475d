"""Fault catalogue and injection model.

Each fault kind reproduces a §3 degradation pattern:

  THERMAL       cooling deficiency -> device temp target rises -> Table-2
                downclocking (compute straggler)
  POWER         power-delivery deficit: 10-15% low draw, full utilization,
                reduced sustained FLOPS (§3.3)
  MEM_ECC       marginal memory: stalls, reduced effective bandwidth
  NIC_DOWN      adapter dead; traffic reroutes via link 0 (§3.2, Table 1)
  NIC_DEGRADED  lossy/downtrained link: reduced bandwidth + error counters
  HOST_CPU      bad CPU allocation/frequency settings (Fig. 2)
  CONGESTION    transient fabric congestion: short comm spikes, NOT a node
                fault (the detector must not quarantine for these)
  FAIL_STOP     hard crash — the fail-fast class traditional checks catch
  COLLECTIVE_HANG  a rank wedges around a blocking collective (CCL-D's
                hang class): device -1 = stuck BEFORE the collective
                (never enters), device >= 0 = deadlocked INSIDE it with
                error-counter creep on the stuck channel. The job's
                barrier never completes — steps stop, no crash
  NIC_BROWNOUT  intermittent link brownout: heavy downtraining + error
                bursts; severe episodes (severity >= BROWNOUT_HANG_SEV)
                wedge the in-flight collective outright

Grey (fail-slow) faults carry an ESCALATION clock: unmitigated, a degrading
component eventually hard-fails. This is what gives proactive removal its
MTTF benefit (§7.2): pulling a grey node early prevents the later crash.

The injector is event-driven: Poisson arrivals are pre-sampled as per-kind
exponential next-arrival clocks, and every future state change (arrival,
transient expiry, escalation, scheduled scenario injection) lives on one
time-ordered heap. ``tick`` pops only the events that actually fire inside
the interval, and active faults are indexed per node and counted per kind
in fleet-width arrays — so per-window cost scales with fired events, not
with the monotonically growing fault history, and ``next_change_t`` gives
the sim engine an exact horizon for batching whole windows of steps.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.simcluster.node import Fleet


class FaultKind(enum.Enum):
    THERMAL = "thermal"
    POWER = "power"
    MEM_ECC = "mem_ecc"
    NIC_DOWN = "nic_down"
    NIC_DEGRADED = "nic_degraded"
    HOST_CPU = "host_cpu"
    CONGESTION = "congestion"
    FAIL_STOP = "fail_stop"
    COLLECTIVE_HANG = "collective_hang"
    NIC_BROWNOUT = "nic_brownout"


GREY_KINDS = (FaultKind.THERMAL, FaultKind.POWER, FaultKind.MEM_ECC,
              FaultKind.NIC_DOWN, FaultKind.NIC_DEGRADED, FaultKind.HOST_CPU)

# hang-capable kinds and the Fleet.hang_phase values they induce
# (repro_torch.ccltrace taxonomy: a never-entering rank outranks a stalled one)
HANG_KINDS = (FaultKind.COLLECTIVE_HANG, FaultKind.NIC_BROWNOUT)
HANG_NONE, HANG_STALLED, HANG_NEVER_ENTER = 0, 1, 2
# brownout severity at or above which the in-flight collective wedges
# (below it the link is merely slow — the z-score path's territory)
BROWNOUT_HANG_SEV = 0.55

# which remediation stages can clear which fault kinds (triage FSM model)
REMEDIATION_FIX: Dict[str, tuple] = {
    "gpu_reset": (FaultKind.THERMAL,),            # driver reset re-seats clocks
    "nic_reset": (FaultKind.NIC_DEGRADED, FaultKind.NIC_BROWNOUT),
    "reboot": (FaultKind.THERMAL, FaultKind.NIC_DEGRADED, FaultKind.HOST_CPU,
               FaultKind.MEM_ECC, FaultKind.COLLECTIVE_HANG,
               FaultKind.NIC_BROWNOUT),
    "reimage": (FaultKind.THERMAL, FaultKind.NIC_DEGRADED, FaultKind.HOST_CPU,
                FaultKind.MEM_ECC, FaultKind.NIC_DOWN,
                FaultKind.COLLECTIVE_HANG, FaultKind.NIC_BROWNOUT),
}
# probability each stage actually clears an eligible fault
REMEDIATION_P = {"gpu_reset": 0.5, "nic_reset": 0.5, "reboot": 0.6,
                 "reimage": 0.8}


@dataclasses.dataclass
class Fault:
    fid: int
    kind: FaultKind
    node: int
    device: int                      # device/link index (-1: node-level)
    severity: float                  # kind-specific magnitude in [0, 1]
    t_start: float
    t_end: Optional[float]           # None = persistent until remediated
    escalate_at: Optional[float]     # grey -> fail-stop time (None = never)
    active: bool = True
    t_cleared: Optional[float] = None  # when the fault actually reverted
    # (injector clock at revert; None while active — benchmark ground
    # truth for was-this-node-faulty-at-time-t queries)

    def active_at(self, t: float) -> bool:
        if t < self.t_start:
            return False
        return self.t_cleared is None or t < self.t_cleared


@dataclasses.dataclass(frozen=True)
class FaultRates:
    """Poisson arrival rates, events per node-hour (fitted so an unmanaged
    multi-week run degrades the way §3/§7 describes: total grey arrival
    ~3.3e-3/node-h, background hard-failure ~4.7e-4/node-h)."""
    thermal: float = 1.0e-3
    power: float = 0.6e-3
    mem_ecc: float = 0.4e-3
    nic_down: float = 0.4e-3
    nic_degraded: float = 0.6e-3
    host_cpu: float = 0.3e-3
    congestion: float = 3.0e-2       # transient, short-lived
    fail_stop: float = 4.7e-4        # background hard-failure rate
    # hang-class arrivals default OFF: they freeze the job's collective,
    # so runs opt in via scenarios or explicit rates (and rate-0 kinds
    # draw no rng, keeping pre-existing runs bit-identical)
    collective_hang: float = 0.0
    nic_brownout: float = 0.0
    # mean time for an unmitigated grey fault to escalate to fail-stop
    escalation_mean_s: float = 90 * 3600.0
    # fraction of freshly provisioned nodes that are grey on arrival
    # (they passed burn-in — §5.1)
    admission_grey_p: float = 0.08

    def rate_of(self, kind: FaultKind) -> float:
        return {
            FaultKind.THERMAL: self.thermal,
            FaultKind.POWER: self.power,
            FaultKind.MEM_ECC: self.mem_ecc,
            FaultKind.NIC_DOWN: self.nic_down,
            FaultKind.NIC_DEGRADED: self.nic_degraded,
            FaultKind.HOST_CPU: self.host_cpu,
            FaultKind.CONGESTION: self.congestion,
            FaultKind.FAIL_STOP: self.fail_stop,
            FaultKind.COLLECTIVE_HANG: self.collective_hang,
            FaultKind.NIC_BROWNOUT: self.nic_brownout,
        }[kind]


# heap event ops
_EXPIRE = "expire"
_ESCALATE = "escalate"
_INJECT = "inject"           # pre-scheduled (scenario-layer) injection


class FaultInjector:
    def __init__(self, fleet: Fleet, rates: Optional[FaultRates] = None,
                 seed: int = 1):
        self.fleet = fleet
        self.rates = rates or FaultRates()
        self.rng = np.random.RandomState(seed)
        self.faults: List[Fault] = []            # full history (audit only)
        self._next_id = itertools.count()
        self._seq = itertools.count()            # heap tie-break
        # future state changes: (t, seq, op, payload)
        self._heap: List[Tuple[float, int, str, object]] = []
        # per-kind Poisson next-arrival clocks (exponential inter-arrivals,
        # rescaled when the active-set size changes — memorylessness makes
        # that exact); (time, seq) so merge order with the heap is total
        self._arrival: Dict[FaultKind, Tuple[float, int]] = {}
        self._n_active = -1                      # -1: clocks not seeded yet
        # active-fault indexes: per node for revert ops, per kind for O(1)
        # error-signal queries
        self._by_node: Dict[int, List[Fault]] = {}
        self._kind_count: Dict[FaultKind, np.ndarray] = {
            k: np.zeros(fleet.n, dtype=np.int64) for k in FaultKind}
        # transient congestion multiplies a node's comm time; maintained
        # incrementally (multiply on arrival, divide on expiry, snapped
        # back to exactly 1.0 when a node's active-congestion count hits
        # zero) so one event costs O(1), not an O(N) rebuild
        self.congestion_factor = np.ones(fleet.n)
        self._cong_count = np.zeros(fleet.n, dtype=np.int64)
        # injector clock: the latest sim time this injector has seen;
        # stamps Fault.t_cleared for audit/ground-truth queries
        self.t_last = 0.0

    # --------------------------------------------------------- creation

    def inject(self, kind: FaultKind, node: int, now: float = 0.0,
               severity: Optional[float] = None,
               device: Optional[int] = None,
               duration_s: Optional[float] = None) -> Fault:
        """Deterministic manual fault injection (benchmarks/tests/scenarios).

        ``duration_s`` bounds the fault in time (auto-revert; used by the
        scenario layer for e.g. maintenance windows); time-bounded faults
        do not escalate."""
        return self._mk(kind, node, now, severity, device,
                        duration_s=duration_s)

    def schedule(self, kind: FaultKind, node: int, at: float,
                 severity: Optional[float] = None,
                 device: Optional[int] = None,
                 duration_s: Optional[float] = None) -> None:
        """Pre-schedule an injection at absolute sim time ``at`` (the
        scenario layer's primitive for correlated future events)."""
        spec = (kind, int(node), severity, device, duration_s)
        heapq.heappush(self._heap, (at, next(self._seq), _INJECT, spec))

    def _mk(self, kind: FaultKind, node: int, now: float,
            severity: Optional[float] = None,
            device: Optional[int] = None,
            duration_s: Optional[float] = None) -> Fault:
        r = self.rates
        dev = int(self.rng.randint(self.fleet.d)) if device is None \
            else int(device)
        sev = severity if severity is not None else float(
            np.clip(self.rng.beta(2, 3), 0.05, 0.95))
        t_end = None
        esc = None
        if duration_s is not None:
            t_end = now + float(duration_s)
        elif kind == FaultKind.CONGESTION:
            t_end = now + float(self.rng.uniform(30, 180))
        elif kind in GREY_KINDS:
            esc = now + float(self.rng.exponential(r.escalation_mean_s))
        self.t_last = max(self.t_last, now)
        f = Fault(next(self._next_id), kind, node, dev, sev, now, t_end, esc)
        self.faults.append(f)
        self._register(f)
        self._apply(f)
        if t_end is not None:
            heapq.heappush(self._heap, (t_end, next(self._seq), _EXPIRE, f))
        elif esc is not None:
            heapq.heappush(self._heap, (esc, next(self._seq), _ESCALATE, f))
        return f

    @staticmethod
    def _cong_mult(severity: float) -> float:
        return 1.0 + 0.5 + 1.5 * severity

    def _register(self, f: Fault) -> None:
        self._by_node.setdefault(f.node, []).append(f)
        self._kind_count[f.kind][f.node] += 1
        if f.kind == FaultKind.CONGESTION:
            self._cong_count[f.node] += 1
            self.congestion_factor[f.node] *= self._cong_mult(f.severity)
        elif f.kind in HANG_KINDS:
            self._refresh_hang(f.node)

    def _unregister(self, f: Fault) -> None:
        lst = self._by_node.get(f.node)
        if lst is not None and f in lst:
            lst.remove(f)
        self._kind_count[f.kind][f.node] -= 1
        if f.kind == FaultKind.CONGESTION:
            self._cong_count[f.node] -= 1
            if self._cong_count[f.node] == 0:
                self.congestion_factor[f.node] = 1.0   # exact recovery
            else:
                self.congestion_factor[f.node] /= self._cong_mult(f.severity)
        elif f.kind in HANG_KINDS:
            self._refresh_hang(f.node)

    def _refresh_hang(self, node: int) -> None:
        """Recompute one node's hang phase from its remaining active
        hang-class faults (never-enter outranks stalled)."""
        phase = HANG_NONE
        for f in self.active_faults(node):
            if f.kind == FaultKind.COLLECTIVE_HANG:
                phase = max(phase, HANG_NEVER_ENTER if f.device < 0
                            else HANG_STALLED)
            elif (f.kind == FaultKind.NIC_BROWNOUT
                  and f.severity >= BROWNOUT_HANG_SEV):
                phase = max(phase, HANG_STALLED)
        self.fleet.hang_phase[node] = phase
        self.fleet.state_version += 1

    def _apply(self, f: Fault) -> None:
        fl = self.fleet
        k, n, d, s = f.kind, f.node, f.device, f.severity
        if k == FaultKind.THERMAL:
            # severity -> target temperature 65..90 °C
            fl.temp_target[n, d] = 65.0 + 25.0 * s
            fl.mark_thermal_dirty()
        elif k == FaultKind.POWER:
            fl.power_factor[n, d] = 1.0 - (0.08 + 0.12 * s)   # 8-20% deficit
            fl.refresh_node_perf(n)
        elif k == FaultKind.MEM_ECC:
            fl.mem_factor[n, d] = 1.0 - (0.05 + 0.15 * s)
            fl.refresh_node_perf(n)
        elif k == FaultKind.NIC_DOWN:
            fl.nic_up[n, d] = False
            fl.nic_err_count[n, d] += 1000
            fl.invalidate_link_state(node=n)
        elif k == FaultKind.NIC_DEGRADED:
            fl.nic_quality[n, d] = 1.0 - (0.2 + 0.5 * s)
            fl.invalidate_link_state(node=n)
        elif k == FaultKind.HOST_CPU:
            fl.host_factor[n] = 1.0 - (0.2 + 0.4 * s)
        elif k == FaultKind.CONGESTION:
            pass                     # factor maintained by _register
        elif k == FaultKind.FAIL_STOP:
            fl.alive[n] = False
        elif k == FaultKind.COLLECTIVE_HANG:
            # hang_phase maintained by _register/_refresh_hang; a rank
            # deadlocked INSIDE the collective (device >= 0) leaves
            # observable error-counter creep on the stuck channel — the
            # evidence the watchdog's entered-and-stalled verdict needs
            if d >= 0:
                fl.nic_err_count[n, d] += 400
                fl.invalidate_link_state(node=n)
        elif k == FaultKind.NIC_BROWNOUT:
            fl.nic_quality[n, d] = 1.0 - (0.45 + 0.45 * s)
            fl.nic_err_count[n, d] += 200 + 600 * s
            fl.invalidate_link_state(node=n)

    def _revert(self, f: Fault, at: Optional[float] = None) -> None:
        if not f.active:
            return
        f.t_cleared = self.t_last if at is None else at
        fl = self.fleet
        k, n, d = f.kind, f.node, f.device
        if k == FaultKind.THERMAL:
            fl.temp_target[n, d] = fl.hw.load_temp_c
            fl.mark_thermal_dirty()
        elif k == FaultKind.POWER:
            fl.power_factor[n, d] = 1.0
            fl.refresh_node_perf(n)
        elif k == FaultKind.MEM_ECC:
            fl.mem_factor[n, d] = 1.0
            fl.refresh_node_perf(n)
        elif k == FaultKind.NIC_DOWN:
            fl.nic_up[n, d] = True
            fl.invalidate_link_state(node=n)
        elif k == FaultKind.NIC_DEGRADED:
            fl.nic_quality[n, d] = 1.0
            fl.invalidate_link_state(node=n)
        elif k == FaultKind.HOST_CPU:
            fl.host_factor[n] = 1.0
        elif k == FaultKind.CONGESTION:
            pass                     # factor maintained by _unregister
        elif k == FaultKind.COLLECTIVE_HANG:
            pass                     # hang_phase maintained by _unregister
        elif k == FaultKind.NIC_BROWNOUT:
            fl.nic_quality[n, d] = 1.0
            fl.invalidate_link_state(node=n)
        f.active = False
        self._unregister(f)

    # ----------------------------------------------------- arrival clocks

    def _sample_arrival(self, kind: FaultKind, now: float) -> None:
        rate_s = self.rates.rate_of(kind) * self._n_active / 3600.0
        if rate_s <= 0.0:
            self._arrival[kind] = (math.inf, next(self._seq))
        else:
            self._arrival[kind] = (
                now + float(self.rng.exponential(1.0 / rate_s)),
                next(self._seq))

    def _set_active_count(self, n: int, now: float) -> None:
        """(Re)scale the per-kind arrival clocks to the active-set size.

        An exponential clock conditioned on not having fired is still
        exponential, so remaining time scales by old_n/new_n exactly."""
        if n == self._n_active:
            return
        old = self._n_active
        self._n_active = n
        for kind in FaultKind:
            t, seq = self._arrival.get(kind, (math.inf, -1))
            if old <= 0 or not math.isfinite(t) or n <= 0:
                if n <= 0:
                    self._arrival[kind] = (math.inf, next(self._seq))
                else:
                    self._sample_arrival(kind, now)
            else:
                self._arrival[kind] = (now + (t - now) * old / n, seq)

    def prime(self, now: float, active_nodes: np.ndarray) -> None:
        """Seed/rescale the arrival clocks without firing anything: the
        window engine must know the true event horizon BEFORE the first
        tick of a batch (matching the clock state a per-step loop would
        have after its first tick)."""
        self.t_last = max(self.t_last, now)
        if self._n_active < 0:
            self._n_active = 0
        self._set_active_count(len(active_nodes), now)

    def next_change_t(self) -> Optional[float]:
        """Earliest future time anything about the fleet state changes:
        the sim engine batches whole windows of steps up to this horizon."""
        # drop stale heap entries (faults already reverted by other paths)
        h = self._heap
        while h and h[0][2] in (_EXPIRE, _ESCALATE) and not h[0][3].active:
            heapq.heappop(h)
        t = h[0][0] if h else math.inf
        for at, _ in self._arrival.values():
            t = min(t, at)
        return None if not math.isfinite(t) else t

    # ------------------------------------------------------------ tick

    def tick(self, now: float, dt_s: float, active_nodes: np.ndarray) -> None:
        """Fire every pre-sampled event in (now, now+dt]: Poisson
        arrivals, transient expiries, grey escalations and scheduled
        scenario injections, in global time order. Cost is O(events
        fired), independent of how many faults have ever existed."""
        t_end = now + dt_s
        self.t_last = max(self.t_last, t_end)
        if self._n_active < 0:
            self._n_active = 0
        self._set_active_count(len(active_nodes), now)
        while True:
            # next arrival across kinds vs. next heap event, merged by
            # (time, seq) so processing order is deterministic
            akind = None
            at, aseq = math.inf, -1
            for kind, (t, seq) in self._arrival.items():
                if (t, seq) < (at, aseq) or akind is None:
                    at, aseq, akind = t, seq, kind
            ht, hseq = (self._heap[0][0], self._heap[0][1]) if self._heap \
                else (math.inf, -1)
            if min(at, ht) > t_end:
                break
            if (at, aseq) <= (ht, hseq):
                # Poisson arrival lands on a random active node
                if len(active_nodes):
                    node = int(self.rng.choice(active_nodes))
                    self._mk(akind, node, at)
                self._sample_arrival(akind, at)
            else:
                _, _, op, payload = heapq.heappop(self._heap)
                if op == _INJECT:
                    kind, node, sev, dev, dur = payload
                    self._mk(kind, node, ht, sev, dev, duration_s=dur)
                elif op == _EXPIRE:
                    self._revert(payload, at=ht)
                elif op == _ESCALATE and payload.active:
                    self._revert(payload, at=ht)
                    self._mk(FaultKind.FAIL_STOP, payload.node, ht,
                             severity=1.0)

    # ----------------------------------------------------- queries/ops

    def active_faults(self, node: Optional[int] = None) -> List[Fault]:
        if node is not None:
            return [f for f in self._by_node.get(node, ()) if f.active]
        return [f for lst in self._by_node.values() for f in lst if f.active]

    def node_error_signals(self, node: int):
        """Actionable evidence for triage routing (O(1) via kind counts)."""
        from repro_torch.core.triage import ErrorSignals
        kc = self._kind_count
        gpu = bool(kc[FaultKind.THERMAL][node] + kc[FaultKind.MEM_ECC][node])
        nic = bool(kc[FaultKind.NIC_DOWN][node] +
                   kc[FaultKind.NIC_DEGRADED][node] +
                   kc[FaultKind.NIC_BROWNOUT][node])
        host = bool(kc[FaultKind.HOST_CPU][node] +
                    kc[FaultKind.COLLECTIVE_HANG][node])
        return ErrorSignals(gpu_errors=gpu, nic_errors=nic,
                            host_errors=host)

    def remediate(self, node: int, stage: str) -> None:
        """Apply a triage stage: eligible faults clear with stage-specific
        probability (models the paper's escalating-invasiveness ladder)."""
        eligible = REMEDIATION_FIX.get(stage, ())
        p = REMEDIATION_P.get(stage, 0.5)
        for f in self.active_faults(node):
            if f.kind in eligible and self.rng.rand() < p:
                self._revert(f)

    def clear_node(self, node: int) -> None:
        """Node replaced: all its faults go with the hardware."""
        for f in self.active_faults(node):
            self._revert(f)

    def seed_admission_grey(self, node: int, now: float) -> Optional[Fault]:
        """Fresh hardware that passed burn-in may still be grey (§5.1)."""
        if self.rng.rand() < self.rates.admission_grey_p:
            kind = self.rng.choice(
                [FaultKind.THERMAL, FaultKind.POWER, FaultKind.MEM_ECC,
                 FaultKind.NIC_DEGRADED])
            return self._mk(kind, node, now)
        return None
