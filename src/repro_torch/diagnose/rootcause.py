# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Root-cause classification and routing for flagged nodes.

The what-if engine says *how much* each node delays the job; the
classifier says *why*, so the closed loop routes each flagged node into
the correct lane instead of treating every latch as an eviction:

  compute_degraded   own compute time in sustained excess (thermal
                     throttle, power deficit, marginal memory) -> GPU
                     remediation lane
  comm_degraded      own exposed-communication time in sustained excess
                     (downed/downtrained NIC) -> NIC remediation lane
  data_stall         host/data-pipeline time in excess (bad CPU
                     settings, input starvation) -> host lane
  cascade_victim     no own excess, but barrier stall: the node is
                     WAITING on a degraded peer in its collective group.
                     Watched, never evicted (evicting it would both lose
                     a healthy node and leave the culprit in the job).
  undiagnosed        flagged with no attributable own excess — e.g. a
                     transient fabric-congestion spike (comm excess that
                     is not sustained across the trace, or shared by a
                     large fleet fraction at once). Watched.
  hang_culprit       the ccltrace watchdog accused this node of wedging
                     a blocking collective (never entered, or entered
                     with independent link evidence) -> evicted; triage
                     starts in the NIC lane with link evidence, the host
                     lane otherwise
  hang_victim        arrived at the collective and blocked on the
                     barrier behind a hang culprit. Watched, never
                     evicted (same logic as cascade_victim: pulling it
                     loses a healthy node and fixes nothing)

The z-score lanes key on the ``TimingTrace`` decomposition + what-if
blame; the hang lanes are recorded by ``Diagnoser.record_hang`` from
``repro_torch.ccltrace`` watchdog verdicts — hangs produce no step samples,
so they can never arrive through ``diagnose``.

Classification keys on the ``TimingTrace`` decomposition + what-if blame
and is sharpened by the detector's sustained hardware-signal masks
(thermal/frequency/power for the GPU lane, NIC error-delta/throughput
for the network lane). Diagnoses are exported as rich ``ErrorSignals``
so offline triage starts in the right remediation lane instead of
early-terminating nodes whose substrate reports no error counters.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.detector import FleetAssessment
from repro_torch.core.policy import Action, Decision
from repro_torch.core.telemetry import Frame
from repro_torch.core.triage import ErrorSignals
from repro_torch.diagnose.trace import TimingTrace
from repro_torch.diagnose.whatif import (Topology, fast_median,
                                         row_median, whatif)


class RootCause(enum.Enum):
    COMPUTE_DEGRADED = "compute_degraded"
    COMM_DEGRADED = "comm_degraded"
    DATA_STALL = "data_stall"
    CASCADE_VICTIM = "cascade_victim"
    UNDIAGNOSED = "undiagnosed"
    HANG_CULPRIT = "hang_culprit"
    HANG_VICTIM = "hang_victim"


# causes that must be WATCHED, not evicted: the node itself is (as far
# as attribution can tell) healthy
HOLD_CAUSES = (RootCause.CASCADE_VICTIM, RootCause.UNDIAGNOSED,
               RootCause.HANG_VICTIM)

# detector support masks backing each lane
_GPU_SUPPORT = ("gpu_temp", "gpu_freq", "gpu_power")
_NIC_SUPPORT = ("nic_errors", "nic_tx_rate", "nic_up")


@dataclasses.dataclass(frozen=True)
class RootCauseConfig:
    blame_floor: float = 0.04     # relative blame to call a culprit
    stall_floor: float = 0.04     # stall share of wall -> cascade victim
    component_floor: float = 0.02 # relative per-row excess that counts
    sustain_frac: float = 0.6     # comm-excess row fraction; below =
                                  # transient (congestion, not the NIC)
    fabric_share: float = 0.30    # fleet share with simultaneous comm
                                  # excess -> fabric-wide, not node-level
    min_windows: int = 2          # trace rows required to diagnose


@dataclasses.dataclass
class Diagnosis:
    """One node's attribution verdict for one evaluation window."""

    node_id: int
    root_cause: RootCause
    blame: float                  # standalone what-if excess, seconds
    blame_rel: float              # blame / healthy reference
    marginal: float               # leave-one-out fleet delta, seconds
    stall_share: float            # barrier wait / wall
    evidence: Tuple[str, ...]
    t: float
    step: int

    @property
    def held(self) -> bool:
        return self.root_cause in HOLD_CAUSES

    def to_error_signals(self) -> ErrorSignals:
        rc = self.root_cause
        # hang culprits route by their evidence: link evidence -> NIC
        # lane (nic_reset first), never-entered/wedged -> host lane
        # (reboot unwedges a stuck process)
        hang_nic = rc is RootCause.HANG_CULPRIT and \
            any("link" in e or "nic" in e for e in self.evidence)
        return ErrorSignals(
            gpu_errors=rc == RootCause.COMPUTE_DEGRADED,
            nic_errors=rc == RootCause.COMM_DEGRADED or hang_nic,
            host_errors=rc == RootCause.DATA_STALL or
            (rc is RootCause.HANG_CULPRIT and not hang_nic),
            root_cause=rc.value,
            detail="; ".join(self.evidence))


class FleetDiagnosis:
    """One window's attribution over the fleet (flagged nodes only get
    materialized ``Diagnosis`` records; arrays cover everyone)."""

    __slots__ = ("node_ids", "blame", "blame_rel", "marginal",
                 "stall_share", "records", "new_records")

    def __init__(self, node_ids: np.ndarray, blame: np.ndarray,
                 blame_rel: np.ndarray, marginal: np.ndarray,
                 stall_share: np.ndarray,
                 records: Dict[int, Diagnosis],
                 new_records: List[Diagnosis]):
        self.node_ids = node_ids
        self.blame = blame
        self.blame_rel = blame_rel
        self.marginal = marginal
        self.stall_share = stall_share
        self.records = records           # node_id -> Diagnosis (flagged)
        self.new_records = new_records   # new/changed verdicts this window

    def cause_of(self, node_id: int) -> Optional[RootCause]:
        rec = self.records.get(int(node_id))
        return rec.root_cause if rec is not None else None

    def reroute(self, decision: Decision) -> Decision:
        """The Diagnoser stage between detector and policy: mitigation
        decisions against held causes (victims / undiagnosed transients)
        are downgraded to watching — the node stays in the job."""
        if decision.action not in (Action.DEFER_TO_CHECKPOINT,
                                   Action.IMMEDIATE_RESTART):
            return decision
        rec = self.records.get(decision.node_id)
        if rec is None or not rec.held:
            return decision
        return Decision(
            decision.node_id, Action.PENDING_VERIFICATION,
            f"watched ({rec.root_cause.value}): {decision.reason}",
            decision.slowdown)


class Diagnoser:
    """Stateful attribution stage: trace + topology in, diagnoses out.

    One instance serves one job. ``diagnose`` runs once per evaluation
    window (only when something is flagged — quiet windows cost nothing)
    and keeps the latest per-node verdicts for the health manager's
    hold-check and for triage signal enrichment."""

    def __init__(self, trace: TimingTrace,
                 topology: Optional[Topology] = None,
                 cfg: Optional[RootCauseConfig] = None):
        self.trace = trace
        self.topology = topology
        self.cfg = cfg or RootCauseConfig()
        self.last: Dict[int, Diagnosis] = {}    # survives eviction (triage)
        self._emitted: Dict[int, RootCause] = {}
        self.last_fleet: Optional[FleetDiagnosis] = None
        self.windows_diagnosed = 0
        self.last_cost_s = 0.0
        # per-row comm-deviation cache aligned with the trace's circular
        # buffer: a row's peer-median comparison never changes once
        # written, so steady state re-medians one new row per window
        # instead of the whole (depth, N) buffer
        self._comm_gen = -1
        self._comm_seen = 0                     # trace.pushes consumed
        self._comm_dev: Optional[np.ndarray] = None   # (depth, N) bool
        # steady-state verdict reuse: when the flagged set and its cause
        # codes repeat, last window's record dict is returned as-is
        self._prev_fi: Optional[np.ndarray] = None
        self._prev_causes: Optional[np.ndarray] = None
        self._prev_ids: Optional[np.ndarray] = None
        self._prev_records: Dict[int, Diagnosis] = {}

    # ------------------------------------------------------------- core

    def diagnose(self, frame: Frame,
                 fleet: FleetAssessment) -> Optional[FleetDiagnosis]:
        flagged_idx = fleet.flagged_indices()
        if not flagged_idx.size:
            self.last_fleet = None
            # nodes that cleared may re-flag later: re-emit then
            self._emitted.clear()
            self._prev_fi = None
            return None
        trace = self.trace
        if len(trace) < self.cfg.min_windows or \
                not np.array_equal(trace.node_ids, frame.node_ids):
            self.last_fleet = None
            return None

        t0 = time.perf_counter()
        cfg = self.cfg
        comp = trace.mean("compute")
        comm = trace.mean("comm")
        host = trace.mean("host")
        stall = trace.mean("stall")
        own = comp + comm + host
        topo = self.topology or Topology.single(len(own))
        rep = whatif(own, topo, ref_own=fast_median(own))
        wall = own + stall
        np.maximum(wall, 1e-9, out=wall)
        stall_share = np.divide(stall, wall, out=wall)

        # dominant component: excess of each channel mean over the
        # fleet's healthy median. The medians are fleet-wide scalars but
        # the comparison only matters for flagged rows, so the
        # elementwise part runs on the O(flagged) gather; the nested
        # where matches argmax's first-max tie-breaking
        fi = flagged_idx
        e0 = comp[fi] - fast_median(comp)
        e1 = comm[fi] - fast_median(comm)
        e2 = host[fi] - fast_median(host)
        dm = np.where(e2 > np.maximum(e0, e1), np.int8(2),
                      np.where(e1 > e0, np.int8(1), np.int8(0)))

        # comm transience: sustained excess must cover >= sustain_frac
        # of the kept windows AND still be present in the LATEST window
        # (a congestion burst that already expired keeps polluting the
        # trace means for depth windows — it must not read as a bad
        # NIC); a fabric-wide simultaneous excess is congestion too.
        # The newest cached row IS the latest window's deviation mask.
        comm_sustain = self._comm_sustain()
        last_dev = self._comm_dev[trace.last_row]
        fabric_wide = (np.count_nonzero(last_dev) >=
                       cfg.fabric_share * last_dev.size)

        # ---- vectorized verdicts over the flagged rows
        br = rep.blame_rel[fi]
        ss = stall_share[fi]
        culprit = br >= cfg.blame_floor
        # the flagged rows' support bits, in flagged order: the host copy
        # the assessment already made this window (the masks themselves
        # stay on the detector's device)
        sup = {m: fleet.flagged_support(m)
               for m in _GPU_SUPPORT + _NIC_SUPPORT}
        gpu_any = np.zeros(len(fi), bool)
        nic_any = np.zeros(len(fi), bool)
        for m in _GPU_SUPPORT:
            gpu_any |= sup[m]
        for m in _NIC_SUPPORT:
            nic_any |= sup[m]
        C = RootCause
        causes = np.full(len(fi), 0, dtype=np.int8)  # 0 = UNDIAGNOSED
        code = {C.UNDIAGNOSED: 0, C.COMPUTE_DEGRADED: 1,
                C.COMM_DEGRADED: 2, C.DATA_STALL: 3, C.CASCADE_VICTIM: 4}
        by_code = {v: k for k, v in code.items()}
        causes[culprit & (dm == 0)] = code[C.COMPUTE_DEGRADED]
        causes[culprit & (dm == 2)] = code[C.DATA_STALL]
        comm_ok = culprit & (dm == 1) & last_dev[fi] & \
            (comm_sustain[fi] >= cfg.sustain_frac) & (not fabric_wide)
        causes[comm_ok] = code[C.COMM_DEGRADED]
        rest = ~culprit
        causes[rest & (ss >= cfg.stall_floor)] = code[C.CASCADE_VICTIM]
        presym = rest & (ss < cfg.stall_floor)
        causes[presym & gpu_any & ~nic_any] = code[C.COMPUTE_DEGRADED]
        causes[presym & nic_any & ~gpu_any] = code[C.COMM_DEGRADED]

        if (self._prev_fi is not None
                and np.array_equal(fi, self._prev_fi)
                and np.array_equal(causes, self._prev_causes)
                and np.array_equal(frame.node_ids, self._prev_ids)):
            # steady state: same flagged rows, same verdict codes — last
            # window's record dict is the answer, no per-node loop
            records = self._prev_records
            new_records: List[Diagnosis] = []
        else:
            records = {}
            new_records = []
            for k, i in enumerate(fi):
                i = int(i)
                nid = int(frame.node_ids[i])
                cause = by_code[int(causes[k])]
                prev = self.last.get(nid)
                if self._emitted.get(nid) == cause and prev is not None \
                        and prev.root_cause is cause:
                    # verdict unchanged for this node — reuse the record
                    # (evidence strings only materialize on change)
                    records[nid] = prev
                    continue
                rec = self._materialize(
                    nid, cause, rep.blame[i], br[k], rep.marginal[i],
                    ss[k], bool(culprit[k]), int(dm[k]), comm_sustain[i],
                    fabric_wide, bool(last_dev[i]), gpu_any[k],
                    nic_any[k], sup, k, frame)
                records[nid] = rec
                self.last[nid] = rec
                self._emitted[nid] = cause
                new_records.append(rec)
            # forget emission state for nodes no longer flagged
            # (re-emits on a later re-flag); keep ``last`` so triage can
            # still read it
            for nid in list(self._emitted):
                if nid not in records:
                    del self._emitted[nid]
            self._prev_fi = fi.copy()
            self._prev_causes = causes.copy()
            self._prev_ids = frame.node_ids.copy()
            self._prev_records = records

        out = FleetDiagnosis(frame.node_ids, rep.blame, rep.blame_rel,
                             rep.marginal, stall_share, records,
                             new_records)
        self.last_fleet = out
        self.windows_diagnosed += 1
        self.last_cost_s = time.perf_counter() - t0
        return out

    def _comm_sustain(self) -> np.ndarray:
        """(N,) fraction of kept trace windows with per-row comm excess.

        Each circular-buffer row's peer-median comparison is frozen once
        the row is written, so the (depth, N) deviation mask is cached
        and only rows pushed since the last diagnose are re-medianed —
        one row per window in steady state instead of the whole buffer."""
        trace, cfg = self.trace, self.cfg
        raw = trace.rows_raw("comm")                  # (depth, N)
        depth, used = trace.depth, len(trace)
        delta = trace.pushes - self._comm_seen
        rebuild = (self._comm_gen != trace.generation
                   or self._comm_dev is None
                   or self._comm_dev.shape != raw.shape
                   or trace.last_backfill is not None
                   or delta >= used or not trace.full)
        if rebuild:
            self._comm_gen = trace.generation
            sub = raw[:used]
            dev = sub > row_median(sub) * (1.0 + cfg.component_floor)
            if self._comm_dev is None or \
                    self._comm_dev.shape != raw.shape:
                self._comm_dev = np.empty(raw.shape, bool)
            self._comm_dev[:used] = dev
            self._comm_count = dev.sum(0, dtype=np.int16)  # rolling
        elif delta == 1:
            # steady state: one new row replaced one old row (row_median
            # keeps the comparison bit-identical to the rebuild path)
            row = trace.last_row
            new = raw[row] > row_median(raw[row:row + 1])[0] * \
                (1.0 + cfg.component_floor)
            self._comm_count += new
            self._comm_count -= self._comm_dev[row]
            self._comm_dev[row] = new
        else:
            rows = (trace.last_row - np.arange(delta)) % depth
            sub = raw[rows]
            dev = sub > row_median(sub) * (1.0 + cfg.component_floor)
            self._comm_count += dev.sum(0, dtype=np.int16)
            self._comm_count -= self._comm_dev[rows].sum(0,
                                                         dtype=np.int16)
            self._comm_dev[rows] = dev
        self._comm_seen = trace.pushes
        return self._comm_count.astype(np.float32) * \
            np.float32(1.0 / used)

    def _materialize(self, nid: int, cause: RootCause, blame: float,
                     blame_rel: float, marginal: float, stall_share: float,
                     culprit: bool, dominant: int, comm_sustain: float,
                     fabric_wide: bool, last_dev: bool,
                     gpu_any: bool, nic_any: bool,
                     sup: Dict[str, np.ndarray], k: int,
                     frame: Frame) -> Diagnosis:
        """Build the full record (evidence strings included) for a new
        or changed verdict — the only non-array work per window. ``sup``
        holds the flagged rows' support bits; ``k`` is this node's
        position among the flagged rows."""
        evidence: List[str] = []
        gpu_sup = [m for m in _GPU_SUPPORT if sup[m][k]]
        nic_sup = [m for m in _NIC_SUPPORT if sup[m][k]]
        if culprit:
            evidence.append(f"blame +{blame_rel:.0%} own time "
                            f"({blame:.2f}s)")
            if marginal > 0:
                evidence.append(f"fleet impact {marginal:.2f}s/step")
            if dominant == 1 and cause is RootCause.UNDIAGNOSED:
                if fabric_wide:
                    evidence.append("comm excess fabric-wide (congestion)")
                elif not last_dev:
                    evidence.append("comm excess already gone "
                                    "(expired transient)")
                else:
                    evidence.append(
                        f"comm excess transient "
                        f"({comm_sustain:.0%} of trace windows)")
            elif cause is RootCause.COMM_DEGRADED:
                evidence.extend(f"{m} deviant" for m in nic_sup)
            elif cause is RootCause.COMPUTE_DEGRADED:
                evidence.extend(f"{m} deviant" for m in gpu_sup)
        elif cause is RootCause.CASCADE_VICTIM:
            evidence.append(f"barrier stall {stall_share:.0%} of wall, "
                            f"no own excess")
        elif cause is RootCause.COMPUTE_DEGRADED:
            evidence.extend(f"{m} deviant" for m in gpu_sup)
            evidence.append("no step impact yet")
        elif cause is RootCause.COMM_DEGRADED:
            evidence.extend(f"{m} deviant" for m in nic_sup)
            evidence.append("no step impact yet")
        else:
            evidence.append("no attributable excess")
        return Diagnosis(nid, cause, float(blame), float(blame_rel),
                         float(marginal), float(stall_share),
                         tuple(evidence), frame.t, frame.step)

    # ------------------------------------------------------- hang intake

    def record_hang(self, verdict, t: float, step: int) -> List[Diagnosis]:
        """Fold one ccltrace ``HangVerdict`` into the per-node diagnosis
        state: culprits get ``HANG_CULPRIT`` (evidence-routed to the NIC
        or host triage lane), arrived-and-blocked ranks get
        ``HANG_VICTIM`` — a HOLD cause, so the health manager keeps them
        in the job. Duck-typed on the verdict so ``repro_torch.ccltrace``
        stays import-free of this package."""
        out: List[Diagnosis] = []
        victims = {int(v) for v in verdict.victims}
        base = (f"{verdict.op} group {verdict.group} overdue "
                f"{verdict.waited_s:.0f}s "
                f"(deadline {verdict.deadline_s:.0f}s)")
        for nid, role in verdict.roles.items():
            nid = int(nid)
            value = getattr(role, "value", str(role))
            if nid in victims:
                cause = RootCause.HANG_VICTIM
                detail = "arrived, blocked on the barrier"
            else:
                cause = RootCause.HANG_CULPRIT
                detail = ("never entered the collective"
                          if value == "never_entered"
                          else "entered and stalled (link evidence)")
            rec = Diagnosis(nid, cause, 0.0, 0.0, 0.0,
                            1.0 if cause is RootCause.HANG_VICTIM else 0.0,
                            (base, detail), float(t), int(step))
            self.last[nid] = rec
            self._emitted.pop(nid, None)   # a later z-flag must re-emit
            out.append(rec)
        return out

    # ---------------------------------------------------------- consumers

    def should_hold(self, node_id: int) -> bool:
        """Health-manager gate: True = keep this node in the job (its
        latest diagnosis says it is a victim / transient, not a culprit)."""
        rec = self.last.get(int(node_id))
        return rec is not None and rec.held

    def signals_for(self, node_id: int) -> Optional[ErrorSignals]:
        """Rich triage evidence from the latest diagnosis (None if the
        node was never diagnosed)."""
        rec = self.last.get(int(node_id))
        return rec.to_error_signals() if rec is not None else None

    def node_replaced(self, node_id: int) -> None:
        """A node left the job: a later node reusing the id must re-emit.
        The last diagnosis is kept — offline triage consumes it."""
        self._emitted.pop(int(node_id), None)


__all__ = ["Diagnoser", "Diagnosis", "FleetDiagnosis", "HOLD_CAUSES",
           "RootCause", "RootCauseConfig"]
