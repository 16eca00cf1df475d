"""Trainer → Guard adapter: real step timings become telemetry Frames;
the port of ``repro.guard.hook``.

``GuardStepHook`` implements the trainer's ``StepHook`` protocol
(``(step, wall_s, metrics) -> bool``). It aggregates the measured
per-step wall times into evaluation windows, builds real ``Frame``s (this
host's window-mean step time alongside its peers') and feeds them through
the session's monitor → policy → manager pipeline, whose detector scores
them on ``device`` (the fleet_score kernel on the card). When the tiered
policy fires an IMMEDIATE restart for this host's node, the hook returns
True and the trainer rewinds to its last checkpoint: the full Fig.-1
loop, driven by actual training-step measurements.

On a multi-host deployment each host reports its own barrier time and
the frames are assembled fleet-side; in the single-process setting the
hook synthesizes healthy peer timings around the measured baseline so
the peer-relative detector has a population to score against
(``n_peers``, deterministic via ``seed``: the reference's
``np.random.RandomState`` stream, so both packages build the same
frames).

If the trainer's metrics dict carries hardware telemetry (any key from
``repro_torch.core.telemetry.HARDWARE_METRICS``), the hook aggregates it
into the Frames and derives actionable ``ErrorSignals`` from the
accumulated window telemetry for triage. Without hardware telemetry it
falls back to step-time evidence for a latched node.

With ``diagnose=True`` (or a caller's ``trace=``) every window also pushes
a ``WindowTiming`` into a ``repro_torch.diagnose.TimingTrace``: this
host's measured split of the wall into compute/comm/host (the trainer's
``compute_s``/``comm_s``/``host_s`` metric keys, or ``own_split`` of the
wall), and the peers' baseline scaled by the same split. The push draws
no random numbers, so the frames stay the reference's.

``LocalHostControl`` / ``LocalSweepBackend`` are the minimal substrate
implementations for a process with no cluster control plane: swaps are
bookkeeping, restarts raise the hook's restart flag, and qualification
sweeps trivially pass (there is no hardware to probe).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.ccltrace import adaptive_deadline
from repro_torch.core.detector import DetectorConfig
from repro_torch.core.sweep import SweepReference
from repro_torch.core.telemetry import HARDWARE_METRICS, Frame
from repro_torch.core.triage import ErrorSignals
from repro_torch.device import DeviceLike
from repro_torch.diagnose import (Diagnoser, TimingTrace, Topology,
                                  WindowTiming)
from repro_torch.guard.events import HangDetected, NodeSwapped, RecoveryEvent
from repro_torch.guard.session import GuardSession, Tier


class LocalHostControl:
    """ClusterControl for a single process (no real fleet). ``t`` is the
    clock the caller advances."""

    def __init__(self, next_provision_id: int = 1000):
        self.t = 0.0
        self.swaps: List[tuple] = []
        self.restarts: List[str] = []
        self._next = next_provision_id
        # per-node evidence source (a step hook may register itself here
        # so triage sees telemetry-derived signals, not empty ones)
        self.signals_provider: \
            Optional[Callable[[int], ErrorSignals]] = None

    def swap_node(self, old: int, new: int) -> None:
        self.swaps.append((old, new))

    def restart_job(self, reason: str) -> None:
        self.restarts.append(reason)

    def provision_node(self) -> int:
        nid = self._next
        self._next += 1
        return nid

    def error_signals(self, node_id: int) -> ErrorSignals:
        if self.signals_provider is not None:
            return self.signals_provider(node_id)
        return ErrorSignals()

    def remediate(self, node_id: int, stage: str) -> None:
        pass

    def now(self) -> float:
        return self.t


class LocalSweepBackend:
    """SweepBackend stub for hosts with nothing to probe offline: every
    probe reports exactly the reference, so qualification passes."""

    def __init__(self, devices: int = 1):
        self._devices = devices
        self._ref = SweepReference(device_tflops=100.0, intra_bw_gbps=100.0,
                                   pair_step_time=1.0)

    def device_count(self, node_id: int) -> int:
        return self._devices

    def compute_probe(self, node_id: int, device: int,
                      seconds: float) -> float:
        return self._ref.device_tflops

    def intra_bw_probe(self, node_id: int, dev_a: int, dev_b: int) -> float:
        return self._ref.intra_bw_gbps

    def multi_node_probe(self, node_ids: Sequence[int],
                         steps: int) -> np.ndarray:
        return np.full(steps, self._ref.pair_step_time)

    def reference(self) -> SweepReference:
        return self._ref


@dataclasses.dataclass
class _Stall:
    """A synthetic fault window: measured wall times are scaled by
    ``factor`` for ``steps`` steps starting at ``at_step`` (simulates a
    stalled/degraded host without burning real wall-clock)."""
    at_step: int
    factor: float
    steps: int


class GuardStepHook:
    """StepHook adapter feeding trainer step timings into a GuardSession."""

    def __init__(self, session: Optional[GuardSession] = None,
                 node_id: int = 0, n_peers: int = 15,
                 window_steps: int = 6, n_spares: int = 2,
                 peer_jitter: float = 0.01, seed: int = 0,
                 warmup_windows: int = 1, baseline_alpha: float = 0.25,
                 detector_cfg: Optional[DetectorConfig] = None,
                 trace: Optional[TimingTrace] = None,
                 diagnose: bool = False,
                 own_split: Sequence[float] = (0.75, 0.15, 0.10),
                 step_deadline_s: Optional[float] = None,
                 step_deadline_mult: float = 8.0,
                 device: DeviceLike = "cuda"):
        """``device`` places the detector of a session the hook builds
        itself (a caller-supplied session keeps its own)."""
        owns_session = session is None
        if owns_session:
            control = LocalHostControl()
            diagnoser = None
            if diagnose:
                trace = trace or TimingTrace()
                diagnoser = Diagnoser(trace, Topology.single(1 + n_peers))
            session = GuardSession.from_tier(
                Tier.ONLINE, control, LocalSweepBackend(),
                detector_cfg=detector_cfg, diagnoser=diagnoser,
                device=device)
        elif diagnose:
            # a caller-supplied session owns its own wiring: silently
            # dropping the flag would run WITHOUT victim-holding while
            # the caller believes it is on
            raise ValueError(
                "diagnose=True only applies to a hook-owned session; "
                "build a Diagnoser on your GuardSession and pass its "
                "TimingTrace via trace= instead")
        self.session = session
        self.control = session.control
        self.node_id = node_id
        self.window_steps = window_steps
        self.peer_ids = [node_id + 1 + i for i in range(n_peers)]
        self.peer_jitter = peer_jitter
        # the first window(s) carry JIT compilation / cache-warm spikes;
        # real fleets re-baseline after (re)start for the same reason
        self.warmup_windows = warmup_windows
        # synthetic peers track the host's healthy drift slowly (EMA of
        # unflagged window medians) so benign whole-job slowdown is not
        # mistaken for this one node straggling
        self.baseline_alpha = baseline_alpha
        self.rng = np.random.RandomState(seed)
        # preallocated window buffer: one slot per step of the evaluation
        # window (the hook sits on the trainer's hot path)
        self._walls = np.empty(window_steps)
        self._n_walls = 0
        self._windows_seen = 0
        self._baseline: Optional[float] = None
        self._stalls: List[_Stall] = []
        self._restart_pending = False
        self._ckpt = None        # TieredCheckpointManager, bind_checkpoint
        self.frames_fed = 0
        self.restarts_requested = 0
        # liveness: a rank wedged inside a collective never finishes a
        # step, so it never produces a Frame and the detector never sees
        # it. A watchdog (timer thread, sibling process) calls
        # ``check_liveness`` on wall-clock cadence instead; the deadline
        # adapts to the healthy step baseline via the same rule the
        # ccltrace barrier watchdog uses.
        self.step_deadline_floor_s = (300.0 if step_deadline_s is None
                                      else float(step_deadline_s))
        self.step_deadline_mult = float(step_deadline_mult)
        self._last_step_t = self.control.now()
        self._last_step = 0
        self.hangs_detected = 0
        # timing-trace feed (repro_torch.diagnose): measured wall split
        # into compute/comm/host via trainer-supplied component seconds
        # ("compute_s"/"comm_s"/"host_s" metric keys) or ``own_split``
        self.trace = trace
        self.own_split = tuple(own_split)
        self._comp_sums = np.zeros(3)
        # hardware telemetry accumulated from the trainer's metrics dict
        # (HARDWARE_METRICS keys): window sums + per-metric sample counts
        # (exporters often report at a lower cadence than the step loop)
        # -> means -> Frame columns + triage ErrorSignals
        self._hw_sums: Dict[str, float] = {}
        self._hw_counts: Dict[str, int] = {}
        self._hw_last: Dict[str, float] = {}
        self._hw_base: Dict[str, float] = {}
        # evidence snapshots for node ids this host reported under that
        # were swapped out (offline triage queries them AFTER the swap)
        self._evicted_signals: Dict[int, ErrorSignals] = {}

        # register the synthetic population only on a session we built
        # ourselves: a caller-supplied session already has real node
        # pools, and re-registering in-job ids as spares would corrupt
        # them (the caller must register node_id and the peer ids)
        if owns_session:
            session.register_active([node_id, *self.peer_ids])
            session.register_spares(
                [max(self.peer_ids, default=node_id) + 1 + i
                 for i in range(n_spares)])
        # follow our own replacement: after an immediate swap this host
        # reports under its new node identity
        session.bus.subscribe(NodeSwapped, self._on_swap)
        # triage evidence: the hook is the telemetry accumulator for this
        # host, so it (not an empty stub) answers error_signals queries
        if isinstance(self.control, LocalHostControl) and \
                self.control.signals_provider is None:
            self.control.signals_provider = self.derive_signals

    # -------------------------------------------------------------- faults

    def inject_stall(self, at_step: int, factor: float = 8.0,
                     steps: int = 1) -> None:
        """Scale this host's *measured* wall time for a step range —
        deterministic stand-in for an actual stall/slowdown."""
        self._stalls.append(_Stall(at_step, factor, steps))

    def _stall_factor(self, step: int) -> float:
        f = 1.0
        for s in self._stalls:
            if s.at_step <= step < s.at_step + s.steps:
                f *= s.factor
        return f

    # ------------------------------------------------------------ protocol

    def _reset_window(self) -> None:
        self._n_walls = 0
        self._comp_sums[:] = 0.0
        self._hw_sums.clear()
        self._hw_counts.clear()

    def __call__(self, step: int, wall_s: float,
                 metrics: Dict[str, float]) -> bool:
        if self._restart_pending:
            # deferred swaps landed at the last checkpoint: the manager
            # already replaced the node(s); rewind the job now
            self._restart_pending = False
            self._reset_window()
            self.restarts_requested += 1
            return True
        wall = wall_s * self._stall_factor(step)
        self._walls[self._n_walls] = wall
        self._n_walls += 1
        # hardware telemetry riding on the metrics dict (DCGM-style
        # exporter keys) accumulates into the window
        for m in HARDWARE_METRICS:
            v = metrics.get(m)
            if v is not None:
                self._hw_sums[m] = self._hw_sums.get(m, 0.0) + float(v)
                self._hw_counts[m] = self._hw_counts.get(m, 0) + 1
        # own-time decomposition for the timing trace: measured component
        # seconds when the trainer reports them, the configured split of
        # the (stall-scaled) wall otherwise
        if "compute_s" in metrics:
            self._comp_sums[0] += float(metrics["compute_s"])
            self._comp_sums[1] += float(metrics.get("comm_s", 0.0))
            self._comp_sums[2] += float(metrics.get("host_s", 0.0))
        else:
            self._comp_sums[0] += wall * self.own_split[0]
            self._comp_sums[1] += wall * self.own_split[1]
            self._comp_sums[2] += wall * self.own_split[2]
        if isinstance(self.control, LocalHostControl):
            # the local control has no other clock source; a real
            # substrate (e.g. the simulator) advances its own time
            self.control.t += wall
        # a completed step is proof of liveness
        self._last_step_t = self.control.now()
        self._last_step = step
        if self._n_walls < self.window_steps:
            return False
        self._windows_seen += 1
        if self._windows_seen <= self.warmup_windows:
            self._reset_window()         # compile/warm spikes: re-baseline
            return False
        frame = self._make_frame(step)
        self._reset_window()
        outcome = self.session.observe(frame)
        if outcome.restarts:
            self.restarts_requested += 1
            # the faulty node was swapped out: its injected fault leaves
            # the job with it (future-scheduled stalls stay armed)
            self._stalls = [s for s in self._stalls if s.at_step > step]
            return True
        return False

    def on_restart(self, step: int) -> None:
        """Trainer notification: a rewind happened. Drop the partial
        window and re-enter warmup: the first window(s) after a restore
        carry checkpoint-load / re-JIT spikes exactly like job start, and
        scoring them would flag the freshly swapped-in node and cascade
        into further spurious restarts."""
        self._reset_window()
        self._windows_seen = 0
        # restore/warmup time must not count toward the step deadline
        self._last_step_t = self.control.now()

    def on_checkpoint(self, step: int) -> None:
        """Trainer notification: a checkpoint was saved. Deferred and
        pending-patience mitigations land here (§4.2) — if the manager
        applied swaps, the next step call requests the rewind."""
        ck = self.session.on_checkpoint(step=step)
        if self._ckpt is not None:
            # fast-tier cadence follows the live MTTF estimate
            self._ckpt.update_mttf(
                self.session.mttf.estimate(self.control.now()))
        if ck.applied_swaps:
            self._restart_pending = True

    def bind_checkpoint(self, ckpt) -> None:
        """Attach a ``TieredCheckpointManager`` so its fast-snapshot
        cadence is re-tuned (Young-Daly) from the session's live MTTF
        estimate at every checkpoint boundary."""
        self._ckpt = ckpt
        ckpt.update_mttf(self.session.mttf.estimate(self.control.now()))

    def on_recovery(self, step: int, info: Dict) -> None:
        """Trainer notification: a restore completed. Publishes the
        incident as a ``RecoveryEvent`` with the tier the state came
        from, so the MTTR decomposition covers the real path too."""
        self.session.publish(RecoveryEvent(
            t=self.control.now(), step=step,
            reason=str(info.get("reason", "guard restart")),
            ckpt_tier=str(info.get("ckpt_tier", "cold")),
            hot_spare=bool(info.get("hot_spare", False)),
            restore_s=float(info.get("restore_s", 0.0)),
            detect_s=float(info.get("detect_s", 0.0)),
            drain_s=float(info.get("drain_s", 0.0)),
            warmup_s=float(info.get("warmup_s", 0.0)),
            replay_steps=int(info.get("replay_steps", 0))))

    # ------------------------------------------------------------ liveness

    def step_deadline(self) -> float:
        """Wall-clock budget for one training step before this host is
        presumed hung. Scaled from the rolling healthy step baseline by
        the ccltrace adaptive-deadline rule; before a baseline exists
        (first window after start/restart) the configured floor applies
        alone — better a loose cold deadline than a tight wrong one."""
        if self._baseline is None:
            return self.step_deadline_floor_s
        return adaptive_deadline(self._baseline, self.step_deadline_mult,
                                 floor_s=self.step_deadline_floor_s,
                                 cap_s=3600.0)

    def check_liveness(self, now: Optional[float] = None) -> bool:
        """Called off the step path (watchdog thread / sibling process):
        returns True when the trainer must restart because no step has
        completed within the deadline. The hook can only see its own
        host, so it reports itself as a hang *victim* (op="step", no
        culprit) — fleet-side culprit/victim attribution needs the
        ccltrace barrier watchdog, which sees every rank. Without this
        path a rank wedged in a collective blocks the job forever: it
        never finishes a step, so it never produces a Frame, and the
        frame-driven detector never fires."""
        t = self.control.now() if now is None else float(now)
        waited = t - self._last_step_t
        deadline = self.step_deadline()
        if waited < deadline:
            return False
        self.hangs_detected += 1
        self.restarts_requested += 1
        self.session.publish(HangDetected(
            t=t, step=self._last_step, op="step",
            victims=(self.node_id,),
            roles=((self.node_id, "victim"),),
            waited_s=float(waited), deadline_s=float(deadline)))
        self.session.mttf.observe_failure(t)
        # the wedged step's partial window is garbage; the restart path
        # (on_restart) re-enters warmup as usual
        self._reset_window()
        self._last_step_t = t
        return True

    # ------------------------------------------------------------ internal

    def _make_frame(self, step: int) -> Frame:
        walls = self._walls[:self._n_walls]
        n_steps = self._n_walls
        mine = float(walls.mean())
        med = float(np.median(walls))
        latched = self.session.monitor.detector.is_latched(self.node_id)
        if self._baseline is None:
            self._baseline = med
        elif not latched and med < self._baseline * 1.5:
            a = self.baseline_alpha
            self._baseline = (1 - a) * self._baseline + a * med
        peers = self._baseline * (
            1.0 + self.rng.normal(0.0, self.peer_jitter,
                                  len(self.peer_ids)))
        node_ids = np.asarray([self.node_id, *self.peer_ids], np.int64)
        times = np.concatenate([[mine], peers])
        metrics: Dict[str, np.ndarray] = {"step_time": times}
        # hardware telemetry columns: this host's measured window means,
        # peers synthesized around the rolling healthy baseline (so the
        # detector's supporting-signal masks run on the real path).
        # Every metric EVER seen keeps its column — exporters slower
        # than the window cadence would otherwise flap the frame schema,
        # and a schema change makes the detector's RingHistory restart
        # (wiping the K-of-N persistence history every window)
        for m in sorted(set(self._hw_last) | set(self._hw_sums)):
            if m in self._hw_sums:
                v = self._hw_sums[m] / self._hw_counts[m]  # per-sample
                self._hw_last[m] = v
                base = self._hw_base.get(m)
                if base is None:
                    self._hw_base[m] = base = v
                elif not latched:
                    a = self.baseline_alpha
                    self._hw_base[m] = base = (1 - a) * base + a * v
            else:
                v = self._hw_last[m]       # no sample: carry forward
                base = self._hw_base.get(m, v)
            pv = base * (1.0 + self.rng.normal(0.0, 0.005,
                                               len(self.peer_ids)))
            metrics[m] = np.concatenate([[v], pv])
        if self.trace is not None:
            # own-time decomposition: measured for this host, the
            # baseline scaled by the same split for synthetic peers
            comp = self._comp_sums / n_steps
            split = comp / max(float(comp.sum()), 1e-9)
            self.trace.push(WindowTiming(
                t=self.control.now(), step=step, node_ids=node_ids,
                compute=np.concatenate([[comp[0]], peers * split[0]]),
                comm=np.concatenate([[comp[1]], peers * split[1]]),
                host=np.concatenate([[comp[2]], peers * split[2]]),
                stall=np.zeros(len(node_ids))))
        self.frames_fed += 1
        return Frame(t=self.control.now(), step=step, node_ids=node_ids,
                     metrics=metrics,
                     valid=np.ones(len(node_ids), bool))

    # ------------------------------------------------------------ triage

    def derive_signals(self, node_id: int) -> ErrorSignals:
        """Actionable triage evidence from the accumulated window
        telemetry (registered as the LocalHostControl signals provider).

        Lane evidence comes from hardware metrics when the trainer
        supplies them (temperature rise, frequency/power sag -> GPU
        lane; NIC error counters, throughput sag, link down -> NIC
        lane). With no hardware telemetry at all, a latched node still
        yields GPU-lane evidence from its sustained step-time deviation
        — the paper's early-termination rule is for nodes with NO
        evidence, not for hosts whose exporter is missing."""
        if node_id in self._evicted_signals:
            return self._evicted_signals[node_id]
        if node_id != self.node_id:
            return ErrorSignals()
        hw, base = self._hw_last, self._hw_base
        gpu = nic = False
        notes: List[str] = []

        def sag(metric, tol):
            v, b = hw.get(metric), base.get(metric)
            return v is not None and b is not None and b > 0 and \
                v < b * (1.0 - tol)

        if hw.get("gpu_temp", 0.0) > base.get("gpu_temp", np.inf) + 5.0:
            gpu = True
            notes.append("gpu_temp rise")
        if sag("gpu_freq", 0.03):
            gpu = True
            notes.append("gpu_freq sag")
        if sag("gpu_power", 0.08):
            gpu = True
            notes.append("gpu_power sag")
        if hw.get("nic_errors", 0.0) > 0:
            nic = True
            notes.append("nic error counters")
        if sag("nic_tx_rate", 0.08):
            nic = True
            notes.append("nic_tx_rate sag")
        if hw.get("nic_up", 1.0) < 0.999:
            nic = True
            notes.append("nic link down")
        if not (gpu or nic) and \
                self.session.monitor.detector.is_latched(self.node_id):
            gpu = True
            notes.append("sustained step-time deviation "
                         "(no hardware telemetry available)")
        return ErrorSignals(gpu_errors=gpu, nic_errors=nic,
                            detail="; ".join(notes))

    def _on_swap(self, ev: NodeSwapped) -> None:
        if ev.old == self.node_id:
            # snapshot the accumulated evidence under the departing id —
            # the detector latch is already reset by the swap, but the
            # eviction itself is step-time evidence
            sig = self.derive_signals(ev.old)
            if not sig.actionable:
                sig = ErrorSignals(
                    gpu_errors=True,
                    detail=f"evicted: {ev.reason} "
                           f"(no hardware telemetry available)")
            self._evicted_signals[ev.old] = sig
            self.node_id = ev.new


__all__ = ["GuardStepHook", "LocalHostControl", "LocalSweepBackend"]
