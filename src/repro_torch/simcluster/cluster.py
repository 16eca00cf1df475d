# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Synchronous-job step-time composition + Guard substrate adapters.

``SimCluster`` owns the fleet, the fault injector and the active node set,
and composes per-step node barrier times the way a hybrid-parallel job does:

  node_time = compute/compute_factor + comm_exposed/(comm_factor/congestion)
              + host/host_factor + noise
  step_time = max over active nodes            (synchronous collectives)

It implements all three Guard substrate protocols — telemetry ``Collector``,
``SweepBackend`` and ``ClusterControl`` — so the identical detection stack
runs over the simulator and (with different adapters) over real hardware.

The workload profile can be seeded from the *real* compiled model's roofline
terms via ``WorkloadProfile.from_roofline`` so the simulation's
compute/comm/host split matches the architecture being trained.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.ccltrace.spans import (CollectiveSpanTrace,
                                        PendingCollective, SpanWindow)
from repro_torch.core.sweep import SweepReference
from repro_torch.core.telemetry import Frame, reduce_device_metrics
from repro_torch.diagnose.trace import TimingTrace, WindowTiming
from repro_torch.diagnose.whatif import Topology
from repro_torch.simcluster.faults import (HANG_NEVER_ENTER,
                                           FaultInjector, FaultRates)
from repro_torch.simcluster.node import Fleet, HWConfig, freq_at_temp


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Healthy per-step time decomposition of one training step."""
    name: str = "guard_pretrain"
    compute_s: float = 8.0          # device-gated compute
    comm_exposed_s: float = 0.6     # non-overlapped inter-node collectives
    host_s: float = 1.4             # data loading / checkpoint / coordination
    bytes_per_link_gb: float = 4.0  # per-step per-link transmit (Fig. 4)
    step_noise: float = 0.01        # lognormal sigma on node barrier times
    mfu_at_healthy: float = 0.20    # job MFU when every node is healthy
    step_tflops: float = 4500.0     # model FLOPs per step (goodput scale)

    @property
    def healthy_step_s(self) -> float:
        return self.compute_s + self.comm_exposed_s + self.host_s

    @classmethod
    def from_roofline(cls, name: str, compute_term_s: float,
                      memory_term_s: float, collective_term_s: float,
                      host_s: float = 1.0, overlap: float = 0.7,
                      mfu: float = 0.2) -> "WorkloadProfile":
        """Seed the sim split from a compiled step's roofline terms:
        the device-gated part is max(compute, memory); a fraction
        ``overlap`` of collective time hides under compute."""
        return cls(
            name=name,
            compute_s=max(compute_term_s, memory_term_s),
            comm_exposed_s=collective_term_s * (1.0 - overlap),
            host_s=host_s,
            mfu_at_healthy=mfu,
        )


# 2-node offline-sweep mini workload (§5.3): collective-heavy by design so
# link problems dominate the measurement.
SWEEP_PROFILE = WorkloadProfile(
    name="node_sweep", compute_s=0.6, comm_exposed_s=0.5, host_s=0.1,
    step_noise=0.01)


class SimSweepBackend:
    """``SweepBackend`` over a simulated :class:`Fleet` — scalar probes
    plus the batched fleet-campaign protocol (``batch_compute_probe`` /
    ``batch_intra_bw_probe`` / ``batch_multi_node_probe``), all reading
    the same keyed probe noise and the same cached node perf factors, so
    a batched campaign over N nodes is a handful of ``(N, D)`` array
    expressions and its measurements are bit-identical to N scalar
    sweeps."""

    def __init__(self, fleet: Fleet):
        self.fleet = fleet

    def device_count(self, node_id: int) -> int:
        return self.fleet.d

    # --- compute -----------------------------------------------------

    def _effective_temp(self, temp, target, seconds: float):
        # longer burns average away sensor noise and surface slow thermal
        # ramps: let the node reach its thermal target first
        frac = min(seconds / self.fleet.hw.temp_tau_s, 5.0)
        return temp + (1 - math.exp(-frac)) * (target - temp)

    def compute_probe(self, node_id: int, device: int,
                      seconds: float) -> float:
        fl = self.fleet
        # a wedged node's burn kernel never completes: the probe times
        # out and reports zero sustained throughput (so qualification
        # fails until triage actually clears the hang)
        if fl.hang_phase[node_id]:
            return 0.0
        t_eff = self._effective_temp(fl.temp_c[node_id, device],
                                     fl.temp_target[node_id, device],
                                     seconds)
        saved = fl.temp_c[node_id, device]
        fl.temp_c[node_id, device] = t_eff
        try:
            return fl.probe_device_tflops(node_id, device)
        finally:
            fl.temp_c[node_id, device] = saved

    def batch_compute_probe(self, node_ids: Sequence[int],
                            seconds: float) -> np.ndarray:
        """(len(node_ids), D) sustained throughputs, one array pass."""
        fl = self.fleet
        idx = np.asarray(list(node_ids))
        temp = fl.temp_c[idx]
        t_eff = self._effective_temp(temp, fl.temp_target[idx], seconds)
        f = freq_at_temp(t_eff) / fl.hw.base_freq_ghz * \
            fl.power_factor[idx] * fl.mem_factor[idx]
        out = fl.hw.base_tflops * f * fl.probe_noise_compute()[idx]
        # same wedged-node timeout as the scalar probe (exact zeros keep
        # the batched-vs-scalar bit-identity contract)
        out[fl.hang_phase[idx] != 0] = 0.0
        return out

    # --- intra-node bandwidth ----------------------------------------

    def intra_bw_probe(self, node_id: int, dev_a: int, dev_b: int) -> float:
        return self.fleet.probe_intra_bw(node_id, dev_a, dev_b)

    def batch_intra_bw_probe(self, node_ids: Sequence[int],
                             pairs: Sequence[tuple]) -> np.ndarray:
        """(len(node_ids), len(pairs)) pairwise bandwidths."""
        fl = self.fleet
        idx = np.asarray(list(node_ids))
        pa = np.asarray([p[0] for p in pairs])
        pb = np.asarray([p[1] for p in pairs])
        mem = fl.mem_factor[idx]
        q = np.minimum(mem[:, pa], mem[:, pb])
        lo = np.minimum(pa, pb)
        hi = np.maximum(pa, pb)
        noise = fl.probe_noise_bw()[idx[:, None], lo[None, :], hi[None, :]]
        return fl.hw.intra_bw_gbps * q * noise

    # --- multi-node collective stage ---------------------------------

    def _group_base(self, groups: np.ndarray) -> np.ndarray:
        """(G,) noise-free group step times over the perf caches."""
        fl = self.fleet
        w = SWEEP_PROFILE
        comp = w.compute_s / fl.node_compute_factor()[groups]
        comm = w.comm_exposed_s / np.maximum(
            fl.node_comm_factor()[groups], 1e-9)
        host = w.host_s / fl.host_factor[groups]
        return (comp + comm + host).max(axis=-1)

    def multi_node_probe(self, node_ids: Sequence[int],
                         steps: int) -> np.ndarray:
        """2/4/8-node collective mini-workload (§5.3)."""
        idx = np.asarray(list(node_ids))
        base = self._group_base(idx)
        noise = np.exp(self.fleet.pair_noise(int(idx[0]), steps,
                                             SWEEP_PROFILE.step_noise))
        return base * noise

    def batch_multi_node_probe(self, groups: Sequence[Sequence[int]],
                               steps: int) -> np.ndarray:
        """(len(groups), steps) step times; group g's noise is keyed on
        its candidate (first member), exactly as the scalar probe."""
        g = np.asarray([list(gr) for gr in groups])
        base = self._group_base(g)
        sigma = SWEEP_PROFILE.step_noise
        noise = np.stack([self.fleet.pair_noise(int(gr[0]), steps, sigma)
                          for gr in g])
        return base[:, None] * np.exp(noise)

    def reference(self) -> SweepReference:
        return SweepReference(
            device_tflops=self.fleet.hw.base_tflops,
            intra_bw_gbps=self.fleet.hw.intra_bw_gbps,
            pair_step_time=SWEEP_PROFILE.healthy_step_s,
        )


class SimCluster:
    """N-node synchronous training job over a simulated fleet."""

    def __init__(self, n_active: int, n_spare: int = 16,
                 reserve: Optional[int] = None,
                 workload: Optional[WorkloadProfile] = None,
                 hw: Optional[HWConfig] = None,
                 rates: Optional[FaultRates] = None,
                 window_steps: int = 6,
                 topology: Optional[Topology] = None,
                 seed: int = 0):
        reserve = reserve if reserve is not None else max(n_active // 2, 32)
        total = n_active + n_spare + reserve
        self.fleet = Fleet(total, hw, seed=seed)
        self.injector = FaultInjector(self.fleet, rates, seed=seed + 1)
        self.sweep_backend = SimSweepBackend(self.fleet)
        self.workload = workload or WorkloadProfile()
        self.window_steps = window_steps
        # barrier-noise source; must support exact state save/restore and
        # batch==sequential gaussian streams (run_window's rewind replay)
        self.rng = np.random.Generator(np.random.SFC64(seed + 2))

        self.active = list(range(n_active))
        # initial spare population only: once these ids are registered
        # with a GuardSession/HealthManager, the manager owns pool
        # membership (take_spare/return_spare) and this list is NOT kept
        # in sync (swap_node drops a node it promotes, nothing re-adds)
        self.spares = list(range(n_active, n_active + n_spare))
        self._unprovisioned = list(range(n_active + n_spare, total))

        self.t = 0.0
        self.step = 0
        self.restarts: List[dict] = []
        self._active_arr: Optional[np.ndarray] = None
        # per-window buffers: (k, N) barrier-time blocks + one (N,) alive
        # row per committed block/step
        self._win_node_times: List[np.ndarray] = []
        self._win_alive: List[np.ndarray] = []
        # per-node cumulative NIC error baseline for window deltas;
        # re-snapshotted per node at swap-in so a spare's idle-time errors
        # are never misattributed to its first in-job window
        self._prev_err = np.zeros_like(self.fleet.nic_err_count)
        self._err_seen = self.fleet.err_version
        self._err_dirty = False
        # --- diagnosis substrate (all optional; the hot path pays only
        # when wired). ``topology`` is the blocking-collective structure:
        # when set, telemetry step_time becomes the MEASURED wall (each
        # node reports its barrier-group max — what real per-host
        # instrumentation sees, stall contamination included). A
        # ``TimingTrace`` attached via ``attach_timing`` additionally
        # receives the true per-window compute/comm/host/stall split.
        self.topology = topology
        if topology is not None:
            assert topology.n == n_active, (topology.n, n_active)
        self.timing: Optional[TimingTrace] = None
        self._parts_sum: Optional[np.ndarray] = None   # (3, N) seconds
        self._wall_sum: Optional[np.ndarray] = None    # (N,) seconds
        # collective span capture (repro_torch.ccltrace substrate): enter =
        # own pre-barrier work (compute + host), exit = group wall
        self.spans: Optional[CollectiveSpanTrace] = None
        self._span_op = "all_reduce"
        self._enter_sum: Optional[np.ndarray] = None   # (N,) seconds

    # ------------------------------------------------------------ stepping

    def _active_idx(self) -> np.ndarray:
        """Cached ndarray view of the active list (invalidated on swap
        and on any length change, e.g. tests removing nodes in place)."""
        arr = self._active_arr
        if arr is None or len(arr) != len(self.active):
            arr = self._active_arr = np.asarray(self.active)
        return arr

    def _barrier_parts(self, idx: np.ndarray):
        """Noise-free (compute, comm, host) decomposition of the barrier
        time, each (n_active,). The single source of the step-time model
        for the per-step path, the window-batched path AND the diagnosis
        trace (their bit-identical contract depends on sharing it)."""
        w = self.workload
        comp = w.compute_s / self.fleet.node_compute_factor()[idx]
        commf = self.fleet.node_comm_factor()[idx] / \
            self.injector.congestion_factor[idx]
        comm = w.comm_exposed_s / np.maximum(commf, 1e-9)
        host = w.host_s / self.fleet.host_factor[idx]
        return comp, comm, host

    def _barrier_base(self, idx: np.ndarray) -> np.ndarray:
        """(n_active,) noise-free barrier-time composition."""
        comp, comm, host = self._barrier_parts(idx)
        return comp + comm + host

    def node_barrier_times(self) -> np.ndarray:
        """(n_active,) seconds for each node to finish the current step."""
        idx = self._active_idx()
        noise = np.exp(self.rng.standard_normal(
            len(idx), dtype=np.float32) * self.workload.step_noise)
        return self._barrier_base(idx) * noise

    # ------------------------------------------------- diagnosis capture

    def attach_timing(self, trace: TimingTrace) -> None:
        """Feed per-window timing decompositions into ``trace`` (the
        ``repro_torch.diagnose`` substrate). One push per ``collect()``."""
        self.timing = trace

    def attach_spans(self, trace: CollectiveSpanTrace,
                     op: str = "all_reduce") -> None:
        """Feed per-window collective spans into ``trace`` (the
        ``repro_torch.ccltrace`` substrate): enter = window-mean pre-barrier
        work (compute + host), exit = window-mean group wall, group ids
        from the attached topology (one global group without one). One
        push per ``collect()``."""
        self.spans = trace
        self._span_op = op

    def _accum_decomp(self, times: np.ndarray, dts: np.ndarray,
                      parts) -> None:
        """Accumulate one committed block's decomposition: ``times`` is
        the (k, N) own barrier times, ``dts`` the (k,) job step times,
        ``parts`` the PRE-TICK (compute, comm, host) split the times
        were composed from (the tick that closes the block may fire
        fault events — the post-event state must not relabel this
        block's seconds). O(N) per block regardless of k — the
        multiplicative step noise scales every component alike, so
        component sums derive from the own-time sums and the noise-free
        split."""
        n = times.shape[1]
        if self._parts_sum is None or self._parts_sum.shape[1] != n:
            # f64 accumulators by design: the sim composes device physics
            # in f64, Frame metrics are f64 at the collector boundary,
            # and the telemetry ring downcasts to f32 on ingest
            # guardlint: disable=GL002 reason=f64 device-physics accumulator
            self._parts_sum = np.zeros((3, n), np.float64)
            # guardlint: disable=GL002 reason=f64 device-physics accumulator
            self._wall_sum = np.zeros(n, np.float64)
            # guardlint: disable=GL002 reason=f64 device-physics accumulator
            self._enter_sum = np.zeros(n, np.float64)
        if self.timing is not None or self.spans is not None:
            comp, comm, host = parts
            scale = times.sum(axis=0) / np.maximum(comp + comm + host,
                                                   1e-12)
            if self.timing is not None:
                self._parts_sum[0] += comp * scale
                self._parts_sum[1] += comm * scale
                self._parts_sum[2] += host * scale
            if self.spans is not None:
                self._enter_sum += (comp + host) * scale
        if self.topology is not None:
            self._wall_sum += self.topology.group_max(times).sum(axis=0)
        else:
            # single global barrier: every node's wall is the step time
            self._wall_sum += float(dts.sum())

    def _reset_decomp(self) -> None:
        if self._parts_sum is not None:
            self._parts_sum[:] = 0.0
            self._wall_sum[:] = 0.0
            self._enter_sum[:] = 0.0

    def run_step(self) -> dict:
        """Advance the job by one training step; returns the step record."""
        idx = self._active_idx()
        alive = self.fleet.alive[idx]
        track = (self.timing is not None or self.topology is not None
                 or self.spans is not None)
        if track:
            # pre-tick split (the tick below may fire events that change
            # it); compose the barrier times from it directly instead of
            # rebuilding the identical components in node_barrier_times
            parts = self._barrier_parts(idx)
            noise = np.exp(self.rng.standard_normal(
                len(idx), dtype=np.float32) * self.workload.step_noise)
            times = (parts[0] + parts[1] + parts[2]) * noise
        else:
            parts = None
            times = self.node_barrier_times()
        step_time = float(times.max())
        crashed = not alive.all()

        dt = step_time if not crashed else 60.0
        self.injector.tick(self.t, dt, idx)
        self.fleet.advance_thermals(dt)
        self.fleet.account_traffic(self.workload.bytes_per_link_gb)
        self.t += dt
        if not crashed:
            self.step += 1
            self._win_node_times.append(times[None, :])
            self._win_alive.append(alive)
            if track:
                self._accum_decomp(times[None, :],
                                   np.asarray([step_time]), parts)
        return {"t": self.t, "step": self.step, "step_time": step_time,
                "crashed": crashed, "node_times": times}

    def run_window(self, steps: Optional[int] = None) -> dict:
        """Advance the job by up to one evaluation window of steps,
        batching the barrier-time composition between fault events.

        The stretch of steps up to the fault injector's
        ``next_change_t`` horizon is composed as ONE ``(k, N)``
        vectorized draw — the per-step loop, its per-step injector
        ticks, and its per-step thermal/traffic updates all collapse.
        The batch draws replay the rng stream exactly as k successive
        per-step draws would, so with no thermal ramp in flight a fixed
        seed produces trajectories bit-identical to repeated
        ``run_step`` — through instant-effect fault events (power,
        memory, NIC, host, congestion, fail-stop) included. Thermal
        ramps integrate at batch granularity: device temperatures hold
        for the span of one batch (at most one evaluation window — the
        telemetry cadence, well inside the thermal time constant) and
        then advance by the batch's total dt, reaching the same
        equilibrium as per-step integration with transiently coarser
        sampling of the throttle curve.

        Stops early on a fail-stop crash, or on a hung collective (any
        active node with nonzero ``hang_phase``): the barrier never
        completes, so no further step can commit — the record comes back
        with ``hung`` set and the caller drives the ccltrace watchdog
        (or the blind CCL-timeout fallback). Returns the window record:
        ``step_times`` holds the committed steps' job step times."""
        target = self.window_steps if steps is None else int(steps)
        step_times: List[float] = []
        crashed = False
        hung = False
        while len(step_times) < target and not crashed:
            idx = self._active_idx()
            if not self.fleet.alive[idx].all():
                self.run_step()              # crash bookkeeping path
                crashed = True
                break
            if self.fleet.hang_phase[idx].any():
                hung = True
                break
            k = target - len(step_times)
            if k == 1:
                rec = self.run_step()
                if rec["crashed"]:
                    crashed = True
                else:
                    step_times.append(rec["step_time"])
                continue
            # ---- frozen-state fast path: one (k, N) composition
            self.injector.prime(self.t, idx)
            w = self.workload
            track = (self.timing is not None or self.topology is not None
                     or self.spans is not None)
            parts = self._barrier_parts(idx) if track else None
            base = parts[0] + parts[1] + parts[2] if track \
                else self._barrier_base(idx)               # (N,)
            rng_state = self.rng.bit_generator.state
            noise = np.exp(self.rng.standard_normal(
                (k, len(idx)), dtype=np.float32) * w.step_noise)
            times = base[None, :] * noise                  # (k, N)
            dts = times.max(axis=1)
            ends = self.t + np.cumsum(dts)
            horizon = self.injector.next_change_t()
            m = k
            if horizon is not None and ends[-1] > horizon:
                # an event fires inside the window: commit only the steps
                # up to (and including) the one whose tick lands it, and
                # rewind the rng so the stream position matches m
                # per-step draws exactly
                m = min(int(np.searchsorted(ends, horizon, "left")) + 1, k)
                self.rng.bit_generator.state = rng_state
                noise = np.exp(self.rng.standard_normal(
                    (m, len(idx)), dtype=np.float32) * w.step_noise)
                times = base[None, :] * noise
                dts = times.max(axis=1)
            # rows 0..m-2 are event-free: their ticks are no-ops by
            # construction, traffic accounting runs batched, and any
            # thermal ramp integrates over the head's total time in one
            # call (a no-op for settled fleets, keeping the bitwise
            # contract); the last row's tick may land events — same
            # order as the per-step loop
            if m > 1:
                self.fleet.account_traffic(
                    (m - 1) * w.bytes_per_link_gb)
                head = 0.0
                for dt in dts[:-1]:      # sequential: bit-identical t
                    self.t += float(dt)
                    head += float(dt)
                self.fleet.advance_thermals(head)
            last_dt = float(dts[-1])
            self.injector.tick(self.t, last_dt, idx)
            self.fleet.advance_thermals(last_dt)
            self.fleet.account_traffic(w.bytes_per_link_gb)
            self.t += last_dt
            self.step += m
            self._win_node_times.append(times)
            self._win_alive.append(np.ones(len(idx), bool))
            if track:
                self._accum_decomp(times, dts, parts)
            step_times.extend(dts.tolist())
        return {"t": self.t, "step": self.step,
                "step_times": np.asarray(step_times),
                "steps_run": len(step_times), "crashed": crashed,
                "hung": hung}

    def crashed_nodes(self) -> List[int]:
        return [n for n in self.active if not self.fleet.alive[n]]

    def hang_pending(self) -> Optional[PendingCollective]:
        """Observable snapshot of the stuck in-flight collective, for the
        ccltrace watchdog. Built ONLY from what a CCL tracing layer sees:
        which ranks posted the collective (never-entering ranks are wedged
        before it), which groups completed theirs, and per-rank link
        evidence (down/degraded port or error-counter creep since the
        last window). Returns None while nothing is hung."""
        idx = self._active_idx()
        ph = self.fleet.hang_phase[idx]
        if not ph.any():
            return None
        comp, comm, host = self._barrier_parts(idx)
        entered = ph != HANG_NEVER_ENTER
        enter_off = comp + host
        enter_t = np.where(entered, self.t + enter_off, np.inf)
        group_of = (self.topology.stage_of.astype(np.int64)
                    if self.topology is not None
                    else np.zeros(len(idx), np.int64))
        # a group with no wedged member finished its own collective; its
        # ranks block at the next global sync point, outside this op
        hung_groups = np.unique(group_of[ph > 0])
        completed = ~np.isin(group_of, hung_groups)
        fl = self.fleet
        err_delta = (fl.nic_err_count[idx] - self._prev_err[idx]).sum(axis=1)
        nic_suspect = ((~fl.nic_up[idx]).any(axis=1)
                       | (fl.nic_quality[idx] < 0.95).any(axis=1)
                       | (err_delta > 0))
        return PendingCollective(
            t_start=self.t, step=self.step, op=self._span_op,
            node_ids=idx.astype(np.int64), group_of=group_of,
            entered=entered, enter_t=enter_t, completed=completed,
            nic_suspect=nic_suspect)

    def advance_idle(self, seconds: float) -> None:
        """Advance wall time without training (restart/recovery windows)."""
        idx = self._active_idx() if self.active else np.arange(0)
        self.injector.tick(self.t, seconds, idx)
        self.fleet.advance_thermals(seconds)
        self.t += seconds

    # --------------------------------------------------- telemetry Collector

    def collect(self) -> Optional[Frame]:
        """Aggregate the last window of steps into a telemetry Frame."""
        if not self._win_node_times:
            return None
        idx = self._active_idx()
        times = np.vstack(self._win_node_times)       # (W, N)
        valid = np.stack(self._win_alive).all(axis=0) & self.fleet.alive[idx]
        self._win_node_times.clear()
        self._win_alive.clear()
        sensors = self.fleet.read_sensors(idx)
        metrics = reduce_device_metrics(
            sensors["temp"], sensors["util"], sensors["freq"],
            sensors["power"], sensors["nic_err"], sensors["nic_tx"],
            sensors["nic_up"])
        own_mean = times.mean(axis=0)
        node_ids = idx.astype(np.int64)
        w = times.shape[0]
        wall_mean = None
        if self.topology is not None:
            # measured wall: each node reports its blocking-collective
            # group's completion time — barrier-stall contamination, the
            # signal a real per-host collector sees (one degraded node
            # inflates every group peer's step_time)
            wall_mean = self._wall_sum / w
            metrics["step_time"] = wall_mean
        else:
            metrics["step_time"] = own_mean
        if self.timing is not None and self._parts_sum is not None and \
                self._parts_sum.shape[1] == len(idx):
            if wall_mean is None:
                wall_mean = self._wall_sum / w
            self.timing.push(WindowTiming(
                t=self.t, step=self.step, node_ids=node_ids,
                compute=self._parts_sum[0] / w,
                comm=self._parts_sum[1] / w,
                host=self._parts_sum[2] / w,
                stall=np.maximum(wall_mean - own_mean, 0.0)))
        if self.spans is not None and self._enter_sum is not None and \
                self._enter_sum.shape[0] == len(idx):
            if wall_mean is None:
                wall_mean = self._wall_sum / w
            group_of = (self.topology.stage_of.astype(np.int64)
                        if self.topology is not None
                        else np.zeros(len(idx), np.int64))
            self.spans.push(SpanWindow(
                t=self.t, step=self.step, op=self._span_op,
                node_ids=node_ids, group_of=group_of,
                enter=self._enter_sum / w, exit=wall_mean))
        self._reset_decomp()
        # error counters are cumulative — report the window delta. Clean
        # windows (no NIC events since the last collect, no swaps moving
        # baselines) skip the full-fleet delta scan outright.
        if self.fleet.err_version == self._err_seen and not self._err_dirty:
            # guardlint: disable=GL002 reason=Frame metrics are f64 at the
            # collector boundary; the telemetry ring downcasts on ingest
            metrics["nic_errors"] = np.zeros(len(idx), np.float64)
        else:
            delta = self.fleet.nic_err_count - self._prev_err
            np.copyto(self._prev_err, self.fleet.nic_err_count)
            metrics["nic_errors"] = delta[idx].sum(axis=1)
            self._err_seen = self.fleet.err_version
            self._err_dirty = False
        return Frame(t=self.t, step=self.step, node_ids=node_ids,
                     metrics=metrics, valid=valid)

    # ------------------------------------------------------- SweepBackend
    # Probe logic lives in SimSweepBackend (scalar + batched protocol);
    # the cluster keeps the protocol surface by delegation so passing
    # ``sweep_backend=cluster`` stays valid — and batched campaigns get
    # the array path automatically.

    def device_count(self, node_id: int) -> int:
        return self.sweep_backend.device_count(node_id)

    def compute_probe(self, node_id: int, device: int,
                      seconds: float) -> float:
        return self.sweep_backend.compute_probe(node_id, device, seconds)

    def batch_compute_probe(self, node_ids: Sequence[int],
                            seconds: float) -> np.ndarray:
        return self.sweep_backend.batch_compute_probe(node_ids, seconds)

    def intra_bw_probe(self, node_id: int, dev_a: int, dev_b: int) -> float:
        return self.sweep_backend.intra_bw_probe(node_id, dev_a, dev_b)

    def batch_intra_bw_probe(self, node_ids: Sequence[int],
                             pairs: Sequence[tuple]) -> np.ndarray:
        return self.sweep_backend.batch_intra_bw_probe(node_ids, pairs)

    def multi_node_probe(self, node_ids: Sequence[int],
                         steps: int) -> np.ndarray:
        return self.sweep_backend.multi_node_probe(node_ids, steps)

    def batch_multi_node_probe(self, groups: Sequence[Sequence[int]],
                               steps: int) -> np.ndarray:
        return self.sweep_backend.batch_multi_node_probe(groups, steps)

    def reference(self) -> SweepReference:
        return self.sweep_backend.reference()

    # ------------------------------------------------------ ClusterControl

    def swap_node(self, old: int, new: int) -> None:
        i = self.active.index(old)
        self.active[i] = new
        self._active_arr = None
        if new in self.spares:
            self.spares.remove(new)
        # baseline the spare's cumulative NIC error counters at swap-in:
        # errors it accrued while idle must not surface as one giant
        # first-window delta (instant spurious peer-relative flag)
        self._prev_err[new] = self.fleet.nic_err_count[new]
        self._err_dirty = True

    def restart_job(self, reason: str) -> None:
        self.restarts.append({"t": self.t, "step": self.step,
                              "reason": reason})
        self._win_node_times.clear()
        self._win_alive.clear()
        self._reset_decomp()

    def provision_node(self) -> int:
        if not self._unprovisioned:
            raise RuntimeError("simulated provisioning pool exhausted")
        nid = self._unprovisioned.pop(0)
        self.injector.seed_admission_grey(nid, self.t)
        return nid

    def error_signals(self, node_id: int):
        return self.injector.node_error_signals(node_id)

    def remediate(self, node_id: int, stage: str) -> None:
        self.injector.remediate(node_id, stage)

    def now(self) -> float:
        return self.t
