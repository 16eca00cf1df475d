"""Multi-week training-run simulator — the §7 evaluation substrate; the
port of the JAX package's ``repro.simcluster.runtime``.

``simulate_run`` drives a synchronous job over the simulated fleet under one
of the four ablation tiers of Table 4 (see ``repro_torch.guard.Tier``):

  BURNIN            NCCL/burn-in only: fail-stop crashes are handled
                    (replace + restart); grey nodes persist until a human
                    notices the slowdown and hand-debugs, or the fault
                    escalates into a crash.
  NODE_SWEEP        + offline single-node sweep: spares/repairs are swept
                    before (re-)entering service, and human investigations
                    can use sweep tooling (faster, more accurate).
  ONLINE            + Guard online monitoring: peer-relative detection with
                    the tiered policy drives automated quarantine/swap.
  ENHANCED          + enhanced sweep: multi-node (2-node) collective stage
                    and long sustained burns in qualification/admission —
                    comm-level greys stop bouncing back into the job.

The whole closed loop runs through the public ``repro_torch.guard`` API: one
``GuardSession`` owns detection, the node pools, and the non-blocking
sweep scheduler (offline qualification overlaps the job in simulated
time); every incident lands on the session's event bus and comes back in
``RunResult.events`` as typed records.

Outputs: MTTF (mean active time between job-interrupting hardware
failures), MFU (model-FLOPs utilization: completed-step FLOPs over elapsed
wall time), mean human hours per incident, plus full step-time and event
traces for the figure-level benchmarks.

The simulator itself is host NumPy, so a run is the reference's run bit
for bit; ``RunConfig.device`` places the session's detector, whose
fleet_score kernel scores every window's frame on the card (the tests
pass ``"cpu"``, which runs the kernel's plain version).

``simulate_fleet`` drives N concurrent jobs through one
``repro_torch.fleet.FleetController`` (global spare pool, shared sweep
bench, healthscan, fleet event log); ``FleetRunConfig.device`` places
every job's detector, so each job's observed windows run fleet_score on
the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.ccltrace import (CollectiveSpanTrace, HangWatchdog,
                                  WatchdogConfig)
from repro_torch.core.sweep import (SweepConfig, multi_node_sweep,
                                    single_node_sweep)
from repro_torch.device import DeviceLike
from repro_torch.diagnose import (Diagnoser, RootCauseConfig, TimingTrace,
                                  Topology)
from repro_torch.guard import (CheckpointTier, GuardSession, JobRestart,
                               RecoveryEvent, RecoveryModel, Tier,
                               goodput_tflop_h, mttr_decomposition,
                               replica_partner, young_daly_interval)
from repro_torch.simcluster.cluster import SimCluster, WorkloadProfile
from repro_torch.simcluster.faults import FaultRates
from repro_torch.simcluster.scenarios import (InitialGreyPopulation,
                                              Scenario, arm_all)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    tier: Tier = Tier.ENHANCED
    n_nodes: int = 128
    n_spare: int = 12
    duration_h: float = 72.0
    window_steps: int = 6                # evaluation window (≈60 s of steps)
    checkpoint_interval_steps: int = 90  # 15 min at the healthy step
    crash_detect_s: float = 120.0
    restart_overhead_s: float = 600.0
    provision_delay_s: float = 1800.0
    # crash recovery: with no tooling a hard failure needs hours of manual
    # diagnosis before the job is back; Guard tiers automate it away
    crash_recovery_s: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 7_200.0, 2: 2_700.0, 3: 600.0,
                                 4: 600.0})
    crash_human_h: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 3.0, 2: 1.5, 3: 0.25, 4: 0.25})
    # manual grey hunting pauses/perturbs the job in the untooled tiers
    hunt_downtime_s: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 5_400.0, 2: 2_700.0})
    # grey population a long-unmanaged cluster has accumulated at t=0
    # (armed through the scenario layer as InitialGreyPopulation)
    initial_grey_p: float = 0.10
    # declarative correlated-fault scenarios (Scenario instances or
    # registry names — see repro_torch.simcluster.scenarios)
    scenarios: Tuple = ()
    # blocking-collective structure: nodes per DP gradient-barrier group
    # (0 = legacy idealized telemetry, each node reports its OWN barrier
    # time; > 0 = realistic measured walls — each node reports its
    # group's completion time, barrier-stall contamination included)
    dp_group_size: int = 0
    # run the repro_torch.diagnose attribution stage (trace -> what-if ->
    # root cause) between detector and policy: cascade victims are
    # watched instead of evicted, triage gets root-caused ErrorSignals,
    # and DiagnosisEvents land in RunResult.events
    diagnose: bool = False
    trace_depth: int = 8
    rootcause_cfg: Optional[RootCauseConfig] = None
    # collective-granular hang watchdog (repro_torch.ccltrace): feed per-window
    # spans into a CollectiveSpanTrace and poll the barrier-timeout
    # watchdog when a window wedges — culprits are evicted, victims
    # watched, and the job restarts instead of blocking until the blind
    # framework-level CCL abort (``ccl_timeout_s``) fires
    hang_watchdog: bool = False
    hang_cfg: Optional[WatchdogConfig] = None
    ccl_timeout_s: float = 600.0
    # manual grey-hunting model (tiers 1-2 have no online detection)
    manual_trigger_ratio: float = 1.12   # hour-mean step/healthy to notice
    manual_delay_h: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 6.0, 2: 3.0})
    manual_hours: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 5.0, 2: 1.8})
    manual_success_p: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {1: 0.75, 2: 0.92})
    # automated-tier residual human attention per incident (approve swap,
    # ticket hygiene): online needs more eyes than enhanced
    auto_human_h: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {3: 0.9, 4: 0.35})
    # tiered-checkpoint recovery model: per-tier restore seconds, fast-
    # snapshot cost, and the cadence clamp for the Young-Daly auto-tuner.
    # Which checkpoint tiers exist follows the ablation tier (goodput.py):
    # BURNIN/NODE_SWEEP cold-only, ONLINE + local shard, ENHANCED + peer
    # replica with hot-spare promotion.
    recovery: RecoveryModel = dataclasses.field(
        default_factory=RecoveryModel)
    workload: WorkloadProfile = dataclasses.field(
        default_factory=WorkloadProfile)
    rates: FaultRates = dataclasses.field(default_factory=FaultRates)
    seed: int = 0
    # where the session's detector keeps its state and scores each window
    # (no silent CPU fall back: "cuda" without a card raises)
    device: DeviceLike = "cuda"


@dataclasses.dataclass
class RunResult:
    tier: Tier
    elapsed_h: float
    active_h: float
    steps: int
    crashes: int
    mttf_h: float
    mfu: float
    mean_step_s: float
    p95_step_s: float
    human_hours: float
    incidents: int
    human_h_per_incident: float
    guard_restarts: int
    deferred_swaps: int
    nodes_terminated: int
    step_times: np.ndarray
    events: List[dict]
    # injector fault history (ground truth for attribution scoring):
    # one dict per fault with node/kind/severity/t_start/t_cleared
    fault_log: List[dict] = dataclasses.field(default_factory=list)
    # good (unique-progress) FLOPs per wall hour: replayed steps excluded
    goodput_tflop_h: float = 0.0
    # recovery accounting: MTTR decomposition over the run's
    # RecoveryEvents + fast-snapshot cadence + unique progress
    recovery: Dict = dataclasses.field(default_factory=dict)
    # end-of-run node-pool census (NodeState value -> count) — the
    # conservation check the property tests assert on: every node the
    # run ever touched is in exactly one pool when it ends
    pools: Dict[str, int] = dataclasses.field(default_factory=dict)


def _admission_check(cluster: SimCluster, nid: int, tier: Tier,
                     sweep_cfg: SweepConfig,
                     buddies: List[int]) -> bool:
    """Qualify a freshly provisioned node before it becomes a spare."""
    if tier == Tier.BURNIN:
        return True                      # burn-in passes grey nodes (§5.1)
    enhanced = tier == Tier.ENHANCED
    rep = single_node_sweep(cluster, nid, sweep_cfg, enhanced=enhanced)
    if rep.passed and enhanced and buddies:
        rep = multi_node_sweep(cluster, nid, buddies[:1], sweep_cfg)
    if not rep.passed:
        cluster.injector.clear_node(nid)  # sim shorthand for RMA/replace
    return True


def simulate_run(cfg: RunConfig) -> RunResult:
    rng = np.random.RandomState(cfg.seed + 7)
    topology = Topology.grouped(cfg.n_nodes, cfg.dp_group_size) \
        if cfg.dp_group_size else None
    cluster = SimCluster(cfg.n_nodes, cfg.n_spare,
                         workload=cfg.workload, rates=cfg.rates,
                         window_steps=cfg.window_steps,
                         topology=topology, seed=cfg.seed)
    sweep_cfg = SweepConfig()
    tier = Tier(cfg.tier)

    diagnoser = None
    if cfg.diagnose:
        trace = TimingTrace(depth=cfg.trace_depth)
        cluster.attach_timing(trace)
        diagnoser = Diagnoser(trace,
                              topology or Topology.single(cfg.n_nodes),
                              cfg=cfg.rootcause_cfg)

    watchdog = None
    if cfg.hang_watchdog:
        spans = CollectiveSpanTrace(depth=cfg.trace_depth)
        cluster.attach_spans(spans)
        watchdog = HangWatchdog(spans, cfg=cfg.hang_cfg)

    session = GuardSession.from_tier(
        tier, control=cluster, sweep_backend=cluster, sweep_cfg=sweep_cfg,
        diagnoser=diagnoser, device=cfg.device,
        on_provision=lambda nid: _admission_check(
            cluster, nid, tier, sweep_cfg, session.spare_ids()))
    session.register_active(cluster.active)
    session.register_spares(cluster.spares)
    # correlated scenarios + the pre-existing grey population (the state
    # of the world Guard inherits), all through the declarative layer
    scenarios: List[Scenario] = list(cfg.scenarios)
    if cfg.initial_grey_p > 0:
        scenarios.append(InitialGreyPopulation(p=cfg.initial_grey_p))
    arm_all(scenarios, cluster, rng)
    cluster.fleet.advance_thermals(3600.0)

    duration_s = cfg.duration_h * 3600.0
    healthy_step = cfg.workload.healthy_step_s
    ckpt_every = cfg.checkpoint_interval_steps
    rec = cfg.recovery
    fast_tiers = rec.fast_tier_enabled(int(tier))
    last_ckpt_step = 0             # durable (COLD) restore point
    last_fast_step = 0             # fast-tier restore point (peer/local)
    snap_interval = young_daly_interval(
        session.mttf.estimate(cluster.t), rec.snapshot_cost_s,
        rec.min_interval_s, rec.max_interval_s)
    next_snap_t = cluster.t + snap_interval
    step_chunks: List[np.ndarray] = []
    total_steps = 0
    crashes = 0
    human_hours = 0.0
    incidents = 0
    downtime_s = 0.0
    slow_since: Optional[float] = None
    hour_steps = 0
    hour_sum = 0.0
    win_accum = 0                  # steps gathered toward the next window

    def recover(reason: str, *, rewind: bool, node_alive: bool = True,
                replica_lost: bool = False, detect_s: float = 0.0,
                drain_s: float = 0.0) -> None:
        """One restart, charged at the recovery model's rate: restore from
        the fastest checkpoint tier this ablation tier has built, then the
        generic warmup (re-shard / re-JIT / rejoin). Non-COLD restores
        rewind only to the last *fast* snapshot — the whole point of the
        fast tiers is a shorter replay. Publishes the JobRestart plus the
        MTTR-decomposed RecoveryEvent. ``detect_s``/``drain_s`` were
        already charged by the caller (they precede the restore); they
        ride along for the decomposition only."""
        nonlocal last_fast_step, downtime_s
        ck = rec.pick(int(tier), node_alive, replica_lost)
        restore_s = rec.restore_s(ck)
        warmup_s = cfg.restart_overhead_s
        cluster.advance_idle(restore_s + warmup_s)
        downtime_s += restore_s + warmup_s
        lost = 0
        if rewind:
            target = last_fast_step if ck is not CheckpointTier.COLD \
                else last_ckpt_step
            target = min(target, cluster.step)
            lost = cluster.step - target
            cluster.step = target
        # a fast snapshot taken past the current position is unusable now
        last_fast_step = min(last_fast_step, cluster.step)
        cluster.restart_job(reason)
        session.publish(JobRestart(t=cluster.t, step=cluster.step,
                                   reason=reason, lost_steps=lost,
                                   rewind=rewind))
        session.publish(RecoveryEvent(
            t=cluster.t, step=cluster.step, reason=reason,
            ckpt_tier=ck.value,
            hot_spare=ck is CheckpointTier.PEER,
            detect_s=detect_s, drain_s=drain_s,
            restore_s=restore_s, warmup_s=warmup_s, replay_steps=lost))

    while cluster.t < duration_s:
        # ---------------- one evaluation window (or the slice of one
        # that reaches the next checkpoint boundary), batched
        to_ckpt = ckpt_every - (cluster.step % ckpt_every)
        win = cluster.run_window(min(cfg.window_steps - win_accum, to_ckpt))

        # ---------------- crash path (fail-stop)
        if win["crashed"]:
            if win["steps_run"]:
                step_chunks.append(win["step_times"])
                total_steps += win["steps_run"]
            crashes += 1
            incidents += 1
            drain = cfg.crash_recovery_s[int(tier)]
            cluster.advance_idle(cfg.crash_detect_s + drain)
            downtime_s += cfg.crash_detect_s + drain
            human_hours += cfg.crash_human_h[int(tier)]
            # batch handling: every node found dead during this recovery
            # window is swapped in the same restart
            replica_lost = False
            while cluster.crashed_nodes():
                dead = cluster.crashed_nodes()
                # peer-replica coverage check BEFORE the swaps rewrite the
                # active list: if both members of a DP mirror pair died,
                # some shard has no surviving in-memory replica and the
                # restore degrades to the cold tier
                idx = {n: i for i, n in enumerate(cluster.active)}
                n_act = len(cluster.active)
                dead_idx = {idx[d] for d in dead}
                replica_lost |= any(
                    replica_partner(i, n_act) in dead_idx
                    for i in dead_idx)
                missing = max(0, len(dead) - session.spares_free)
                if missing:
                    # pool ran dry mid-incident: the job waits for delivery
                    cluster.advance_idle(missing * cfg.provision_delay_s)
                    drain += missing * cfg.provision_delay_s
                    downtime_s += missing * cfg.provision_delay_s
                session.handle_crash(
                    dead, lost_steps=cluster.step - last_ckpt_step,
                    step=cluster.step)
                for bad in dead:
                    cluster.injector.clear_node(bad)  # hw leaves with node
            # the dead nodes' local shards died with them (node_alive
            # False); the ENHANCED tier still hot-spare-promotes from the
            # surviving peer replicas unless a whole mirror pair is gone
            recover("fail-stop crash", rewind=True, node_alive=False,
                    replica_lost=replica_lost,
                    detect_s=cfg.crash_detect_s, drain_s=drain)
            win_accum = 0
            hour_steps, hour_sum = 0, 0.0
            continue

        # ---------------- hang path (wedged collective, no step samples)
        if win["hung"]:
            if win["steps_run"]:
                step_chunks.append(win["step_times"])
                total_steps += win["steps_run"]
            incidents += 1
            t_onset = cluster.t
            pend = cluster.hang_pending()
            window_s = cfg.window_steps * healthy_step
            verdicts: List = []
            if watchdog is not None:
                # poll at window cadence: silence accrues against the
                # per-group adaptive deadlines, bounded by the blind
                # framework-level CCL abort
                while not verdicts and \
                        cluster.t - t_onset < cfg.ccl_timeout_s:
                    cluster.advance_idle(window_s)
                    downtime_s += window_s
                    verdicts = watchdog.check(pend, cluster.t)
            else:
                # no ccltrace layer: nothing fires until the framework
                # CCL abort kills the job blind
                cluster.advance_idle(cfg.ccl_timeout_s)
                downtime_s += cfg.ccl_timeout_s
            detect_s = cluster.t - t_onset
            if verdicts:
                n_culprits = sum(len(v.culprits) for v in verdicts)
                missing = max(0, n_culprits - session.spares_free)
                if missing:
                    # pool ran dry mid-incident: wait for delivery
                    cluster.advance_idle(missing * cfg.provision_delay_s)
                    downtime_s += missing * cfg.provision_delay_s
                attributed = False
                for v in verdicts:
                    attributed |= v.attributed
                    session.handle_hang(
                        v, step=cluster.step,
                        latency_windows=detect_s / window_s)
                human_hours += cfg.auto_human_h[int(tier)]
                # culprits left with their hardware faults attached; the
                # quarantine -> sweep -> triage path owns them now (the
                # hang-gated probes keep a still-wedged node from
                # requalifying). Victims were merely blocked: they stay.
                recover("collective hang (culprit evicted)" if attributed
                        else "collective hang (no culprit attributed)",
                        rewind=True, node_alive=True, detect_s=detect_s)
            else:
                # the watchdog never attributed within the CCL abort:
                # blind framework restart, crash-grade human cost
                crashes += 1
                human_hours += cfg.crash_human_h[int(tier)]
                session.mttf.observe_failure(cluster.t)
                recover("collective hang (CCL timeout)", rewind=True,
                        node_alive=True, detect_s=detect_s)
            win_accum = 0
            hour_steps, hour_sum = 0, 0.0
            continue

        step_chunks.append(win["step_times"])
        total_steps += win["steps_run"]
        win_accum += win["steps_run"]
        hour_steps += win["steps_run"]
        hour_sum += float(win["step_times"].sum())
        # offline qualification overlaps the job: let the sweep bench
        # catch up to job time after every window
        session.advance(cluster.t, step=cluster.step)

        # ---------------- fast-tier snapshot (peer replica + local shard)
        if fast_tiers and cluster.t >= next_snap_t:
            last_fast_step = cluster.step
            cluster.advance_idle(rec.snapshot_cost_s)
            downtime_s += rec.snapshot_cost_s
            # cadence follows the live MTTF estimate (Young-Daly): a
            # crashing fleet snapshots more often, a quiet one backs off
            snap_interval = young_daly_interval(
                session.mttf.estimate(cluster.t), rec.snapshot_cost_s,
                rec.min_interval_s, rec.max_interval_s)
            next_snap_t = cluster.t + snap_interval

        # ---------------- online monitoring (tiers 3-4)
        if session.online_monitoring and win_accum >= cfg.window_steps:
            win_accum = 0
            frame = cluster.collect()
            if frame is not None:
                outcome = session.observe(frame)
                restarted = False
                for reason in outcome.restarts:
                    incidents += 1
                    human_hours += cfg.auto_human_h[int(tier)]
                    # eviction: the grey node is alive, so even the
                    # local-shard tier can serve; ENHANCED promotes the
                    # spare from the peer replica (hot-spare resume)
                    recover(reason, rewind=True, node_alive=True)
                    restarted = True
                if restarted:
                    hour_steps, hour_sum = 0, 0.0
        elif win_accum >= cfg.window_steps:
            win_accum = 0

        # ---------------- checkpoint boundary
        if cluster.step > 0 and cluster.step % ckpt_every == 0:
            last_ckpt_step = cluster.step
            if fast_tiers:
                # the durable snapshot is (at least) as fresh as any
                # fast-tier one: both restore points now coincide
                last_fast_step = cluster.step
            ck = session.on_checkpoint(now=cluster.t, step=cluster.step)
            if ck.applied_swaps:
                incidents += ck.applied_swaps
                human_hours += ck.applied_swaps * cfg.auto_human_h[int(tier)]
                # planned restart at the boundary: state is fresh, no
                # rewind; the swapped-out nodes are alive (evictions)
                recover("deferred swaps", rewind=False, node_alive=True)
                win_accum = 0
            human_hours += session.drain_human_hours()
            # background warm-pool maintenance overlaps the job
            session.top_up_spares(cfg.n_spare)

        # ---------------- manual grey hunting (tiers 1-2)
        if not session.online_monitoring and \
                hour_steps * healthy_step >= 3600.0:
            hour_mean = hour_sum / hour_steps
            hour_steps, hour_sum = 0, 0.0
            if hour_mean > cfg.manual_trigger_ratio * healthy_step:
                if slow_since is None:
                    slow_since = cluster.t
                delay = cfg.manual_delay_h[int(tier)] * 3600.0
                if cluster.t - slow_since >= delay:
                    slow_since = None
                    incidents += 1
                    human_hours += cfg.manual_hours[int(tier)]
                    hunt_dt = cfg.hunt_downtime_s[int(tier)]
                    cluster.advance_idle(hunt_dt)
                    downtime_s += hunt_dt
                    times = cluster.node_barrier_times()
                    worst = cluster.active[int(np.argmax(times))]
                    if rng.rand() < cfg.manual_success_p[int(tier)]:
                        if not session.spares_free:
                            # pool dry: the job waits for delivery
                            cluster.advance_idle(cfg.provision_delay_s)
                            downtime_s += cfg.provision_delay_s
                        # a hand-debugged node leaves the fleet for RMA;
                        # it is NOT requalified back into the pool — with
                        # no online monitoring a bounced-back grey would
                        # go unwatched until it escalates
                        session.replace_node(
                            worst, "manual grey-node replacement",
                            quarantine=False, step=cluster.step)
                        if session.sweep_tooling:
                            # tier 2: the human confirms the diagnosis
                            # with the sweep tooling before the RMA
                            rep = single_node_sweep(cluster, worst,
                                                    sweep_cfg)
                            if not rep.passed:
                                cluster.injector.clear_node(worst)
                        else:
                            cluster.injector.clear_node(worst)
                        recover("manual grey-node replacement",
                                rewind=False, node_alive=True)
                        win_accum = 0
            else:
                slow_since = None

    # land any still-running offline qualifications for final accounting
    # (drain stamps the end-of-run events with the FINAL global step, not
    # whatever step the last mid-run advance happened to see)
    session.scheduler.drain(cluster.t, step=cluster.step)
    human_hours += session.drain_human_hours()

    # ----------------------------------------------------------- metrics
    st = np.concatenate(step_chunks) if step_chunks else np.asarray([])
    elapsed_h = cluster.t / 3600.0
    active_h = max(elapsed_h - downtime_s / 3600.0, 1e-9)
    steps = len(st)
    mttf_h = active_h / max(crashes, 1)
    # MFU: completed useful FLOPs over total elapsed time
    mfu = cfg.workload.mfu_at_healthy * (steps * healthy_step) / cluster.t
    stats = session.stats
    events = session.trace.as_dicts()
    # goodput counts only unique forward progress: every step re-executed
    # after a rewind is excluded (MFU above counts it — that's throughput)
    good_steps = int(cluster.step)
    recovery_summary = mttr_decomposition(
        e for e in events if e.get("kind") == "recovery")
    recovery_summary["good_steps"] = good_steps
    recovery_summary["wasted_steps"] = max(steps - good_steps, 0)
    recovery_summary["snap_interval_s"] = float(snap_interval) \
        if fast_tiers else 0.0
    pools: Dict[str, int] = {}
    for state in session.manager.state.values():
        pools[state.value] = pools.get(state.value, 0) + 1
    return RunResult(
        tier=tier, elapsed_h=elapsed_h, active_h=active_h, steps=steps,
        crashes=crashes, mttf_h=mttf_h, mfu=float(mfu),
        mean_step_s=float(st.mean()) if steps else float("nan"),
        p95_step_s=float(np.percentile(st, 95)) if steps else float("nan"),
        human_hours=human_hours, incidents=max(incidents, 1),
        human_h_per_incident=human_hours / max(incidents, 1),
        guard_restarts=stats.immediate_restarts,
        deferred_swaps=stats.deferred_swaps,
        nodes_terminated=stats.nodes_terminated,
        step_times=st, events=events,
        fault_log=[{"node": f.node, "kind": f.kind.value,
                    "device": f.device, "severity": f.severity,
                    "t_start": f.t_start, "t_cleared": f.t_cleared}
                   for f in cluster.injector.faults],
        goodput_tflop_h=goodput_tflop_h(
            good_steps, cfg.workload.step_tflops, elapsed_h),
        recovery=recovery_summary, pools=pools)


# --------------------------------------------------------------------------
# Fleet mode: N concurrent jobs through one FleetController
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetJobSpec:
    """One tenant of the fleet control plane."""
    name: str
    tier: Tier = Tier.ONLINE
    n_nodes: int = 128
    n_spare: int = 4          # private spares adopted into the pool at t=0
    priority: Optional[int] = None    # defaults to the tier value
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FleetRunConfig:
    """The multi-tenant sim: every job shares the controller's global
    spare pool, sweep bench, healthscan and event log."""
    jobs: Tuple[FleetJobSpec, ...] = ()
    duration_h: float = 24.0
    window_steps: int = 6
    checkpoint_interval_steps: int = 90
    crash_detect_s: float = 120.0
    crash_recovery_s: float = 600.0
    restart_overhead_s: float = 600.0
    provision_delay_s: float = 1800.0
    ccl_timeout_s: float = 600.0
    initial_grey_p: float = 0.05
    auto_human_h: float = 0.5
    # fleet control plane
    bench_slots: int = 4
    healthscan_period_s: Optional[float] = 6 * 3600.0
    healthscan_batch: int = 16
    starvation_age_s: float = 3600.0
    floor_frac: float = 0.5
    spare_target: int = 16            # global free-pool floor
    home_min: int = 2                 # per-job sweep-buddy floor
    log_capacity: int = 65536
    workload: WorkloadProfile = dataclasses.field(
        default_factory=WorkloadProfile)
    rates: FaultRates = dataclasses.field(default_factory=FaultRates)
    seed: int = 0
    # where every job's session keeps its detector and scores its windows
    # (no silent CPU fall back: "cuda" without a card raises)
    device: DeviceLike = "cuda"


@dataclasses.dataclass
class FleetRunResult:
    jobs: List[dict]                  # per-job summaries
    elapsed_h: float                  # sim-time horizon reached
    starvation_events: int
    max_wait_s: float
    census: Dict[str, object]         # FleetController.census()
    census_ok: bool
    pool: Dict[str, int]              # grants / transfers / provisions
    healthscan: Dict[str, int]
    events_logged: int
    overhead_s: float                 # control-plane self-time
    wall_s: float                     # total sim wall time
    overhead_frac: float              # overhead_s / wall_s (<5% gated)


@dataclasses.dataclass
class _FleetJobState:
    spec: FleetJobSpec
    cluster: SimCluster
    session: GuardSession
    last_ckpt_step: int = 0
    win_accum: int = 0
    crashes: int = 0
    restarts: int = 0
    total_steps: int = 0
    human_hours: float = 0.0


def _fleet_restart(job: "_FleetJobState", cfg: FleetRunConfig,
                   reason: str, rewind: bool) -> None:
    """Cold-restore restart for the fleet driver (the tiered-checkpoint
    ladder lives in ``simulate_run``; fleet mode keeps recovery lean)."""
    cluster = job.cluster
    cluster.advance_idle(cfg.restart_overhead_s)
    lost = 0
    if rewind:
        target = min(job.last_ckpt_step, cluster.step)
        lost = cluster.step - target
        cluster.step = target
    cluster.restart_job(reason)
    job.restarts += 1
    job.session.publish(JobRestart(t=cluster.t, step=cluster.step,
                                   reason=reason, lost_steps=lost,
                                   rewind=rewind))


def _fleet_window(job: "_FleetJobState", cfg: FleetRunConfig,
                  controller) -> None:
    """Advance one job by (up to) one evaluation window — the fleet
    driver's unit of interleaving."""
    cluster, session = job.cluster, job.session
    ckpt_every = cfg.checkpoint_interval_steps
    to_ckpt = ckpt_every - (cluster.step % ckpt_every)
    win = cluster.run_window(min(cfg.window_steps - job.win_accum, to_ckpt))
    job.total_steps += win["steps_run"]

    if win["crashed"]:
        job.crashes += 1
        cluster.advance_idle(cfg.crash_detect_s + cfg.crash_recovery_s)
        job.human_hours += cfg.auto_human_h
        while cluster.crashed_nodes():
            dead = cluster.crashed_nodes()
            missing = max(0, len(dead) - session.spares_free)
            if missing:
                # global pool dry mid-incident: the job waits for the
                # controller to materialize capacity
                cluster.advance_idle(missing * cfg.provision_delay_s)
            session.handle_crash(dead,
                                 lost_steps=cluster.step -
                                 job.last_ckpt_step,
                                 step=cluster.step)
            for bad in dead:
                cluster.injector.clear_node(bad)
        _fleet_restart(job, cfg, "fail-stop crash", rewind=True)
        job.win_accum = 0
        return

    if win["hung"]:
        # lean hang handling: wait out the framework CCL abort, evict
        # nothing (no ccltrace layer in fleet mode), restart blind
        cluster.advance_idle(cfg.ccl_timeout_s)
        job.crashes += 1
        job.human_hours += cfg.auto_human_h
        session.mttf.observe_failure(cluster.t)
        _fleet_restart(job, cfg, "collective hang (CCL timeout)",
                       rewind=True)
        job.win_accum = 0
        return

    job.win_accum += win["steps_run"]
    session.advance(cluster.t, step=cluster.step)

    if session.online_monitoring and job.win_accum >= cfg.window_steps:
        job.win_accum = 0
        frame = cluster.collect()
        if frame is not None:
            outcome = session.observe(frame)
            for reason in outcome.restarts:
                job.human_hours += cfg.auto_human_h
                _fleet_restart(job, cfg, reason, rewind=True)
    elif job.win_accum >= cfg.window_steps:
        job.win_accum = 0

    if cluster.step > 0 and cluster.step % ckpt_every == 0:
        job.last_ckpt_step = cluster.step
        ck = session.on_checkpoint(now=cluster.t, step=cluster.step)
        if ck.applied_swaps:
            job.human_hours += ck.applied_swaps * cfg.auto_human_h
            _fleet_restart(job, cfg, "deferred swaps", rewind=False)
            job.win_accum = 0
        job.human_hours += session.drain_human_hours()
        # warm-pool maintenance is a CONTROLLER duty in fleet mode: the
        # global floor + per-job buddy floor replace per-job n_spare
        controller.top_up(cfg.spare_target, home_min=cfg.home_min)


def simulate_fleet(cfg: FleetRunConfig) -> FleetRunResult:
    """Drive N concurrent jobs through one ``FleetController``.

    Jobs advance in global event order (the job with the smallest sim
    clock steps next), so cross-job contention on the pool and bench is
    resolved in the same order a real shared control plane would see
    the requests. Control-plane overhead is the controller's self-timed
    entry points as a fraction of total sim wall time."""
    from repro_torch.fleet import FleetController

    assert cfg.jobs, "FleetRunConfig needs at least one job"
    wall0 = time.perf_counter()
    controller = FleetController(
        bench_slots=cfg.bench_slots,
        starvation_age_s=cfg.starvation_age_s,
        floor_frac=cfg.floor_frac,
        log_capacity=cfg.log_capacity,
        healthscan_period_s=cfg.healthscan_period_s,
        healthscan_batch=cfg.healthscan_batch)
    rng = np.random.RandomState(cfg.seed + 17)
    jobs: List[_FleetJobState] = []
    for spec in cfg.jobs:
        cluster = SimCluster(spec.n_nodes, spec.n_spare,
                             workload=cfg.workload, rates=cfg.rates,
                             window_steps=cfg.window_steps,
                             seed=cfg.seed + spec.seed)
        # no inline admission in fleet mode: spares live in the shared
        # pool and the healthscan orchestrator is the line of defense
        # against admission greys (the cluster-service model)
        session = GuardSession.from_tier(Tier(spec.tier), control=cluster,
                                         sweep_backend=cluster,
                                         sweep_cfg=SweepConfig(),
                                         device=cfg.device)
        session.register_active(cluster.active)
        session.register_spares(cluster.spares)
        controller.register_job(spec.name, session,
                                priority=spec.priority)
        if cfg.initial_grey_p > 0:
            arm_all([InitialGreyPopulation(p=cfg.initial_grey_p)],
                    cluster, rng)
        cluster.fleet.advance_thermals(3600.0)
        jobs.append(_FleetJobState(spec, cluster, session))
    controller.top_up(cfg.spare_target, home_min=cfg.home_min)

    duration_s = cfg.duration_h * 3600.0
    while True:
        pending = [j for j in jobs if j.cluster.t < duration_s]
        if not pending:
            break
        job = min(pending, key=lambda j: j.cluster.t)
        _fleet_window(job, cfg, controller)
        controller.tick(job.cluster.t)

    for job in jobs:
        job.session.scheduler.drain(job.cluster.t, step=job.cluster.step)
        job.human_hours += job.session.drain_human_hours()

    census = controller.census()
    wall_s = time.perf_counter() - wall0
    fj = controller.jobs
    return FleetRunResult(
        jobs=[{
            "name": j.spec.name,
            "tier": int(j.spec.tier),
            "priority": fj[j.spec.name].priority,
            "n_nodes": j.spec.n_nodes,
            "steps": j.total_steps,
            "good_steps": int(j.cluster.step),
            "crashes": j.crashes,
            "restarts": j.restarts,
            "leases": fj[j.spec.name].leases,
            "transfers": fj[j.spec.name].transfer_grants,
            "provision_grants": fj[j.spec.name].provision_grants,
            "human_hours": j.human_hours,
            "elapsed_h": j.cluster.t / 3600.0,
        } for j in jobs],
        elapsed_h=max(j.cluster.t for j in jobs) / 3600.0,
        starvation_events=controller.starvation_events(),
        max_wait_s=controller.pool.stats.max_wait_s,
        census=census,
        census_ok=bool(census["conserved"]),
        pool={"grants": controller.pool.stats.grants,
              "transfers": controller.pool.stats.transfers,
              "provisions": controller.pool.stats.provisions},
        healthscan={
            "campaigns": controller.healthscan.campaigns,
            "scanned": controller.healthscan.scanned,
            "failed": len(controller.healthscan.failed),
        } if controller.healthscan is not None else {},
        events_logged=controller.log.head,
        overhead_s=controller.overhead_s,
        wall_s=wall_s,
        overhead_frac=controller.overhead_s / max(wall_s, 1e-9))
