"""Offline node-sweep verification (§5).

Event-driven qualification: a node flagged by online monitoring (or returning
from repair) must pass sweeps before re-entering the healthy pool.

  Single-node sweep (§5.2): sustained per-device compute throughput (matmul
  burn — on the card this is the ``repro_torch.kernels.sweep_burn``
  CUDA kernel) + pairwise intra-node interconnect bandwidth/symmetry.

  Multi-node sweep (§5.3): collective-communication mini-workload on small
  groups. 2-node sweeps against a known-good buddy are the default — the
  paper finds most communication degradations already visible at 2 nodes;
  4/8-node configurations are supported but offer diminishing returns.

  Fleet campaign: ``fleet_qualification`` sweeps every node of a campaign
  in one vectorized pass — batched compute/bandwidth/collective probes
  (the optional ``batch_*`` backend methods, with a scalar-compat
  fallback), round-robin buddy pairing from a known-good reference pool
  (suspects are never each other's buddies), and per-node verdicts that
  are bit-identical to running the scalar sweeps node by node.

Verdicts are conservative (§5.4): a node re-enters service only if EVERY
probe is within tolerance both of the fleet reference and of its own peers
(intra-node symmetry); otherwise it stays quarantined for triage.

Cost model: the per-device burns run SEQUENTIALLY on the node, so a
single-node sweep occupies the sweep bench for ``burn_seconds * devices``
(+ a fixed setup cost per bandwidth pair) — an 8-device enhanced sweep is
a multi-hour bench occupation, which is exactly why qualification is
scheduled off the job's critical path.

The sweep talks to hardware through ``SweepBackend`` — the simulated fleet
and the local-device backend (``LocalTorchSweepBackend``) both
implement it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

# fixed per-pair setup/teardown cost of a bandwidth probe, seconds
PAIR_PROBE_S = 30.0


@dataclasses.dataclass(frozen=True)
class SweepReference:
    """Fleet-expected healthy values (from qualification of known-good
    hardware; refreshed whenever the platform generation changes)."""
    device_tflops: float          # sustained matmul TFLOP/s per device
    intra_bw_gbps: float          # pairwise interconnect GB/s
    pair_step_time: float         # 2-node sweep-workload step time, s


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    # single-node
    compute_tolerance: float = 0.07      # device within 7% of reference
    symmetry_tolerance: float = 0.05     # device within 5% of node median
    bw_tolerance: float = 0.10           # pair bw within 10% of reference
    burn_seconds: float = 120.0          # per-device sustained burn
    # multi-node
    group_size: int = 2                  # default 2-node sweeps
    sweep_steps: int = 50                # mini-workload steps per group
    inflation_tolerance: float = 0.08    # step time within 8% of reference
    # enhanced sweep = longer burns + multi-node stage (§7.2 Table 4 tier 4)
    enhanced_burn_seconds: float = 3600.0


class SweepBackend(Protocol):
    """What the sweep needs from the substrate.

    The ``batch_*`` methods are OPTIONAL: a backend that can amortize
    probes fleet-wide (the simulator, a real campaign runner fanning out
    over hosts) implements them and ``fleet_qualification`` uses them;
    otherwise the campaign falls back to the scalar probes node by node
    with identical results.
    """

    def device_count(self, node_id: int) -> int: ...

    def compute_probe(self, node_id: int, device: int,
                      seconds: float) -> float:
        """Sustained matmul throughput, TFLOP/s."""
        ...

    def intra_bw_probe(self, node_id: int, dev_a: int, dev_b: int) -> float:
        """Pairwise intra-node interconnect bandwidth, GB/s."""
        ...

    def multi_node_probe(self, node_ids: Sequence[int],
                         steps: int) -> np.ndarray:
        """Step times (s) of a collective mini-workload over the group."""
        ...

    def reference(self) -> SweepReference: ...

    # --- optional batched protocol (fleet campaigns) ---
    # def batch_compute_probe(node_ids, seconds) -> (N, D) array
    # def batch_intra_bw_probe(node_ids, pairs) -> (N, len(pairs)) array
    # def batch_multi_node_probe(groups, steps) -> (G, steps) array


@dataclasses.dataclass
class SweepReport:
    node_id: int
    passed: bool
    failures: List[str]
    duration_s: float
    measurements: Dict[str, object]


def intra_pairs(nd: int) -> List[Tuple[int, int]]:
    """Deduped canonical (lo, hi) bandwidth-probe pairs covering every
    device: the ring plus a few cross pairs. Single-device nodes have no
    intra-node interconnect to probe (the naive ring would emit a
    degenerate (0, 0) self-pair), and for small ``nd`` the ring and
    cross sets overlap — duplicates are dropped in first-seen order."""
    if nd <= 1:
        return []
    raw = [(a, (a + 1) % nd) for a in range(nd)]
    raw += [(a, (a + nd // 2) % nd) for a in range(nd // 2)]
    seen = set()
    pairs: List[Tuple[int, int]] = []
    for a, b in raw:
        key = (a, b) if a <= b else (b, a)
        if key not in seen:
            seen.add(key)
            pairs.append(key)
    return pairs


# ------------------------------------------------------- verdict builders
# Shared by the scalar sweeps and the batched campaign: both paths MUST
# produce identical failure strings for identical measurements (the
# batched-vs-scalar golden contract).

def _single_node_failures(tflops: np.ndarray,
                          pairs: Sequence[Tuple[int, int]],
                          bw: Sequence[float], ref: SweepReference,
                          cfg: SweepConfig) -> List[str]:
    failures: List[str] = []
    node_med = np.median(tflops)
    for d in range(len(tflops)):
        if tflops[d] < ref.device_tflops * (1 - cfg.compute_tolerance):
            failures.append(
                f"compute dev{d}: {tflops[d]:.1f} TF/s < "
                f"{(1 - cfg.compute_tolerance) * ref.device_tflops:.1f}")
        if tflops[d] < node_med * (1 - cfg.symmetry_tolerance):
            failures.append(
                f"asymmetry dev{d}: {tflops[d]:.1f} TF/s vs node median "
                f"{node_med:.1f}")
    for (a, b), g in zip(pairs, bw):
        if g < ref.intra_bw_gbps * (1 - cfg.bw_tolerance):
            failures.append(
                f"intra-bw {a}<->{b}: {g:.0f} GB/s < "
                f"{(1 - cfg.bw_tolerance) * ref.intra_bw_gbps:.0f}")
    return failures


def _multi_failure(group: Sequence[int], med: float, ref: SweepReference,
                   cfg: SweepConfig) -> str:
    return (f"group step time {med:.3f}s > "
            f"{(1 + cfg.inflation_tolerance) * ref.pair_step_time:.3f}s "
            f"(group={list(group)})")


def _single_duration(burn: float, nd: int, n_pairs: int) -> float:
    # per-device burns are sequential on the node: the bench is occupied
    # for burn * nd, NOT burn (the pre-fix `burn * nd / max(nd, 1)`
    # collapsed to `burn` for every device count, releasing 8-device
    # qualifications ~8x too early)
    return burn * nd + PAIR_PROBE_S * n_pairs


# ---------------------------------------------------------- scalar sweeps

def single_node_sweep(backend: SweepBackend, node_id: int,
                      cfg: Optional[SweepConfig] = None,
                      enhanced: bool = False,
                      reference: Optional[SweepReference] = None
                      ) -> SweepReport:
    cfg = cfg or SweepConfig()
    ref = reference if reference is not None else backend.reference()
    nd = backend.device_count(node_id)
    burn = cfg.enhanced_burn_seconds if enhanced else cfg.burn_seconds

    tflops = np.array([backend.compute_probe(node_id, d, burn)
                       for d in range(nd)])
    pairs = intra_pairs(nd)
    bw = [backend.intra_bw_probe(node_id, a, b) for a, b in pairs]
    failures = _single_node_failures(tflops, pairs, bw, ref, cfg)
    duration = _single_duration(burn, nd, len(pairs))
    return SweepReport(node_id, not failures, failures, duration,
                       {"tflops": tflops, "bw": dict(zip(pairs, bw))})


def multi_node_sweep(backend: SweepBackend, node_id: int,
                     buddies: Sequence[int],
                     cfg: Optional[SweepConfig] = None,
                     reference: Optional[SweepReference] = None
                     ) -> SweepReport:
    """Sweep ``node_id`` in a group with known-good ``buddies``."""
    cfg = cfg or SweepConfig()
    ref = reference if reference is not None else backend.reference()
    group = [node_id, *buddies][: max(cfg.group_size, 2)]
    times = backend.multi_node_probe(group, cfg.sweep_steps)
    med = float(np.median(times))
    failures = []
    if med > ref.pair_step_time * (1 + cfg.inflation_tolerance):
        failures.append(_multi_failure(group, med, ref, cfg))
    duration = med * cfg.sweep_steps
    return SweepReport(node_id, not failures, failures, duration,
                       {"group": group, "step_times": times})


def qualification_sweep(backend: SweepBackend, node_id: int,
                        buddies: Sequence[int],
                        cfg: Optional[SweepConfig] = None,
                        enhanced: bool = True,
                        reference: Optional[SweepReference] = None
                        ) -> SweepReport:
    """Full offline qualification: single-node stage, then (enhanced only)
    the 2-node collective stage. Conservative: all stages must pass."""
    cfg = cfg or SweepConfig()
    rep = single_node_sweep(backend, node_id, cfg, enhanced=enhanced,
                            reference=reference)
    if not enhanced:
        return rep
    if rep.passed and buddies:
        multi = multi_node_sweep(backend, node_id, buddies, cfg,
                                 reference=reference)
        rep = SweepReport(
            node_id, rep.passed and multi.passed,
            rep.failures + multi.failures,
            rep.duration_s + multi.duration_s,
            {**rep.measurements, **multi.measurements})
    return rep


# ------------------------------------------------------ fleet campaigns

@dataclasses.dataclass(frozen=True)
class SweepCampaign:
    """One offline fleet-qualification campaign (pre-job or periodic).

    ``reference_pool`` holds tracked known-good nodes used as multi-node
    buddies (round-robin), so campaign suspects are never each other's
    buddies; when empty, the campaign bootstraps the pool from its own
    single-stage passers. ``reference=None`` auto-calibrates the
    :class:`SweepReference` from fleet medians — the §5 practice of
    qualifying a new platform generation against itself."""
    node_ids: Tuple[int, ...]
    reference_pool: Tuple[int, ...] = ()
    enhanced: bool = True
    reference: Optional[SweepReference] = None


@dataclasses.dataclass
class CampaignResult:
    reports: List[SweepReport]            # one per campaign node, in order
    reference: SweepReference             # the reference verdicts used
    calibrated: bool                      # True when derived from medians
    buddies: Dict[int, Tuple[int, ...]]   # first-attempt buddy sets
    retry_buddies: Dict[int, Tuple[int, ...]]   # disjoint retry sets
    sweeps: int                           # total sweep executions
    node_seconds: float                   # summed bench occupancy
    wall_s: float                         # real wall of the campaign pass

    @property
    def passed(self) -> List[int]:
        return [r.node_id for r in self.reports if r.passed]

    @property
    def failed(self) -> List[int]:
        return [r.node_id for r in self.reports if not r.passed]


def _batch_compute(backend: SweepBackend, nodes: Sequence[int], nd: int,
                   seconds: float) -> np.ndarray:
    fn = getattr(backend, "batch_compute_probe", None)
    if fn is not None:
        out = np.asarray(fn(nodes, seconds), dtype=float)
    else:
        out = np.array([[backend.compute_probe(n, d, seconds)
                         for d in range(nd)] for n in nodes], dtype=float)
    assert out.shape == (len(nodes), nd), out.shape
    return out


def _batch_bw(backend: SweepBackend, nodes: Sequence[int],
              pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    if not pairs:
        return np.zeros((len(nodes), 0))
    fn = getattr(backend, "batch_intra_bw_probe", None)
    if fn is not None:
        out = np.asarray(fn(nodes, tuple(pairs)), dtype=float)
    else:
        out = np.array([[backend.intra_bw_probe(n, a, b) for a, b in pairs]
                        for n in nodes], dtype=float)
    assert out.shape == (len(nodes), len(pairs)), out.shape
    return out


def _batch_multi(backend: SweepBackend, groups: Sequence[Sequence[int]],
                 steps: int) -> np.ndarray:
    if not groups:
        return np.zeros((0, steps))
    fn = getattr(backend, "batch_multi_node_probe", None)
    if fn is not None:
        out = np.asarray(fn(tuple(tuple(g) for g in groups), steps),
                         dtype=float)
    else:
        out = np.array([backend.multi_node_probe(list(g), steps)
                        for g in groups], dtype=float)
    assert out.shape == (len(groups), steps), out.shape
    return out


def _round_robin_buddies(candidates: Sequence[int], pool: Sequence[int],
                         nb: int,
                         avoid: Optional[Dict[int, set]] = None
                         ) -> Dict[int, Tuple[int, ...]]:
    """Round-robin buddy assignment from a known-good pool. A candidate
    never buddies itself, never repeats a buddy within its set, and
    (via ``avoid``) never re-tests against a buddy it already failed
    with — the retry must be DISJOINT to disambiguate a contaminated
    buddy from a genuinely bad node."""
    out: Dict[int, Tuple[int, ...]] = {}
    k = 0
    for c in candidates:
        banned = {c} | (avoid.get(c, set()) if avoid else set())
        bs: List[int] = []
        for _ in range(len(pool) + nb):
            if len(bs) == nb or not pool:
                break
            b = pool[k % len(pool)]
            k += 1
            if b not in banned and b not in bs:
                bs.append(b)
        out[c] = tuple(bs)
    return out


def fleet_qualification(backend: SweepBackend, campaign: SweepCampaign,
                        cfg: Optional[SweepConfig] = None
                        ) -> CampaignResult:
    """Qualify every campaign node in one vectorized pass.

    Stage 1 batches all compute burns and bandwidth probes; stage 2
    (enhanced campaigns) batches the collective mini-workloads of the
    single-stage passers against round-robin buddies from the reference
    pool, retrying each failing group once against a disjoint buddy set.
    Per-node verdicts, failure strings and measurements are bit-identical
    to running the scalar sweeps node by node with the same reference
    and buddy assignment."""
    t0 = time.perf_counter()
    cfg = cfg or SweepConfig()
    nodes = [int(n) for n in campaign.node_ids]
    ref0 = campaign.reference
    calibrated = ref0 is None
    if not nodes:
        return CampaignResult([], ref0 or backend.reference(), calibrated,
                              {}, {}, 0, 0.0, time.perf_counter() - t0)
    nd = int(backend.device_count(nodes[0]))
    hetero = [n for n in nodes if int(backend.device_count(n)) != nd]
    if hetero:
        # the batched pass is one uniform (N, D) composition — a mixed
        # fleet must be split into per-device-count campaigns
        raise ValueError(
            f"fleet_qualification needs a uniform device count: "
            f"node {nodes[0]} has {nd}, nodes {hetero[:4]} differ")
    burn = cfg.enhanced_burn_seconds if campaign.enhanced \
        else cfg.burn_seconds
    pairs = intra_pairs(nd)

    # ---- stage 1: batched single-node probes
    tflops = _batch_compute(backend, nodes, nd, burn)        # (N, D)
    bw = _batch_bw(backend, nodes, pairs)                    # (N, P)
    ref_tf = float(np.median(tflops)) if calibrated \
        else ref0.device_tflops
    ref_bw = float(np.median(bw)) if calibrated and bw.size \
        else (backend.reference().intra_bw_gbps if calibrated
              else ref0.intra_bw_gbps)
    node_med = np.median(tflops, axis=1)                     # (N,)
    comp_bad = tflops < ref_tf * (1 - cfg.compute_tolerance)
    asym_bad = tflops < node_med[:, None] * (1 - cfg.symmetry_tolerance)
    bw_bad = bw < ref_bw * (1 - cfg.bw_tolerance)
    single_bad = comp_bad.any(axis=1) | asym_bad.any(axis=1) | \
        bw_bad.any(axis=1)
    single_dur = _single_duration(burn, nd, len(pairs))
    sweeps = len(nodes)

    # ---- stage 2: batched multi-node collective stage
    buddies: Dict[int, Tuple[int, ...]] = {}
    retry_buddies: Dict[int, Tuple[int, ...]] = {}
    med1: Dict[int, float] = {}
    med2: Dict[int, float] = {}
    times1: Dict[int, np.ndarray] = {}
    times2: Dict[int, np.ndarray] = {}
    multi_ok: Dict[int, bool] = {}
    ref_pair = backend.reference().pair_step_time if calibrated \
        else ref0.pair_step_time
    if campaign.enhanced:
        nb = max(cfg.group_size - 1, 1)
        cands = [n for n, bad in zip(nodes, single_bad) if not bad]
        pool = [int(p) for p in campaign.reference_pool] or cands
        buddies = _round_robin_buddies(cands, pool, nb)
        runnable = [c for c in cands if buddies[c]]
        groups = [[c, *buddies[c]][: max(cfg.group_size, 2)]
                  for c in runnable]
        t_all = _batch_multi(backend, groups, cfg.sweep_steps)
        sweeps += len(groups)
        meds = np.median(t_all, axis=1) if len(groups) else np.zeros(0)
        if calibrated and len(groups):
            # fleet-median calibration of the pair reference: median of
            # the per-group medians (robust to the faulty minority)
            ref_pair = float(np.median(meds))
        for c, m, row in zip(runnable, meds, t_all):
            med1[c] = float(m)
            times1[c] = row
            multi_ok[c] = float(m) <= ref_pair * \
                (1 + cfg.inflation_tolerance)
        # retry the failing groups against DISJOINT buddies: a failure
        # shared with a contaminated buddy must not condemn the node
        retry_cands = [c for c in runnable if not multi_ok[c]]
        if retry_cands:
            avoid = {c: set(buddies[c]) for c in retry_cands}
            retry_buddies = _round_robin_buddies(retry_cands, pool, nb,
                                                 avoid=avoid)
            retry_run = [c for c in retry_cands if retry_buddies[c]]
            rgroups = [[c, *retry_buddies[c]][: max(cfg.group_size, 2)]
                       for c in retry_run]
            rt = _batch_multi(backend, rgroups, cfg.sweep_steps)
            sweeps += len(rgroups)
            rmeds = np.median(rt, axis=1) if len(rgroups) else np.zeros(0)
            for c, m, row in zip(retry_run, rmeds, rt):
                med2[c] = float(m)
                times2[c] = row
                multi_ok[c] = float(m) <= ref_pair * \
                    (1 + cfg.inflation_tolerance)

    reference = SweepReference(ref_tf, ref_bw, ref_pair)

    # ---- per-node reports (failure strings materialized O(failing))
    reports: List[SweepReport] = []
    node_seconds = 0.0
    for i, n in enumerate(nodes):
        failures: List[str] = []
        duration = single_dur
        meas: Dict[str, object] = {"tflops": tflops[i],
                                   "bw": dict(zip(pairs, bw[i]))}
        if single_bad[i]:
            failures = _single_node_failures(tflops[i], pairs, bw[i],
                                             reference, cfg)
        elif campaign.enhanced:
            bs = buddies.get(n, ())
            if not bs:
                failures.append(
                    "buddy_exhausted: no known-good buddy for the "
                    "multi-node stage")
            else:
                group = [n, *bs][: max(cfg.group_size, 2)]
                duration += med1[n] * cfg.sweep_steps
                meas["group"] = group
                meas["step_times"] = times1[n]
                if not multi_ok[n] or n in med2:
                    rbs = retry_buddies.get(n, ())
                    if not multi_ok[n] and not rbs:
                        failures.append(_multi_failure(group, med1[n],
                                                       reference, cfg))
                        failures.append(
                            "buddy_exhausted: no disjoint retry buddy")
                    elif n in med2:
                        rgroup = [n, *rbs][: max(cfg.group_size, 2)]
                        duration += med2[n] * cfg.sweep_steps
                        meas["first_group"] = group
                        meas["first_step_times"] = times1[n]
                        meas["group"] = rgroup
                        meas["step_times"] = times2[n]
                        meas["retried"] = True
                        if not multi_ok[n]:
                            failures.append(_multi_failure(
                                rgroup, med2[n], reference, cfg))
        node_seconds += duration
        reports.append(SweepReport(n, not failures, failures, duration,
                                   meas))
    return CampaignResult(reports, reference, calibrated, buddies,
                          retry_buddies, sweeps, node_seconds,
                          time.perf_counter() - t0)
