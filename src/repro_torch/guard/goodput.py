"""Recovery accounting: checkpoint tiers, MTTF-tuned snapshot cadence,
MTTR decomposition, and goodput; the port's own copy of the JAX package's
``repro.guard.goodput`` (standard library only).

The detection half of the loop optimizes *avoidance* metrics (MFU, step
variance, MTTF); this module carries the *recovery* half: once detection
works, wasted FLOPs are dominated by how a job gets back to training
after an incident.

Three checkpoint tiers (``CheckpointTier``), fastest first:

  PEER    each node's shard mirrored in a DP peer's memory. Restoring is
          a fabric copy: a hot spare promoted into the job pulls the
          evicted/dead node's state from the surviving replica holder
          instead of cold-starting from durable storage.
  LOCAL   per-node local shard on node-local disk. Survives evictions
          (the node is alive, its shard is readable) but dies with the
          node on fail-stop.
  COLD    the durable global checkpoint (the npz/manifest directory).

Cadence for the fast tiers is auto-tuned from the **live** MTTF estimate
the Guard session tracks (``MTTFEstimator``) with the Young–Daly optimum
``sqrt(2 * snapshot_cost * MTTF)``: a fleet that starts crashing
snapshots more often; a quiet fleet backs off toward the cap.

``mttr_decomposition`` aggregates the ``RecoveryEvent``s a run published
into the detect → drain → restore → warmup phase split plus per-tier
restore counts, and ``goodput_tflop_h`` is the headline: good (unique,
never-replayed) FLOPs per wall hour.

Everything here is dependency-free, so ``repro_torch.train.checkpoint``
and the session both import it without cycles.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Iterable, List, Optional, Tuple


class CheckpointTier(enum.Enum):
    """Restore sources, fastest first (see module docstring)."""
    PEER = "peer"
    LOCAL = "local"
    COLD = "cold"


def young_daly_interval(mttf_s: float, snapshot_cost_s: float,
                        lo: float = 60.0, hi: float = 1800.0) -> float:
    """Optimal checkpoint interval ``sqrt(2 * C * MTTF)`` (Young/Daly),
    clamped to [lo, hi]."""
    mttf_s = max(float(mttf_s), 1e-9)
    opt = math.sqrt(2.0 * max(float(snapshot_cost_s), 1e-9) * mttf_s)
    return float(min(max(opt, lo), hi))


def replica_partner(i: int, n: int) -> int:
    """DP-peer replica placement over ``n`` job slots: adjacent pairing
    (slot ``i`` mirrors onto ``i ^ 1``), with the odd tail slot mirroring
    onto slot 0. Symmetric for every even-sized fleet; the only
    asymmetric slots are the odd tail and its holder."""
    if n <= 1:
        return i
    j = i ^ 1
    return j if j < n else 0


@dataclasses.dataclass
class MTTFEstimator:
    """Live mean-time-between-job-interrupts estimate.

    Bayesian-flavored: a ``prior_mttf_s`` prior observation is blended
    with the observed (elapsed time, interrupt count), so the estimate
    is finite from t=0 and converges to the empirical rate as evidence
    accumulates. "Failure" here means any job-interrupting event that
    forces a restore — fail-stop crashes and Guard-driven immediate
    restarts both count, because both cost a replay window (the quantity
    the snapshot cadence is tuned against)."""
    t0: float = 0.0
    prior_mttf_s: float = 6 * 3600.0
    prior_weight: float = 1.0
    failures: int = 0
    last_failure_t: Optional[float] = None

    def observe_failure(self, t: float) -> None:
        self.failures += 1
        self.last_failure_t = float(t)

    def estimate(self, now: float) -> float:
        elapsed = max(float(now) - self.t0, 0.0)
        return (elapsed + self.prior_weight * self.prior_mttf_s) / \
            (self.failures + self.prior_weight)


@dataclasses.dataclass(frozen=True)
class RecoveryModel:
    """Tier-dependent recovery costs + which checkpoint tiers each Guard
    ablation tier has built (the recovery ladder mirrors the detection
    ladder of Table 4):

      BURNIN / NODE_SWEEP   durable checkpoints only (cold restarts)
      ONLINE                + local-shard fast tier
      ENHANCED              + peer-replica tier and hot-spare promotion
    """
    peer_restore_s: float = 30.0      # fabric copy from the replica holder
    local_restore_s: float = 120.0    # node-local shard reload
    cold_restore_s: float = 480.0     # durable storage, full job re-shard
    snapshot_cost_s: float = 2.0      # async fast-tier snapshot stall
    min_interval_s: float = 60.0      # fast-tier cadence clamp
    max_interval_s: float = 1800.0

    def restore_s(self, tier: CheckpointTier) -> float:
        return {CheckpointTier.PEER: self.peer_restore_s,
                CheckpointTier.LOCAL: self.local_restore_s,
                CheckpointTier.COLD: self.cold_restore_s}[tier]

    def tiers_for(self, guard_tier: int) -> Tuple[CheckpointTier, ...]:
        if guard_tier >= 4:
            return (CheckpointTier.PEER, CheckpointTier.LOCAL,
                    CheckpointTier.COLD)
        if guard_tier >= 3:
            return (CheckpointTier.LOCAL, CheckpointTier.COLD)
        return (CheckpointTier.COLD,)

    def fast_tier_enabled(self, guard_tier: int) -> bool:
        return guard_tier >= 3

    def pick(self, guard_tier: int, node_alive: bool,
             replica_lost: bool = False) -> CheckpointTier:
        """Best restore source for one incident.

        ``node_alive``: the leaving node still responds (eviction /
        planned swap) — its LOCAL shard is readable. On fail-stop the
        local shard died with the node, so only the PEER replica (if the
        holder survived) or COLD storage can serve.
        ``replica_lost``: the incident also took out a replica holder
        (both members of a mirror pair died), so the PEER tier cannot
        cover every shard and the restore degrades to COLD."""
        tiers = self.tiers_for(guard_tier)
        if CheckpointTier.PEER in tiers and not replica_lost:
            return CheckpointTier.PEER
        if CheckpointTier.LOCAL in tiers and node_alive:
            return CheckpointTier.LOCAL
        return CheckpointTier.COLD


#: phase keys of the MTTR decomposition, in incident order
MTTR_PHASES = ("detect_s", "drain_s", "restore_s", "warmup_s")


def mttr_decomposition(events: Iterable) -> Dict[str, object]:
    """Aggregate ``RecoveryEvent``s (typed or their ``to_dict`` form)
    into the detect → drain → restore → warmup decomposition.

    Always returns the full schema — zero-filled when the run had no
    incidents — so artifact consumers (and the CI gate) can rely on the
    fields existing."""
    recs: List[dict] = []
    for e in events:
        d = e.to_dict() if hasattr(e, "to_dict") else dict(e)
        if d.get("kind", "recovery") == "recovery":
            recs.append(d)
    n = len(recs)
    out: Dict[str, object] = {"incidents": n}
    totals = {}
    for k in MTTR_PHASES:
        totals[k] = float(sum(r.get(k, 0.0) for r in recs))
        out[f"{k}_total"] = totals[k]
        out[f"{k}_mean"] = totals[k] / n if n else 0.0
    total = sum(totals.values())
    out["mttr_total_s"] = total
    out["mttr_s"] = total / n if n else 0.0
    out["replay_steps_total"] = int(sum(r.get("replay_steps", 0)
                                        for r in recs))
    out["hot_spare_promotions"] = sum(1 for r in recs if r.get("hot_spare"))
    out["by_tier"] = {t.value: sum(1 for r in recs
                                   if r.get("ckpt_tier") == t.value)
                      for t in CheckpointTier}
    return out


def goodput_tflop_h(good_steps: int, step_tflops: float,
                    elapsed_h: float) -> float:
    """Good FLOPs per wall hour: only *unique* forward progress counts —
    a step re-executed after a rewind is wasted work, not goodput."""
    if elapsed_h <= 0.0:
        return 0.0
    return float(step_tflops) * int(good_steps) / float(elapsed_h)


__all__ = [
    "CheckpointTier", "MTTFEstimator", "MTTR_PHASES", "RecoveryModel",
    "goodput_tflop_h", "mttr_decomposition", "replica_partner",
    "young_daly_interval",
]
