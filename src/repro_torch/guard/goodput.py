"""Recovery accounting the session needs: the live MTTF estimate.

The JAX package's ``repro.guard.goodput`` also holds the checkpoint
tiers, the Young–Daly cadence, the MTTR decomposition and goodput; they
serve the training slice and come over with it. The session itself only
tracks the mean time between job interrupts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class MTTFEstimator:
    """Live mean-time-between-job-interrupts estimate.

    Bayesian-flavored: a ``prior_mttf_s`` prior observation is blended
    with the observed (elapsed time, interrupt count), so the estimate
    is finite from t=0 and converges to the empirical rate as evidence
    accumulates. "Failure" here means any job-interrupting event that
    forces a restore — fail-stop crashes and Guard-driven immediate
    restarts both count, because both cost a replay window."""
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


__all__ = ["MTTFEstimator"]
