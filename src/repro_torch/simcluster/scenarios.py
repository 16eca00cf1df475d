"""Declarative fault-scenario layer: correlated injections over the fleet.

Independent Poisson arrivals (``FaultRates``) model background wear, but
real incident logs are dominated by CORRELATED events — a rack loses
cooling and eight nodes throttle together, a leaf switch dies and every
NIC behind it downtrains, fabric congestion storms sweep a job, planned
maintenance degrades a block of hosts for a bounded window. A
``Scenario`` is a frozen declarative spec of one such event; ``arm``
compiles it against a concrete ``SimCluster`` into scheduled injections
on the fault injector's event heap (or immediate injections for t<=0
events such as the pre-existing grey population a long-unmanaged cluster
has accumulated).

Usage::

    from repro_torch.simcluster.scenarios import scenario, RackThermal
    cfg = RunConfig(scenarios=(RackThermal(at_h=8.0, rack=3),
                               scenario("congestion_storm", at_h=20.0)))

New scenarios subclass ``Scenario``, implement ``arm``, and register
with ``@register_scenario`` so config files / CLIs can name them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Type

import numpy as np

from repro_torch.simcluster.faults import (BROWNOUT_HANG_SEV, Fault,
                                           FaultKind, GREY_KINDS)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Base declarative scenario spec. Subclasses add their knobs as
    dataclass fields; ``arm`` resolves the spec against a cluster and
    schedules/injects the underlying faults. ``arm`` returns the faults
    it injected immediately (t<=0 events); scheduled future events live
    on the injector heap and fire during the run."""

    name = "scenario"            # registry key (subclass class attribute)

    def arm(self, cluster, rng: np.random.RandomState) -> List[Fault]:
        raise NotImplementedError

    # ------------------------------------------------------------ helpers

    def _group(self, cluster, rng: np.random.RandomState, size: int,
               start: Optional[int]) -> List[int]:
        """A contiguous block of ``size`` active nodes (rack / switch
        neighbourhood). ``start`` pins the block's first active slot;
        None picks one at random."""
        active = list(cluster.active)
        size = min(size, len(active))
        lo = int(start) if start is not None else \
            int(rng.randint(max(len(active) - size + 1, 1)))
        lo = min(lo, len(active) - size)
        return active[lo:lo + size]

    def _emit(self, cluster, kind: FaultKind, node: int, at_s: float,
              severity: float, device: Optional[int] = None,
              duration_s: Optional[float] = None) -> Optional[Fault]:
        """Inject now (at_s <= 0) or schedule on the event heap."""
        if at_s <= 0.0:
            return cluster.injector.inject(kind, node, now=0.0,
                                           severity=severity, device=device,
                                           duration_s=duration_s)
        cluster.injector.schedule(kind, node, at_s, severity=severity,
                                  device=device, duration_s=duration_s)
        return None


_REGISTRY: Dict[str, Type[Scenario]] = {}


def register_scenario(cls: Type[Scenario]) -> Type[Scenario]:
    assert cls.name not in _REGISTRY, f"duplicate scenario {cls.name!r}"
    _REGISTRY[cls.name] = cls
    return cls


def scenario(name: str, **kw) -> Scenario:
    """Build a registered scenario by name with keyword overrides."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None
    return cls(**kw)


def builtin_scenarios() -> Dict[str, Type[Scenario]]:
    return dict(_REGISTRY)


def arm_all(scenarios: Sequence, cluster,
            rng: np.random.RandomState) -> List[Fault]:
    """Arm a mixed sequence of Scenario instances and registry names."""
    injected: List[Fault] = []
    for sc in scenarios:
        if isinstance(sc, str):
            sc = scenario(sc)
        injected.extend(sc.arm(cluster, rng))
    return injected


# --------------------------------------------------------------- built-ins


@register_scenario
@dataclasses.dataclass(frozen=True)
class RackThermal(Scenario):
    """Rack-level cooling/power-delivery incident: every node in one rack
    ramps hot (or power-starved) within ``stagger_s`` of the onset —
    the correlated compute-straggler signature of a CRAC/ CDU failure."""

    name = "rack_thermal"
    at_h: float = 4.0            # onset, hours into the run (<=0: at start)
    rack_size: int = 8
    rack_start: Optional[int] = None   # first active slot; None = random
    severity: float = 0.7
    stagger_s: float = 120.0     # per-node onset jitter
    power_fraction: float = 0.25  # fraction seeing POWER instead of THERMAL

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        for nid in self._group(cluster, rng, self.rack_size,
                               self.rack_start):
            kind = FaultKind.POWER if rng.rand() < self.power_fraction \
                else FaultKind.THERMAL
            at = self.at_h * 3600.0 + float(rng.uniform(0, self.stagger_s))
            f = self._emit(cluster, kind, nid, at, self.severity,
                           device=int(rng.randint(cluster.fleet.d)))
            if f is not None:
                out.append(f)
        return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class SwitchFailure(Scenario):
    """Leaf-switch failure: every node behind the switch loses one link
    outright and the rest downtrain — many NICs degrade in the same
    window (§3.2's reroute pattern, fleet-wide)."""

    name = "switch_failure"
    at_h: float = 4.0
    group_size: int = 16
    group_start: Optional[int] = None
    down_fraction: float = 0.25  # nodes whose link goes fully DOWN
    severity: float = 0.8        # downtrain severity for the rest

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        at = self.at_h * 3600.0
        for nid in self._group(cluster, rng, self.group_size,
                               self.group_start):
            dev = int(rng.randint(cluster.fleet.d))
            if rng.rand() < self.down_fraction:
                f = self._emit(cluster, FaultKind.NIC_DOWN, nid, at,
                               1.0, device=dev)
            else:
                f = self._emit(cluster, FaultKind.NIC_DEGRADED, nid, at,
                               self.severity, device=dev)
            if f is not None:
                out.append(f)
        return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class CongestionStorm(Scenario):
    """Fabric congestion storm: a burst train of short transient
    congestion events across a large random slice of the fleet. The
    detector must ride it out without quarantining anyone."""

    name = "congestion_storm"
    at_h: float = 2.0
    duration_h: float = 1.0
    hit_fraction: float = 0.3    # fleet fraction hit over the storm
    bursts_per_node: float = 2.0
    severity: float = 0.6

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        active = list(cluster.active)
        n_hit = max(int(len(active) * self.hit_fraction), 1)
        hit = rng.choice(active, size=n_hit, replace=False)
        start = self.at_h * 3600.0
        for nid in hit:
            for _ in range(max(int(round(self.bursts_per_node)), 1)):
                at = start + float(rng.uniform(0, self.duration_h * 3600.0))
                f = self._emit(cluster, FaultKind.CONGESTION, int(nid), at,
                               self.severity)
                if f is not None:
                    out.append(f)
        return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class MaintenanceWindow(Scenario):
    """Planned maintenance: a block of hosts runs degraded (patching,
    firmware flashes, daemon churn -> HOST_CPU pressure) for a bounded
    window, then reverts on its own — no escalation clock, because it is
    not a hardware fault."""

    name = "maintenance_window"
    at_h: float = 6.0
    duration_h: float = 2.0
    group_size: int = 16
    group_start: Optional[int] = None
    severity: float = 0.4

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        at = self.at_h * 3600.0
        for nid in self._group(cluster, rng, self.group_size,
                               self.group_start):
            f = self._emit(cluster, FaultKind.HOST_CPU, nid, at,
                           self.severity,
                           duration_s=self.duration_h * 3600.0)
            if f is not None:
                out.append(f)
        return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class InitialGreyPopulation(Scenario):
    """The grey population a long-unmanaged cluster has accumulated by
    t=0 — the state of the world Guard inherits (was the inline
    ``initial_grey_p`` seeding block in ``simulate_run``)."""

    name = "initial_grey"
    p: float = 0.10              # per-active-node grey probability

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        for nid in cluster.active:
            if rng.rand() < self.p:
                kind = GREY_KINDS[rng.randint(len(GREY_KINDS))]
                out.append(cluster.injector.inject(kind, nid, now=0.0))
        return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class DeadlockedCollective(Scenario):
    """A rank wedges around a blocking collective and the job's barrier
    never completes (CCL-D's hang class): ``count`` sequential incidents
    on distinct nodes, each either stuck BEFORE the collective (never
    enters; device -1) or deadlocked INSIDE it (device >= 0, with
    error-counter creep on the stuck channel). Ground truth for the
    watchdog's culprit attribution."""

    name = "deadlocked_collective"
    at_h: float = 1.0            # first incident onset
    count: int = 2               # sequential incidents
    interval_h: float = 0.75     # spacing between incidents
    never_enter_fraction: float = 0.5

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        active = list(cluster.active)
        n = min(self.count, len(active))
        targets = rng.choice(active, size=n, replace=False)
        for i, nid in enumerate(targets):
            at = (self.at_h + i * self.interval_h) * 3600.0
            never = rng.rand() < self.never_enter_fraction
            dev = -1 if never else int(rng.randint(cluster.fleet.d))
            f = self._emit(cluster, FaultKind.COLLECTIVE_HANG, int(nid), at,
                           1.0, device=dev)
            if f is not None:
                out.append(f)
        return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class PartialNicBrownout(Scenario):
    """Link brownout across a switch neighbourhood: every node in the
    block downtrains hard with error bursts, and the severe subset
    (always at least the first node) brown out far enough to wedge the
    in-flight collective — the all-entered hang whose attribution needs
    link evidence rather than a missing rank."""

    name = "partial_nic_brownout"
    at_h: float = 1.0
    group_size: int = 8
    group_start: Optional[int] = None
    severe_fraction: float = 0.35  # wedging (vs merely slow) fraction
    stagger_s: float = 60.0        # per-node onset jitter

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        for i, nid in enumerate(self._group(cluster, rng, self.group_size,
                                            self.group_start)):
            severe = i == 0 or rng.rand() < self.severe_fraction
            sev = float(rng.uniform(BROWNOUT_HANG_SEV, 0.95)) if severe \
                else float(rng.uniform(0.1, BROWNOUT_HANG_SEV - 0.1))
            at = self.at_h * 3600.0 + float(rng.uniform(0, self.stagger_s))
            f = self._emit(cluster, FaultKind.NIC_BROWNOUT, nid, at, sev,
                           device=int(rng.randint(cluster.fleet.d)))
            if f is not None:
                out.append(f)
        return out


@register_scenario
@dataclasses.dataclass(frozen=True)
class StragglerTimeoutCascade(Scenario):
    """A compute straggler degrades and then times out: a THERMAL fault
    lands first, and ``lag_h`` later the same node wedges before the
    collective entirely (data/compute watchdog timeout). ``count``
    incidents on distinct nodes — the hang-after-slow pattern that makes
    the slow-vs-hang split matter (the z-path alone sees only the slow
    prologue, never the deadlock)."""

    name = "straggler_timeout_cascade"
    at_h: float = 1.0
    count: int = 2
    interval_h: float = 0.75
    lag_h: float = 0.05          # slow prologue before the wedge
    severity: float = 0.85       # thermal prologue severity

    def arm(self, cluster, rng) -> List[Fault]:
        out = []
        active = list(cluster.active)
        n = min(self.count, len(active))
        targets = rng.choice(active, size=n, replace=False)
        for i, nid in enumerate(targets):
            at = (self.at_h + i * self.interval_h) * 3600.0
            f = self._emit(cluster, FaultKind.THERMAL, int(nid), at,
                           self.severity,
                           device=int(rng.randint(cluster.fleet.d)))
            if f is not None:
                out.append(f)
            f = self._emit(cluster, FaultKind.COLLECTIVE_HANG, int(nid),
                           at + self.lag_h * 3600.0, 1.0, device=-1)
            if f is not None:
                out.append(f)
        return out
