"""Simulated fleet: hardware dynamics, event-driven fault injection, the
window-granular synchronous step engine, the declarative correlated-fault
scenario layer, the multi-week run simulator and its multi-tenant fleet
mode (``simulate_fleet``); the port's own copy of
the JAX package's ``repro.simcluster``.

The simulator is host NumPy, as in the reference: its keyed SFC64 streams
make both packages simulate the same fleet bit for bit. What runs on the
card is the Guard loop it feeds: every window's ``Frame`` goes through the
session's detector, whose fleet_score kernel scores it on ``device``.
Everything above this layer (Guard's detection/triage/sweep logic) is
substrate-independent.
"""
from repro_torch.simcluster.cluster import (SWEEP_PROFILE, SimCluster,
                                            SimSweepBackend, WorkloadProfile)
from repro_torch.simcluster.faults import (BROWNOUT_HANG_SEV, GREY_KINDS,
                                           HANG_KINDS, FaultInjector,
                                           FaultKind, FaultRates)
from repro_torch.simcluster.node import (THROTTLE_CURVE_C,
                                         THROTTLE_CURVE_GHZ, Fleet, HWConfig,
                                         freq_at_temp)
from repro_torch.simcluster.runtime import (FleetJobSpec, FleetRunConfig,
                                            FleetRunResult, RunConfig,
                                            RunResult, Tier, simulate_fleet,
                                            simulate_run)
from repro_torch.simcluster.scenarios import (CongestionStorm,
                                              DeadlockedCollective,
                                              InitialGreyPopulation,
                                              MaintenanceWindow,
                                              PartialNicBrownout,
                                              RackThermal, Scenario,
                                              StragglerTimeoutCascade,
                                              SwitchFailure, arm_all,
                                              builtin_scenarios,
                                              register_scenario, scenario)

__all__ = [
    "BROWNOUT_HANG_SEV",
    "CongestionStorm", "DeadlockedCollective", "FaultInjector", "FaultKind",
    "FaultRates", "Fleet", "FleetJobSpec", "FleetRunConfig",
    "FleetRunResult",
    "GREY_KINDS", "HANG_KINDS", "HWConfig", "InitialGreyPopulation",
    "MaintenanceWindow",
    "PartialNicBrownout",
    "RackThermal", "RunConfig", "RunResult", "SWEEP_PROFILE", "Scenario",
    "SimCluster", "SimSweepBackend", "StragglerTimeoutCascade",
    "SwitchFailure", "THROTTLE_CURVE_C",
    "THROTTLE_CURVE_GHZ",
    "Tier", "WorkloadProfile", "arm_all", "builtin_scenarios",
    "freq_at_temp", "register_scenario", "scenario", "simulate_fleet",
    "simulate_run",
]
