"""Guard's core on PyTorch: scalable straggler detection and node health
management for large-scale training.

  telemetry       metric schema, device ring buffers, Collector (§4.1)
  detector        peer-relative multi-signal temporal detection (§4.2)
  policy          tiered response policy (§4.2)
  monitor         online monitoring loop -> HealthEvents (§4)
  sweep           offline single-/multi-node qualification sweeps (§5)
  triage          remediation FSM + 3-strikes rule (§6, Fig. 8)
  health_manager  closed loop: pools, swaps, event-driven sweeps (Fig. 1)
"""
from repro_torch.core.detector import (DetectorConfig, FleetAssessment,
                                       NodeAssessment, StragglerDetector)
from repro_torch.core.health_manager import (ClusterControl, HealthManager,
                                             ManagerStats, NodeState,
                                             QualificationTicket)
from repro_torch.core.monitor import HealthEvent, OnlineMonitor
from repro_torch.core.policy import (Action, Decision, PolicyConfig,
                                     TieredPolicy)
from repro_torch.core.sweep import (CampaignResult, SweepBackend,
                                    SweepCampaign, SweepConfig,
                                    SweepReference, SweepReport,
                                    fleet_qualification, intra_pairs,
                                    multi_node_sweep, qualification_sweep,
                                    single_node_sweep)
from repro_torch.core.telemetry import (HARDWARE_METRICS, METRIC_DIRECTION,
                                        METRICS, Collector, Frame,
                                        RingHistory, reduce_device_metrics)
from repro_torch.core.triage import (ErrorSignals, Stage, TriageConfig,
                                     TriageOutcome, TriageResult,
                                     TriageWorkflow)

__all__ = [
    "Action", "CampaignResult", "ClusterControl", "Collector", "Decision",
    "DetectorConfig", "ErrorSignals", "FleetAssessment", "Frame",
    "HARDWARE_METRICS", "HealthEvent", "HealthManager", "METRICS",
    "METRIC_DIRECTION", "ManagerStats", "NodeAssessment", "NodeState",
    "OnlineMonitor", "PolicyConfig", "QualificationTicket", "RingHistory",
    "Stage", "StragglerDetector", "SweepBackend", "SweepCampaign",
    "SweepConfig", "SweepReference", "SweepReport", "TieredPolicy",
    "TriageConfig", "TriageOutcome", "TriageResult", "TriageWorkflow",
    "fleet_qualification", "intra_pairs", "multi_node_sweep",
    "qualification_sweep", "reduce_device_metrics", "single_node_sweep",
]
