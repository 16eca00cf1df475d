"""``repro_torch.guard`` — the public entry point to the Guard closed loop
on PyTorch.

  session     GuardSession facade + Tier ablation builders (Fig. 1, §7)
  events      typed ControlEvent hierarchy, EventBus, trace/JSONL sinks
  scheduler   non-blocking offline-qualification queue (§5)
  hook        Trainer StepHook adapter (step timings → Frames → monitor)
              and the single-process substrates
  goodput     recovery accounting: checkpoint tiers, MTTF-tuned snapshot
              cadence, MTTR decomposition, goodput metric

The reference's ``GuardEvent`` base is ``ControlEvent`` here (see
``events``); every other name is the reference's.
"""
from repro_torch.guard.events import (EVENT_TYPES, CampaignFinished,
                                      CheckpointSaved, ControlEvent,
                                      CrashDetected, DiagnosisEvent,
                                      EventBus, HangDetected, JobRestart,
                                      JsonlSink, NodeProvisioned,
                                      NodeQuarantined, NodeSwapped,
                                      NodeTerminated, RecoveryEvent,
                                      StragglerCleared, StragglerFlagged,
                                      SweepFinished, SweepStarted,
                                      TraceSink, TriageStage)
from repro_torch.guard.goodput import (MTTR_PHASES, CheckpointTier,
                                       MTTFEstimator, RecoveryModel,
                                       goodput_tflop_h, mttr_decomposition,
                                       replica_partner, young_daly_interval)
from repro_torch.guard.hook import (GuardStepHook, LocalHostControl,
                                    LocalSweepBackend)
from repro_torch.guard.scheduler import SweepScheduler
from repro_torch.guard.session import (CheckpointOutcome, GuardSession,
                                       Tier, WindowOutcome)

__all__ = [
    "CampaignFinished", "CheckpointOutcome", "CheckpointSaved",
    "CheckpointTier", "ControlEvent", "CrashDetected", "DiagnosisEvent",
    "EVENT_TYPES", "EventBus", "GuardSession", "GuardStepHook",
    "HangDetected", "JobRestart", "JsonlSink", "LocalHostControl",
    "LocalSweepBackend", "MTTFEstimator", "MTTR_PHASES", "NodeProvisioned",
    "NodeQuarantined", "NodeSwapped", "NodeTerminated", "RecoveryEvent",
    "RecoveryModel", "StragglerCleared", "StragglerFlagged",
    "SweepFinished", "SweepScheduler", "SweepStarted", "Tier", "TraceSink",
    "TriageStage", "WindowOutcome", "goodput_tflop_h", "mttr_decomposition",
    "replica_partner", "young_daly_interval",
]
