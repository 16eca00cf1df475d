"""``repro_torch.guard`` — the public entry point to the Guard closed loop
on PyTorch.

  session     GuardSession facade + Tier ablation builders (Fig. 1, §7)
  events      typed ControlEvent hierarchy, EventBus, trace/JSONL sinks
  scheduler   non-blocking offline-qualification queue (§5)
  hook        single-process substrates (LocalHostControl, LocalSweepBackend)
  goodput     the live MTTF estimate the session keeps
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
from repro_torch.guard.goodput import MTTFEstimator
from repro_torch.guard.hook import LocalHostControl, LocalSweepBackend
from repro_torch.guard.scheduler import SweepScheduler
from repro_torch.guard.session import (CheckpointOutcome, GuardSession,
                                       Tier, WindowOutcome)

__all__ = [
    "CampaignFinished", "CheckpointOutcome", "CheckpointSaved",
    "ControlEvent", "CrashDetected", "DiagnosisEvent", "EVENT_TYPES",
    "EventBus", "GuardSession", "HangDetected", "JobRestart", "JsonlSink",
    "LocalHostControl", "LocalSweepBackend", "MTTFEstimator",
    "NodeProvisioned", "NodeQuarantined", "NodeSwapped", "NodeTerminated",
    "RecoveryEvent", "StragglerCleared", "StragglerFlagged",
    "SweepFinished", "SweepScheduler", "SweepStarted", "Tier", "TraceSink",
    "TriageStage", "WindowOutcome",
]
