"""``repro_torch.ccltrace`` — collective-granular tracing and hang
detection; the port's own copy of the JAX package's ``repro.ccltrace``.

  spans      per-collective span ring buffers (enter/exit per rank, in
             the circular (depth, N) TimingTrace idiom) + the observable
             ``PendingCollective`` snapshot of a stuck collective
  watchdog   barrier-timeout hang detector: adaptive per-group deadline
             from trailing span durations, CCL-D culprit/victim
             classification (never-entered / entered-and-stalled vs
             arrived-and-blocked)

This package is substrate-free and host NumPy only: it imports neither
the simulator nor the guard loop, so both (and a real CCL tracing layer)
can feed it.
"""
from repro_torch.ccltrace.spans import (SPAN_CHANNELS, CollectiveSpanTrace,
                                        PendingCollective, SpanWindow)
from repro_torch.ccltrace.watchdog import (CULPRIT_ROLES, HangRole,
                                           HangVerdict, HangWatchdog,
                                           WatchdogConfig, adaptive_deadline)

__all__ = [
    "CULPRIT_ROLES", "CollectiveSpanTrace", "HangRole", "HangVerdict",
    "HangWatchdog", "PendingCollective", "SPAN_CHANNELS", "SpanWindow",
    "WatchdogConfig", "adaptive_deadline",
]
