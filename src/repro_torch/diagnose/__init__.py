"""``repro_torch.diagnose`` — what-if blame attribution and root-cause
routing; the port's own copy of the JAX package's ``repro.diagnose``.

The detector (``repro_torch.core.detector``) says WHO deviates; this
package says WHY, so the Guard loop routes each flagged node into the
right lane instead of treating every latch as an eviction:

  trace       per-window, per-node timing decompositions
              (compute / comm / host / stall) in circular (depth, N)
              buffers, fed by the simulator and the trainer hook
  whatif      vectorized counterfactual replay over the collective
              dependency structure (DP barrier groups / pipeline stages):
              per-node blame scores that separate culprits from
              barrier-stalled cascade victims
  rootcause   blame + telemetry deltas -> RootCause taxonomy + rich
              ErrorSignals; ``Diagnoser`` is the session stage between
              detector and policy (victims are watched, not evicted)

Everything here is host NumPy, as in the reference, so verdicts are
bit-identical to it. The detector's state lives on the session's device;
the diagnoser reads only the flagged rows that ``FleetAssessment``
already copies to the host once per window.

Wire-up: build a ``TimingTrace`` + ``Topology``, hand them to a
``Diagnoser``, attach the trace to the substrate
(``SimCluster.attach_timing`` / ``GuardStepHook``) and pass the
diagnoser to ``GuardSession``. ``RunConfig(diagnose=True)`` does all of
it for simulated runs.
"""
from repro_torch.diagnose.rootcause import (HOLD_CAUSES, Diagnoser,
                                            Diagnosis, FleetDiagnosis,
                                            RootCause, RootCauseConfig)
from repro_torch.diagnose.trace import (CHANNELS, OWN_CHANNELS, TimingTrace,
                                        WindowTiming)
from repro_torch.diagnose.whatif import Topology, WhatIfReport, whatif

__all__ = [
    "CHANNELS", "Diagnoser", "Diagnosis", "FleetDiagnosis", "HOLD_CAUSES",
    "OWN_CHANNELS", "RootCause", "RootCauseConfig", "TimingTrace",
    "Topology", "WhatIfReport", "WindowTiming", "whatif",
]
