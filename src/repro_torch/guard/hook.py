"""Minimal substrates for a process with no cluster control plane.

``LocalHostControl`` / ``LocalSweepBackend`` implement the session's
``ClusterControl`` and ``SweepBackend`` protocols for a single process:
swaps and restarts are bookkeeping, and qualification sweeps trivially
pass (there is no hardware to probe). The trainer adapter
``GuardStepHook`` of the JAX package comes with the training slice.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.sweep import SweepReference
from repro_torch.core.triage import ErrorSignals


class LocalHostControl:
    """ClusterControl for a single process (no real fleet). ``t`` is the
    clock the caller advances."""

    def __init__(self, next_provision_id: int = 1000):
        self.t = 0.0
        self.swaps: List[tuple] = []
        self.restarts: List[str] = []
        self._next = next_provision_id
        # per-node evidence source (a step hook may register itself here
        # so triage sees telemetry-derived signals, not empty ones)
        self.signals_provider: \
            Optional[Callable[[int], ErrorSignals]] = None

    def swap_node(self, old: int, new: int) -> None:
        self.swaps.append((old, new))

    def restart_job(self, reason: str) -> None:
        self.restarts.append(reason)

    def provision_node(self) -> int:
        nid = self._next
        self._next += 1
        return nid

    def error_signals(self, node_id: int) -> ErrorSignals:
        if self.signals_provider is not None:
            return self.signals_provider(node_id)
        return ErrorSignals()

    def remediate(self, node_id: int, stage: str) -> None:
        pass

    def now(self) -> float:
        return self.t


class LocalSweepBackend:
    """SweepBackend stub for hosts with nothing to probe offline: every
    probe reports exactly the reference, so qualification passes."""

    def __init__(self, devices: int = 1):
        self._devices = devices
        self._ref = SweepReference(device_tflops=100.0, intra_bw_gbps=100.0,
                                   pair_step_time=1.0)

    def device_count(self, node_id: int) -> int:
        return self._devices

    def compute_probe(self, node_id: int, device: int,
                      seconds: float) -> float:
        return self._ref.device_tflops

    def intra_bw_probe(self, node_id: int, dev_a: int, dev_b: int) -> float:
        return self._ref.intra_bw_gbps

    def multi_node_probe(self, node_ids: Sequence[int],
                         steps: int) -> np.ndarray:
        return np.full(steps, self._ref.pair_step_time)

    def reference(self) -> SweepReference:
        return self._ref


__all__ = ["LocalHostControl", "LocalSweepBackend"]
