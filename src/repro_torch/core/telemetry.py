# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Telemetry schema, ring buffers and the Collector protocol (§4.1).

Guard consumes fleet telemetry through one narrow interface: a
``Collector`` that yields one ``Frame`` per evaluation window. A Frame
holds named per-node metric arrays as the collector delivers them, host
numpy arrays; the detector never touches the substrate underneath.

``RingHistory`` keeps the last ``depth`` frames on the session's device
as one ``(depth, M, N)`` float32 tensor (M metrics, N nodes), so that the
rows to score are one contiguous slice for the fleet-score kernel. Each
push converts the frame's float64 metrics to float32 on the host, as the
reference does when it stores them, and copies one ``(M, N)`` row and the
``(N,)`` valid mask to the device.

Metric catalogue (paper §4.1), per-node reductions over the node's
accelerators / NICs:

  step_time     seconds this node took to reach the sync barrier (PRIMARY)
  gpu_temp      hottest device temperature, °C
  gpu_util      mean device utilization, [0, 1]
  gpu_freq      slowest device clock, GHz
  gpu_power     lowest device power draw, W
  nic_errors    summed NIC error counters over the window (retx, retries)
  nic_tx_rate   lowest per-NIC effective transmit rate, Gb/s
  nic_up        fraction of this node's NICs that are up, [0, 1]
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve

# Canonical metric names + the direction in which deviation is UNHEALTHY.
#   +1: higher-than-peers is bad      -1: lower-than-peers is bad
METRIC_DIRECTION: Dict[str, int] = {
    "step_time": +1,
    "gpu_temp": +1,
    "gpu_util": -1,
    "gpu_freq": -1,
    "gpu_power": -1,
    "nic_errors": +1,
    "nic_tx_rate": -1,
    "nic_up": -1,
}
METRICS: tuple = tuple(METRIC_DIRECTION)
HARDWARE_METRICS: tuple = tuple(m for m in METRICS if m != "step_time")


@dataclasses.dataclass
class Frame:
    """One evaluation window of fleet telemetry, as host arrays.

    Every metric is a float array of shape (num_nodes,) aligned with
    ``node_ids``. ``valid`` masks nodes that reported (False = no
    heartbeat, treated as a stall by the monitor)."""

    t: float                                 # sim/wall time, seconds
    step: int                                # global training step index
    node_ids: np.ndarray                     # (N,) int64
    metrics: Dict[str, np.ndarray]           # name -> (N,) float64
    valid: np.ndarray                        # (N,) bool

    def __post_init__(self):
        n = len(self.node_ids)
        for k, v in self.metrics.items():
            if k not in METRIC_DIRECTION:
                raise ValueError(f"unknown metric {k}")
            if np.shape(v) != (n,):
                raise ValueError(f"metric {k} has shape {np.shape(v)}, "
                                 f"expected ({n},)")
        if np.shape(self.valid) != (n,):
            raise ValueError(f"valid has shape {np.shape(self.valid)}, "
                             f"expected ({n},)")


class Collector(Protocol):
    """The substrate interface: one Frame per evaluation window."""

    def collect(self) -> Optional[Frame]:
        """Next telemetry frame, or None if the job has stopped."""
        ...


class RingHistory:
    """Fixed-depth history of fleet frames on a device.

    Preallocated circular ``(depth, M, N)`` float32 buffer plus a
    ``(depth, N)`` valid buffer: each ``push`` writes one row in place.
    Node ids stay on the host (the policy and manager speak in ids)."""

    def __init__(self, depth: int, device: DeviceLike = "cuda"):
        self.depth = depth
        self.device = resolve(device)
        self._buf: Optional[torch.Tensor] = None     # (depth, M, N) f32
        self._valid: Optional[torch.Tensor] = None   # (depth, N) bool
        self._names: tuple = ()                      # metric order of _buf
        self._ids: Optional[np.ndarray] = None       # (N,) current node ids
        self._used = 0          # rows filled so far (<= depth)
        self._head = 0          # next row to (over)write
        self._last: Optional[Frame] = None
        self.generation = 0     # bumped on every (re)allocation
        self.last_backfill: Optional[np.ndarray] = None  # cols changed by
        # the most recent push's replacement backfill (None if none)

    def _alloc(self, frame: Frame) -> None:
        n = len(frame.node_ids)
        self._names = tuple(frame.metrics)
        self._buf = torch.empty((self.depth, len(self._names), n),
                                dtype=torch.float32, device=self.device)
        self._valid = torch.empty((self.depth, n), dtype=torch.bool,
                                  device=self.device)
        self._ids = np.array(frame.node_ids, copy=True)
        self._used = 0
        self._head = 0
        self.generation += 1

    def _frame_row(self, frame: Frame) -> torch.Tensor:
        """(M, N) float32 row of ``frame`` on the device, in buffer metric
        order; float64 -> float32 rounds on the host, as numpy stores it."""
        row = np.stack([np.asarray(frame.metrics[m], np.float32)
                        for m in self._names])
        return torch.from_numpy(row).to(self.device)

    def push(self, frame: Frame) -> None:
        self.last_backfill = None
        ids = self._ids
        if ids is None or len(frame.node_ids) != len(ids) or \
                set(frame.metrics) != set(self._names):
            # fleet resized (or metric schema changed): history no longer
            # aligns - restart.
            self._alloc(frame)
            ids = None
        row_t = self._frame_row(frame)
        if ids is not None and not np.array_equal(frame.node_ids, ids):
            # node replacement: the new node must NOT inherit its
            # predecessor's history column. Backfill changed columns with
            # the new node's current readings in every row; everyone else
            # keeps their window.
            changed = frame.node_ids != ids
            cols = torch.from_numpy(np.flatnonzero(changed)).to(self.device)
            self._buf[:, :, cols] = row_t[:, cols].unsqueeze(0)
            self._valid[:, cols] = True
            self._ids = ids.copy()
            self._ids[changed] = frame.node_ids[changed]
            self.last_backfill = changed
        r = self._head
        self._buf[r] = row_t
        self._valid[r] = torch.from_numpy(
            np.asarray(frame.valid, bool)).to(self.device)
        self._head = (r + 1) % self.depth
        self._used = min(self._used + 1, self.depth)
        self._last = frame

    @property
    def last_row(self) -> int:
        """Buffer row index the most recent push wrote."""
        return (self._head - 1) % self.depth

    def __len__(self) -> int:
        return self._used

    def metric_names(self) -> tuple:
        return self._names

    def buffer(self) -> torch.Tensor:
        """(depth, M, N) backing buffer (rows beyond ``len(self)`` are
        uninitialized). For the row-indexed score caches; do not mutate."""
        return self._buf

    def order(self) -> list:
        """Buffer row indices of the filled rows, oldest first."""
        if self._used < self.depth:
            return list(range(self._used))
        return [(self._head + i) % self.depth for i in range(self.depth)]

    def last(self) -> Frame:
        if self._last is None:
            raise IndexError("empty history")
        return self._last


def reduce_device_metrics(
    temps: np.ndarray, utils: np.ndarray, freqs: np.ndarray,
    powers: np.ndarray, nic_err: np.ndarray, nic_tx: np.ndarray,
    nic_up: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Per-device (N, D) host arrays -> per-node (N,) metric dict.

    Reductions pick the WORST device per node (hottest / slowest /
    weakest), because a single degraded device gates the node's
    collectives (§3.3). Host NumPy, as in the reference: the simulated
    collector hands its frames to the detector as host arrays."""
    return {
        "gpu_temp": temps.max(axis=1),
        "gpu_util": utils.mean(axis=1),
        "gpu_freq": freqs.min(axis=1),
        "gpu_power": powers.min(axis=1),
        "nic_errors": nic_err.sum(axis=1),
        "nic_tx_rate": nic_tx.min(axis=1),
        "nic_up": nic_up.mean(axis=1),
    }


__all__ = ["Collector", "Frame", "HARDWARE_METRICS", "METRICS",
           "METRIC_DIRECTION", "RingHistory", "reduce_device_metrics"]
