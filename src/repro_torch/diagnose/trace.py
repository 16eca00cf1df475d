# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Per-window, per-node timing decompositions (the diagnosis substrate).

Blame attribution needs more than the detector's step-time metric: it
needs to know *where* each node's window went — device compute, exposed
inter-node communication, host/data work, and barrier stall (time spent
waiting on peers inside a blocking collective). ``TimingTrace`` keeps a
fixed-depth history of those decompositions as preallocated circular
``(depth, N)`` float arrays, the same discipline as the detector's
``RingHistory``: one ``push`` per evaluation window costs one row-write
per channel, never a re-stack.

Producers:

  - ``SimCluster`` feeds the trace from the step-time model itself (the
    simulator knows the true compute/comm/host split and the barrier
    structure), via ``SimCluster.attach_timing``.
  - ``GuardStepHook`` feeds it from measured trainer step times, using
    trainer-supplied component timings when available and a configured
    split otherwise (``repro_torch.guard.hook``).
  - A real deployment feeds it from device/collective timeline
    instrumentation (profiler-style busy/wait accounting).

Consumers: the what-if engine (``repro_torch.diagnose.whatif``) and the
root-cause classifier (``repro_torch.diagnose.rootcause``) read the raw rows —
their reductions are order-invariant, so the circular buffers are never
reordered on the hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# decomposition channels, in "own work" order; wall = own + stall
CHANNELS = ("compute", "comm", "host", "stall")
OWN_CHANNELS = ("compute", "comm", "host")


@dataclasses.dataclass
class WindowTiming:
    """One evaluation window's timing decomposition, per node.

    Every channel is window-mean seconds aligned with ``node_ids``.
    ``stall`` is barrier wait: the gap between the node finishing its own
    work and its blocking collective completing (group wall - own)."""

    t: float
    step: int
    node_ids: np.ndarray                 # (N,) int64
    compute: np.ndarray                  # (N,) device-gated compute
    comm: np.ndarray                     # (N,) exposed inter-node comm
    host: np.ndarray                     # (N,) host/data-pipeline work
    stall: np.ndarray                    # (N,) barrier wait (>= 0)

    def __post_init__(self):
        n = len(self.node_ids)
        for ch in CHANNELS:
            assert getattr(self, ch).shape == (n,), (ch, n)

    @property
    def own(self) -> np.ndarray:
        """(N,) seconds of the node's own work (compute + comm + host)."""
        return self.compute + self.comm + self.host

    @property
    def wall(self) -> np.ndarray:
        """(N,) measured wall seconds (own work + barrier stall)."""
        return self.own + self.stall


class TimingTrace:
    """Fixed-depth circular history of ``WindowTiming`` rows.

    Preallocated ``(depth, N)`` buffers per channel. Fleet membership
    changes are handled like the detector's ``RingHistory``: a resize
    reallocates (history no longer aligns), while a same-size node
    replacement backfills only the changed columns with the new node's
    current readings so a freshly swapped-in spare never inherits its
    predecessor's timing history."""

    def __init__(self, depth: int = 8):
        assert depth >= 1
        self.depth = depth
        self._bufs: Dict[str, np.ndarray] = {}     # channel -> (depth, N)
        self._ids: Optional[np.ndarray] = None
        self._used = 0
        self._head = 0
        self._last: Optional[WindowTiming] = None
        self._sums: Dict[str, np.ndarray] = {}     # channel -> (N,) f64
        self._sums_stale = False
        self.generation = 0          # bumped on every (re)allocation
        self.pushes = 0              # total rows ever written
        self.last_backfill: Optional[np.ndarray] = None  # cols changed by
        # the most recent push's replacement backfill (None if none)

    # ------------------------------------------------------------- intake

    def _alloc(self, wt: WindowTiming) -> None:
        n = len(wt.node_ids)
        # float32 like the detector's RingHistory: window durations are
        # O(seconds) so f32 keeps ~1e-7 s relative resolution, and the
        # downstream what-if reductions stay f32 end-to-end
        self._bufs = {ch: np.empty((self.depth, n), np.float32)
                      for ch in CHANNELS}
        self._ids = wt.node_ids.copy()
        self._used = 0
        self._head = 0
        self.generation += 1
        # rolling per-channel window sums (f64 accumulators: adding and
        # later subtracting the same stored f32 row keeps the drift at
        # rounding noise), so ``mean`` is O(N) instead of O(depth * N)
        # guardlint: disable=GL002 reason=rolling add/subtract accumulator
        # — f32 sums drift as windows cycle; the stored rows stay f32
        self._sums = {ch: np.zeros(n, np.float64) for ch in CHANNELS}
        self._means = {ch: np.empty(n, np.float32) for ch in CHANNELS}
        self._sums_stale = False

    def push(self, wt: WindowTiming) -> None:
        self.last_backfill = None
        ids = self._ids
        if ids is None or len(wt.node_ids) != len(ids):
            self._alloc(wt)
        elif not np.array_equal(wt.node_ids, ids):
            changed = wt.node_ids != ids
            for ch, buf in self._bufs.items():
                buf[:, changed] = getattr(wt, ch)[changed]
            self._ids = ids.copy()
            self._ids[changed] = wt.node_ids[changed]
            self.last_backfill = changed
            self._sums_stale = True
        row = self._head
        full = self._used == self.depth
        for ch, buf in self._bufs.items():
            if full and not self._sums_stale:
                self._sums[ch] -= buf[row]       # evicted row leaves
            buf[row] = getattr(wt, ch)
            if not self._sums_stale:
                self._sums[ch] += buf[row]       # stored f32 row enters
        self._head = (row + 1) % self.depth
        self._used = min(self._used + 1, self.depth)
        self._last = wt
        self.pushes += 1

    # ------------------------------------------------------------ queries

    def __len__(self) -> int:
        return self._used

    @property
    def full(self) -> bool:
        return self._used == self.depth

    @property
    def node_ids(self) -> Optional[np.ndarray]:
        return self._ids

    def last(self) -> WindowTiming:
        if self._last is None:
            raise IndexError("empty timing trace")
        return self._last

    @property
    def last_row(self) -> int:
        """Buffer row index the most recent push wrote."""
        return (self._head - 1) % self.depth

    def rows(self, channel: str) -> np.ndarray:
        """(used, N) raw buffer rows in ARBITRARY window order — zero-copy
        view for order-invariant reductions. Callers must not mutate."""
        return self._bufs[channel][:self._used]

    def rows_raw(self, channel: str) -> np.ndarray:
        """(depth, N) full backing buffer (rows beyond ``len(self)`` are
        uninitialized). For row-indexed caches; do not mutate."""
        return self._bufs[channel]

    def mean(self, channel: str) -> np.ndarray:
        """(N,) per-node mean of one channel over the kept windows,
        float32, served from the rolling sums.

        Returns a per-channel scratch buffer reused across calls — valid
        until the next ``mean`` of the same channel; copy to retain."""
        if self._sums_stale:
            for ch, buf in self._bufs.items():
                # guardlint: disable=GL002 reason=recomputing the rolling
                # f64 accumulator (see _alloc); output means stay f32
                np.sum(buf[:self._used], axis=0, dtype=np.float64,
                       out=self._sums[ch])
            self._sums_stale = False
        out = self._means[channel]
        np.multiply(self._sums[channel], 1.0 / self._used, out=out,
                    casting="unsafe")
        return out

    def own_rows(self) -> np.ndarray:
        """(used, N) own-work seconds per kept window."""
        return (self.rows("compute") + self.rows("comm") +
                self.rows("host"))

    def own_mean(self) -> np.ndarray:
        return self.own_rows().mean(axis=0)

    def wall_mean(self) -> np.ndarray:
        return self.own_mean() + self.mean("stall")

    @property
    def nbytes(self) -> int:
        """Resident bytes of the circular buffers (memory report)."""
        return sum(b.nbytes for b in self._bufs.values())

    def clear(self) -> None:
        self._used = 0
        self._head = 0
        self._last = None
        self._sums_stale = True


__all__ = ["CHANNELS", "OWN_CHANNELS", "TimingTrace", "WindowTiming"]
