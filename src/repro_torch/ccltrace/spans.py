"""Per-collective span records (the hang-diagnosis substrate).

The timing trace (``repro_torch.diagnose.trace``) answers "where did the
window go"; it cannot answer "who is INSIDE the stuck collective right
now". ARGUS-style hang diagnosis needs collective-granular spans: for
each blocking collective, when did every rank *enter* (finish the work
that precedes the barrier) and when did the group *exit* (the collective
completed). ``CollectiveSpanTrace`` keeps a fixed-depth history of those
spans as preallocated circular ``(depth, N)`` float arrays — the same
discipline as ``RingHistory``/``TimingTrace``: one ``push`` per
evaluation window costs one row-write per channel, never a re-stack.

Producers:

  - ``SimCluster`` feeds the trace from the step-time model itself
    (``SimCluster.attach_spans``): enter = window-mean own pre-barrier
    work (compute + host), exit = window-mean group wall.
  - ``GuardStepHook`` feeds the watchdog's shared deadline rule from
    measured step walls (``repro_torch.guard.hook.GuardStepHook.step_deadline``).
  - A real deployment feeds it from CCL tracing hooks (the per-collective
    enqueue/kernel-complete timeline ARGUS records).

Consumers: ``repro_torch.ccltrace.watchdog`` reads trailing span *durations*
(exit - enter = collective time + barrier stall) to scale each group's
hang deadline, and ``PendingCollective`` snapshots the one currently
stuck collective for culprit/victim classification.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# span channels: enter = rank finished its pre-barrier work and posted
# the collective; exit = the group's collective completed (group wall)
SPAN_CHANNELS = ("enter", "exit")


@dataclasses.dataclass
class SpanWindow:
    """One evaluation window's collective span, per rank.

    ``enter``/``exit`` are window-mean seconds from step start, aligned
    with ``node_ids``; ``group_of`` maps each row to its blocking-
    collective group id. ``exit - enter`` is the rank's collective span:
    its exposed communication plus any barrier stall behind slower
    group peers."""

    t: float
    step: int
    op: str
    node_ids: np.ndarray                 # (N,) int64
    group_of: np.ndarray                 # (N,) int64 barrier-group ids
    enter: np.ndarray                    # (N,) entered the collective at
    exit: np.ndarray                     # (N,) group collective completed

    def __post_init__(self):
        n = len(self.node_ids)
        assert self.group_of.shape == (n,), ("group_of", n)
        for ch in SPAN_CHANNELS:
            assert getattr(self, ch).shape == (n,), (ch, n)

    @property
    def duration(self) -> np.ndarray:
        """(N,) span seconds inside the collective (comm + stall)."""
        return self.exit - self.enter


class CollectiveSpanTrace:
    """Fixed-depth circular history of ``SpanWindow`` rows.

    Preallocated ``(depth, N)`` buffers per channel. Fleet membership
    changes follow the ``TimingTrace`` discipline: a resize reallocates
    (history no longer aligns), a same-size node replacement backfills
    only the changed columns so a freshly swapped-in spare never
    inherits its predecessor's span history."""

    def __init__(self, depth: int = 8):
        assert depth >= 1
        self.depth = depth
        self._bufs: Dict[str, np.ndarray] = {}     # channel -> (depth, N)
        self._ids: Optional[np.ndarray] = None
        self._group_of: Optional[np.ndarray] = None
        self._used = 0
        self._head = 0
        self._last: Optional[SpanWindow] = None
        self.generation = 0          # bumped on every (re)allocation

    # ------------------------------------------------------------- intake

    def _alloc(self, sw: SpanWindow) -> None:
        n = len(sw.node_ids)
        self._bufs = {ch: np.empty((self.depth, n)) for ch in SPAN_CHANNELS}
        self._ids = sw.node_ids.copy()
        self._used = 0
        self._head = 0
        self.generation += 1

    def push(self, sw: SpanWindow) -> None:
        ids = self._ids
        if ids is None or len(sw.node_ids) != len(ids):
            self._alloc(sw)
        elif not np.array_equal(sw.node_ids, ids):
            changed = sw.node_ids != ids
            for ch, buf in self._bufs.items():
                buf[:, changed] = getattr(sw, ch)[changed]
            self._ids = ids.copy()
            self._ids[changed] = sw.node_ids[changed]
        row = self._head
        for ch, buf in self._bufs.items():
            buf[row] = getattr(sw, ch)
        self._group_of = sw.group_of
        self._head = (row + 1) % self.depth
        self._used = min(self._used + 1, self.depth)
        self._last = sw

    # ------------------------------------------------------------ queries

    def __len__(self) -> int:
        return self._used

    @property
    def full(self) -> bool:
        return self._used == self.depth

    @property
    def node_ids(self) -> Optional[np.ndarray]:
        return self._ids

    @property
    def node_count(self) -> int:
        return 0 if self._ids is None else len(self._ids)

    @property
    def group_of(self) -> Optional[np.ndarray]:
        """(N,) barrier-group id per row, from the latest push."""
        return self._group_of

    def last(self) -> SpanWindow:
        if self._last is None:
            raise IndexError("empty span trace")
        return self._last

    def rows(self, channel: str) -> np.ndarray:
        """(used, N) raw buffer rows in ARBITRARY window order — zero-copy
        view for order-invariant reductions. Callers must not mutate."""
        return self._bufs[channel][:self._used]

    def duration_rows(self) -> np.ndarray:
        """(used, N) span seconds (exit - enter) per kept window."""
        return self.rows("exit") - self.rows("enter")

    def trailing_duration(self) -> np.ndarray:
        """(N,) per-rank worst span over the kept windows — the basis of
        the watchdog's adaptive deadline (order-invariant max)."""
        return self.duration_rows().max(axis=0)

    def clear(self) -> None:
        self._used = 0
        self._head = 0
        self._last = None


@dataclasses.dataclass
class PendingCollective:
    """Observable snapshot of ONE stuck in-flight collective.

    This is what a CCL tracing layer can actually see at hang time —
    which ranks posted the collective and when, which groups already
    completed theirs, and which ranks show independent link evidence
    (down/degraded port, error-counter creep). It deliberately carries
    no ground-truth fault state; the watchdog classifies from these
    fields alone.

    ``enter_t`` is absolute seconds for ranks that entered and ``inf``
    for ranks that never arrived. A group whose members all completed
    (``completed``) is not hung on THIS op — its ranks block at the next
    global sync point and are out of scope for the verdict."""

    t_start: float                       # hang onset (step start)
    step: int
    op: str
    node_ids: np.ndarray                 # (N,) int64
    group_of: np.ndarray                 # (N,) int64
    entered: np.ndarray                  # (N,) bool — posted the collective
    enter_t: np.ndarray                  # (N,) float, inf if never entered
    completed: np.ndarray                # (N,) bool — group's op finished
    nic_suspect: np.ndarray              # (N,) bool — link evidence

    def __post_init__(self):
        n = len(self.node_ids)
        for ch in ("group_of", "entered", "enter_t", "completed",
                   "nic_suspect"):
            assert getattr(self, ch).shape == (n,), (ch, n)


__all__ = ["SPAN_CHANNELS", "CollectiveSpanTrace", "PendingCollective",
           "SpanWindow"]
