"""Fleet-wide streaming event log: every session's ControlEvent bus,
aggregated, tagged, and replayable by cursor; the port of
``repro.fleet.stream``, writing the same JSONL.

The control plane serves *thousands* of sessions, so the log is a
bounded-memory ring of ``FleetRecord`` (job tag + monotonic fleet
sequence id + the original typed event). Consumers hold a *cursor* —
the last sequence id they processed — and call
``subscribe(after=cursor)`` to replay everything newer; if the ring has
already evicted part of that range the reply says how many records were
lost, so a slow consumer knows it must re-snapshot instead of silently
missing transitions (the ARGUS streaming-diagnosis contract).

Push-style delivery uses the same record type: ``attach`` a sink (the
JSONL audit sink, or the SSE-style text sink a dashboard would tail)
and it sees every record at append time.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Deque, Dict, IO, List, Optional, Tuple

from repro_torch.guard.events import ControlEvent


@dataclasses.dataclass(frozen=True)
class FleetRecord:
    """One log entry: a session event stamped with its fleet position."""
    seq: int                  # monotonic fleet-wide sequence id
    job: str                  # owning session ("" = controller itself)
    event: ControlEvent

    def to_dict(self) -> Dict[str, object]:
        d = self.event.to_dict()
        d["seq"] = self.seq
        d["job"] = self.job
        return d


class FleetEventLog:
    """Bounded ring + cursor replay + push sinks."""

    def __init__(self, capacity: int = 65536):
        assert capacity >= 1
        self._ring: Deque[FleetRecord] = collections.deque(maxlen=capacity)
        self._seq = 0                 # last assigned sequence id
        self._sinks: List[object] = []

    # ------------------------------------------------------------- intake

    def append(self, job: str, event: ControlEvent) -> FleetRecord:
        self._seq += 1
        rec = FleetRecord(self._seq, job, event)
        self._ring.append(rec)
        for sink in self._sinks:
            sink.emit(rec)
        return rec

    def session_sink(self, job: str) -> "SessionTap":
        """A per-session bus sink that funnels that session's events
        into this log under its job tag (``session.add_sink(...)``)."""
        return SessionTap(self, job)

    # ------------------------------------------------------------ cursors

    @property
    def head(self) -> int:
        """Latest assigned sequence id (0 = nothing logged yet)."""
        return self._seq

    @property
    def tail(self) -> int:
        """Oldest sequence id still in the ring (0 when empty)."""
        return self._ring[0].seq if self._ring else 0

    def __len__(self) -> int:
        return len(self._ring)

    def subscribe(self, after: int = 0, limit: Optional[int] = None
                  ) -> Tuple[List[FleetRecord], int]:
        """Replay every record with ``seq > after`` (oldest first).

        Returns ``(records, lost)``: ``lost`` counts records in the
        requested range the ring already evicted — nonzero means the
        consumer's cursor fell behind the retention window and it should
        resynchronize from a snapshot, not pretend continuity."""
        after = int(after)
        lost = 0
        if self._ring and after < self._ring[0].seq - 1:
            lost = self._ring[0].seq - 1 - after
        out = [r for r in self._ring if r.seq > after]
        if limit is not None:
            out = out[:limit]
        return out, lost

    # -------------------------------------------------------------- sinks

    def attach(self, sink) -> None:
        """Attach a push consumer (anything with ``emit(record)``)."""
        self._sinks.append(sink)

    def detach(self, sink) -> None:
        self._sinks.remove(sink)


class SessionTap:
    """Bus-sink adapter: tags one session's events into the fleet log."""

    def __init__(self, log: FleetEventLog, job: str):
        self.log = log
        self.job = job

    def emit(self, ev: ControlEvent) -> None:
        self.log.append(self.job, ev)


class JsonlStreamSink:
    """Durable fleet audit log: one JSON object per record."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[IO[str]] = open(path, "a")

    def emit(self, rec: FleetRecord) -> None:
        if self._fh is None:
            raise ValueError(f"JsonlStreamSink({self.path}) is closed")
        json.dump(rec.to_dict(), self._fh)
        self._fh.write("\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlStreamSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SSEStreamSink:
    """Server-sent-events framing over any text stream: the shape a
    live dashboard would tail (``id:`` carries the cursor so a
    reconnecting client resumes with ``subscribe(after=last_id)``)."""

    def __init__(self, stream: IO[str]):
        self.stream = stream

    def emit(self, rec: FleetRecord) -> None:
        d = rec.to_dict()
        self.stream.write(f"id: {rec.seq}\n")
        self.stream.write(f"event: {rec.event.kind}\n")
        self.stream.write(f"data: {json.dumps(d)}\n\n")


__all__ = ["FleetEventLog", "FleetRecord", "JsonlStreamSink",
           "SSEStreamSink", "SessionTap"]
