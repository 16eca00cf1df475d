# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Peer-relative, multi-signal, temporally-filtered straggler detection
(§4.2), with its state on a device.

The detector never uses absolute thresholds. Every metric is scored
against the *peer baseline* of nodes in the same job via robust
statistics (median / MAD z-scores). A node is flagged only when

  1. its PRIMARY signal (step_time) shows a sustained relative slowdown, OR
  2. multiple SUPPORTING hardware signals deviate together (pending
     verification tier - no step impact yet),

and the deviation persists for >= K of the last N evaluation windows.
Hysteresis: once flagged, a node needs ``clear_windows`` consecutive clean
windows to unflag.

The ring buffers, the per-row score caches and the latch / clean-streak
arrays live on ``DetectorConfig.device``. In steady state one window
scores only the newest ring row (R = 1) through the fleet-score kernel.
``update`` returns a ``FleetAssessment`` of device tensors; only the
flagged rows cross to the host, once per window, when a consumer asks.

Verdicts are bit-identical to the JAX package's detector: the slowdown
sums the cached contributions in chronological ring order, one row at a
time, and the stall test takes ``np.median`` of the frame's float64 step
times on the host, where the frame arrives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.telemetry import (HARDWARE_METRICS, METRIC_DIRECTION,
                                        Frame, RingHistory)
from repro_torch.device import resolve
from repro_torch.kernels.fleet_score import score_rows


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Defaults are the paper's 'moderately conservative' operating point
    (§6.1): aggressive enough to catch mild greys early (low FNR) at the
    price of a double-digit FPR (Table 3: FPR 12.4%, FNR 7.8%)."""
    window: int = 6              # N: evaluation windows kept for filtering
    persistence: int = 3         # K: windows (of N) a signal must deviate
    z_threshold: float = 3.0     # robust z beyond which a signal deviates
    min_support: int = 2         # hardware signals required for hw-only flag
    slowdown_floor: float = 0.025  # relative step-time excess that counts
    stall_factor: float = 5.0    # step_time > stall_factor x median = stall
    clear_windows: int = 3       # hysteresis: clean windows to unflag
    mad_floor_frac: float = 0.01 # MAD floor as a fraction of the median
    device: str = "cuda"         # where state lives and scoring runs


@dataclasses.dataclass
class NodeAssessment:
    """Detector verdict for one node in one evaluation window."""
    node_id: int
    slowdown: float              # sustained relative step-time excess (>=0)
    stalled: bool
    support: List[str]           # hardware metrics in sustained deviation
    step_deviant: bool           # primary signal sustained deviation
    flagged: bool                # overall verdict after temporal filtering


class FleetAssessment:
    """One evaluation window's verdicts for the whole fleet.

    ``node_ids`` is a host array; every other field is a device tensor
    aligned with it. The flagged rows (indices, slowdown, stalled,
    step-deviant and support bits) are brought to the host together, once,
    the first time a consumer asks; per-node ``NodeAssessment`` records are
    materialized only on request (``node``), and ``materialized`` counts
    them."""

    __slots__ = ("node_ids", "slowdown", "stalled", "step_deviant",
                 "support_masks", "flagged", "materialized", "_host")

    def __init__(self, node_ids: np.ndarray, slowdown: torch.Tensor,
                 stalled: torch.Tensor, step_deviant: torch.Tensor,
                 support_masks: Dict[str, torch.Tensor],
                 flagged: torch.Tensor):
        self.node_ids = node_ids
        self.slowdown = slowdown
        self.stalled = stalled
        self.step_deviant = step_deviant
        self.support_masks = support_masks
        self.flagged = flagged
        self.materialized = 0
        self._host: Optional[dict] = None

    def _flagged_host(self) -> dict:
        """Host copy of the flagged rows: one gather, one transfer."""
        if self._host is None:
            idx = torch.nonzero(self.flagged).flatten()
            names = list(self.support_masks)
            bits = torch.stack([self.stalled[idx], self.step_deviant[idx],
                                *(self.support_masks[m][idx]
                                  for m in names)]) if idx.numel() else None
            idx_h = idx.cpu().numpy()
            self._host = {
                "idx": idx_h,
                "pos": {int(i): j for j, i in enumerate(idx_h)},
                "slowdown": self.slowdown[idx].cpu().numpy(),
                "bits": None if bits is None else bits.cpu().numpy(),
                "names": names,
            }
        return self._host

    # ------------------------------------------------------ array queries

    def flagged_indices(self) -> np.ndarray:
        return self._flagged_host()["idx"]

    def flagged_slowdown(self) -> np.ndarray:
        """float32 slowdown of the flagged rows, in index order."""
        return self._flagged_host()["slowdown"]

    def flagged_stalled(self) -> np.ndarray:
        h = self._flagged_host()
        if h["bits"] is None:
            return np.zeros(0, bool)
        return h["bits"][0]

    def flagged_support(self, name: str) -> np.ndarray:
        """bool sustained-deviation bits of support metric ``name`` for the
        flagged rows, in index order (all False when the frame carried no
        such metric). Read from the flagged rows' host copy."""
        h = self._flagged_host()
        if h["bits"] is None or name not in h["names"]:
            return np.zeros(len(h["idx"]), bool)
        return h["bits"][2 + h["names"].index(name)]

    def index_of(self, node_id: int) -> Optional[int]:
        hit = np.flatnonzero(self.node_ids == node_id)
        return int(hit[0]) if hit.size else None

    def flagged_of(self, node_id: int) -> Optional[bool]:
        """Latched verdict for one node id; None if not in this frame."""
        i = self.index_of(node_id)
        return None if i is None else i in self._flagged_host()["pos"]

    # ---------------------------------------------- lazy materialization

    def support_of(self, i: int) -> List[str]:
        h = self._flagged_host()
        j = h["pos"].get(int(i))
        if j is not None:
            return [m for k, m in enumerate(h["names"]) if h["bits"][2 + k, j]]
        return [m for m, msk in self.support_masks.items() if bool(msk[i])]

    def node(self, i: int) -> NodeAssessment:
        """Materialize the per-node record for row ``i``."""
        self.materialized += 1
        h = self._flagged_host()
        j = h["pos"].get(int(i))
        if j is not None:
            return NodeAssessment(
                node_id=int(self.node_ids[i]),
                slowdown=float(h["slowdown"][j]),
                stalled=bool(h["bits"][0, j]),
                support=self.support_of(i),
                step_deviant=bool(h["bits"][1, j]),
                flagged=True)
        return NodeAssessment(
            node_id=int(self.node_ids[i]),
            slowdown=float(self.slowdown[i]),
            stalled=bool(self.stalled[i]),
            support=self.support_of(i),
            step_deviant=bool(self.step_deviant[i]),
            flagged=False)

    def numpy(self) -> Dict[str, object]:
        """Every field as host arrays (tests and offline analysis)."""
        return {
            "node_ids": self.node_ids,
            "slowdown": self.slowdown.cpu().numpy(),
            "stalled": self.stalled.cpu().numpy(),
            "step_deviant": self.step_deviant.cpu().numpy(),
            "flagged": self.flagged.cpu().numpy(),
            "support_masks": {m: v.cpu().numpy()
                              for m, v in self.support_masks.items()},
        }


class StragglerDetector:
    """Stateful fleet-wide detector; feed one Frame per evaluation window."""

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        self.cfg = cfg or DetectorConfig()
        self.device = resolve(self.cfg.device)
        self.history = RingHistory(self.cfg.window, self.device)
        # latch / clean-streak state as device arrays aligned with the
        # last frame's node_ids (host); ids that left the frame park their
        # state in _off until reset_node forgets them
        self._state_ids: Optional[np.ndarray] = None
        self._latched: Optional[torch.Tensor] = None   # (N,) bool
        self._clean: Optional[torch.Tensor] = None     # (N,) int64
        self._latched_host: Optional[np.ndarray] = None  # cached indices
        self._off: Dict[int, tuple] = {}   # id -> (latched, clean_streak)
        # per-row score caches aligned with the ring rows: a row's
        # verdicts never change once scored (peer medians are within-row)
        self._gen = -1                      # history generation scored
        self._dev3: Optional[torch.Tensor] = None     # (M, depth, N) bool
        self._rel: Optional[torch.Tensor] = None      # (depth, N) f32
        self._contrib: Optional[torch.Tensor] = None  # (depth, N) f32
        self._metric_list: List[str] = []
        self._metric_idx: Dict[str, int] = {}
        self._dirs: Optional[torch.Tensor] = None     # (M,) f32
        self._st_j: Optional[int] = None

    # ------------------------------------------------------------ core

    def _score_rows(self, lo: int, hi: int) -> None:
        """Score ring rows ``lo:hi`` in one fused (R, M, N) launch."""
        cfg = self.cfg
        dev, rel, contrib = score_rows(
            self.history.buffer()[lo:hi], self._dirs, self._st_j,
            z_threshold=cfg.z_threshold, slowdown_floor=cfg.slowdown_floor,
            mad_floor_frac=cfg.mad_floor_frac)
        self._dev3[:, lo:hi] = dev.transpose(0, 1)
        if self._st_j is not None:
            self._rel[lo:hi] = rel
            self._contrib[lo:hi] = contrib

    def _sync_scores(self) -> None:
        """Bring the per-row caches up to date after a push."""
        hist = self.history
        if hist.generation != self._gen:
            self._gen = hist.generation
            n = len(hist.last().node_ids)
            m = len(hist.metric_names())
            d = hist.depth
            self._metric_list = list(hist.metric_names())
            self._dirs = torch.tensor(
                [METRIC_DIRECTION[k] for k in self._metric_list],
                dtype=torch.float32, device=self.device)
            self._metric_idx = {k: j
                                for j, k in enumerate(self._metric_list)}
            self._st_j = self._metric_idx.get("step_time")
            self._dev3 = torch.zeros((m, d, n), dtype=torch.bool,
                                     device=self.device)
            self._rel = torch.zeros((d, n), dtype=torch.float32,
                                    device=self.device)
            self._contrib = torch.zeros((d, n), dtype=torch.float32,
                                        device=self.device)
            self._score_rows(0, len(hist))
        elif hist.last_backfill is not None:
            self._score_rows(0, len(hist))    # backfill rescores everything
        else:
            self._score_rows(hist.last_row, hist.last_row + 1)

    def _realign_state(self, node_ids: np.ndarray) -> None:
        """Carry latch state over a fleet membership change by id."""
        old_ids, old_latch, old_clean = \
            self._state_ids, self._latched, self._clean
        n = len(node_ids)
        dev = self.device
        if old_ids is not None and len(old_ids) == n:
            # typical case: a few replaced columns - keep the rest
            same = old_ids == node_ids
            keep = torch.from_numpy(same).to(dev)
            self._latched = old_latch & keep
            self._clean = torch.where(keep, old_clean,
                                      torch.zeros_like(old_clean))
            moved = np.flatnonzero(~same)
        else:
            self._latched = torch.zeros(n, dtype=torch.bool, device=dev)
            self._clean = torch.zeros(n, dtype=torch.int64, device=dev)
            moved = np.arange(0 if old_ids is None else len(old_ids))
        if moved.size:                        # departing ids park in _off
            mi = torch.from_numpy(moved).to(dev)
            lat = old_latch[mi].cpu().numpy()
            cln = old_clean[mi].cpu().numpy()
            for i, la, cl in zip(moved, lat, cln):
                self._off[int(old_ids[i])] = (bool(la), int(cl))
        if self._off:
            joins = moved if old_ids is not None and len(old_ids) == n \
                else np.arange(n)
            hit, lat, cln = [], [], []
            for i in joins:                   # rejoining ids resume state
                st = self._off.pop(int(node_ids[i]), None)
                if st is not None:
                    hit.append(int(i))
                    lat.append(st[0])
                    cln.append(st[1])
            if hit:
                hi = torch.tensor(hit, dtype=torch.int64, device=dev)
                self._latched[hi] = torch.tensor(lat, dtype=torch.bool,
                                                 device=dev)
                self._clean[hi] = torch.tensor(cln, dtype=torch.int64,
                                               device=dev)
        self._state_ids = np.array(node_ids, copy=True)
        self._latched_host = None

    def update(self, frame: Frame) -> FleetAssessment:
        cfg = self.cfg
        dev = self.device
        self.history.push(frame)
        self._sync_scores()
        depth = len(self.history)
        # "sustained" requires a full persistence window of history; until
        # then only stalls can flag (fresh jobs / post-replacement re-baseline)
        warmed = depth >= cfg.persistence
        need = cfg.persistence if warmed else depth + 1  # unattainable early

        # --- primary signal: sustained relative step-time excess
        all_counts = self._dev3[:, :depth].sum(1)        # (M, N) int64
        dev_count = all_counts[self._st_j]
        step_deviant = dev_count >= need
        # sustained slowdown magnitude: mean over deviant windows, summed
        # in chronological ring order one row at a time (at most depth
        # rows), exactly as the reference's float32 axis-0 reduction adds
        order = self.history.order()
        slow_sum = self._contrib[order[0]].clone()
        for r in order[1:]:
            slow_sum = slow_sum + self._contrib[r]
        slowdown = torch.where(
            step_deviant,
            slow_sum / torch.clamp(dev_count, min=1).to(torch.float32),
            torch.zeros((), dtype=torch.float32, device=dev))

        # --- stalls: no heartbeat or grossly inflated latest step, tested
        # on the host frame in float64 against np.median (even N averages
        # the two middle values; torch.median would not)
        last = self.history.last()
        st = np.asarray(last.metrics["step_time"])
        stalled_h = (~np.asarray(last.valid, bool)) | (
            st > cfg.stall_factor * np.median(st))
        stalled = torch.from_numpy(stalled_h).to(dev)

        # --- supporting hardware signals (sustained)
        support_masks = {}
        support_count = torch.zeros(len(frame.node_ids), dtype=torch.int64,
                                    device=dev)
        for m in HARDWARE_METRICS:
            if m in self._metric_idx:
                mask = all_counts[self._metric_idx[m]] >= need
                support_masks[m] = mask
                support_count += mask

        raw_flag = stalled | step_deviant | (support_count >= cfg.min_support)

        # --- hysteresis latch, vectorized over node-indexed state arrays
        if self._state_ids is None or \
                not np.array_equal(self._state_ids, frame.node_ids):
            self._realign_state(frame.node_ids)
        latched, clean = self._latched, self._clean
        clean.copy_(torch.where(raw_flag, torch.zeros_like(clean),
                                torch.where(latched, clean + 1, clean)))
        latched.copy_(raw_flag | (latched & (clean < cfg.clear_windows)))
        self._latched_host = None

        return FleetAssessment(
            node_ids=frame.node_ids, slowdown=slowdown, stalled=stalled,
            step_deviant=step_deviant, support_masks=support_masks,
            flagged=latched.clone())

    # ------------------------------------------------------- latch queries

    def _latched_idx(self) -> np.ndarray:
        """Host indices of latched columns (one transfer, cached until
        the latch state changes)."""
        if self._latched_host is None:
            self._latched_host = torch.nonzero(
                self._latched).flatten().cpu().numpy()
        return self._latched_host

    def latched_many(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized ``is_latched`` over an id array."""
        ids = np.asarray(ids)
        out = np.zeros(len(ids), bool)
        if self._state_ids is not None:
            idx = self._latched_idx()
            if idx.size:
                out |= np.isin(ids, self._state_ids[idx])
        off_lat = [n for n, st in self._off.items() if st[0]]
        if off_lat:
            out |= np.isin(ids, np.asarray(off_lat, dtype=ids.dtype))
        return out

    def is_latched(self, node_id: int) -> bool:
        """Public latch query: is this node currently flagged (with
        hysteresis)?"""
        if self._state_ids is not None:
            hit = np.flatnonzero(self._state_ids == node_id)
            if hit.size:
                return bool(np.isin(hit[0], self._latched_idx()))
        st = self._off.get(int(node_id))
        return bool(st[0]) if st is not None else False

    def latched_nodes(self) -> List[int]:
        """All currently latched node ids (sorted, for stable iteration)."""
        ids = set()
        if self._state_ids is not None:
            ids.update(int(n) for n in self._state_ids[self._latched_idx()])
        ids.update(n for n, st in self._off.items() if st[0])
        return sorted(ids)

    def reset_node(self, node_id: int) -> None:
        """Forget latch state (node replaced/repaired)."""
        self._off.pop(int(node_id), None)
        if self._state_ids is not None:
            hit = np.flatnonzero(self._state_ids == node_id)
            if hit.size:
                self._latched[int(hit[0])] = False
                self._clean[int(hit[0])] = 0
                self._latched_host = None


__all__ = ["DetectorConfig", "FleetAssessment", "NodeAssessment",
           "StragglerDetector"]
