# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Vectorized what-if counterfactual replay over the collective structure.

The peer-relative detector scores the *measured* per-node step time,
which in a real job includes barrier wait: one degraded node inflates
the wall time of every peer in its blocking collective group, and the
z-score cannot tell the culprit from the cascade victims stalled behind
it. The what-if engine separates them by replaying each window against
the collective dependency structure with counterfactual node timings —
the approach of the what-if straggler-analysis line of work, reduced to
array passes.

``Topology`` captures the dependency structure Guard needs: the
partition of job nodes into blocking-collective groups (the DP gradient
barrier within each pipeline/model-parallel stage). Nodes in a group
complete together at the group's slowest member; the job step completes
at the slowest group. Build one from a distributed context's axis sizes
(``Topology.from_dist``) or directly (``grouped`` / ``pipeline`` /
``single``).

Two counterfactuals, both one vectorized pass per window over ``(N,)``
arrays:

  blame      standalone what-if: fleet step time in a world where ONLY
             node i is degraded (everyone else at the healthy
             reference) minus the all-healthy fleet time — i.e. the
             node's own excess over reference. Robust to multiple
             concurrent culprits (a culprit shadowed by a worse one in
             the same group still carries its own blame); exactly zero
             for barrier-stalled victims.
  marginal   leave-one-out what-if: actual fleet step time minus the
             fleet step time with node i replaced by the healthy
             reference — the step-time seconds mitigation would win
             back *right now*. Ranks severity; shadowed culprits show
             zero until the node ahead of them is fixed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class Topology:
    """Partition of the N job nodes into blocking-collective groups.

    ``stage_of`` maps each node ROW (its position in the active array /
    telemetry frame, which is stable across spare swaps) to a group id.
    Group reductions are precompiled into a sort permutation +
    ``reduceat`` boundaries so ``group_max`` over a ``(..., N)`` array is
    one gather, one segmented reduction and one scatter."""

    def __init__(self, stage_of: np.ndarray):
        stage_of = np.asarray(stage_of)
        assert stage_of.ndim == 1 and len(stage_of) >= 1
        self.stage_of = stage_of
        self.n = len(stage_of)
        # contiguous fast path: every builder lays groups out in sorted
        # blocks, so the permutation is the identity and each segmented
        # reduction can skip its (..., N) gather/scatter — the difference
        # between O(N) copies and pure reduceat at 100k nodes
        self.contiguous = bool(np.all(stage_of[1:] >= stage_of[:-1]))
        self.order = (np.arange(self.n) if self.contiguous
                      else np.argsort(stage_of, kind="stable"))
        sorted_stages = stage_of if self.contiguous \
            else stage_of[self.order]
        boundary = np.r_[True, sorted_stages[1:] != sorted_stages[:-1]]
        self.starts = np.flatnonzero(boundary)
        self.n_groups = len(self.starts)
        self.counts = np.diff(np.r_[self.starts, self.n])
        # group ordinal of each SORTED position (for expand/scatter)
        self._pos_group = np.repeat(np.arange(self.n_groups), self.counts)

    # ---------------------------------------------------------- builders

    @classmethod
    def single(cls, n: int) -> "Topology":
        """One global barrier: every node blocks on every other."""
        return cls(np.zeros(n, dtype=np.int64))

    @classmethod
    def grouped(cls, n: int, group_size: int) -> "Topology":
        """Contiguous blocks of ``group_size`` nodes barrier together
        (DP gradient all-reduce groups; the last block may be short)."""
        assert group_size >= 1
        return cls(np.arange(n, dtype=np.int64) // group_size)

    @classmethod
    def pipeline(cls, n: int, n_stages: int) -> "Topology":
        """``n_stages`` contiguous pipeline stages, each one barrier
        group (nodes of a stage hold the same model shard and all-reduce
        gradients together)."""
        assert 1 <= n_stages <= n
        return cls.grouped(n, -(-n // n_stages))

    @classmethod
    def from_dist(cls, ctx, n: int) -> "Topology":
        """Derive the barrier structure from a distributed context (any
        object with ``axis_size(name)``, as the reference's DistContext
        has): the model-parallel axis size ("tp" -> mesh "model")
        is the number of model shards, i.e. the number of independent DP
        all-reduce groups; nodes are laid out shard-major."""
        stages = max(int(ctx.axis_size("tp")), 1)
        return cls.pipeline(n, min(stages, n))

    # --------------------------------------------------------- reductions

    def group_reduce_max(self, x: np.ndarray) -> np.ndarray:
        """(..., N) -> (..., G) max within each group."""
        xs = x if self.contiguous else x[..., self.order]
        return np.maximum.reduceat(xs, self.starts, axis=-1)

    def group_max(self, x: np.ndarray) -> np.ndarray:
        """(..., N) -> (..., N): each element replaced by its group max
        (the wall time a blocking collective imposes on every member)."""
        gm = self.group_reduce_max(x)
        expanded = gm[..., self._pos_group]
        if self.contiguous:
            return expanded
        out = np.empty_like(x)
        out[..., self.order] = expanded
        return out


@dataclasses.dataclass
class WhatIfReport:
    """Per-window counterfactual attribution for the fleet."""

    fleet_time: float                # actual fleet step time (s)
    healthy_time: float              # all-healthy counterfactual (s)
    ref_own: float                   # healthy per-node own-time reference
    blame: np.ndarray                # (N,) standalone what-if excess, s
    blame_rel: np.ndarray            # (N,) blame / ref_own
    marginal: np.ndarray             # (N,) leave-one-out fleet delta, s

    def culprit_mask(self, floor_rel: float = 0.04) -> np.ndarray:
        return self.blame_rel > floor_rel


def fast_median(a: np.ndarray) -> float:
    """1-D median via one partition — identical result to ``np.median``
    without its per-call dispatch/nan-check overhead (this sits on the
    per-window attribution path).

    Even length uses ONE kth plus a max over the left half (the (h-1)-th
    order statistic): numpy's multi-kth introselect is ~7x slower than
    single-kth, and the max recovers the same element exactly."""
    n = a.size
    h = n // 2
    p = np.partition(a, h)
    if n % 2:
        return float(p[h])
    return float(p[:h].max() + p[h]) / 2.0


def row_median(mat: np.ndarray) -> np.ndarray:
    """(M, N) -> (M, 1) median along axis 1 via one partition (same
    single-kth + left-half-max trick as ``fast_median``)."""
    n = mat.shape[1]
    h = n // 2
    p = np.partition(mat, h, axis=1)
    if n % 2:
        return p[:, h:h + 1]
    return (p[:, :h].max(axis=1, keepdims=True) + p[:, h:h + 1]) / 2.0


def whatif(own: np.ndarray, topology: Topology,
           ref_own: Optional[float] = None) -> WhatIfReport:
    """Counterfactual attribution for one window of own-work times.

    ``own`` is the (N,) per-node own-time (compute + comm + host,
    EXCLUDING barrier stall) — typically a ``TimingTrace`` window mean.
    ``ref_own`` is the healthy per-node reference; defaults to the fleet
    median (robust while the healthy population is the majority).

    One array pass: blame is elementwise; the leave-one-out marginal
    needs each group's (first) argmax and runner-up, both computed with
    segmented reductions — no per-group Python loop.
    """
    own = np.asarray(own)
    if not np.issubdtype(own.dtype, np.floating):
        own = own.astype(np.float32)   # dtype-preserving: f32 stays f32
    assert own.shape == (topology.n,)
    ref = fast_median(own) if ref_own is None else float(ref_own)
    ref = max(ref, 1e-9)

    # standalone what-if: only node i degraded, rest at reference. The
    # job would finish at max(ref, own_i); all-healthy finishes at ref.
    blame = own - ref
    np.maximum(blame, 0.0, out=blame)

    # leave-one-out what-if: group times with node i at reference. Only
    # a group's (first) argmax can lower its group time; the fleet step
    # then re-completes at the slowest remaining group.
    order, starts = topology.order, topology.starts
    xs = own if topology.contiguous else own[order]
    gmax = np.maximum.reduceat(xs, starts)                     # (G,)
    fleet_time = float(gmax.max())
    # first-argmax position per group: the first is-max flag at or after
    # each group's start (every group has one, so searchsorted lands
    # inside the right segment)
    flags = np.flatnonzero(xs == gmax[topology._pos_group])
    pos = flags[np.searchsorted(flags, starts)]
    arg_nodes = pos if topology.contiguous else order[pos]
    xs2 = xs.copy()
    xs2[pos] = -np.inf
    second = np.maximum.reduceat(xs2, starts)    # -inf for singletons
    # "slowest OTHER group": top-2 of the group maxima (ties resolve to
    # the shared max, which is exactly right)
    if topology.n_groups == 1:
        others = np.full(1, -np.inf, own.dtype)
    else:
        part = np.partition(gmax, topology.n_groups - 2)
        g1, g2 = part[-1], part[-2]     # numpy scalars: keep own's dtype
        others = np.where(gmax == g1, g2, g1)
    new_group = np.maximum(np.maximum(second, ref), others)
    marginal = np.zeros_like(own)
    marginal[arg_nodes] = np.maximum(fleet_time - new_group, 0.0)

    return WhatIfReport(
        fleet_time=fleet_time, healthy_time=ref, ref_own=ref,
        blame=blame, blame_rel=blame / ref, marginal=marginal)


__all__ = ["Topology", "WhatIfReport", "fast_median", "row_median",
           "whatif"]
