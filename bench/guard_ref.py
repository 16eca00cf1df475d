"""Plain NumPy reference of Guard's straggler verdicts on the frames a run
fed its detector (Guard paper, section 4.2).

Each window's frame holds every node's step time. A row is scored
against its peers: median m, MAD of the deviations, robust z = (x - m) /
max(MAD / 0.6745, max(|m| 0.01, 1e-9)); a node deviates in that row where
z > 3 and its relative excess x / max(m, 1e-9) - 1 passes 0.025. With
the last 6 rows kept, a node is step-deviant where it deviated in at
least 3 of them (in a ring not yet 3 deep, never), its slowdown is the
float32 sum of its excess over the deviant rows, oldest first, over their
count, and it is stalled where its frame reading is invalid or above 5
times the frame's median (float64). A node is flagged where it is stalled
or step-deviant, and stays flagged until 3 clean windows in a row. A node
replaced in the frame takes its new reading in every kept row and starts
unflagged. All float32 arithmetic is done in float32, one rounding per
operation, in the order written above.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

F = np.float32
DEPTH, PERSIST, Z, FLOOR, STALL, CLEAR, MADF = 6, 3, 3.0, 0.025, 5.0, 3, 0.01


def _score(row: np.ndarray):
    med = np.median(row)
    diff = row - med
    mad = np.median(np.abs(diff))
    floor = np.maximum(np.abs(med) * F(MADF), F(1e-9))
    scale = np.maximum(mad / F(0.6745), floor)
    z = (diff / scale) * F(1.0)
    rel = row / np.maximum(med, F(1e-9)) - F(1.0)
    dev = (z > F(Z)) & (rel > F(FLOOR))
    return dev, np.where(dev, rel, F(0.0)).astype(F)


def verdicts(frames: Sequence[dict]) -> List[Dict[str, np.ndarray]]:
    """frames: dicts of "node_ids", "step_time" (float64) and "valid" ->
    per window "flagged", "stalled", "step_deviant", "slowdown"."""
    rows: List[np.ndarray] = []
    scored: List[tuple] = []
    ids = latched = clean = None
    out = []
    for fr in frames:
        node_ids = np.asarray(fr["node_ids"])
        st = np.asarray(fr["step_time"], np.float64)
        valid = np.asarray(fr["valid"], bool)
        row = st.astype(F)
        if ids is None or len(ids) != len(node_ids):
            rows, scored = [], []
            ids = node_ids.copy()
            latched = np.zeros(len(ids), bool)
            clean = np.zeros(len(ids), np.int64)
        changed = node_ids != ids
        if changed.any():                 # a replaced node: backfilled
            for r in rows:
                r[changed] = row[changed]
            scored = [_score(r) for r in rows]
            latched = latched & ~changed
            clean = np.where(changed, 0, clean)
            ids = node_ids.copy()
        rows.append(row.copy())
        scored.append(_score(rows[-1]))
        if len(rows) > DEPTH:
            rows.pop(0)
            scored.pop(0)
        need = PERSIST if len(rows) >= PERSIST else len(rows) + 1
        count = np.sum([d for d, _ in scored], axis=0)
        deviant = count >= need
        total = scored[0][1].copy()
        for _, c in scored[1:]:
            total = (total + c).astype(F)
        slowdown = np.where(deviant, total / np.maximum(count, 1).astype(F),
                            F(0.0)).astype(F)
        stalled = ~valid | (st > STALL * np.median(st))
        raw = stalled | deviant
        clean = np.where(raw, 0, np.where(latched, clean + 1, clean))
        latched = raw | (latched & (clean < CLEAR))
        out.append({"flagged": latched.copy(), "stalled": stalled,
                    "step_deviant": deviant, "slowdown": slowdown})
    return out


def mismatches(frames: Sequence[dict], got: Sequence[dict]) -> int:
    """Nodes over all windows whose flagged, stalled, step-deviant bit or
    slowdown (bit for bit) differs from the reference's; a window missing
    on either side counts every node of it."""
    want = verdicts(frames)
    bad = 0
    for i in range(max(len(want), len(got))):
        if i >= len(want) or i >= len(got):
            n = len((want if i < len(want) else got)[i]["flagged"])
            bad += n
            continue
        w, g = want[i], got[i]
        diff = np.zeros(len(w["flagged"]), bool)
        for key in ("flagged", "stalled", "step_deviant"):
            diff |= np.asarray(g[key], bool) != w[key]
        gs = np.asarray(g["slowdown"], F)
        diff |= gs.view(np.uint32) != w["slowdown"].view(np.uint32)
        bad += int(diff.sum())
    return bad
