#!/usr/bin/env python3
"""Time an earlier design of the sharded training step beside this
tree's, in turns, on one card.

Run from the repository root:

    mkdir -p build/parent
    git archive <commit> src chip_smoke.py | tar -x -C build/parent
    python3 tools/mesh_ab.py --parent build/parent

Each turn is a process of its own that imports one tree's ``repro_torch``
and ``chip_smoke.py``, builds that tree's dense training kernels, and
runs ``chip_smoke``'s phase 10 (``train_full_width``: qwen3-4b at full
width, 8 layers, one 4,096-token sequence, bf16, remat "full") and phase
14 (``phase_train_mesh``: the same cell under a one-rank NCCL mesh, held
bit-equal to the unsharded steps), in the order earlier, this tree, this
tree, earlier. Prints the card's name and power limit, each turn's
phase 14 line, and a JSON line of each turn's step median, busy time,
peak and held memory, without and with the mesh.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("step_ms", "busy_ms", "profiled_step_ms", "peak_gb", "state_gb")


def turn(tree: str) -> dict:
    """Phases 10 and 14 of ``tree`` in this process."""
    sys.path[:0] = [str(Path(tree) / "src"), tree]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import (_build, flash_attention, fleet_score,
                                     sweep_burn, wkv6)
    _build.build_all(["flash_attention", "flash_attention_bwd",
                      "fleet_score"])
    counters = {"fleet_score": fleet_score.COUNTER,
                "sweep_burn": sweep_burn.COUNTER,
                "flash_attention": flash_attention.COUNTER,
                "flash_attention_bwd": flash_attention.BWD_COUNTER,
                "wkv6": wkv6.COUNTER, "wkv6_bwd": wkv6.BWD_COUNTER}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _, plain = cs.train_full_width(
        torch, np, counters, "qwen3-4b", cs.TRAIN_LAYERS,
        {"flash_attention": 2 * cs.TRAIN_LAYERS,
         "flash_attention_bwd": cs.TRAIN_LAYERS})
    _, mesh = cs.phase_train_mesh(torch, np, counters, plain, card)
    return {"tree": tree, "card": card,
            "plain": {k: plain[k] for k in KEYS},
            "mesh": {k: mesh[k] for k in KEYS}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier tree's src/ and chip_smoke.py")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print("TURN " + json.dumps(turn(args.turn)), flush=True)
        return
    turns = []
    for tree in (args.parent, str(ROOT), str(ROOT), args.parent):
        proc = subprocess.run(
            [sys.executable, __file__, "--parent", args.parent,
             "--turn", tree], capture_output=True, text=True, timeout=600)
        lines = proc.stdout.splitlines()
        for line in lines:
            if "under a one-rank NCCL mesh (" in line:
                print(line[:400], flush=True)
        done = [json.loads(x[5:]) for x in lines if x.startswith("TURN ")]
        if proc.returncode or not done:
            sys.exit(f"turn {tree} failed ({proc.returncode}):\n"
                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        turns.append(done[0])
    print(turns[0]["card"], flush=True)
    print(json.dumps(turns), flush=True)


if __name__ == "__main__":
    main()
