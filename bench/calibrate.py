"""The readings the limits of a cell are set from: whole runs of the cell
(``harness.run_cell``, a short window) on many seeds in one process, each
printing every number the check can compare, for the program's sound
runs, and the leaves whose gradient reads worst where the family's
checks name them; ``bench/control.py`` reads the control's and the
faults'.

  python3 bench/calibrate.py --workload <name> --seconds 2 --seeds <n> ...
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(harness.load_benchmark(), args.workload)
    for seed in args.seeds:
        out = harness.run_cell(c, seed, args.seconds, False, "cuda",
                               time.perf_counter())
        worst = sorted(out["detail"].items(), key=lambda kv: -kv[1])[:5]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["result"]["correct"],
                          "numbers": out["gaps"],
                          "worst_leaves": worst,
                          "loss": out["program"]["loss"],
                          "ref_loss": out["ref"]["loss"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
