"""The control and the planted faults of a cell, read on the card at the
cell's own size: the plain reference computed one precision lower in the
program's place (the control: float8 products for the program's
bfloat16 ones, TF32 for its float32 ones), and with half of each batch
left out, each compared with the float32 reference by the cell's own
numbers and held to the cell's limits by the harness's own comparison
(``harness.control_numbers``, ``harness.judge``): each must come out not
correct. A state left unchanged reads 1 by construction and needs no run.

  python3 bench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed, with "control_correct" and
"half_batch_correct". The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT)]


def readings(c: dict, seed: int, device: str) -> dict:
    from bench import harness
    return {"seed": seed, **harness.control_numbers(c, seed, device)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(harness.load_benchmark(), args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **readings(c, seed, "cuda")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
