"""Phase 25 of ``chip_smoke.py`` alone on the card, after the kernel
phases' cases at the tensor-parallel ranks' shapes (with ``--kernels``):
each kernel phase then runs its main case and its rank case only
(``TP_AUDIO_ATTN``, ``TP_K4``, ``TP_K4B``, ``TP_K5``, ``TP_K5B``,
``TP_WINDOW``; the float32 window cases too). Run it from the
repository root on a machine with the card (~4 min with the builds):

    python3 tools/tp_phase25.py --kernels

Prints each phase's lines, the rank cases' numbers (``TPKERNELS``) and
phase 25's (``P25``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    cs.run_phase(torch, "1 build", _build.build_all)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    if "--kernels" in sys.argv:
        cs.K3_CASES = [cs.K3_CASES[0], cs.TP_AUDIO_ATTN, *cs.TP_AUDIO_OTHER]
        cs.K3B_CASES = [cs.K3B_CASES[0], cs.TP_AUDIO_ATTN]
        cs.K4_CASES = [cs.K4_CASES[0], cs.TP_K4]
        cs.K4B_CASES = [cs.K4B_CASES[0], cs.TP_K4B]
        cs.K5_CASES = [cs.K5_CASES[0], cs.TP_K5]
        cs.K5B_CASES = [cs.K5B_CASES[0], cs.TP_K5B]
        cs.K3W_CASES = [*cs.K3W_CASES[:2], cs.TP_WINDOW]
        cs.K3BW_CASES = [*cs.K3BW_CASES[:2], cs.TP_WINDOW]
        out = {}
        for label, fn in (("5", cs.phase_k3), ("6", cs.phase_k4),
                          ("9", cs.phase_k3_bwd), ("13(a)", cs.phase_k4_bwd),
                          ("17(a)", cs.phase_k5),
                          ("17(b)", cs.phase_k3_window),
                          ("19(a)", cs.phase_k5_bwd),
                          ("19(b)", cs.phase_k3_bwd_window)):
            out[label] = cs.run_phase(torch, label, fn, torch, np)
        print("TPKERNELS " + json.dumps(
            {k: {kk: v[kk] for kk in ("tp", "tp_audio") if kk in v}
             for k, v in out.items()}, default=str), flush=True)
    _, nums = cs.run_phase(torch, "25 tensor parallelism, four ranks",
                           cs.phase_tp, torch, np, card)
    print("P25 " + json.dumps(nums, default=str), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
