"""The RG-LRU scan kernel (``src/repro_torch/csrc/rglru.cu``, K5) compiled
with g++ against the CPU stand-in of the CUDA runtime in
``tools/cpu_shim`` (a thread per CUDA thread, ``std::barrier`` for
``__syncthreads`` and the named barriers of its gate, walker and store
warps' handoffs) and held, case by case, to ``rglru_ref`` at the kernel's
own limit (``chip_smoke.K5_TOL``): H and h_last from a nonzero h0,
float32 and bfloat16, at S of 1, 37, 300 and 769 steps (one step, part of
a 128-step tile, two and a third tiles, six tiles and one step: the ring
of three slots wrapped twice) and W of 33 (element accesses, a block with
one live channel) and 64 (16-byte vectors).

``tools/cpu_shim/check.py rglru`` runs in a subprocess under a time
limit: a handoff that deadlocks fails the cases instead of hanging the
suite. Skips where there is no g++.
"""
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHECK = ROOT / "tools" / "cpu_shim" / "check.py"
TIMEOUT_S = 300


def _cases():
    spec = importlib.util.spec_from_file_location("cpu_shim_check", CHECK)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.RGLRU_CASES


CASES = _cases()


@pytest.fixture(scope="module")
def shim_lines():
    """Each case's result line of one ``check.py rglru`` run."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel against the CPU stand-in")
    try:
        run = subprocess.run([sys.executable, str(CHECK), "rglru"],
                             capture_output=True, text=True,
                             timeout=TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the shim run took over {TIMEOUT_S} s (a deadlocked "
                    f"barrier?); it printed:\n{e.stdout}")
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("rglru ")]
    if len(lines) != len(CASES):
        pytest.fail(f"check.py exited {run.returncode} after "
                    f"{len(lines)} of {len(CASES)} cases:\n{run.stdout}\n"
                    f"{run.stderr}")
    return lines


@pytest.mark.parametrize("j", range(len(CASES)),
                         ids=[f"B{b}-S{s}-W{w}-{str(dt)[6:]}"
                              for b, s, w, dt in CASES])
def test_rglru_kernel_on_cpu_shim_matches_plain(shim_lines, j):
    b, s, w, dt = CASES[j]
    line = shim_lines[j]
    assert line.startswith(f"rglru B,S,W={b},{s},{w} {str(dt)[6:]} "), line
    assert line.endswith(" ok"), line
