"""The RG-LRU scan kernel (``src/repro_torch/csrc/rglru.cu``, K5) and its
backward (``src/repro_torch/csrc/rglru_bwd.cu``, K5') compiled with g++
against the CPU stand-in of the CUDA runtime in ``tools/cpu_shim`` (a
thread per CUDA thread, ``std::barrier`` for ``__syncthreads`` and the
named barriers of K5's gate, walker and store warps' handoffs) and held,
case by case, to their plain versions at the kernels' own limits:

- K5 against ``rglru_ref`` (``chip_smoke.K5_TOL``): H and h_last from a
  nonzero h0, float32 and bfloat16 (there also the float32 states it
  writes for the backward), at S of 1, 37, 300 and 769 steps (one step,
  part of a 128-step tile, two and a third tiles, six tiles and one step:
  the ring of three slots wrapped twice) and W of 33 (element accesses, a
  block with one live channel) and 64 (16-byte vectors);
- K5' against ``rglru_bwd_ref`` (``chip_smoke.K5B_TOL``): dxb, dwa, dwi,
  dlam and dh0 from a nonzero h0 and h_last cotangent, float32 and
  bfloat16, at S of 1, 15, 37, 44, 45, 88, 89, 300, 385 and 441 (it walks
  the sequence from its end in tiles of 44 float32 or 88 bfloat16 steps
  through a ring of two slots: one live row of a tile; one partial tile;
  a whole tile of either dtype; one step past a tile; several tiles and a
  part; 10 or 5 tiles and one step, the ring wrapped more than once) and
  W of 33 and 64; and at S = 89, W = 64 with every fifth x at +-400, where
  exp(-x w) overflows and the sigmoids' reciprocals take their clamp.

``tools/cpu_shim/check.py <kernel>`` runs in a subprocess under a time
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


def _check_module():
    spec = importlib.util.spec_from_file_location("cpu_shim_check", CHECK)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CHECK = _check_module()
CASES = _CHECK.RGLRU_CASES
BWD_CASES = _CHECK.RGLRU_BWD_CASES


def _shim_lines(kernel: str, n_cases: int) -> list:
    """Each case's result line of one ``check.py <kernel>`` run."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel against the CPU stand-in")
    try:
        run = subprocess.run([sys.executable, str(CHECK), kernel],
                             capture_output=True, text=True,
                             timeout=TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the shim run took over {TIMEOUT_S} s (a deadlocked "
                    f"barrier?); it printed:\n{e.stdout}")
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith(f"{kernel} ")]
    if len(lines) != n_cases:
        pytest.fail(f"check.py exited {run.returncode} after "
                    f"{len(lines)} of {n_cases} cases:\n{run.stdout}\n"
                    f"{run.stderr}")
    return lines


@pytest.fixture(scope="module")
def shim_lines():
    return _shim_lines("rglru", len(CASES))


@pytest.fixture(scope="module")
def shim_bwd_lines():
    return _shim_lines("rglru_bwd", len(BWD_CASES))


@pytest.mark.parametrize("j", range(len(CASES)),
                         ids=[f"B{b}-S{s}-W{w}-{str(dt)[6:]}"
                              for b, s, w, dt in CASES])
def test_rglru_kernel_on_cpu_shim_matches_plain(shim_lines, j):
    b, s, w, dt = CASES[j]
    line = shim_lines[j]
    assert line.startswith(f"rglru B,S,W={b},{s},{w} {str(dt)[6:]} "), line
    assert line.endswith(" ok"), line


@pytest.mark.parametrize("j", range(len(BWD_CASES)),
                         ids=[f"B{c[0]}-S{c[1]}-W{c[2]}-{str(c[3])[6:]}"
                              + ("-big" if c[4:] else "")
                              for c in BWD_CASES])
def test_rglru_bwd_kernel_on_cpu_shim_matches_plain(shim_bwd_lines, j):
    b, s, w, dt = BWD_CASES[j][:4]
    line = shim_bwd_lines[j]
    assert line.startswith(f"rglru_bwd B,S,W={b},{s},{w} {str(dt)[6:]} "), \
        line
    assert line.endswith(" ok"), line
