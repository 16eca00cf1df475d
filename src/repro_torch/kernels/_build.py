"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``. The build
lands in ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the flags, the source and every header
it includes (``csrc/hopper.cuh``), so an edited source or header never
loads a stale library. Nothing is built when a module is
imported: the first launch builds, or a caller builds every kernel at
once, in parallel, with ``build_all``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# nvcc flags per source. All keep IEEE division, square root and expf (no
# --use_fast_math); fleet_score also forbids fused multiply-adds so that
# every product and sum is rounded on its own, as numpy rounds them.
# flash_attention and flash_attention_bwd need no flag of their own: both
# reach the driver's cuTensorMapEncodeTiled through the runtime's driver
# entry point (no -lcuda) and write their wgmma/TMA instructions as inline
# PTX (no CUTLASS include), from the shared csrc/hopper.cuh; sweep_burn's
# grid barrier is cooperative_groups' grid.sync, which needs no
# relocatable device code.
_COMMON = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
FLAGS: Dict[str, Tuple[str, ...]] = {
    "fleet_score": _COMMON + ("-fmad=false",),
    "sweep_burn": _COMMON,
    "flash_attention": _COMMON,
    "flash_attention_bwd": _COMMON,
    "wkv6": _COMMON,
    "wkv6_bwd": _COMMON,
    "rglru": _COMMON,
    "rglru_bwd": _COMMON,
}


class LaunchCounter:
    """Plain integer count of one kernel's launches. Each wrapper adds one
    where it launches its kernel and nowhere else; a caller resets it."""

    def __init__(self) -> None:
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and every header it includes with quotes, recursively,
    each once."""
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(path.parent / inc.decode(), seen)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256("\0".join(FLAGS[name]).encode())
    for path in _sources(CSRC / f"{name}.cu", []):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc(), *FLAGS[name], "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = tuple(FLAGS)) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns each kernel's compiler log
    (``-Xptxas -v`` register and shared-memory report); raises with the
    log of any build that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            logs[name] = "(already built)"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


__all__ = ["BUILD_DIR", "CSRC", "FLAGS", "LaunchCounter", "build_all",
           "load", "nvcc"]
