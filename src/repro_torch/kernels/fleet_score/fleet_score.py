# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Wrapper of the hand-written CUDA fleet-score kernel
(``csrc/fleet_score.cu``): one block per (row, metric), exact medians by a
radix select over uint32 keys (4 rounds of 8-bit digits per order
statistic, from a copy of the row in shared memory up to 49,152 nodes,
from global memory beyond), outputs bit-identical to
``ref.score_rows_ref``.

The library is built with ``nvcc`` at the first launch (see
``repro_torch.kernels._build``). The wrapper checks its inputs, allocates
the outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports an error. ``COUNTER.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import _build

COUNTER = _build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = _build.load("fleet_score")
    fn = lib.fleet_score_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, i, i, i, f, f, f, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.fleet_score_error_string.argtypes = [ctypes.c_int]
        lib.fleet_score_error_string.restype = ctypes.c_char_p
    return lib


def fleet_score(
    mats: torch.Tensor,
    dirs: Union[Sequence[float], torch.Tensor],
    st_j: Optional[int],
    *,
    z_threshold: float,
    slowdown_floor: float,
    mad_floor_frac: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score (R, M, N) float32 rows on the card. Returns ``(dev, rel,
    contrib)``: (R, M, N) bool, (R, N) float32, (R, N) float32. ``dirs``
    may already be a float32 tensor on the card (the detector caches it),
    which saves a host-to-device copy per launch."""
    if mats.device.type != "cuda":
        raise ValueError(f"fleet_score kernel needs a CUDA tensor, got "
                         f"{mats.device}")
    if mats.dtype != torch.float32 or mats.dim() != 3:
        raise ValueError(f"mats must be (R, M, N) float32, got "
                         f"{tuple(mats.shape)} {mats.dtype}")
    if not mats.is_contiguous():
        raise ValueError("mats must be contiguous")
    r, m, n = mats.shape
    if len(dirs) != m:
        raise ValueError(f"{len(dirs)} directions for {m} metrics")
    if r == 0 or n == 0 or r * m * n >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(mats.shape)}")
    if st_j is not None and not 0 <= st_j < m:
        raise ValueError(f"st_j={st_j} out of range for {m} metrics")
    dev_ = mats.device
    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev_).contiguous()
    dev = torch.empty((r, m, n), dtype=torch.uint8, device=dev_)
    alloc = torch.empty if st_j is not None else torch.zeros
    rel = alloc((r, n), dtype=torch.float32, device=dev_)
    contrib = alloc((r, n), dtype=torch.float32, device=dev_)
    lib = _lib()
    stream = torch.cuda.current_stream(dev_).cuda_stream
    err = lib.fleet_score_launch(
        mats.data_ptr(), d.data_ptr(), r, m, n,
        -1 if st_j is None else int(st_j),
        float(np.float32(z_threshold)), float(np.float32(slowdown_floor)),
        float(np.float32(mad_floor_frac)),
        dev.data_ptr(), rel.data_ptr(), contrib.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fleet_score launch failed: "
                           f"{lib.fleet_score_error_string(err).decode()}")
    COUNTER.launches += 1
    return dev.view(torch.bool), rel, contrib


__all__ = ["COUNTER", "fleet_score"]
