"""Wrapper of the hand-written CUDA RG-LRU scan kernel (``csrc/rglru.cu``,
K5): the recurrence h = a h + b of Griffin's Real-Gated LRU with its gates
computed in the kernel, one launch a call (a block per 32 channels of a
batch row, the sequence in tiles of 128 steps through a ring in shared
memory: gate warps compute each element's gates once, one walker warp
runs the chain, store warps write H).

The library is built with ``nvcc`` at the first launch (see
``repro_torch.kernels._build``). The wrapper checks its inputs, allocates
the outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports an error. ``COUNTER.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

COUNTER = _build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru")
    fn = lib.rglru_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
               lam: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb (B, S, W) contiguous float32 or bfloat16, wa/wi/lam (W,), h0
    (B, W) CUDA tensors -> (H (B, S, W) in xb's dtype, h_last (B, W)
    float32): ``ref.rglru_ref`` on the card. The gates' parameters and h0
    are read as float32 (cast here when they are not)."""
    for name, t in (("xb", xb), ("wa", wa), ("wi", wi), ("lam", lam),
                    ("h0", h0)):
        if t.device.type != "cuda":
            raise ValueError(f"rglru kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.device != xb.device:
            raise ValueError(f"{name} on {t.device}, xb on {xb.device}")
    if xb.dim() != 3 or xb.dtype not in _DTYPES:
        raise ValueError(f"xb must be (B, S, W) float32 or bfloat16, got "
                         f"{tuple(xb.shape)} {xb.dtype}")
    if not xb.is_contiguous():
        raise ValueError("xb must be contiguous")
    B, S, W = xb.shape
    if B == 0 or S == 0 or W == 0:
        raise ValueError(f"empty input {tuple(xb.shape)}")
    for name, t in (("wa", wa), ("wi", wi), ("lam", lam)):
        if tuple(t.shape) != (W,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({W},)")
    if tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} != {(B, W)}")
    wa, wi, lam, h0 = (t.float().contiguous() for t in (wa, wi, lam, h0))
    out = torch.empty_like(xb)
    h_last = torch.empty((B, W), dtype=torch.float32, device=xb.device)
    lib = _lib()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.rglru_launch(xb.data_ptr(), wa.data_ptr(), wi.data_ptr(),
                           lam.data_ptr(), h0.data_ptr(), out.data_ptr(),
                           h_last.data_ptr(), _DTYPES[xb.dtype], B, S, W,
                           stream)
    if err:
        raise RuntimeError(f"rglru launch failed: "
                           f"{lib.rglru_error_string(err).decode()}")
    COUNTER.launches += 1
    return out, h_last


__all__ = ["COUNTER", "rglru_scan"]
