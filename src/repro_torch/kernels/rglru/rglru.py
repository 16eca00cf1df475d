"""Wrappers of the hand-written CUDA RG-LRU scan kernel (``csrc/rglru.cu``,
K5) and of its backward (``csrc/rglru_bwd.cu``, K5').

K5: the recurrence h = a h + b of Griffin's Real-Gated LRU with its gates
computed in the kernel, one launch a call (a block per 32 channels of a
batch row, the sequence in tiles of 128 steps through a ring in shared
memory: gate warps compute each element's gates once, one walker warp
runs the chain, store warps write H). When a gradient is wanted
(``keep_states``) its store warps also write H in float32, which K5'
reads: the states before the cast.

K5': dxb and the gates' parameters' gradients, two launches a call: one
pass over the sequence from its end in a block per 32 channels of a batch
row, on K5's tiled ring (worker warps load xb, dH and the states a tile
ahead and compute each element's gates once, with the four coefficients
its dh multiplies; one walker warp runs the reverse chain, one FMA a step;
the workers then write dxb and keep the parameters' sums), then a small
pass that sums the per-row parameter sums over the batch in order.

The library is built with ``nvcc`` at the first launch (see
``repro_torch.kernels._build``). The wrapper checks its inputs, allocates
the outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports an error. ``COUNTER.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.rglru.ref import (rglru_bwd_bytes, rglru_bwd_flops,
                                           rglru_bytes, rglru_flops)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

COUNTER = _build.LaunchCounter()
BWD_COUNTER = _build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru")
    fn = lib.rglru_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def _check(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
           lam: torch.Tensor, h0: torch.Tensor, what: str) -> None:
    for name, t in (("xb", xb), ("wa", wa), ("wi", wi), ("lam", lam),
                    ("h0", h0)):
        if t.device.type != "cuda":
            raise ValueError(f"{what} kernel needs CUDA tensors, {name} is "
                             f"on {t.device}")
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


def rglru_scan(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
               lam: torch.Tensor, h0: torch.Tensor, *,
               keep_states: bool = False):
    """xb (B, S, W) contiguous float32 or bfloat16, wa/wi/lam (W,), h0
    (B, W) CUDA tensors -> (H (B, S, W) in xb's dtype, h_last (B, W)
    float32): ``ref.rglru_ref`` on the card. The gates' parameters and h0
    are read as float32 (cast here when they are not). With
    ``keep_states`` also the float32 states (B, S, W) that the backward
    reads (H itself when xb is float32)."""
    _check(xb, wa, wi, lam, h0, "rglru")
    B, S, W = xb.shape
    wa, wi, lam, h0 = (t.float().contiguous() for t in (wa, wi, lam, h0))
    out = torch.empty_like(xb)
    h_last = torch.empty((B, W), dtype=torch.float32, device=xb.device)
    states = None
    if keep_states and xb.dtype != torch.float32:
        states = torch.empty((B, S, W), dtype=torch.float32,
                             device=xb.device)
    lib = _lib()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.rglru_launch(xb.data_ptr(), wa.data_ptr(), wi.data_ptr(),
                           lam.data_ptr(), h0.data_ptr(), out.data_ptr(),
                           h_last.data_ptr(),
                           None if states is None else states.data_ptr(),
                           _DTYPES[xb.dtype], B, S, W, stream)
    if err:
        raise RuntimeError(f"rglru launch failed: "
                           f"{lib.rglru_error_string(err).decode()}")
    COUNTER.launches += 1
    if not keep_states:
        return out, h_last
    return out, h_last, out if states is None else states


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rglru_bwd")
    fn = lib.rglru_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        lib.rglru_bwd_error_string.argtypes = [ctypes.c_int]
        lib.rglru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan_bwd(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
                   lam: torch.Tensor, h0: torch.Tensor, H: torch.Tensor,
                   dH: torch.Tensor, dh_last: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """``ref.rglru_bwd_ref`` on the card: ``H`` the forward's float32
    states (``rglru_scan(..., keep_states=True)``), ``dH`` the gradient of
    H in xb's dtype, ``dh_last`` that of h_last (None: zero) -> (dxb in
    xb's dtype, dwa, dwi, dlam (W,), dh0 (B, W), float32). Two calls are
    bit-equal (fixed-order sums, no atomics)."""
    _check(xb, wa, wi, lam, h0, "rglru_bwd")
    B, S, W = xb.shape
    if H.dtype != torch.float32 or tuple(H.shape) != (B, S, W) \
            or H.device != xb.device:
        raise ValueError(f"H must be the float32 states {(B, S, W)} on "
                         f"{xb.device}, got {tuple(H.shape)} {H.dtype}")
    if tuple(dH.shape) != (B, S, W) or dH.device != xb.device:
        raise ValueError(f"dH {tuple(dH.shape)} on {dH.device} does not "
                         f"match xb {(B, S, W)}")
    wa, wi, lam, h0 = (t.float().contiguous() for t in (wa, wi, lam, h0))
    H = H.contiguous()
    dH = dH.to(xb.dtype).contiguous()
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
        if tuple(dh_last.shape) != (B, W):
            raise ValueError(f"dh_last {tuple(dh_last.shape)} != {(B, W)}")
    dxb = torch.empty_like(xb)
    grads = torch.empty((3, W), dtype=torch.float32, device=xb.device)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=xb.device)
    part = torch.empty((B, 3, W), dtype=torch.float32, device=xb.device)
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.rglru_bwd_launch(
        xb.data_ptr(), wa.data_ptr(), wi.data_ptr(), lam.data_ptr(),
        h0.data_ptr(), H.data_ptr(), dH.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dxb.data_ptr(),
        grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
        dh0.data_ptr(), part.data_ptr(), _DTYPES[xb.dtype], B, S, W, stream)
    if err:
        raise RuntimeError(f"rglru_bwd launch failed: "
                           f"{lib.rglru_bwd_error_string(err).decode()}")
    BWD_COUNTER.launches += 1
    return dxb, grads[0], grads[1], grads[2], dh0


def rglru_scan_meta(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
                    lam: torch.Tensor, h0: torch.Tensor, *,
                    keep_states: bool = False):
    """``rglru_scan``'s stand-in on meta tensors (``kernels.meta``): H,
    h_last and, with ``keep_states``, the float32 states, nothing computed;
    reports the call's operations (``rglru_flops``) and bytes
    (``rglru_bytes``)."""
    B, S, W = xb.shape
    out = torch.empty_like(xb, memory_format=torch.contiguous_format)
    h_last = torch.empty((B, W), dtype=torch.float32, device=xb.device)
    meta.report("rglru", rglru_flops(B, S, W),
                rglru_bytes(B, S, W, xb.element_size()))
    if not keep_states:
        return out, h_last
    states = out if xb.dtype == torch.float32 else torch.empty(
        (B, S, W), dtype=torch.float32, device=xb.device)
    return out, h_last, states


def rglru_scan_bwd_meta(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
                        lam: torch.Tensor, h0: torch.Tensor, H: torch.Tensor,
                        dH: torch.Tensor, dh_last: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """``rglru_scan_bwd``'s stand-in on meta tensors: dxb, dwa, dwi, dlam,
    dh0 in the backward kernel's shapes and dtypes; reports the call's
    operations and bytes."""
    B, S, W = xb.shape
    dxb = torch.empty_like(xb, memory_format=torch.contiguous_format)
    grads = torch.empty((3, W), dtype=torch.float32, device=xb.device)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=xb.device)
    meta.report("rglru_bwd", rglru_bwd_flops(B, S, W),
                rglru_bwd_bytes(B, S, W, xb.element_size()))
    return dxb, grads[0], grads[1], grads[2], dh0


__all__ = ["BWD_COUNTER", "COUNTER", "rglru_scan", "rglru_scan_bwd",
           "rglru_scan_bwd_meta", "rglru_scan_meta"]
