"""Wrapper of the hand-written CUDA burn kernel (``csrc/sweep_burn.cu``):
a tiled float32 SIMT GEMM plus a fixed-order rescale, 2 launches per
iteration, issued by one C call. ``COUNTER.launches`` counts the calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE = 64          # the kernel's output tile: M and K must be multiples

COUNTER = _build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = _build.load("sweep_burn")
    fn = lib.sweep_burn_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.sweep_burn_error_string.argtypes = [ctypes.c_int]
        lib.sweep_burn_error_string.restype = ctypes.c_char_p
    return lib


def burn(a: torch.Tensor, b: torch.Tensor, *, iters: int = 64
         ) -> torch.Tensor:
    """a (M, K), b (K, K) float32 CUDA tensors -> (M, K) chained product.

    FLOPs executed = ``burn_flops(M, K, iters)``."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"burn kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    m, k = a.shape
    if tuple(b.shape) != (k, k):
        raise ValueError(f"burn chain needs square b of side {k}, got "
                         f"{tuple(b.shape)}")
    if m % TILE or k % TILE or m * k >= 2 ** 31:
        raise ValueError(f"M={m} and K={k} must be multiples of {TILE}")
    if iters < 0:
        raise ValueError(f"iters={iters} < 0")
    b = b.contiguous()
    x = a.contiguous().clone()
    y = torch.empty_like(x)
    partial = torch.empty((m // TILE) * (k // TILE), dtype=torch.float32,
                          device=a.device)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.sweep_burn_launch(x.data_ptr(), b.data_ptr(), y.data_ptr(),
                                partial.data_ptr(), m, k, int(iters), stream)
    if err:
        raise RuntimeError(f"sweep_burn launch failed: "
                           f"{lib.sweep_burn_error_string(err).decode()}")
    COUNTER.launches += 1
    return x


def burn_flops(M: int, K: int, iters: int) -> float:
    return 2.0 * M * K * K * iters


__all__ = ["COUNTER", "TILE", "burn", "burn_flops"]
