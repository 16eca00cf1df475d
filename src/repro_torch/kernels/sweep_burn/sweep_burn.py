"""Wrapper of the hand-written CUDA burn kernel (``csrc/sweep_burn.cu``):
the whole chain in one cooperative launch, one grid barrier per
iteration. Each block owns 32x64 tiles of y; at 512^2 the 128 blocks keep
their panels of b resident in shared memory, larger shapes stream b in
double-buffered slices. Sums are taken in a fixed order, so the result
repeats bit for bit. ``COUNTER.launches`` counts the launches and
``LAST`` holds the last launch's mode (``resident`` or ``streaming``) and
grid size. A grid that cannot be co-resident raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

TILE = 64          # M and K must be multiples
_TILE_ROWS = 32    # the kernel's tiles of y are 32 x 64

COUNTER = _build.LaunchCounter()
LAST: Dict[str, object] = {}
_MODES = {1: "resident", 2: "streaming"}


def _lib() -> ctypes.CDLL:
    lib = _build.load("sweep_burn")
    fn = lib.sweep_burn_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [p, p, p, p, p, i, i, i, p, ip, ip]
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
    a, b = a.contiguous(), b.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("burn kernel needs 16-byte aligned a and b")
    if iters == 0:
        return a.clone()
    out = torch.empty_like(a)
    ybuf = torch.empty((2, m, k), dtype=torch.float32, device=a.device)
    partial = torch.empty(2 * (m // _TILE_ROWS) * (k // TILE),
                          dtype=torch.float32, device=a.device)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    mode, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.sweep_burn_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                ybuf.data_ptr(), partial.data_ptr(), m, k,
                                int(iters), stream, ctypes.byref(mode),
                                ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"sweep_burn launch failed: "
                           f"{lib.sweep_burn_error_string(err).decode()}")
    COUNTER.launches += 1
    LAST.update(mode=_MODES[mode.value], blocks=blocks.value)
    return out


def burn_flops(M: int, K: int, iters: int) -> float:
    return 2.0 * M * K * K * iters


__all__ = ["COUNTER", "LAST", "TILE", "burn", "burn_flops"]
