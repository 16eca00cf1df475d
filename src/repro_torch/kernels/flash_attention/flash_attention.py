"""Wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``). bfloat16 runs on the tensor cores: one
block per (128 query rows, q head, batch), a TMA producer warpgroup
filling a 2-stage K/V ring, two consumer warpgroups on ``wgmma`` with the
online softmax in registers and P rounded to bfloat16 for P.V. float32
runs on the CUDA cores (one block per 64 query rows), exact to the
reference's 2e-5. Both skip key tiles in the causal future and mask the
ragged edges in the kernel.

The library is built with ``nvcc`` at the first launch (see
``repro_torch.kernels._build``). The wrapper checks its inputs, allocates
the output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports an error. ``COUNTER.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

COUNTER = _build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = [p, p, p, p] + [i] * 10 + [f] + [ll] * 12 + [p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: int = 0) -> torch.Tensor:
    """q (B, Hq, S, hd); k/v (B, Hkv, T, hd) CUDA tensors -> (B, Hq, S, hd).

    The same function as ``ref.attention_ref``, except that in bfloat16
    the kernel rounds P to bfloat16 before P.V. Inputs may be strided
    views (a transposed (B, S, H, hd) tensor needs no copy) as long as the
    last dimension is contiguous. The result is a (B, Hq, S, hd) view of a
    (B, S, Hq, hd) buffer, so moving it back to the model layout is free."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.dim() != 4 or t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be 4-D float32 or bfloat16, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
    if not (q.device == k.device == v.device) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one device and one dtype")
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    if tuple(k.shape) != (B, Hkv, T, hd) or tuple(v.shape) != (B, Hkv, T,
                                                                hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS or Hq % Hkv or S == 0 or T == 0:
        raise ValueError(f"unsupported shape: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (head dim in {HEAD_DIMS}, Hq a "
                         f"multiple of Hkv)")
    kv_len = kv_len or T
    if not 0 < kv_len <= T:
        raise ValueError(f"kv_len={kv_len} outside 1..{T}")
    if q.dtype == torch.bfloat16:      # TMA reads 16-byte aligned rows
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st * 2 % 16 for st in t.stride()[:3]):
                raise ValueError(
                    f"{name}: the bfloat16 kernel loads with TMA, which needs "
                    f"a 16-byte aligned base and (batch, head, row) strides "
                    f"that are multiples of 8 elements; got strides "
                    f"{t.stride()}")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, Hq, Hkv, S, T, hd, kv_len, int(q_offset),
        int(bool(causal)), 1.0 / math.sqrt(hd), *strides, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    COUNTER.launches += 1
    return out


def attention_flops(B: int, Hq: int, S: int, T: int, hd: int, *,
                    causal: bool, q_offset: int = 0) -> float:
    """Multiply-adds x 2 of QK^T and PV over the (query, key) pairs the
    mask leaves live: the work these inputs need."""
    if causal:
        live = sum(max(0, min(T, q_offset + i + 1)) for i in range(S))
    else:
        live = S * T
    return 4.0 * B * Hq * hd * live


__all__ = ["COUNTER", "HEAD_DIMS", "attention_flops", "flash_attention"]
