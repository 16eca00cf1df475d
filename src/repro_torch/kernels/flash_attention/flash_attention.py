"""Wrappers of the hand-written CUDA flash-attention kernels.

Forward (``csrc/flash_attention.cu``). bfloat16 runs on the tensor cores: one
block per (128 query rows, q head, batch), a TMA producer warpgroup
filling a 2-stage K/V ring, two consumer warpgroups on ``wgmma`` with the
online softmax in registers and P rounded to bfloat16 for P.V. float32
runs on the CUDA cores (one block per 64 query rows), exact to the
reference's 2e-5. Both skip key tiles in the causal future and mask the
ragged edges in the kernel, and both write each row's log-sum-exp when
asked (``lse=True``), for the backward. With ``window`` > 0 (the hybrid
family's sliding window) both also skip the key tiles before each query
tile's window and mask the keys k <= p - window of query position p.
Head dims 32, 64, 128 and 256 (256 with 64-key tiles on the tensor
cores).

Backward (``csrc/flash_attention_bwd.cu``): dQ, dK, dV from the forward's
output and log-sum-exp, three launches per call (D = rowsum(dO o O), a
dK/dV kernel per 128-key tile, a dQ kernel per 128-query tile), float32
sums in a fixed order with no atomics, so two calls are bit-equal. In
bfloat16, where the key tiles are too few to fill the card (one KV head
at batch 1, as recurrentgemma's), the dK/dV kernel splits each KV head's
query heads (``dkdv_split``) into float32 parts that a fourth launch adds
in order.
bfloat16 runs on the tensor cores like the forward (a TMA producer
warpgroup and two ``wgmma`` consumer warpgroups a block; P and dS rounded
to bfloat16 before their products) and needs 16-byte aligned rows of q,
k, v, o and do; float32 runs on the CUDA cores. ``BWD_COUNTER`` counts its
calls. It takes the forward's ``window`` (the dK/dV kernel walks the query
tiles from the causal limit to the window's end, the dQ kernel the key
tiles from the window's start) and every head dim of the forward
(``BWD_HEAD_DIMS``): at 256 a dK/dV block takes 64 keys, one consumer
computes the scores and P, the other dP and dS, they hand them to each
other through shared memory and each owns half the head dim of dK and dV;
the dQ kernel takes 48-key tiles through a two-stage ring there.

The library is built with ``nvcc`` at the first launch (see
``repro_torch.kernels._build``). The wrapper checks its inputs, allocates
the outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports an error. ``COUNTER.launches`` counts the
forward's launches.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build, meta

HEAD_DIMS = (32, 64, 128, 256)
BWD_HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

COUNTER = _build.LaunchCounter()
BWD_COUNTER = _build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = [p] * 5 + [i] * 11 + [f] + [ll] * 12 + [p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 10 + [i] * 11 + [ctypes.c_float, i, p]
                       + [ctypes.POINTER(ctypes.c_longlong), p])
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def aligned16(t: torch.Tensor) -> bool:
    """Whether a bfloat16 tensor's base and (batch, head, row) strides are
    16-byte aligned, as TMA and the 16-byte tile loads need."""
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:3])


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: int) -> int:
    """Raise on what the kernels do not take; returns kv_len (0 -> T)."""
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
    return kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, kv_len: int = 0,
                    window: int = 0, lse: bool = False):
    """q (B, Hq, S, hd); k/v (B, Hkv, T, hd) CUDA tensors -> (B, Hq, S, hd),
    and with ``lse`` also the rows' float32 log-sum-exp (B, Hq, S).
    ``window`` > 0 (which needs ``causal``) lets query position p see only
    the keys k with p - window < k <= p.

    The same function as ``ref.attention_ref``, except that in bfloat16
    the kernel rounds P to bfloat16 before P.V. Inputs may be strided
    views (a transposed (B, S, H, hd) tensor needs no copy) as long as the
    last dimension is contiguous. The result is a (B, Hq, S, hd) view of a
    (B, S, Hq, hd) buffer, so moving it back to the model layout is free."""
    kv_len = _check_qkv(q, k, v, kv_len)
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window}: a sliding window is >= 0 and "
                         f"needs causal=True")
    if q.dtype == torch.bfloat16:      # TMA reads 16-byte aligned rows
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not aligned16(t):
                raise ValueError(
                    f"{name}: the bfloat16 kernel loads with TMA, which needs "
                    f"a 16-byte aligned base and (batch, head, row) strides "
                    f"that are multiples of 8 elements; got strides "
                    f"{t.stride()}")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    rows = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
            if lse else None)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if rows is None else rows.data_ptr(),
        _DTYPES[q.dtype], B, Hq, Hkv, S, T, hd, kv_len, int(q_offset),
        int(bool(causal)), int(window), 1.0 / math.sqrt(hd), *strides,
        stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    COUNTER.launches += 1
    return out if rows is None else (out, rows)


def dkdv_split(B: int, Hkv: int, T: int, hd: int, G: int, sms: int) -> int:
    """How many parts the bfloat16 dK/dV kernel cuts each KV head's G query
    heads into. At hd 256 (64-key blocks, each walking every query head of
    its group) where the blocks do not fill the card's ``sms``
    multiprocessors: doubled (as G allows) until they fill it twice over
    (at recurrentgemma's shape, on an H100, a whole call by
    ``tools/kernel_ab.py``: 1.58 ms unsplit, 0.99 at 2 parts, 0.96 at 4,
    0.86 at 8, 0.92 at 16); else 1. The parts' float32 sums are added in
    order by a fourth kernel, so two calls stay bit-equal."""
    blocks = -(-T // 64) * Hkv * B
    split = 1
    if hd == 256 and blocks < sms:
        while blocks * split < 2 * sms and G % (2 * split) == 0:
            split *= 2
    return split


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        kv_len: int = 0, window: int = 0):
    """dq, dk, dv of ``flash_attention`` for the upstream gradient ``do``:
    the same function as ``ref.attention_bwd_ref``, ``window`` as the
    forward's. q, k, v, o, do are CUDA
    tensors in the forward's layouts (strided views with a contiguous last
    dimension, one dtype); ``o`` and ``lse`` are what the forward returned
    with ``lse=True``. Needs ``q_offset >= 0`` when causal, so that every
    query row sees a key. dq is a (B, Hq, S, hd) view of a (B, S, Hq, hd)
    buffer and dk/dv (B, Hkv, T, hd) views of (B, T, Hkv, hd) buffers, so
    moving them back to the model layout is free."""
    kv_len = _check_qkv(q, k, v, kv_len)
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernel takes head dims "
                         f"{BWD_HEAD_DIMS}, got {hd}")
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype or \
                tuple(t.shape) != (B, Hq, S, hd) or t.stride(-1) != 1:
            raise ValueError(f"{name} must match q's device, dtype and shape "
                             f"with a contiguous last dimension; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.device != q.device or lse.dtype != torch.float32 or \
            tuple(lse.shape) != (B, Hq, S) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(B, Hq, S)} on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset}: the backward needs every "
                         f"query row to see a key (q_offset >= 0)")
    if window < 0 or (window and not causal):
        raise ValueError(f"window={window}: a sliding window is >= 0 and "
                         f"needs causal=True")
    if q.dtype == torch.bfloat16:      # TMA reads 16-byte aligned rows
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if not aligned16(t):
                raise ValueError(
                    f"{name}: the bfloat16 backward loads with TMA, which "
                    f"needs a 16-byte aligned base and (batch, head, row) "
                    f"strides that are multiples of 8 elements; got strides "
                    f"{t.stride()}")
    dq = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk, dv = (torch.empty((B, T, Hkv, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2) for _ in range(2))
    scratch = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    split, part = 1, None
    if q.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        split = dkdv_split(B, Hkv, T, hd, Hq // Hkv, sms)
    if split > 1:
        part = torch.empty((2, split, B, Hkv, T, hd), dtype=torch.float32,
                           device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *[s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]])
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, Hq, Hkv, S, T,
        hd, kv_len, int(q_offset), int(bool(causal)), int(window),
        1.0 / math.sqrt(hd), split, None if part is None else part.data_ptr(),
        strides, stream)
    if err:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: "
            f"{lib.flash_attention_bwd_error_string(err).decode()}")
    BWD_COUNTER.launches += 1
    return dq, dk, dv


def attention_flops(B: int, Hq: int, S: int, T: int, hd: int, *,
                    causal: bool, q_offset: int = 0, window: int = 0
                    ) -> float:
    """Multiply-adds x 2 of QK^T and PV over the (query, key) pairs the
    mask leaves live: the work these inputs need."""
    if causal:
        pos = q_offset + np.arange(S, dtype=np.int64)
        lo = np.maximum(0, pos - window + 1) if window else 0
        live = int(np.maximum(0, np.minimum(T, pos + 1) - lo).sum())
    else:
        live = S * T
    return 4.0 * B * Hq * hd * live


def attention_bwd_flops(B: int, Hq: int, S: int, T: int, hd: int, *,
                        causal: bool, q_offset: int = 0, window: int = 0
                        ) -> float:
    """The backward's five products (S, dP, dV, dK, dQ) over the live
    pairs: 2.5 times the forward's two."""
    return 2.5 * attention_flops(B, Hq, S, T, hd, causal=causal,
                                 q_offset=q_offset, window=window)


def attention_bytes(B: int, Hq: int, Hkv: int, S: int, T: int, hd: int,
                    itemsize: int, *, lse: bool = False) -> int:
    """Bytes a forward call must move: q, k, v read and o written in their
    dtype, and with ``lse`` the rows' float32 log-sum-exp written."""
    return (2 * B * Hq * S + 2 * B * Hkv * T) * hd * itemsize + \
        (4 * B * Hq * S if lse else 0)


def attention_bwd_bytes(B: int, Hq: int, Hkv: int, S: int, T: int, hd: int,
                        itemsize: int) -> int:
    """Bytes a backward call must move: q, k, v, o, dO read and dQ, dK, dV
    written in their dtype, the forward's float32 log-sum-exp read."""
    return (4 * B * Hq * S + 4 * B * Hkv * T) * hd * itemsize + 4 * B * Hq * S


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_len: int = 0, window: int = 0, lse: bool = False):
    """``flash_attention``'s stand-in on meta tensors (``kernels.meta``):
    its outputs' shapes, dtypes and strides, nothing computed; reports the
    call's operations and bytes."""
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    rows = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
            if lse else None)
    meta.report("flash_attention",
                attention_flops(B, Hq, S, kv_len or T, hd, causal=causal,
                                q_offset=q_offset, window=window),
                attention_bytes(B, Hq, Hkv, S, T, hd, q.element_size(),
                                lse=lse))
    return out if rows is None else (out, rows)


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             q_offset: int = 0, kv_len: int = 0,
                             window: int = 0):
    """``flash_attention_bwd``'s stand-in on meta tensors: dq, dk, dv in
    the backward kernel's layouts; reports the call's operations and
    bytes."""
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    dq = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk, dv = (torch.empty((B, T, Hkv, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2) for _ in range(2))
    meta.report("flash_attention_bwd",
                attention_bwd_flops(B, Hq, S, kv_len or T, hd, causal=causal,
                                    q_offset=q_offset, window=window),
                attention_bwd_bytes(B, Hq, Hkv, S, T, hd, q.element_size()))
    return dq, dk, dv


__all__ = ["BWD_COUNTER", "BWD_HEAD_DIMS", "COUNTER", "HEAD_DIMS",
           "aligned16", "attention_bwd_bytes", "attention_bwd_flops",
           "attention_bytes", "attention_flops", "dkdv_split",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_meta", "flash_attention_meta"]
