"""Wrapper of the hand-written CUDA WKV6 kernels (``csrc/wkv6.cu``). A call
runs two device kernels: ``wkv6_state`` walks the chunks in order, one
block per (16 x 32 tile of the (hd, hd) float32 state, head, batch), and
writes every chunk-start state to a float32 scratch of (B, H, S / C, hd,
hd); ``wkv6_out`` then forms y with one independent block per (32-token
query tile of a chunk, 64 value columns, head, batch). Any chunk length
that divides S works, up to one chunk of the whole sequence.

The library is built with ``nvcc`` at the first launch (see
``repro_torch.kernels._build``). The wrapper checks its inputs, allocates
the outputs and the scratch with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch reports an error.
``COUNTER.launches`` counts calls (each runs both kernels).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import chunk_of

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

COUNTER = _build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 9 + [i] * 6 + [ll] * 15 + [p]
        fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


def supports(S: int, hd: int, C: int) -> bool:
    """The shapes the kernels take: a head dim in ``HEAD_DIMS`` and any
    chunk C >= 1 that divides the sequence length S."""
    return hd in HEAD_DIMS and S >= 1 and C >= 1 and S % C == 0


def scratch_bytes(B: int, H: int, S: int, hd: int, C: int) -> int:
    """Bytes of the float32 chunk-start states a call allocates."""
    return B * H * (S // C) * hd * hd * 4


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned base and (batch, head, row) strides."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in t.stride()[:3])


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                 chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v (B, H, S, hd) float32 or bfloat16 CUDA tensors, logw
    (B, H, S, hd) float32, u (H, hd), s0 (B, H, hd, hd) -> (y (B, H, S, hd)
    float32, state (B, H, hd, hd) float32): ``ref.wkv6_ref`` on the card.

    r/k/v/logw may be strided views with a contiguous last dimension (a
    transposed (B, S, H, hd) tensor needs no copy); they need 16-byte
    aligned bases and strides (both kernels read them in 16-byte pieces).
    y is a (B, H, S, hd) view of a (B, S, H, hd) buffer. The chunk is
    ``ref.chunk_of(S, chunk)``: ``chunk``, or S when shorter."""
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw),
                    ("u", u), ("s0", s0)):
        if t.device.type != "cuda":
            raise ValueError(f"wkv6 kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if r.dim() != 4 or r.dtype not in _DTYPES:
        raise ValueError(f"r must be 4-D float32 or bfloat16, got "
                         f"{tuple(r.shape)} {r.dtype}")
    B, H, S, hd = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if tuple(t.shape) != (B, H, S, hd):
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("r, k, v must share one dtype")
    if logw.dtype != torch.float32:
        raise ValueError(f"logw must be float32, got {logw.dtype}")
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)} / s0 {tuple(s0.shape)} do not "
                         f"match (B, H, hd) = {(B, H, hd)}")
    C = chunk_of(S, chunk)
    if not supports(S, hd, C):
        raise ValueError(f"unsupported shape: head dim {hd} (kernel takes "
                         f"{HEAD_DIMS}), chunk {C} of {S} tokens")
    u = u.float().contiguous()
    s0 = s0.float().contiguous()
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw),
                    ("s0", s0)):
        if not _aligned(t):
            raise ValueError(f"{name} needs a 16-byte aligned base and "
                             f"strides")
    y = torch.empty((B, S, H, hd), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    state = torch.empty_like(s0)
    scratch = torch.empty((B, H, S // C, hd, hd), dtype=torch.float32,
                          device=r.device)
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    strides = [s for t in (r, k, v, logw, y) for s in t.stride()[:3]]
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), y.data_ptr(), state.data_ptr(),
        scratch.data_ptr(), _DTYPES[r.dtype], B, H, S, hd, C, *strides,
        stream)
    if err:
        raise RuntimeError(f"wkv6 launch failed: "
                           f"{lib.wkv6_error_string(err).decode()}")
    COUNTER.launches += 1
    return y, state


def wkv6_flops(B: int, H: int, S: int, hd: int, chunk: int) -> float:
    """Float32 operations the chunked recurrence needs: per chunk of C
    tokens and head, 2 C hd^2 each for q_ S and the state update, C (C - 1)
    hd each for the strictly lower A and A v, and ~10 C hd for the cumsum,
    decays, the u diagonal and the sums (exponentials not counted)."""
    C = min(chunk, S)
    per_chunk = 4 * C * hd * hd + 2 * C * (C - 1) * hd + 10 * C * hd
    return float(B * H * (S // C) * per_chunk)


def wkv6_bytes(B: int, H: int, S: int, hd: int, itemsize: int) -> int:
    """Bytes the call must move: r, k, v read in their dtype, logw read and
    y written in float32, u read, the state read and written."""
    n = B * H * S * hd
    return n * (3 * itemsize + 4 + 4) + H * hd * 4 + 2 * B * H * hd * hd * 4


__all__ = ["COUNTER", "HEAD_DIMS", "scratch_bytes", "supports", "wkv6_bytes",
           "wkv6_chunked", "wkv6_flops"]
