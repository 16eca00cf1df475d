"""Wrappers of the hand-written CUDA WKV6 kernels.

Forward (``csrc/wkv6.cu``, K4). A call runs two device kernels:
``wkv6_state`` walks the chunks in order, one block per (16 x 32 tile of
the (hd, hd) float32 state, head, batch), and writes every chunk-start
state to a float32 scratch of (B, H, S / C, hd, hd); ``wkv6_out`` then
forms y with one independent block per (32-token query tile of a chunk,
64 value columns, head, batch). Any chunk length that divides S works, up
to one chunk of the whole sequence. ``keep_states=True`` returns the
scratch too, for the backward.

Backward (``csrc/wkv6_bwd.cu``, K4'): dr, dk, dv, dlogw, du and ds0 from
dy, d(final state) and the forward's chunk-start states, at the same
chunk; three device kernels a call (four when C > 32): a reverse pass for
the state gradient of every chunk (a cp.async ring, as K4's state pass),
then one block per 32-token tile whose products run on the tensor cores
in TF32 with the 3xTF32 split (float32 accuracy), sums in a fixed order
with no atomics, so two calls are bit-equal. ``BWD_COUNTER`` counts its
calls.

The libraries are built with ``nvcc`` at the first launch (see
``repro_torch.kernels._build``). The wrappers check their inputs,
allocate the outputs and the scratch with ``torch.empty``, launch on
PyTorch's current stream and raise if the launch reports an error.
``COUNTER.launches`` counts forward calls (each runs both kernels).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, meta
from repro_torch.kernels.wkv6.ref import chunk_of

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

COUNTER = _build.LaunchCounter()
BWD_COUNTER = _build.LaunchCounter()


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


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("wkv6_bwd")
    fn = lib.wkv6_bwd_launch
    if fn.argtypes is None:            # first use: declare the C signature
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 18 + [i] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                            p]
        fn.restype = ctypes.c_int
        lib.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_bwd_error_string.restype = ctypes.c_char_p
    return lib


def supports(S: int, hd: int, C: int) -> bool:
    """The shapes the kernels take: a head dim in ``HEAD_DIMS`` and any
    chunk C >= 1 that divides the sequence length S."""
    return hd in HEAD_DIMS and S >= 1 and C >= 1 and S % C == 0


def scratch_bytes(B: int, H: int, S: int, hd: int, C: int) -> int:
    """Bytes of the float32 chunk-start states a call allocates."""
    return B * H * (S // C) * hd * hd * 4


def aligned16(t: torch.Tensor) -> bool:
    """16-byte aligned base and (batch, head, row) strides."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in t.stride()[:3])


def _check_sequences(fn: str, r: torch.Tensor, others) -> None:
    """The checks the forward and the backward share: r and every (name,
    tensor) of ``others`` CUDA tensors on one device, r 4-D float32 or
    bfloat16."""
    for name, t in (("r", r),) + tuple(others):
        if t.device.type != "cuda":
            raise ValueError(f"{fn} kernel needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if r.dim() != 4 or r.dtype not in _DTYPES:
        raise ValueError(f"r must be 4-D float32 or bfloat16, got "
                         f"{tuple(r.shape)} {r.dtype}")


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                 chunk: int = 64, keep_states: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """r/k/v (B, H, S, hd) float32 or bfloat16 CUDA tensors, logw
    (B, H, S, hd) float32, u (H, hd), s0 (B, H, hd, hd) -> (y (B, H, S, hd)
    float32, state (B, H, hd, hd) float32): ``ref.wkv6_ref`` on the card.
    With ``keep_states`` also the chunk-start states (B, H, S / C, hd, hd),
    float32, which ``wkv6_chunked_bwd`` reads.

    r/k/v/logw may be strided views with a contiguous last dimension (a
    transposed (B, S, H, hd) tensor needs no copy); they need 16-byte
    aligned bases and strides (both kernels read them in 16-byte pieces).
    y is a (B, H, S, hd) view of a (B, S, H, hd) buffer. The chunk is
    ``ref.chunk_of(S, chunk)``: ``chunk``, or S when shorter."""
    _check_sequences("wkv6", r, (("k", k), ("v", v), ("logw", logw),
                                 ("u", u), ("s0", s0)))
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
        if not aligned16(t):
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
    if keep_states:
        return y, state, scratch
    return y, state


def wkv6_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     starts: torch.Tensor, dy: torch.Tensor,
                     ds: Optional[torch.Tensor] = None, *, chunk: int = 64
                     ) -> Tuple[torch.Tensor, ...]:
    """The backward of ``wkv6_chunked`` at the same chunk, on the card:
    r/k/v/logw/u as the forward took them, ``starts`` the chunk-start states
    it kept (``keep_states=True``), dy (B, H, S, hd) float32 the gradient of
    y and ds (B, H, hd, hd) that of the final state (None: zero) -> (dr, dk,
    dv in r's dtype, dlogw (B, H, S, hd) float32, du (H, hd) float32, ds0
    (B, H, hd, hd) float32): ``ref.wkv6_bwd_ref`` on the card. The four
    sequence gradients are (B, H, S, hd) views of (B, S, H, hd) buffers,
    as y is; dy and the inputs need 16-byte aligned bases and strides, as
    the forward's inputs do (both passes read them in 16-byte pieces)."""
    _check_sequences("wkv6 backward", r, (("k", k), ("v", v),
                                          ("logw", logw), ("u", u),
                                          ("starts", starts), ("dy", dy)))
    B, H, S, hd = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw), ("dy", dy)):
        if tuple(t.shape) != (B, H, S, hd):
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("r, k, v must share one dtype")
    if logw.dtype != torch.float32 or dy.dtype != torch.float32:
        raise ValueError(f"logw and dy must be float32, got {logw.dtype} "
                         f"and {dy.dtype}")
    C = chunk_of(S, chunk)
    if not supports(S, hd, C):
        raise ValueError(f"unsupported shape: head dim {hd} (kernel takes "
                         f"{HEAD_DIMS}), chunk {C} of {S} tokens")
    NC, TPC = S // C, -(-C // 32)
    if tuple(u.shape) != (H, hd) or tuple(starts.shape) != (B, H, NC, hd,
                                                            hd):
        raise ValueError(f"u {tuple(u.shape)} / starts "
                         f"{tuple(starts.shape)} do not match (B, H, S / C, "
                         f"hd) = {(B, H, NC, hd)}")
    if starts.dtype != torch.float32 or not starts.is_contiguous():
        raise ValueError("starts must be the forward's contiguous float32 "
                         "chunk-start states")
    u = u.float().contiguous()
    if ds is not None:
        if tuple(ds.shape) != (B, H, hd, hd) or ds.device != r.device:
            raise ValueError(f"ds {tuple(ds.shape)} on {ds.device} does not "
                             f"match (B, H, hd, hd) on {r.device}")
        ds = ds.float().contiguous()
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw),
                    ("dy", dy)):
        if not aligned16(t):
            raise ValueError(f"{name} needs a 16-byte aligned base and "
                             f"strides")
    dev = r.device
    dr, dk, dv = (torch.empty((B, S, H, hd), dtype=r.dtype,
                              device=dev).transpose(1, 2) for _ in range(3))
    dw = torch.empty((B, S, H, hd), dtype=torch.float32,
                     device=dev).transpose(1, 2)
    du = torch.empty((H, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    gscratch = torch.empty((B, H, NC, hd, hd), **f32)
    dupart = torch.empty((B, H, NC * TPC, hd), **f32)
    tsum = torch.empty((B, H, NC * TPC, 2, hd), **f32) if TPC > 1 else None
    g4buf = torch.empty((B, H, NC, hd), **f32) if TPC > 1 else None
    strides = (ctypes.c_longlong * 27)(*(
        s for t in (r, k, v, logw, dy, dr, dk, dv, dw)
        for s in t.stride()[:3]))
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        dy.data_ptr(), u.data_ptr(), starts.data_ptr(),
        None if ds is None else ds.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
        gscratch.data_ptr(), dupart.data_ptr(),
        None if tsum is None else tsum.data_ptr(),
        None if g4buf is None else g4buf.data_ptr(), _DTYPES[r.dtype], B, H,
        S, hd, C, strides, stream)
    if err:
        raise RuntimeError(f"wkv6 backward launch failed: "
                           f"{lib.wkv6_bwd_error_string(err).decode()}")
    BWD_COUNTER.launches += 1
    return dr, dk, dv, dw, du, ds0


def wkv6_flops(B: int, H: int, S: int, hd: int, chunk: int) -> float:
    """Float32 operations the chunked recurrence needs: per chunk of C
    tokens and head, 2 C hd^2 each for q_ S and the state update, C (C - 1)
    hd each for the strictly lower A and A v, and ~10 C hd for the cumsum,
    decays, the u diagonal and the sums (exponentials not counted)."""
    C = min(chunk, S)
    per_chunk = 4 * C * hd * hd + 2 * C * (C - 1) * hd + 10 * C * hd
    return float(B * H * (S // C) * per_chunk)


def wkv6_bwd_flops(B: int, H: int, S: int, hd: int, chunk: int) -> float:
    """Float32 operations the backward needs: per chunk of C tokens and head,
    2 C hd^2 each for q_^T dy (the state gradient), dy S^T, v G^T and kd G;
    C (C - 1) hd each for the strictly lower dA and A and the three
    products with them (dA k_, dA^T q_, A^T dy); ~30 C hd for the cumsum,
    decays, diagonals and the dlogw sums, and 2 hd^2 for g4 (exponentials
    not counted)."""
    C = min(chunk, S)
    per_chunk = (8 * C * hd * hd + 5 * C * (C - 1) * hd + 30 * C * hd
                 + 2 * hd * hd)
    return float(B * H * (S // C) * per_chunk)


def wkv6_bwd_bytes(B: int, H: int, S: int, hd: int, itemsize: int) -> int:
    """Bytes the backward must move: r, k, v read and dr, dk, dv written in
    their dtype, logw and dy read and dlogw written in float32, u read and
    du written, d(state) read and ds0 written. The forward's chunk-start
    states that the kernel reads are a saved intermediate, not counted."""
    n = B * H * S * hd
    return (n * (6 * itemsize + 3 * 4) + 2 * H * hd * 4
            + 2 * B * H * hd * hd * 4)


def wkv6_bytes(B: int, H: int, S: int, hd: int, itemsize: int) -> int:
    """Bytes the call must move: r, k, v read in their dtype, logw read and
    y written in float32, u read, the state read and written."""
    n = B * H * S * hd
    return n * (3 * itemsize + 4 + 4) + H * hd * 4 + 2 * B * H * hd * hd * 4


def wkv6_chunked_meta(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      *, chunk: int = 64, keep_states: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """``wkv6_chunked``'s stand-in on meta tensors (``kernels.meta``): y,
    the state and, with ``keep_states``, the chunk-start states in the
    kernel's layouts, nothing computed; reports the call's operations
    (``wkv6_flops``) and bytes (``wkv6_bytes``)."""
    B, H, S, hd = r.shape
    C = chunk_of(S, chunk)
    y = torch.empty((B, S, H, hd), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    meta.report("wkv6", wkv6_flops(B, H, S, hd, C),
                wkv6_bytes(B, H, S, hd, r.element_size()))
    if keep_states:
        return y, state, torch.empty((B, H, S // C, hd, hd),
                                     dtype=torch.float32, device=r.device)
    return y, state


def wkv6_chunked_bwd_meta(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          logw: torch.Tensor, u: torch.Tensor, *,
                          chunk: int = 64) -> Tuple[torch.Tensor, ...]:
    """``wkv6_chunked_bwd``'s stand-in on meta tensors: dr, dk, dv, dlogw,
    du, ds0 in the backward kernel's layouts and dtypes; reports the call's
    operations and bytes."""
    B, H, S, hd = r.shape
    dev = r.device
    dr, dk, dv = (torch.empty((B, S, H, hd), dtype=r.dtype,
                              device=dev).transpose(1, 2) for _ in range(3))
    dw = torch.empty((B, S, H, hd), dtype=torch.float32,
                     device=dev).transpose(1, 2)
    du = torch.empty((H, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    meta.report("wkv6_bwd", wkv6_bwd_flops(B, H, S, hd, chunk_of(S, chunk)),
                wkv6_bwd_bytes(B, H, S, hd, r.element_size()))
    return dr, dk, dv, dw, du, ds0


__all__ = ["BWD_COUNTER", "COUNTER", "HEAD_DIMS", "aligned16", "scratch_bytes",
           "supports",
           "wkv6_bwd_bytes", "wkv6_bwd_flops", "wkv6_bytes", "wkv6_chunked",
           "wkv6_chunked_bwd", "wkv6_chunked_bwd_meta", "wkv6_chunked_meta",
           "wkv6_flops"]
