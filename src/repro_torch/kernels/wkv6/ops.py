"""Public WKV6 entry points in the model's layout.

``wkv6`` dispatches on where its inputs lie: CPU tensors go to the plain
PyTorch versions (``ref.py``), CUDA tensors to the hand-written kernels
(``wkv6.py``), which either launch or raise. There is no fall back from a
kernel to the plain version. When a gradient is wanted, the call is a
``torch.autograd.Function``: on the card its forward is K4, which then
keeps its chunk-start states, and its backward is K4' reading them; on the
CPU its forward is ``wkv6_ref`` and its backward ``wkv6_bwd_ref``.
Without a gradient (prefill) it is the forward alone. ``wkv6_plain`` is
the plain pair on any device. Meta tensors (the dry run) go to the
kernels' stand-ins (``wkv6_chunked_meta``, ``wkv6_chunked_bwd_meta``; see
``repro_torch.kernels.meta``) through the same two paths.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.kernels.wkv6.wkv6 import (aligned16, wkv6_chunked,
                                           wkv6_chunked_bwd,
                                           wkv6_chunked_bwd_meta,
                                           wkv6_chunked_meta)


def _as_inputs(u, s0, grads):
    """The backward's six gradients in the inputs' dtypes, and none for the
    chunk."""
    dr, dk, dv, dw, du, ds0 = grads
    return dr, dk, dv, dw, du.to(u.dtype), ds0.to(s0.dtype), None


class _Kernel(torch.autograd.Function):
    """Kernel layout r/k/v/logw (B, H, S, hd) on the card: K4, then K4'; on
    the meta device (``is_meta``) their stand-ins."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk, is_meta):
        fwd = wkv6_chunked_meta if is_meta else wkv6_chunked
        y, state, starts = fwd(r, k, v, logw, u, s0, chunk=chunk,
                               keep_states=True)
        ctx.save_for_backward(r, k, v, logw, u, s0, starts)
        ctx.chunk, ctx.is_meta = chunk, is_meta
        return y, state

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, logw, u, s0, starts = ctx.saved_tensors
        if ctx.is_meta:
            grads = wkv6_chunked_bwd_meta(r, k, v, logw, u, chunk=ctx.chunk)
            return _as_inputs(u, s0, grads) + (None,)
        if dy.stride(-1) != 1 or not aligned16(dy):
            dy = dy.contiguous()
        grads = wkv6_chunked_bwd(r, k, v, logw, u, starts, dy, ds,
                                 chunk=ctx.chunk)
        return _as_inputs(u, s0, grads) + (None,)


class _Plain(torch.autograd.Function):
    """Kernel layout, any device: ``wkv6_ref``, then ``wkv6_bwd_ref``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.chunk = chunk
        return wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        grads = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds, chunk=ctx.chunk)
        return _as_inputs(u, s0, grads)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def wkv6(r, k, v, logw, u, s0, *, chunk: int = 64
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout r/k/v/logw (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd)
    -> (y (B, S, H, hd) float32, state (B, H, hd, hd) float32)."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, s0, chunk=chunk)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6: unsupported device {r.device}")
    is_meta = r.device.type == "meta"
    args = [t.transpose(1, 2) for t in (r, k, v, logw.float())]
    if _wants_grad(r, k, v, logw, u, s0):
        y, s = _Kernel.apply(*args, u, s0, chunk, is_meta)
    else:
        fwd = wkv6_chunked_meta if is_meta else wkv6_chunked
        y, s = fwd(*args, u, s0, chunk=chunk)
    return y.transpose(1, 2), s


def wkv6_plain(r, k, v, logw, u, s0, *, chunk: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6`` through the plain versions on whatever device the inputs
    lie (the CPU path of ``wkv6``, and the comparison path on the card)."""
    args = [t.transpose(1, 2) for t in (r, k, v, logw.float())]
    if _wants_grad(r, k, v, logw, u, s0):
        y, s = _Plain.apply(*args, u, s0, chunk)
    else:
        y, s = wkv6_ref(*args, u, s0, chunk=chunk)
    return y.transpose(1, 2), s


__all__ = ["wkv6", "wkv6_plain"]
