"""Public flash-attention entry point in the model's layout.

``attention`` dispatches on where its inputs lie: CPU tensors go to the
plain PyTorch version (``ref.py``), differentiated by ordinary autograd;
CUDA tensors to the hand-written kernels (``flash_attention.py``), which
either launch or raise. There is no fall back from a kernel to the plain
version. On the card, when a gradient is wanted, the call is a
``torch.autograd.Function`` whose forward is the forward kernel (which
then also writes the rows' log-sum-exp) and whose backward is the
backward kernel; without a gradient (prefill, decode) it is the forward
kernel alone, with no log-sum-exp. A sliding ``window`` runs both
kernels with that window. Meta tensors (the dry run) go to the kernels'
stand-ins (``flash_attention_meta``, ``flash_attention_bwd_meta``; see
``repro_torch.kernels.meta``) through the same two paths.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    aligned16, flash_attention, flash_attention_bwd,
    flash_attention_bwd_meta, flash_attention_meta)
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    """Kernel layout q (B, Hq, S, hd), k/v (B, Hkv, T, hd) on the card, or
    on the meta device (``is_meta``: the kernels' stand-ins)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len, window, is_meta):
        ctx.kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                      window=window)
        ctx.is_meta = is_meta
        fwd = flash_attention_meta if is_meta else flash_attention
        o, lse = fwd(q, k, v, lse=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.is_meta:
            dq, dk, dv = flash_attention_bwd_meta(q, k, v, **ctx.kw)
            return dq, dk, dv, None, None, None, None, None
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                                  and not aligned16(do)):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              kv_len: int = 0, window: int = 0) -> torch.Tensor:
    """Model layout q (B, S, Hq, hd), k/v (B, T, Hkv, hd) -> (B, S, Hq, hd).

    The kernels mask ragged edges themselves, so nothing is padded, and
    they read the model layout through strides, so nothing is
    transposed."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_ref(qt, kt, vt, window=window,
                             **kw).transpose(1, 2)
    if q.device.type in ("cuda", "meta"):
        is_meta = q.device.type == "meta"
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _FlashAttention.apply(qt, kt, vt, causal, q_offset,
                                         kv_len, window,
                                         is_meta).transpose(1, 2)
        fwd = flash_attention_meta if is_meta else flash_attention
        return fwd(qt, kt, vt, window=window, **kw).transpose(1, 2)
    raise ValueError(f"attention: unsupported device {q.device}")


__all__ = ["attention"]
