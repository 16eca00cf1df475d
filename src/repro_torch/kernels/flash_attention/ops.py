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
kernels with that window.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    aligned16, flash_attention, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    """Kernel layout q (B, Hq, S, hd), k/v (B, Hkv, T, hd) on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len, window):
        ctx.kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                      window=window)
        o, lse = flash_attention(q, k, v, lse=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                                  and not aligned16(do)):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


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
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _FlashAttention.apply(qt, kt, vt, causal, q_offset,
                                         kv_len, window).transpose(1, 2)
        return flash_attention(qt, kt, vt, window=window,
                               **kw).transpose(1, 2)
    raise ValueError(f"attention: unsupported device {q.device}")


__all__ = ["attention"]
