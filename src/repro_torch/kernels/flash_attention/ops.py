"""Public flash-attention entry point in the model's layout.

``attention`` dispatches on where its inputs lie: CPU tensors go to the
plain PyTorch version (``ref.py``), CUDA tensors to the hand-written
kernel (``flash_attention.py``), which either launches or raises. There is
no fall back from the kernel to the plain version. Forward only: the
training slice adds the backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              kv_len: int = 0) -> torch.Tensor:
    """Model layout q (B, S, Hq, hd), k/v (B, T, Hkv, hd) -> (B, S, Hq, hd).

    The kernel masks ragged edges itself, so nothing is padded, and it
    reads the model layout through strides, so nothing is transposed."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_ref(qt, kt, vt, **kw).transpose(1, 2)
    if q.device.type == "cuda":
        return flash_attention(qt, kt, vt, **kw).transpose(1, 2)
    raise ValueError(f"attention: unsupported device {q.device}")


__all__ = ["attention"]
