"""Public WKV6 entry point in the model's layout.

``wkv6`` dispatches on where its inputs lie: CPU tensors go to the plain
PyTorch version (``ref.wkv6_ref``), CUDA tensors to the hand-written
kernel (``wkv6.py``), which either launches or raises. There is no fall
back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.kernels.wkv6.wkv6 import wkv6_chunked


def wkv6(r, k, v, logw, u, s0, *, chunk: int = 64
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout r/k/v/logw (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd)
    -> (y (B, S, H, hd) float32, state (B, H, hd, hd) float32)."""
    args = [t.transpose(1, 2) for t in (r, k, v, logw.float())]
    if r.device.type == "cpu":
        y, s = wkv6_ref(*args, u, s0, chunk=chunk)
    elif r.device.type == "cuda":
        y, s = wkv6_chunked(*args, u, s0, chunk=chunk)
    else:
        raise ValueError(f"wkv6: unsupported device {r.device}")
    return y.transpose(1, 2), s


__all__ = ["wkv6"]
