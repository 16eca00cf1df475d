"""Public RG-LRU scan entry point.

``rglru`` dispatches on where its input lies: a CPU tensor goes to the
plain PyTorch version (``ref.py``), a CUDA tensor to the hand-written
kernel (``rglru.py``), which either launches or raises. There is no fall
back from the kernel to the plain version. The kernel has no backward
yet: a call on the card that wants a gradient raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.kernels.rglru.rglru import rglru_scan


def rglru(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
          lam: torch.Tensor, h0: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb (B, S, W), wa/wi/lam (W,), h0 (B, W) float32 -> (H (B, S, W) in
    xb's dtype, h_last (B, W) float32)."""
    if xb.device.type == "cpu":
        return rglru_ref(xb, wa, wi, lam, h0)
    if xb.device.type != "cuda":
        raise ValueError(f"rglru: unsupported device {xb.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xb, wa, wi, lam, h0)):
        raise NotImplementedError(
            "the RG-LRU scan kernel has no backward yet (it comes with the "
            "hybrid family's training slice)")
    return rglru_scan(xb.contiguous(), wa, wi, lam, h0)


__all__ = ["rglru"]
