"""Plain PyTorch version of the burn kernel: the same chained, rescaled
matrix product, through ``torch.matmul`` in full float32."""
from __future__ import annotations

import torch


def burn_ref(a: torch.Tensor, b: torch.Tensor, *, iters: int = 64
             ) -> torch.Tensor:
    """``iters`` times: ``y = x @ b``, then ``x = y * rsqrt(mean(y^2) +
    1e-12)``, starting from ``x = a``. TF32 is switched off explicitly:
    the kernel it stands beside computes in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = a.to(torch.float32)
    b = b.to(torch.float32)
    for _ in range(iters):
        y = x @ b
        x = y * torch.rsqrt(torch.mean(torch.square(y)) + 1e-12)
    return x


__all__ = ["burn_ref"]
