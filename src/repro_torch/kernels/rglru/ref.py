"""Plain PyTorch version of the RG-LRU scan kernel: the JAX package's
``rg_lru`` (``repro.models.rglru``), gates included, as a sequential loop
over the sequence in float32. It is the CPU path and the yardstick the
kernel is held to on the card; the loop is slow on the card (one step of
small kernels per token) and is not a model path there."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

DECAY_SCALE = 8.0   # Griffin's fixed c inside the decay exponent


def gates(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
          lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb (..., W) -> (log-decay, input gate), both float32: the JAX
    package's ``_gates``, log_a = -c softplus(lam) sigmoid(x wa) < 0 and
    sigmoid(x wi)."""
    xf = xb.float()
    ra = torch.sigmoid(xf * wa.float())
    log_a = -DECAY_SCALE * F.softplus(lam.float()) * ra
    return log_a, torch.sigmoid(xf * wi.float())


def decay_and_input(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
                    lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h = a h + b, float32: a = exp(log_a),
    b = sqrt(max(1 - exp(2 log_a), 1e-12)) sigmoid(x wi) x."""
    log_a, gate_i = gates(xb, wa, wi, lam)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return torch.exp(log_a), beta * gate_i * xb.float()


def rglru_ref(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
              lam: torch.Tensor, h0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb (B, S, W), wa/wi/lam (W,), h0 (B, W) -> (H (B, S, W) in xb's
    dtype, h_last (B, W) float32, the last step's state before the
    cast)."""
    a, bx = decay_and_input(xb, wa, wi, lam)
    h = h0.float()
    out = torch.empty_like(a)
    for t in range(xb.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out[:, t] = h
    return out.to(xb.dtype), h


def rglru_flops(B: int, S: int, W: int) -> float:
    """Float32 operations of a call, ~20 an element: two sigmoids (a
    product, an exponential, a sum and a division each), the decay's
    product and exponential, beta's doubled exponential, difference,
    maximum and square root, two products for b, and the recurrence's
    product and sum. (The softplus is per channel.)"""
    return 20.0 * B * S * W


def rglru_sfu_ops(B: int, S: int, W: int) -> float:
    """Special-function operations of a call, 7 an element: the four
    exponentials (two inside the sigmoids), the sigmoids' two divisions (a
    reciprocal each) and beta's square root. Not a bound by the port's
    rule (bytes or CUDA-core operations), but what paces the kernel: the
    units retire 16 a clock an SM."""
    return 7.0 * B * S * W


def rglru_bytes(B: int, S: int, W: int, itemsize: int) -> int:
    """Bytes a call must move: xb read and H written once, the float32
    gates (W,) x 3, h0 read and h_last written."""
    return 2 * B * S * W * itemsize + 3 * W * 4 + 2 * B * W * 4


__all__ = ["DECAY_SCALE", "decay_and_input", "gates", "rglru_bytes",
           "rglru_flops", "rglru_ref", "rglru_sfu_ops"]
