"""Plain PyTorch versions of the RG-LRU scan kernel and of its backward:
the JAX package's ``rg_lru`` (``repro.models.rglru``), gates included, as
a sequential loop over the sequence in float32, and its ``jax.vjp`` as a
reverse loop. They are the CPU path and the yardsticks the kernels are
held to on the card; the loops are slow on the card (one step of small
kernels per token) and are not a model path there."""
from __future__ import annotations

from typing import Optional, Tuple

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


def rglru_states_ref(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
                     lam: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The states before the cast: (H (B, S, W) float32, h_last (B, W)
    float32). Builds H in place, so it is not for autograd: the backward
    is ``rglru_bwd_ref``."""
    a, bx = decay_and_input(xb, wa, wi, lam)
    h = h0.float()
    out = torch.empty_like(a)
    for t in range(xb.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out[:, t] = h
    return out, h


def rglru_ref(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
              lam: torch.Tensor, h0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb (B, S, W), wa/wi/lam (W,), h0 (B, W) -> (H (B, S, W) in xb's
    dtype, h_last (B, W) float32, the last step's state before the
    cast)."""
    out, h = rglru_states_ref(xb, wa, wi, lam, h0)
    return out.to(xb.dtype), h


def rglru_bwd_ref(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
                  lam: torch.Tensor, h0: torch.Tensor, H: torch.Tensor,
                  dH: torch.Tensor, dh_last: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The backward of ``rglru_ref`` (the JAX package's ``jax.vjp`` of
    ``rg_lru``) as an explicit reverse loop in float32. ``H`` is the
    forward's float32 states (``rglru_states_ref``), ``dH`` the gradient
    of H (B, S, W), ``dh_last`` that of h_last (None: zero). Returns
    (dxb in xb's dtype, dwa, dwi, dlam (W,) and dh0 (B, W), float32).

    dh_t = dH_t + a_{t+1} dh_{t+1} (dh_last joins at t = S-1); the state
    before step 0 is h0, which the reference folds into the first step's
    input (``bx.at[:, 0].add(a[:, 0] * h0)``), so da_t = dh_t h_{t-1}
    with h_{-1} = h0 and dh0 = a_0 dh_0. Then through the gates: beta =
    sqrt(max(1 - exp(2 log_a), 1e-12)) passes no gradient where the 1e-12
    holds; log_a = -c softplus(lam) sigmoid(x wa), so dlam is a sum of
    -c sigmoid(lam) sigmoid(x wa) dlog_a. The parameters' gradients are
    sums over B and S."""
    xf = xb.float()
    wa, wi, lam = wa.float(), wi.float(), lam.float()
    ra = torch.sigmoid(xf * wa)
    c = -DECAY_SCALE * F.softplus(lam)
    log_a = c * ra
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    u = 1.0 - e2
    beta = torch.sqrt(torch.clamp_min(u, 1e-12))
    gi = torch.sigmoid(xf * wi)
    dHf = dH.float()
    dh = torch.empty_like(dHf)
    carry = (torch.zeros_like(dHf[:, 0]) if dh_last is None
             else dh_last.float())
    for t in range(xb.shape[1] - 1, -1, -1):
        g = dHf[:, t] + carry
        dh[:, t] = g
        carry = a[:, t] * g
    dh0 = carry                                 # a_0 dh_0
    hprev = torch.cat([h0.float()[:, None], H.float()[:, :-1]], dim=1)
    dbeta = dh * gi * xf
    dgi = dh * beta * xf
    du = torch.where(u > 1e-12, dbeta * 0.5 / beta, torch.zeros_like(u))
    dlog_a = dh * hprev * a - 2.0 * e2 * du
    dza = dlog_a * c * ra * (1.0 - ra)
    dzi = dgi * gi * (1.0 - gi)
    dx = dh * beta * gi + dza * wa + dzi * wi
    dwa = (dza * xf).sum(dim=(0, 1))
    dwi = (dzi * xf).sum(dim=(0, 1))
    dlam = -DECAY_SCALE * torch.sigmoid(lam) * (dlog_a * ra).sum(dim=(0, 1))
    return dx.to(xb.dtype), dwa, dwi, dlam, dh0


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


def rglru_bwd_flops(B: int, S: int, W: int) -> float:
    """Float32 operations of a backward call, ~50 an element: the gates
    (~20, the forward's), the four coefficients the element's dh_t
    multiplies (the derivatives of beta, the input gate and the decay,
    ~20), the reverse chain's multiply-add, and dxb's product with the
    parameters' three sums (~8)."""
    return 50.0 * B * S * W


def rglru_bwd_sfu_ops(B: int, S: int, W: int) -> float:
    """Special-function operations of a backward call, 8 an element: four
    exponentials (two inside the sigmoids), three divisions (the sigmoids'
    and 1 / beta: a reciprocal each) and beta's square root. Not a bound
    by the port's rule, but what paces the kernel, as in the forward."""
    return 8.0 * B * S * W


def rglru_bwd_bytes(B: int, S: int, W: int, itemsize: int) -> int:
    """Bytes the backward must move: xb, dH and the float32 states H read
    once, dxb written once; the gates' parameters read and their
    gradients written, h0 read, dh0 written."""
    return (3 * itemsize + 4) * B * S * W + 6 * W * 4 + 2 * B * W * 4


__all__ = ["DECAY_SCALE", "decay_and_input", "gates", "rglru_bwd_bytes",
           "rglru_bwd_flops", "rglru_bwd_ref", "rglru_bwd_sfu_ops",
           "rglru_bytes", "rglru_flops", "rglru_ref", "rglru_sfu_ops",
           "rglru_states_ref"]
