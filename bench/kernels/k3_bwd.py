"""K3', the causal flash-attention backward (``fa_bwd_dot``, then
``fa_bwd_dkdv_wgmma`` and ``fa_bwd_dq_wgmma`` in bfloat16), at the
training step's call. Frozen from the program's ``attention_bwd_flops`` /
``attention_bwd_bytes``: five products over the live pairs (2.5 times
the forward's two); q, k, v, o, dO read and dQ, dK, dV written once, the
forward's float32 log-sum-exp read."""
from __future__ import annotations

from bench.kernels import k3

COUNT = "fa_bwd_dot"
PREFIX = "fa_bwd"


def flops(c: dict, traffic: dict) -> float:
    return 2.5 * k3.flops(c, traffic)


def nbytes(c: dict, traffic: dict, itemsize: int = 2) -> float:
    B, Hq, Hkv, S, hd = k3.shape(c, traffic)
    return (4 * B * Hq * S + 4 * B * Hkv * S) * hd * itemsize + 4 * B * Hq * S


def bound_s(c: dict, traffic: dict, peaks: dict) -> float:
    return max(flops(c, traffic) / peaks["bf16_tensor_flops"],
               nbytes(c, traffic) / peaks["hbm_bytes_per_s"])
