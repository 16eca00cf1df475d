"""Plain PyTorch versions of the WKV6 kernel, in the kernel's (B, H, S, hd)
layout: ``wkv6_ref``, the chunked recurrence the kernel computes (the JAX
package's ``models/rwkv6.py::wkv_chunked`` with the chunk as an argument),
and ``wkv6_naive``, the token-by-token definition both are held against."""
from __future__ import annotations

from typing import Tuple

import torch

CLAMP = 25.0       # exponent clamp of the intra-chunk relative decays


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.clamp(-CLAMP, CLAMP))


def chunk_of(S: int, chunk: int) -> int:
    """The chunk length a call uses: ``chunk``, or S when shorter; it must
    divide S."""
    C = min(chunk, S)
    if C <= 0 or S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {C}")
    return C


def wkv6_ref(r, k, v, logw, u, s0, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v (B, H, S, hd) any float dtype; logw (B, H, S, hd) float32;
    u (H, hd); s0 (B, H, hd, hd) -> (y (B, H, S, hd) float32, state
    (B, H, hd, hd) float32). Exponents are clamped to +-25 inside each
    chunk, so the result depends (slightly) on the chunk."""
    B, H, S, hd = r.shape
    C = chunk_of(S, chunk)
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None, :, None, :]
    state = s0.float()
    lower = torch.tril(torch.ones(C, C, dtype=torch.bool, device=r.device),
                       -1)
    ys = []
    for c0 in range(0, S, C):
        rr, kk, vv, w = (t[:, :, c0:c0 + C] for t in (rf, kf, vf, lw))
        clw = torch.cumsum(w, dim=2)                   # inclusive
        ecl = clw - w                                  # exclusive
        q_ = rr * _clip_exp(ecl)
        k_ = kk * _clip_exp(-clw)
        A = (q_ @ k_.transpose(-1, -2)).masked_fill(~lower, 0.0)
        diag = (rr * (uf * kk)).sum(-1, keepdim=True)  # (B, H, C, 1)
        y = A @ vv
        y = y + diag * vv
        y = y + q_ @ state
        total = clw[:, :, -1]                          # (B, H, hd)
        kdecay = kk * _clip_exp(total[:, :, None] - clw)
        state = (_clip_exp(total)[..., None] * state
                 + kdecay.transpose(-1, -2) @ vv)
        ys.append(y)
    return torch.cat(ys, dim=2), state


def wkv6_naive(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence (the mathematical definition)."""
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None, :, :, None]
    state = s0.float()
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = (x[:, :, t] for x in (rf, kf, vf, lw))
        kv = kt[..., None] * vt[..., None, :]          # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, state + uf * kv))
        state = torch.exp(wt)[..., None] * state + kv
    return torch.stack(ys, dim=2), state


__all__ = ["CLAMP", "chunk_of", "wkv6_naive", "wkv6_ref"]
