"""Plain PyTorch version of the flash-attention kernel: the same math as
the JAX package's ``attention_ref`` (float32 scores, one softmax over the
whole key axis), plus the kernel's ``q_offset`` and ``kv_len``."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  kv_len: int = 0) -> torch.Tensor:
    """q (B, Hq, S, hd); k/v (B, Hkv, T, hd) -> (B, Hq, S, hd) in q's dtype.

    GQA: query head h reads kv head h // (Hq // Hkv). Keys at or past
    ``kv_len`` (0 -> T) are masked; with ``causal`` query i sees keys
    ``<= q_offset + i``."""
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, S, hd)
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, k.float()) / math.sqrt(hd)
    kpos = torch.arange(T, device=q.device)
    mask = (kpos < (kv_len or T))[None, :].expand(S, T)
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)
        mask = mask & (kpos[None, :] <= qpos[:, None])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return o.reshape(B, Hq, S, hd).to(q.dtype)


__all__ = ["attention_ref"]
