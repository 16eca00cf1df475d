"""Plain PyTorch versions of the flash-attention kernels: the same math as
the JAX package's ``attention_ref`` (float32 scores, one softmax over the
whole key axis), plus the kernel's ``q_offset``, ``kv_len`` and sliding
``window``, and the backward's recompute equations."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
            q_offset: int, kv_len: int, window: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 scaled scores (B, Hkv, G, S, T) and the live mask (S, T)."""
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    qf = q.float().reshape(B, Hkv, Hq // Hkv, S, hd)
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, k.float()) / math.sqrt(hd)
    kpos = torch.arange(T, device=q.device)
    mask = (kpos < (kv_len or T))[None, :].expand(S, T)
    if causal:
        qpos = q_offset + torch.arange(S, device=q.device)
        mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return s, mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0, kv_len: int = 0,
                  window: int = 0, return_lse: bool = False):
    """q (B, Hq, S, hd); k/v (B, Hkv, T, hd) -> (B, Hq, S, hd) in q's dtype.

    GQA: query head h reads kv head h // (Hq // Hkv). Keys at or past
    ``kv_len`` (0 -> T) are masked; with ``causal`` query i sees keys
    ``<= q_offset + i``, and with a ``window`` > 0 only those
    ``> q_offset + i - window`` (the JAX package's ``local_attention``
    mask). With ``return_lse`` also each row's float32
    log-sum-exp (B, Hq, S) of the scaled, masked scores, as the kernel
    writes it for the backward."""
    B, Hq, S, hd = q.shape
    if window and not causal:
        raise ValueError("a sliding window needs causal=True")
    s, mask = _scores(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len,
                      window=window)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / denom
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    o = o.reshape(B, Hq, S, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(denom)).reshape(B, Hq, S)
    return o, lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, q_offset: int = 0,
                      kv_len: int = 0, window: int = 0,
                      bf16_operands: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's equations in float32: with P = exp(s - lse)
    on the live pairs (exactly 0 elsewhere) and D = rowsum(dO o O),
    dV = P^T dO, dS = P o (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q
    (summed over the query heads of each kv head). Layouts and ``window``
    as ``attention_ref``; ``o`` and ``lse`` are the forward's. With
    ``bf16_operands`` P and dS are rounded to bfloat16 before their
    products, as the bfloat16 kernel feeds them to the tensor cores (each
    product still sums in float32). Returns dq, dk, dv in the inputs'
    dtype."""
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    G, scale = Hq // Hkv, 1.0 / math.sqrt(hd)
    s, mask = _scores(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len,
                      window=window)
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, S)[..., None])
    p = p.masked_fill(~mask, 0.0)
    dof = do.float().reshape(B, Hkv, G, S, hd)
    d = (dof * o.float().reshape(B, Hkv, G, S, hd)).sum(dim=-1)

    def operand(x):
        return x.bfloat16().float() if bf16_operands else x
    dv = torch.einsum("bhgst,bhgsd->bhtd", operand(p), dof)
    ds = operand(p * (torch.einsum("bhgsd,bhtd->bhgst", dof, v.float())
                      - d[..., None]))
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, k.float()) * scale
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds,
                      q.float().reshape(B, Hkv, G, S, hd)) * scale
    return (dq.reshape(B, Hq, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


__all__ = ["attention_bwd_ref", "attention_ref"]
