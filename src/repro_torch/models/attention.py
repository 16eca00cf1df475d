"""Attention: GQA projections, prefill attention through the flash-attention
kernel (causal, or in a sliding window for the hybrid family's
``local_attention``, or full for the audio family's encoder and
``cross_attention``), and decode-step attention over a KV cache.

Local (single-device) paths only: the sequence-sharded flash-decoding
branch comes with tensor parallelism.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import attention as flash
from repro_torch.models.common import Init
from repro_torch.models.layers import apply_rope, rms_norm

_NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` (D, Hq hd), ``wk``/``wv`` (D, Hkv hd), ``wo`` (Hq hd, D);
    optional q/k/v biases and per-head q/k RMS norms."""

    AXES = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
            "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp"),
            "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",),
            "q_norm": (None,), "k_norm": (None,)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        self.wq = init.dense(d, nq * hd)
        self.wk = init.dense(d, nkv * hd)
        self.wv = init.dense(d, nkv * hd)
        self.wo = init.dense(nq * hd, d)
        if cfg.qkv_bias:
            self.bq = init.zeros((nq * hd,))
            self.bk = init.zeros((nkv * hd,))
            self.bv = init.zeros((nkv * hd,))
        if cfg.qk_norm:
            self.q_norm = init.zeros((hd,))
            self.k_norm = init.zeros((hd,))


def project_qkv(p: Attention, cfg, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, Hq, hd), k/v (B, S, Hkv, hd), RoPE
    (``layers.rope_tables`` of the positions, or the vlm family's
    ``layers.mrope_tables``: whichever the caller built) applied after
    the q/k norms; ``rope`` None applies none (the audio family's learned
    position embeddings, the reference's ``rope=False``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if rope is None:
        return q, k, v
    return apply_rope(q, rope), apply_rope(k, rope), v


def out_projection(p: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out (B, S, Hq, hd) -> (B, S, D)."""
    B, S, H, hd = attn_out.shape
    return attn_out.reshape(B, S, H * hd) @ p.wo


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, T, Hkv, hd) -> (B, S, Hq, hd).

    On the card this is the flash-attention kernel; on the CPU its plain
    version. In bfloat16 the kernel rounds the probabilities to bfloat16
    before the value product, as the JAX package's XLA path does; the
    plain version keeps them in float32."""
    return flash(q, k, v, causal=causal, q_offset=q_offset)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Sliding-window causal attention, O(S window): query position p sees
    the keys k with p - window < k <= p. q (B, S, Hq, hd), k/v (B, S, Hkv,
    hd) -> (B, S, Hq, hd).

    As in the JAX package, a sequence no longer than the window is plain
    causal attention, and a longer one must be a multiple of the window
    (the reference asserts it: its chunks are window-sized). On the card
    this is the flash-attention kernel with its window; on the CPU its
    plain version with the same mask."""
    S = q.shape[1]
    if S <= window:
        return flash(q, k, v, causal=True)
    if S % window:
        raise ValueError(f"local_attention: {S} tokens are more than the "
                         f"window {window} and not a multiple of it")
    return flash(q, k, v, causal=True, window=window)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Full (non-causal) attention of S decoder queries over T encoder
    keys, S != T allowed: q (B, S, Hq, hd), k/v (B, T, Hkv, hd) -> (B, S,
    Hq, hd). The flash-attention kernel on the card, its plain version on
    the CPU."""
    return flash(q, k, v, causal=False)


def decode_attention(q: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: int) -> torch.Tensor:
    """One decode step over a local cache (``_decode_inner`` with
    ``axis=None``). q (B, Hq, hd); caches (B, Hkv, Sl, hd); k_new/v_new
    (B, Hkv, hd); ``pos`` is the position written and the last one seen.

    The new row is written into the caches in place (the JAX package
    returns new caches). As there, a ``pos`` outside the cache writes
    nothing, and every cache row at or before ``pos`` is attended to,
    whoever wrote it. Returns out (B, Hq, hd)."""
    B, Hq, hd = q.shape
    Hkv, Sl = kcache.shape[1], kcache.shape[2]
    if 0 <= pos < Sl:
        kcache[:, :, pos] = k_new
        vcache[:, :, pos] = v_new
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                          kcache.float()) * (1.0 / math.sqrt(hd))
    visible = torch.arange(Sl, device=q.device) <= pos
    scores = scores.masked_fill(~visible, _NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", e.to(vcache.dtype), vcache)
    out = o / l.clamp_min(1e-30).to(o.dtype)[..., None]
    return out.reshape(B, Hq, hd).to(q.dtype)


__all__ = ["Attention", "cross_attention", "decode_attention",
           "full_attention", "local_attention", "out_projection",
           "project_qkv"]
