"""Attention: GQA projections, prefill attention through the flash-attention
kernel (causal, or in a sliding window for the hybrid family's
``local_attention``, or full for the audio family's encoder and cross
attention), and decode-step attention over a KV cache.

Under tensor parallelism (``Attention.tp``, set by the model, see
``repro_torch.dist.api``) each rank projects its own query heads (the
rank's slice of ``wq``, ``bq``, ``wo``) and runs the kernel on them; its
KV heads are its own slice where "model" divides them, else every rank
projects all of them (the whole ``wk``, ``wv``) and attends with those its
query heads use. Where the query heads do not divide "model" but the
reference's query chunk does (``min(2048, S)``, or the window in a
windowed attention over more than one window), the query rows split over
"model" instead (the reference's ``_seq_shard_fallback``): each rank
attends with its rows over the whole K/V and the rows are gathered;
where neither divides, every rank computes the whole attention, as the
reference replicates it. ``tp_attention`` takes these three cases for the
causal, the windowed and the non-causal (encoder, cross) attentions
alike. ``out_projection`` is row-parallel. Decode (``decode_attention``)
is the reference's flash-decode where the cache is sequence-sharded: each
rank's partial attention over its slice of the cache, combined by a max
and two sums.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.dist import api as dist
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
        # tensor parallelism (set by the model): the "model" group, and
        # whether this rank holds a slice of the query heads and of the
        # KV heads
        self.tp: Optional[dist.TPGroup] = None
        self.heads_local = self.kv_local = False


def project_qkv(p: Attention, cfg, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, Hq, hd), k/v (B, S, Hkv, hd), RoPE
    (``layers.rope_tables`` of the positions, or the vlm family's
    ``layers.mrope_tables``: whichever the caller built) applied after
    the q/k norms; ``rope`` None applies none (the audio family's learned
    position embeddings, the reference's ``rope=False``).

    With ``p.heads_local`` q holds the rank's query heads, and k/v its KV
    heads where ``p.kv_local``, else all of them; the replicated weights
    that each rank uses for part of the heads (the norms, and ``wk``,
    ``wv`` and their biases where the KV heads replicate) have their
    gradients summed over "model" (``dist.copy_in``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    wk, wv, bk, bv = p.wk, p.wv, getattr(p, "bk", None), getattr(p, "bv",
                                                                  None)
    q_norm, k_norm = getattr(p, "q_norm", None), getattr(p, "k_norm", None)
    if p.tp is not None and p.heads_local:
        tp = p.tp
        x = dist.copy_in(x, tp)
        if cfg.qk_norm:
            q_norm, k_norm = dist.copy_in(q_norm, tp), dist.copy_in(k_norm,
                                                                     tp)
        if not p.kv_local:
            wk, wv = dist.copy_in(wk, tp), dist.copy_in(wv, tp)
            if cfg.qkv_bias:
                bk, bv = dist.copy_in(bk, tp), dist.copy_in(bv, tp)
    q, k, v = x @ p.wq, x @ wk, x @ wv
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    if rope is None:
        return q, k, v
    return apply_rope(q, rope), apply_rope(k, rope), v


def out_projection(p: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out (B, S, Hq, hd) -> (B, S, D); with ``p.heads_local`` the
    rank's heads, the partial products summed over "model"."""
    B, S, H, hd = attn_out.shape
    out = attn_out.reshape(B, S, H * hd) @ p.wo
    if p.tp is not None and p.heads_local:
        return dist.reduce_out(out, p.tp)
    return out


def kv_of_heads(k: torch.Tensor, v: torch.Tensor, heads: int,
                 tp: dist.TPGroup, dim: int = 2
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Of k/v with every KV head on ``dim`` ((B, S, Hkv, hd); dim 1 for a
    cache's (B, Hkv, T, hd)), those the rank's ``heads`` query heads read:
    one KV head where they share it, else each query head's own (a group
    of one)."""
    Hkv = k.shape[dim]
    G = heads * tp.size // Hkv
    first = tp.rank * heads
    if G % heads == 0:
        return (k.narrow(dim, first // G, 1), v.narrow(dim, first // G, 1))
    idx = torch.div(torch.arange(first, first + heads, device=k.device), G,
                    rounding_mode="floor")
    return k.index_select(dim, idx), v.index_select(dim, idx)


def tp_attention(p: Attention, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, causal: bool = True, window: int = 0
                 ) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` (``project_qkv``'s, or the cross
    attention's) -> (B, S, H, hd), H the query heads ``q`` holds: causal,
    in a sliding ``window`` (``local_attention``) or full (``causal``
    False: the encoder's and the cross attention). Under tensor
    parallelism: the rank's query heads over their KV heads; or, where the
    query heads do not divide "model" and the reference's query chunk
    (``min(2048, S)``, the window where the keys span more than one, S
    where the chunk does not divide S) does, the rank's S / tp query rows
    over the whole K/V (the kernel's ``q_offset``), the rows gathered; or,
    where neither divides, the whole attention on every rank, as the
    reference replicates it."""
    def attend(q, k, v, q_offset=0):
        if window:
            return local_attention(q, k, v, window=window, q_offset=q_offset)
        return full_attention(q, k, v, causal=causal, q_offset=q_offset)

    tp = p.tp
    if tp is None or p.kv_local:
        return attend(q, k, v)
    if p.heads_local:
        return attend(q, *kv_of_heads(k, v, q.shape[2], tp))
    S = q.shape[1]
    chunk = window if window and k.shape[1] > window else min(2048, S)
    if S % chunk:
        chunk = S
    if chunk % tp.size:
        return attend(q, k, v)
    n = S // tp.size
    o = attend(dist.split_dim(q, 1, tp), dist.copy_in(k, tp),
               dist.copy_in(v, tp), q_offset=tp.rank * n if causal else 0)
    return dist.gather_dim(o, 1, tp)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, T, Hkv, hd) -> (B, S, Hq, hd).

    On the card this is the flash-attention kernel; on the CPU its plain
    version. In bfloat16 the kernel rounds the probabilities to bfloat16
    before the value product, as the JAX package's XLA path does; the
    plain version keeps them in float32."""
    return flash(q, k, v, causal=causal, q_offset=q_offset)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, q_offset: int = 0) -> torch.Tensor:
    """Sliding-window causal attention, O(S window): query position p sees
    the keys k with p - window < k <= p. q (B, S, Hq, hd), k/v (B, T, Hkv,
    hd) -> (B, S, Hq, hd); the queries are positions ``q_offset`` to
    ``q_offset + S - 1`` of the keys' T (S = T and 0 unless a rank holds
    its slice of the rows).

    As in the JAX package, a sequence no longer than the window is plain
    causal attention, and a longer one must be a multiple of the window
    (the reference asserts it: its chunks are window-sized). On the card
    this is the flash-attention kernel with its window; on the CPU its
    plain version with the same mask."""
    T = k.shape[1]
    if T <= window:
        return flash(q, k, v, causal=True, q_offset=q_offset)
    if T % window:
        raise ValueError(f"local_attention: {T} tokens are more than the "
                         f"window {window} and not a multiple of it")
    return flash(q, k, v, causal=True, q_offset=q_offset, window=window)


def decode_attention(q: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: int,
                     tp: Optional[dist.TPGroup] = None) -> torch.Tensor:
    """One decode step over a cache (``_decode_inner``). q (B, Hq, hd);
    caches (B, Hkv, Sl, hd); k_new/v_new (B, Hkv, hd); ``pos`` is the
    position written and the last one seen.

    The new row is written into the caches in place (the JAX package
    returns new caches). As there, a ``pos`` outside the cache writes
    nothing, and every cache row at or before ``pos`` is attended to,
    whoever wrote it. With ``tp`` the caches are this rank's slice of a
    sequence-sharded cache (flash-decode, the reference's ``shard_map``
    over "model"): positions ``rank * Sl`` to ``rank * Sl + Sl - 1``; the
    rank holding ``pos`` writes it, and the ranks' partial maxima, sums
    and outputs are combined over "model". Returns out (B, Hq, hd), the
    same on every rank."""
    B, Hq, hd = q.shape
    Hkv, Sl = kcache.shape[1], kcache.shape[2]
    offset = 0 if tp is None else tp.rank * Sl
    if 0 <= pos - offset < Sl:
        kcache[:, :, pos - offset] = k_new
        vcache[:, :, pos - offset] = v_new
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                          kcache.float()) * (1.0 / math.sqrt(hd))
    visible = torch.arange(offset, offset + Sl, device=q.device) <= pos
    scores = scores.masked_fill(~visible, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    if tp is not None:
        m = dist.max_all_reduce(m, tp)
    e = torch.exp(scores - m)
    l = e.sum(dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", e.to(vcache.dtype), vcache)
    if tp is not None:
        l, o = dist.reduce_out(l, tp), dist.reduce_out(o, tp)
    out = o / l.clamp_min(1e-30).to(o.dtype)[..., None]
    return out.reshape(B, Hq, hd).to(q.dtype)


__all__ = ["Attention", "decode_attention", "kv_of_heads",
           "full_attention", "local_attention", "out_projection",
           "project_qkv", "tp_attention"]
