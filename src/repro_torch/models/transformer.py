"""The transformer layers: the decoder layer with a dense or an MoE FFN,
for prefill and training (``decoder_layer``) and one decode step
(``decoder_layer_step``), with full causal attention or, for the hybrid
family's attention layers, a sliding window (``local_attention`` over a
sequence, the ring-buffer decode ``_ring_decode``); and the audio family's
(whisper) encoder layer and decoder layer with cross attention over the
encoder's output (``project_cross_kv``, ``_plain_decode_attn`` in
decode), both normed by LayerNorm (``norm``).

Under tensor parallelism every attention of these layers runs through
``attention.tp_attention`` (the rank's heads, its query rows, or the
whole) and ``attention.out_projection``, the decoder's cross attention
included: its queries and K/V are the rank's heads where those divide
"model" (the cross caches then hold the rank's KV heads, so cross decode
needs no collective)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.dist import api as dist
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Init
from repro_torch.models.layers import MLP, layer_norm, rms_norm


class DecoderLayer(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp`` and either ``mlp`` (of hidden
    ``d_ff``, default ``cfg.d_ff``) or, for an MoE layer, ``moe``, and,
    with ``cross`` (the audio family's decoder), ``ln_cross`` and the
    cross attention ``cross``, as in the JAX tree
    (``init_decoder_layer``)."""

    AXES = {"ln_attn": (None,), "ln_mlp": (None,), "ln_cross": (None,)}

    def __init__(self, init: Init, cfg, *, moe_layer: bool = False,
                 d_ff: int = 0, cross: bool = False):
        super().__init__()
        self.ln_attn = init.zeros((cfg.d_model,))
        self.attn = attn.Attention(init, cfg)
        self.ln_mlp = init.zeros((cfg.d_model,))
        self.moe_layer = moe_layer
        if moe_layer:
            self.moe = moe_mod.MoE(init, cfg)
        else:
            self.mlp = MLP(init, cfg.d_model, d_ff or cfg.d_ff, cfg.act)
        if cross:
            self.ln_cross = init.zeros((cfg.d_model,))
            self.cross = attn.Attention(init, cfg)


class EncoderLayer(nn.Module):
    """The audio family's encoder layer: ``ln_attn``, ``attn``, ``ln_mlp``,
    ``mlp`` (``init_encoder_layer``)."""

    AXES = {"ln_attn": (None,), "ln_mlp": (None,)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        self.ln_attn = init.zeros((cfg.d_model,))
        self.attn = attn.Attention(init, cfg)
        self.ln_mlp = init.zeros((cfg.d_model,))
        self.mlp = MLP(init, cfg.d_model, cfg.d_ff, cfg.act)


Rope = Tuple[torch.Tensor, torch.Tensor]
KV = Tuple[torch.Tensor, torch.Tensor]


def norm(cfg, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The layers' norm (the reference's ``_norm``): LayerNorm with scale
    ``1 + scale`` (summed in the scale's dtype) and a zero bias in the
    audio family (whisper), RMSNorm elsewhere."""
    if cfg.family == "audio":
        return layer_norm(x, 1.0 + scale, torch.zeros_like(scale),
                          cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


def project_cross_kv(p: attn.Attention, cfg, enc_out: torch.Tensor) -> KV:
    """A layer's cross-attention K/V of the encoder output (B, T, D), in
    the cache layout (B, Hkv, T, hd): views of (B, T, Hkv, hd) products,
    so that the kernel reads them through strides. Under tensor
    parallelism the rank's KV heads where "model" divides them, else all
    of them; ``enc_out``, and the replicated ``wk`` and ``wv`` where each
    rank uses part of them, have their gradients summed over "model"."""
    B, T, _ = enc_out.shape
    wk, wv = p.wk, p.wv
    if p.tp is not None and p.heads_local:
        enc_out = dist.copy_in(enc_out, p.tp)
        if not p.kv_local:
            wk, wv = dist.copy_in(wk, p.tp), dist.copy_in(wv, p.tp)
    shape = (B, T, -1, cfg.resolved_head_dim)
    return ((enc_out @ wk).reshape(shape).transpose(1, 2),
            (enc_out @ wv).reshape(shape).transpose(1, 2))


def _cross_q(p: attn.Attention, cfg, h: torch.Tensor) -> torch.Tensor:
    """The cross attention's queries of h (..., D) -> (..., H, hd), H the
    query heads the rank holds."""
    if p.tp is not None and p.heads_local:
        h = dist.copy_in(h, p.tp)
    return (h @ p.wq).unflatten(-1, (-1, cfg.resolved_head_dim))


def decoder_layer(p: DecoderLayer, cfg, x: torch.Tensor,
                  rope: Optional[Rope],
                  token_shard: Optional[moe_mod.TokenShard] = None, *,
                  window: int = 0, enc_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """Prefill / training layer. x (B, S, D); ``rope`` the tables of
    positions 0..S-1 (None: no RoPE, the audio family); ``token_shard``
    see ``moe.apply_moe``; ``window`` > 0 attends in that sliding window
    (``attention.local_attention``); ``enc_out`` (B, T, D), the audio
    family's encoder output, adds the cross-attention branch. Returns (x,
    aux, cache): the MoE's aux (zero for a dense FFN); the cache (k, v)
    (B, S, Hkv, hd), and with ``enc_out`` also the cross K/V of
    ``project_cross_kv`` (B, Hkv, T, hd) (the KV heads the rank holds)."""
    h = norm(cfg, x, p.ln_attn)
    q, k, v = attn.project_qkv(p.attn, cfg, h, rope)
    o = attn.tp_attention(p.attn, q, k, v, window=window)
    x = x + attn.out_projection(p.attn, o)
    cache: Tuple = (k, v)
    if enc_out is not None:
        h = norm(cfg, x, p.ln_cross)
        qc = _cross_q(p.cross, cfg, h)
        kc, vc = project_cross_kv(p.cross, cfg, enc_out)
        oc = attn.tp_attention(p.cross, qc, kc.transpose(1, 2),
                               vc.transpose(1, 2), causal=False)
        x = x + attn.out_projection(p.cross, oc)
        cache = (k, v, kc, vc)
    h = norm(cfg, x, p.ln_mlp)
    if p.moe_layer:
        d, aux = moe_mod.apply_moe(p.moe, cfg, h, token_shard)
    else:       # the reference's aux of a dense FFN: a float32 zero
        d = p.mlp(h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + d, aux, cache


def decoder_layer_step(p: DecoderLayer, cfg, x: torch.Tensor,
                       kcache: torch.Tensor, vcache: torch.Tensor, pos: int,
                       rope: Optional[Rope], *, window: int = 0,
                       enc_kv: Optional[KV] = None,
                       kv_sharded: bool = False,
                       token_shard: Optional[moe_mod.TokenShard] = None
                       ) -> torch.Tensor:
    """Decode-step layer. x (B, D); caches (B, Hkv, Sc, hd), written in
    place at ``pos`` (with a ``window``, a ring of Sc = window slots
    written at ``pos % window``, ``_ring_decode``); ``rope`` the (B, 1)
    tables of ``pos`` (None in the audio family); ``enc_kv`` the audio
    family's cross caches (B, Hkv, T, hd), read, not written
    (``_plain_decode_attn``). An MoE layer routes the step's B tokens as
    one call (``token_shard`` see ``moe.apply_moe``) and drops its aux.
    Under tensor parallelism the self caches hold every KV head,
    ``kv_sharded`` says whether they are this rank's
    sequence slice (flash-decode) or the whole (a ring is always whole),
    the rank's q/k/v heads are gathered over "model" for the attention,
    and its query heads of the output go into its slice of ``wo``; the
    cross caches hold the KV heads of the rank's cross projection
    (``project_cross_kv``). Returns x."""
    B, _ = x.shape
    h = norm(cfg, x, p.ln_attn)[:, None]                       # (B, 1, D)
    q, k, v = attn.project_qkv(p.attn, cfg, h, rope)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    tp = p.attn.tp
    if tp is None:
        if window:
            o = _ring_decode(q, kcache, vcache, k, v, pos)
        else:
            o = attn.decode_attention(q, kcache, vcache, k, v, pos)
        return _step_rest(p, cfg, x + o.reshape(B, -1) @ p.attn.wo, enc_kv,
                          token_shard)
    heads = q.shape[1]
    if p.attn.heads_local:
        q = dist.gather_dim(q, 1, tp)
    if p.attn.kv_local:
        k, v = dist.gather_dim(k, 1, tp), dist.gather_dim(v, 1, tp)
    if window:
        o = _ring_decode(q, kcache, vcache, k, v, pos)
    else:
        o = attn.decode_attention(q, kcache, vcache, k, v, pos,
                                  tp if kv_sharded else None)
    if p.attn.heads_local:
        o = o.narrow(1, tp.rank * heads, heads)
    return _step_rest(p, cfg, x + attn.out_projection(
        p.attn, o[:, None])[:, 0], enc_kv, token_shard)


def _step_rest(p: DecoderLayer, cfg, x: torch.Tensor,
               enc_kv: Optional[KV],
               token_shard: Optional[moe_mod.TokenShard] = None
               ) -> torch.Tensor:
    """A decode step after its self-attention: the cross attention (the
    audio family; the rank's query heads over the KV heads they read),
    then the FFN."""
    if enc_kv is not None:
        cross, (ck, cv) = p.cross, enc_kv
        qc = _cross_q(cross, cfg, norm(cfg, x, p.ln_cross))
        if cross.tp is not None and cross.heads_local and \
                not cross.kv_local:
            ck, cv = attn.kv_of_heads(ck, cv, qc.shape[1], cross.tp, dim=1)
        oc = _plain_decode_attn(qc, ck, cv)
        x = x + attn.out_projection(cross, oc[:, None])[:, 0]
    h = norm(cfg, x, p.ln_mlp)
    if p.moe_layer:
        return x + moe_mod.apply_moe(p.moe, cfg, h[:, None],
                                     token_shard)[0][:, 0]
    return x + p.mlp(h)


def encoder_layer(p: EncoderLayer, cfg, x: torch.Tensor) -> torch.Tensor:
    """The audio encoder's layer over x (B, T, D): full (non-causal)
    self-attention without RoPE, then the MLP."""
    h = norm(cfg, x, p.ln_attn)
    q, k, v = attn.project_qkv(p.attn, cfg, h, None)
    o = attn.tp_attention(p.attn, q, k, v, causal=False)
    x = x + attn.out_projection(p.attn, o)
    return x + p.mlp(norm(cfg, x, p.ln_mlp))


def _plain_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> torch.Tensor:
    """One decode step's cross attention over the fixed encoder K/V, no
    mask: q (B, Hq, hd), k/v (B, Hkv, T, hd) -> (B, Hq, hd). The scores
    and softmax in float32, the probabilities cast to v's dtype for the
    value product, as the reference."""
    B, Hq, hd = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhtd->bhgt", qg.float(),
                     k.float()) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgt,bhtd->bhgd", p, v).reshape(B, Hq, hd)


def _ring_decode(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos: int
                 ) -> torch.Tensor:
    """Sliding-window ring-buffer decode attention (griffin's local
    attention), the JAX package's ``_ring_decode``. q (B, Hq, hd); the
    ring kc/vc (B, Hkv, W, hd), where slot i holds the position p with
    p % W == i, gets the new row at ``pos % W`` in place (the JAX package
    returns new caches); slots past ``pos`` (the warm-up) are masked with
    -1e30 and the softmax is taken in float32, then cast to the cache's
    dtype for the value product. Returns (B, Hq, hd)."""
    B, Hkv, W, hd = kc.shape
    slot = pos % W
    kc[:, :, slot] = k_new
    vc[:, :, slot] = v_new
    Hq = q.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                     kc.float()) / math.sqrt(hd)
    valid = torch.arange(W, device=q.device) <= pos      # warm-up masking
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(vc.dtype)
    return torch.einsum("bhgs,bhsd->bhgd", p, vc).reshape(B, Hq, hd)


__all__ = ["DecoderLayer", "EncoderLayer", "decoder_layer",
           "decoder_layer_step", "encoder_layer", "norm", "project_cross_kv"]
