"""The decoder layer with a dense or an MoE FFN: prefill and training
(``decoder_layer``) and one decode step (``decoder_layer_step``), with
full causal attention or, for the hybrid family's attention layers, a
sliding window (``local_attention`` over a sequence, the ring-buffer
decode ``_ring_decode``). Cross attention comes with the audio family."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Init
from repro_torch.models.layers import MLP, rms_norm


class DecoderLayer(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp`` and either ``mlp`` (of hidden
    ``d_ff``, default ``cfg.d_ff``) or, for an MoE layer, ``moe``, as in
    the JAX tree (``init_decoder_layer``)."""

    AXES = {"ln_attn": (None,), "ln_mlp": (None,)}

    def __init__(self, init: Init, cfg, *, moe_layer: bool = False,
                 d_ff: int = 0):
        super().__init__()
        self.ln_attn = init.zeros((cfg.d_model,))
        self.attn = attn.Attention(init, cfg)
        self.ln_mlp = init.zeros((cfg.d_model,))
        self.moe_layer = moe_layer
        if moe_layer:
            self.moe = moe_mod.MoE(init, cfg)
        else:
            self.mlp = MLP(init, cfg.d_model, d_ff or cfg.d_ff, cfg.act)


Rope = Tuple[torch.Tensor, torch.Tensor]


def decoder_layer(p: DecoderLayer, cfg, x: torch.Tensor, rope: Rope,
                  token_shard: Optional[moe_mod.TokenShard] = None, *,
                  window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill / training layer. x (B, S, D); ``rope`` the tables of
    positions 0..S-1; ``token_shard`` see ``moe.apply_moe``; ``window`` >
    0 attends in that sliding window (``attention.local_attention``).
    Returns (x, aux, (k, v)): the MoE's aux (zero for a dense FFN), k/v
    (B, S, Hkv, hd) for the cache."""
    h = rms_norm(x, p.ln_attn, cfg.norm_eps)
    q, k, v = attn.project_qkv(p.attn, cfg, h, rope)
    if window:
        o = attn.local_attention(q, k, v, window=window)
    else:
        o = attn.full_attention(q, k, v, causal=True)
    x = x + attn.out_projection(p.attn, o)
    h = rms_norm(x, p.ln_mlp, cfg.norm_eps)
    if p.moe_layer:
        d, aux = moe_mod.apply_moe(p.moe, cfg, h, token_shard)
    else:       # the reference's aux of a dense FFN: a float32 zero
        d = p.mlp(h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + d, aux, (k, v)


def decoder_layer_step(p: DecoderLayer, cfg, x: torch.Tensor,
                       kcache: torch.Tensor, vcache: torch.Tensor, pos: int,
                       rope: Rope, *, window: int = 0) -> torch.Tensor:
    """Decode-step layer. x (B, D); caches (B, Hkv, Sc, hd), written in
    place at ``pos`` (with a ``window``, a ring of Sc = window slots
    written at ``pos % window``, ``_ring_decode``); ``rope`` the (B, 1)
    tables of ``pos``. An MoE layer routes the step's B tokens as one call
    and drops its aux. Returns x."""
    B, _ = x.shape
    h = rms_norm(x, p.ln_attn, cfg.norm_eps)[:, None]          # (B, 1, D)
    q, k, v = attn.project_qkv(p.attn, cfg, h, rope)
    if window:
        o = _ring_decode(q[:, 0], kcache, vcache, k[:, 0], v[:, 0], pos)
    else:
        o = attn.decode_attention(q[:, 0], kcache, vcache, k[:, 0],
                                  v[:, 0], pos)
    x = x + o.reshape(B, -1) @ p.attn.wo
    h = rms_norm(x, p.ln_mlp, cfg.norm_eps)
    if p.moe_layer:
        return x + moe_mod.apply_moe(p.moe, cfg, h[:, None])[0][:, 0]
    return x + p.mlp(h)


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


__all__ = ["DecoderLayer", "decoder_layer", "decoder_layer_step"]
